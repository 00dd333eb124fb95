"""Device milliseconds of host<->card copies (the "copy" layer: HtoD and
DtoH memcpy) per block."""


def read(ctx):
    s = ctx.layer_s.get("copy", 0.0)
    if not s or not ctx.staged_blocks:
        return None
    return s / ctx.staged_blocks * 1e3
