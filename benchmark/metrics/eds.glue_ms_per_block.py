"""Device milliseconds of the torch glue around the kernels (the "glue"
layer: operations launched from da/eds, ops/nmt, ops/merkle, ops/sha256
and the sharded pipeline, K1 excluded) per block."""


def read(ctx):
    s = ctx.layer_s.get("glue", 0.0)
    if not s or not ctx.staged_blocks:
        return None
    return s / ctx.staged_blocks * 1e3
