"""Device milliseconds per block of da/repair's own torch operations (the
"repair" layer: the gathers of the axes to decode, the scatters of the
decoded shares, the per-axis comparisons of the re-encode), around the
decodes (ops/rs) and the root verification (ops/nmt, K1)."""


def read(ctx):
    s = ctx.layer_s.get("repair", 0.0)
    if not s or not ctx.staged_blocks:
        return None
    return s / ctx.staged_blocks * 1e3
