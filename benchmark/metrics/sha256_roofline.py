"""The least time of a block's SHA-256 compressions (work.sha256_least_s
of k) as a percentage of kernel K1's device time (the "sha256" layer)."""


def read(ctx):
    s = ctx.layer_s.get("sha256", 0.0)
    if not s or not ctx.staged_blocks:
        return None
    least, _ = ctx.work.sha256_least_s(ctx.k)
    return 100 * least * ctx.staged_blocks / s
