"""The least time of the SHA-256 compressions that verify a repaired
square's 4k axis roots (work.sha256_least_s of k without the data root,
which a repair does not compute) as a percentage of kernel K1's device
time (the "sha256" layer), in a withheld-square cell."""


def read(ctx):
    s = ctx.layer_s.get("sha256", 0.0)
    if not s or not ctx.staged_blocks:
        return None
    least, _ = ctx.work.sha256_least_s(ctx.k, data_root=False)
    return 100 * least * ctx.staged_blocks / s
