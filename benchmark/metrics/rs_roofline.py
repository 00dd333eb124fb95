"""The extension's least time (work.extension_least_s of (k, field)) as a
percentage of the "rs" layer's device time: K2 in GF(2^8); the products
and their glue in GF(2^16)."""


def read(ctx):
    s = ctx.layer_s.get("rs", 0.0)
    if not s or not ctx.staged_blocks:
        return None
    least, _ = ctx.work.extension_least_s(ctx.k, ctx.bits)
    return 100 * least * ctx.staged_blocks / s
