"""MiB that cross between host and card through the transfer ledger
(obs/xfer totals, both directions) per block, over the plain segment: a
count, so it repeats exactly."""


def read(ctx):
    if not ctx.plain_blocks:
        return None
    return ctx.crossed_bytes / ctx.plain_blocks / 2**20
