"""Percentage of the plain segment's window in which no operation ran on a
card, averaged over the cards the cell uses."""


def read(ctx):
    window_us = ctx.plain.window_s * 1e6
    busy = ctx.plain.busy_s()
    if not window_us or not busy:
        return None
    return 100 * (1 - sum(busy.get(i, 0.0) for i in range(ctx.chips)) / ctx.chips / window_us)
