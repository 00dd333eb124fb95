"""Milliseconds in which an operation ran on a card (the union of kernel,
copy and memset intervals, summed over the cards) per block, over the
plain segment."""


def read(ctx):
    busy_us = sum(ctx.plain.busy_s().values())
    if not busy_us or not ctx.plain_blocks:
        return None
    return busy_us / 1e3 / ctx.plain_blocks
