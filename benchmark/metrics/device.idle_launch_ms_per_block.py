"""Idle card milliseconds per block, summed over the cell's cards, during
which the launching thread is inside one of the port's pipeline stage
ranges (``eds.*``, ``sharded.*``) and outside every ``xfer.*`` range: the
idle that host enqueueing causes, over the plain segment. A card's idle
time is the complement of its busy spans within the window."""

from benchmark import spans


def read(ctx):
    seg = ctx.plain
    host = spans.launch_time(seg)
    busy = seg.busy_spans()
    if host is None or not busy or not ctx.plain_blocks:
        return None
    idle_us = 0.0
    for card in range(ctx.chips):
        idle = spans.minus([seg.window], busy.get(card, []))
        idle_us += spans.total(spans.overlap(idle, host))
    return idle_us / 1e3 / ctx.plain_blocks
