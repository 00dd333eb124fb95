"""Device milliseconds per block, over the plain segment, of host<->card
copies whose trace name says ``Pageable``: the memcpy operations that go
through CUDA's staging buffer for pageable host memory, in either direction.
What a pinned destination or source takes off the path leaves this
metric and stays in ``host.copy_ms_per_block``."""


def read(ctx):
    if not ctx.plain.ops or not ctx.plain_blocks:
        return None
    lo, hi = ctx.plain.window
    us = sum(max(0.0, min(op.start + op.dur, hi) - max(op.start, lo)) for op in ctx.plain.ops
             if op.name.startswith("Memcpy") and "Pageable" in op.name)
    return us / 1e3 / ctx.plain_blocks
