"""Host milliseconds per block on the launching thread inside the port's
pipeline stage ranges (``eds.*``, ``sharded.*``), less the time in the
``xfer.*`` ranges nested in them, over the plain segment: what enqueueing
the pipeline costs the host. Unions, clipped to the window."""

from benchmark import spans


def read(ctx):
    host = spans.launch_time(ctx.plain)
    if host is None or not ctx.plain_blocks:
        return None
    return spans.total(host) / 1e3 / ctx.plain_blocks
