"""Host milliseconds per block inside the port's ``entry.assemble``
ranges (the DAHs and entries built from the host roots after the
commitments' download), on any thread, clipped to the plain segment's
window."""

from benchmark import spans


def read(ctx):
    seg = ctx.plain
    per_thread = [spans.clip(spans.named(seg, tid, lambda n: n == spans.ASSEMBLE), seg.window)
                  for tid in seg.host_ops]
    if not any(per_thread) or not ctx.plain_blocks:
        return None
    return sum(spans.total(t) for t in per_thread) / 1e3 / ctx.plain_blocks
