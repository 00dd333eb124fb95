"""The largest card's allocated-memory peak over the traced segments, in
MiB (torch.cuda.max_memory_allocated after reset_peak_memory_stats)."""


def read(ctx):
    return ctx.peak_bytes / 2**20 if ctx.peak_bytes else None
