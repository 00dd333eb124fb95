"""Kernel-launch calls (``cudaLaunchKernel*`` / ``cuLaunchKernel*``, a
launch seen as both counted once) on the launching thread inside the
port's entry ranges (``edscache.compute_entry``,
``mesh.compute_entries_batched``, ``mesh.compute_entry_mesh``) per block,
over the plain segment: a count, so it repeats exactly."""

from benchmark import spans


def read(ctx):
    launches = spans.entry_launches(ctx.plain)
    if launches is None or not ctx.plain_blocks:
        return None
    return launches / ctx.plain_blocks
