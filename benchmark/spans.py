"""The port's own ranges in a profiled segment, for the per-layer readers
that read them (``metrics/host.*``, ``metrics/device.idle_launch_*``).

While a profiler records, the port opens ``record_function`` ranges
(``celestia_app_tpu_torch/obs/spans.stage``) around its encode-and-commit
path; they reach ``trace.Segment.host_ops`` as host operations named:

  entries    ``edscache.compute_entry``, ``mesh.compute_entries_batched``,
             ``mesh.compute_entry_mesh``
  stages     ``eds.*`` (one card), ``sharded.*`` (a mesh): code that
             enqueues the pipeline's device work
  crossings  ``xfer.h2d:<site>``, ``xfer.d2h:<site>``: the transfer
             ledger's copies, nested in whatever stage is open
  assembly   ``entry.assemble``: the DAHs and entries built on the host

A program without them (before the ranges existed) yields no range, and
each reader then returns None. Times are microseconds on the trace's
clock; intervals are (start, end) pairs.
"""

from __future__ import annotations

import bisect

ENTRIES = ("edscache.compute_entry", "mesh.compute_entries_batched", "mesh.compute_entry_mesh")
STAGES = ("eds.", "sharded.")
XFER = "xfer."
ASSEMBLE = "entry.assemble"
# the CUDA runtime's and CUDA driver API's kernel-launch calls (cudaLaunchKernelExC,
# cuLaunchKernelEx and the like share these prefixes)
RUNTIME_LAUNCH = "cudaLaunchKernel"
DRIVER_LAUNCH = "cuLaunchKernel"


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint intervals covering `intervals`."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, window) -> list[tuple[float, float]]:
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def minus(a, b) -> list[tuple[float, float]]:
    """What of the disjoint sorted intervals `a` lies outside those of `b`."""
    out, j = [], 0
    for start, end in a:
        while j < len(b) and b[j][1] <= start:
            j += 1
        k, at = j, start
        while k < len(b) and b[k][0] < end:
            if b[k][0] > at:
                out.append((at, b[k][0]))
            at = max(at, b[k][1])
            k += 1
        if at < end:
            out.append((at, end))
    return out


def overlap(a, b) -> list[tuple[float, float]]:
    """The intersection of two sets of disjoint sorted intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def total(intervals) -> float:
    return sum(b - a for a, b in intervals)


def covers(intervals, t: float) -> bool:
    """Whether `t` lies in one of the disjoint sorted `intervals`."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def named(segment, tid, match) -> list[tuple[float, float]]:
    """The union of the ranges on thread `tid` whose name `match` accepts."""
    return union((a, b) for a, b, name in segment.host_ops.get(tid, ()) if match(name))


def launch_time(segment) -> list[tuple[float, float]] | None:
    """Where the launching thread is inside a pipeline stage and outside
    every crossing, within the window; None where the segment has no
    stage range."""
    tid = segment.launch_tid
    stages = named(segment, tid, lambda n: n.startswith(STAGES))
    if not stages:
        return None
    return clip(minus(stages, named(segment, tid, lambda n: n.startswith(XFER))), segment.window)


def entry_launches(segment) -> int | None:
    """Kernel-launch calls on the launching thread inside an entry range;
    a CUDA driver API call inside a runtime call is the same launch, counted once.
    None where the segment has no entry range."""
    tid = segment.launch_tid
    entries = clip(named(segment, tid, lambda n: n in ENTRIES), segment.window)
    if not entries:
        return None
    events = segment.host_ops.get(tid, ())
    runtime = [(a, b) for a, b, name in events if name.startswith(RUNTIME_LAUNCH)]
    in_runtime = union(runtime)
    driver = [a for a, _, name in events if name.startswith(DRIVER_LAUNCH) and not covers(in_runtime, a)]
    return sum(covers(entries, a) for a, _ in runtime) + sum(covers(entries, a) for a in driver)
