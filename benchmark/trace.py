"""Device time from ``torch.profiler``, busy and idle, placed on layers.

A segment of calls is profiled (CPU and CUDA activities) and its chrome
trace read back. Device operations are the ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; the segment's window is the ``benchmark.segment``
annotation around the calls and the final synchronize. Operations
launched inside a ``benchmark.keep`` annotation (the check's copies of
sampled squares) are the benchmark's own and are left out. So are those
launched inside a ``benchmark.prepare`` annotation (a withheld-square
mix's hand-over, made between calls), and its interval besides: it is
cut out of the window, so it counts in no busy, idle or layer time.

With Python stacks on, each device operation is followed to its launch
(the runtime or driver call of the same correlation id) and to the
Python frames open on the launching thread at that moment; the innermost
frame under the program's package names the module and function that
launched it. A layer file (``layers/<name>.json``) claims operations by
``frames`` ("ops/rs.py" for a module, "ops/rs.py:gf16_mix" for a
function) and by ``kernels`` (regular expressions on the operation's
name). The most specific claim wins: a function, then a kernel name,
then a module; ties go to the first layer by name. What no layer claims
is unplaced.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import tempfile
import time
from typing import Callable

import torch

from benchmark import spans

PACKAGE = "celestia_app_tpu_torch/"
SEGMENT = "benchmark.segment"
CALL = "benchmark.call"  # around each call of the entry in a traced segment
KEEP = "benchmark.keep"  # around the check's copies of sampled squares
PREPARE = "benchmark.prepare"  # around a hand-over's preparation between calls
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_FRAME = re.compile(r"^(.*)\((\d+)\): (.*)$")


@dataclasses.dataclass
class Op:
    device: int
    start: float  # us, trace clock
    dur: float  # us
    name: str
    frame: str | None  # "ops/rs.py:gf16_mix", the innermost program frame at launch
    layer: str | None = None


@dataclasses.dataclass
class Segment:
    window: tuple[float, float]  # us, trace clock
    ops: list[Op]
    host_ops: dict = dataclasses.field(default_factory=dict)  # thread id -> sorted [(start, end, name)]
    launch_tid: int | None = None  # the thread that launched most device operations
    kept_s: float = 0.0  # device seconds of the check's own copies, left out of `ops`
    parse_s: float = 0.0  # host seconds spent exporting and reading the trace
    # the hand-overs' preparation: its host intervals (disjoint, sorted, within
    # the window), cut out of the window, and its device seconds, left out of `ops`
    excluded: list = dataclasses.field(default_factory=list)
    prepared_s: float = 0.0

    @property
    def window_s(self) -> float:
        """The window's length, less the intervals cut out of it."""
        return (self.window[1] - self.window[0] - spans.total(self.excluded)) / 1e6

    def busy_s(self) -> dict[int, float]:
        """Union of device operation intervals within the window, per device."""
        return {dev: spans.total(busy) for dev, busy in self.busy_spans().items()}

    def busy_spans(self) -> dict[int, list[tuple[float, float]]]:
        by_dev = collections.defaultdict(list)
        for op in self.ops:
            by_dev[op.device].append((op.start, op.start + op.dur))
        return {dev: spans.minus(spans.union(spans.clip(iv, self.window)), self.excluded)
                for dev, iv in by_dev.items()}


def _frame_key(name: str, root: str) -> str | None:
    """'celestia_app_tpu_torch/ops/rs.py(137): gf16_mix' -> 'ops/rs.py:gf16_mix'
    for root PACKAGE; None when the frame is not under `root`."""
    at = name.find(root)
    m = _FRAME.match(name[at:]) if at >= 0 else None
    if m is None:
        return None
    return f"{m.group(1)[len(root):]}:{m.group(3)}"


def _open_frames(py_events: list[tuple], times: list[float]) -> list[list[str]]:
    """For each time in `times` (sorted), the Python frame names open at that
    time on one thread, outermost first. `py_events` are (start, end, name)
    sorted by start, longest first on ties; frames nest."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(py_events) and py_events[i][0] <= t:
            ev = py_events[i]
            while stack and stack[-1][1] <= ev[0]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append([name for _, _, name in stack])
    return out


def parse(trace: dict, with_frames: bool) -> Segment:
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    window = None
    ops, launches = [], {}
    py = collections.defaultdict(list)
    host_ops = collections.defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            ops.append((e, e.get("args", {}).get("correlation")))
            continue
        if cat in LAUNCH_CATS:
            launches[e.get("args", {}).get("correlation")] = (e["ts"], e["tid"])
        elif cat == "python_function" and with_frames:
            py[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        if cat == "user_annotation" and e.get("name") == SEGMENT:
            window = (e["ts"], e["ts"] + e["dur"])
        elif cat in HOST_CATS:
            host_ops[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    if window is None:
        raise RuntimeError(f"the trace has no {SEGMENT} annotation")
    for events_ in (*py.values(), *host_ops.values()):
        events_.sort(key=lambda ev: (ev[0], -ev[1]))
    kept = _launched_inside(launches, host_ops, KEEP)
    prepared = _launched_inside(launches, host_ops, PREPARE)
    excluded = spans.clip(spans.union((a, b) for evs in host_ops.values() for a, b, name in evs
                                      if name == PREPARE), window)
    frames: dict = {}
    if with_frames:
        wanted = collections.defaultdict(list)
        for corr, (ts, tid) in launches.items():
            wanted[tid].append((ts, corr))
        for tid, items in wanted.items():
            items.sort()
            for (ts, corr), stack in zip(items, _open_frames(py.get(tid, []), [ts for ts, _ in items])):
                keys = [k for k in (_frame_key(n, PACKAGE) for n in reversed(stack)) if k]
                frames[corr] = keys[0] if keys else None
    out, kept_s, prepared_s = [], 0.0, 0.0
    for e, corr in ops:
        if corr in kept:
            kept_s += e.get("dur", 0.0) / 1e6
        elif corr in prepared:
            prepared_s += e.get("dur", 0.0) / 1e6
        else:
            out.append(Op(int(e.get("args", {}).get("device", 0)), e["ts"], e.get("dur", 0.0), e["name"],
                          frames.get(corr)))
    per_tid = collections.Counter(tid for corr, (_, tid) in launches.items()
                                  if corr not in kept and corr not in prepared)
    launch_tid = per_tid.most_common(1)[0][0] if per_tid else None
    return Segment(window, out, dict(host_ops), launch_tid, kept_s, excluded=excluded, prepared_s=prepared_s)


def _launched_inside(launches: dict, host_ops: dict, annotation: str) -> set:
    """Correlation ids of the launches made inside an `annotation` on the
    same thread."""
    inside = {tid: [(a, b) for a, b, name in evs if name == annotation] for tid, evs in host_ops.items()}
    return {corr for corr, (ts, tid) in launches.items()
            if any(a <= ts <= b for a, b in inside.get(tid, ()))}


def place(ops: list[Op], layer_files: dict[str, dict]) -> None:
    """Set each op's layer from the layer files (see the module's rule)."""
    compiled = {name: (set(spec.get("frames", ())), [re.compile(p) for p in spec.get("kernels", ())])
                for name, spec in layer_files.items()}
    for op in ops:
        module = op.frame.split(":")[0] if op.frame else None
        best, best_score = None, 0
        for name, (frames, kernels) in compiled.items():
            score = 0
            if op.frame and op.frame in frames:
                score = 3
            elif any(p.search(op.name) for p in kernels):
                score = 2
            elif module and module in frames:
                score = 1
            if score > best_score:
                best, best_score = name, score
        op.layer = best


def capture(calls: Callable[[], int], with_stack: bool, devices: list[torch.device]
            ) -> tuple[Segment, int]:
    """Profile `calls()` (which returns the blocks it handed over) and the
    synchronize after it. Returns (the parsed segment, blocks)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cards = [d for d in devices if d.type == "cuda"]
    for dev in cards:
        torch.cuda.synchronize(dev)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
    with profile(activities=activities, with_stack=with_stack) as prof:
        with record_function(SEGMENT):
            blocks = calls()
            for dev in cards:
                torch.cuda.synchronize(dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    segment = parse(trace, with_frames=with_stack)
    segment.parse_s = time.perf_counter() - t0
    return segment, blocks


def short_kernel(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    m = re.search(r"cutlass_\w+", name)
    if m:
        return m.group(0)
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    base = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    base = re.split(r"[<(]", base, maxsplit=1)[0]
    return base.split("::")[-1] or name[:60]


def device_ops(segment: Segment, top: int = 10) -> list[list]:
    """The device operations that took most time: [[layer kernel frame, s]]."""
    totals = collections.Counter()
    for op in segment.ops:
        totals[f"{op.layer or 'unplaced'} {short_kernel(op.name)} @{op.frame or '?'}"] += op.dur / 1e6
    return [[name, s] for name, s in totals.most_common(top)]


def _host_activity(segment: Segment, t: float) -> str:
    """What the launching thread was doing at `t`: its innermost host
    operations open then (a torch op, a runtime call), or, between them,
    host Python inside a call of the entry or the benchmark between calls."""
    stack = _open_frames(segment.host_ops.get(segment.launch_tid, []), [t])[0]
    names = [n for n in stack if n != SEGMENT]
    if not names:
        return "benchmark between calls"
    if names == [CALL]:
        return "host Python in the entry"
    return " > ".join(n for n in names if n != CALL)[-120:]


def idle_gaps(segment: Segment, top: int = 10) -> list[list]:
    """The longest idle gaps of each device within the window (the
    intervals cut out of it excepted), named by what the launching thread
    was running at each gap's middle and by the device operation the gap
    follows. Read them from a segment profiled without Python stacks,
    which slow the host."""
    gaps = []
    last = collections.defaultdict(list)
    for op in segment.ops:
        last[op.device].append((op.start + op.dur, short_kernel(op.name)))
    for dev, busy in segment.busy_spans().items():
        ends = sorted(last[dev])
        for a, b in spans.minus(spans.minus([segment.window], busy), segment.excluded):
            gaps.append((b - a, dev, a, (a + b) / 2, ends))
    gaps.sort(key=lambda g: g[:3], reverse=True)
    out = []
    for length, dev, a, mid, ends in gaps[:top]:
        before = [name for end, name in ends if end <= a + 1e-3]
        after = f" after {before[-1]}" if before else " at the segment's start"
        out.append([f"cuda:{dev} {_host_activity(segment, mid)}{after}", length / 1e6])
    return out


def layer_seconds(segment: Segment) -> dict[str | None, float]:
    out = collections.Counter()
    for op in segment.ops:
        out[op.layer] += op.dur / 1e6
    return dict(out)
