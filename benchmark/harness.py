"""One run of one cell: set-up, the measured window (or, with tracing, two
profiled segments), the check against the reference, and the result.

Set-up is everything from process start to the window: imports, the
kernels' load from the build cache (their build, in a run that compiles),
the input pool (with a withheld-square mix, the first blocks' reference
squares), and the mix's warm calls, which build the operands of the
cell's k and warm its shapes; the result's counted fields time each
part. The window is a closed loop of calls for ``seconds``: the rate is
every block over the whole window, the tail is over every call. A traced
run first makes calls until the check's sample is full and one more,
then profiles ``trace_calls`` calls twice: once plainly, for device busy
and idle time, and once with Python stacks, to place device time on
layers (the stack tracer slows the host, so the second segment's idle
time is not used).

Blocks to check are drawn from the seed, by reservoir over every block
handed over after set-up (``Sample``). Their outputs are read once the
window has closed and the memory peak is taken; the reference then
recomputes each from its pool square and stamp, on the first device. In
a withheld-square cell the entry is first called four times more on one
sampled block's hand-over, each with one root altered, and has to raise. The
memory peak is the program's: the sample's bytes on a card are held
constant from before the window and taken off it; where the driver
prepares hand-overs on the card, it reads the peak over its calls alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import check, spans, spec as spec_mod, trace, work
from benchmark.inputs import pool as pool_mod
from benchmark.traffic import Driver

MASK64 = 2**64 - 1


def device_square(entry) -> torch.Tensor | None:
    """The square a device-resident entry (the port's ``DeviceEntry``)
    keeps on its device, or None for a host entry."""
    sq = getattr(entry, "_eds_dev", None)
    return sq if isinstance(sq, torch.Tensor) else None


@dataclasses.dataclass
class Commitments:
    """A sampled device entry's host commitments (its square is in a slot)."""

    dah: object
    data_root: bytes


class Sample:
    """A uniform sample of `size` of the blocks handed over, drawn from the
    seed as they come (reservoir sampling).

    A sampled device entry is not kept: its square is copied into one of
    `size` slots allocated in set-up (``prepare``), inside a ``KEEP``
    annotation that the trace leaves out, and its commitments are on the
    host already. So nothing of the program stays on a card, and the slots'
    bytes (``held``) are the same all through the window. A host entry is
    kept whole; it holds host memory only."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed & MASK64, 0x5EED])
        self.seen = 0
        self.items: list = []  # (sequence number, pool index, entry or Commitments, slot or None)
        self.slots: torch.Tensor | None = None
        self.held: dict[int, int] = {}  # card index -> bytes of the slots

    def prepare(self, entry) -> None:
        """Allocate the slots for squares like `entry`'s, if it keeps one on a device."""
        sq = device_square(entry)
        if sq is None:
            return
        self.slots = torch.empty((self.size, *sq.shape), dtype=sq.dtype, device=sq.device)
        if sq.device.type == "cuda":
            self.held[sq.device.index] = self.slots.numel() * self.slots.element_size()

    def offer(self, seq: int, index: int, entry) -> None:
        if len(self.items) < self.size:
            j = len(self.items)
            self.items.append(None)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if j >= self.size:
            return
        sq = device_square(entry) if self.slots is not None else None
        if sq is None:
            self.items[j] = (seq, index, entry, None)
            return
        with torch.profiler.record_function(trace.KEEP):
            self.slots[j].copy_(sq)
        self.items[j] = (seq, index, Commitments(entry.dah, entry.data_root), j)

    def outputs(self, log) -> list[tuple[int, int, check.Outputs | None]]:
        """(sequence number, pool index, outputs or None where they could
        not be read) of each sampled block; frees the slots."""
        out = []
        for seq, index, kept, slot in self.items:
            try:
                got = check.read_outputs(kept, None if slot is None else self.slots[slot])
            except Exception:
                log(traceback.format_exc())
                got = None
            out.append((seq, index, got))
        self.items.clear()
        self.slots = None
        return out


@dataclasses.dataclass
class Window:
    """What the end-to-end readers (e2e/<name>.py) see."""

    cell: spec_mod.Cell
    k: int
    batched: bool
    setup_s: float
    window_s: float
    blocks: int
    calls: int
    latencies_s: list[float]


@dataclasses.dataclass
class Layers:
    """What the per-layer readers (metrics/<name>.py) see."""

    cell: spec_mod.Cell
    k: int
    bits: int
    chips: int
    plain: trace.Segment  # no stacks: busy and idle
    plain_blocks: int
    staged: trace.Segment  # with stacks: device time placed on layers
    staged_blocks: int
    layer_s: dict
    crossed_bytes: int  # host<->card bytes through obs/xfer in the plain segment
    peak_bytes: int  # the largest card's peak since the segments began, the sample's slots taken off
    work = work


def _devices(device, chips: int) -> list[torch.device]:
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(chips)]


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _peak(devices, held: dict[int, int] | None = None) -> int:
    """The largest card's allocated-memory peak, less the bytes the
    benchmark itself holds there (`held`, by card index)."""
    held = held or {}
    return max((torch.cuda.max_memory_allocated(d) - held.get(d.index, 0) for d in devices if d.type == "cuda"),
               default=0)


def _program_peak(driver: Driver, devices, held: dict[int, int] | None = None) -> int:
    """The program's peak since the last reading: the driver's, where it
    reads one, else the cards' (`_peak`)."""
    peak = driver.take_peak()
    return _peak(devices, held) if peak is None else peak


def _xfer_bytes() -> int:
    from celestia_app_tpu_torch.obs import xfer

    t = xfer.totals()
    return t["h2d_bytes"] + t["d2h_bytes"]


def run(cell: spec_mod.Cell, seed: int, seconds: float, traced: bool, device, t_process: float,
        entry=None, log=None) -> dict:
    """The result of one run (the keys the result line prints, checks last)."""
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    config, mix = cell.config, cell.traffic
    k = int(config["square_size"])
    devices = _devices(device, cell.chips)
    call_device = None if devices[0].type == "cuda" else devices[0]

    from celestia_app_tpu_torch import cuda_build

    marks = [time.perf_counter()]
    if devices[0].type == "cuda":
        cuda_build.build()
    marks.append(time.perf_counter())
    pool = pool_mod.make(config, int(mix["pool"]), seed)
    driver = Driver(mix, pool, call_device, entry=entry, seed=seed, devices=devices)
    driver.ready(int(mix["warm_calls"]))
    _sync(devices)
    marks.append(time.perf_counter())
    sample = Sample(int(mix["check_blocks"]), seed)
    entries: list = []
    for _ in range(int(mix["warm_calls"])):
        _, entries, _ = driver.call()
    _sync(devices)
    setup_peak = _program_peak(driver, devices)
    if entries:
        sample.prepare(entries[0])
    del entries
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_process
    setup_split = {"imports": marks[0] - t_process, "kernel_load": marks[1] - marks[0],
                   "input_pool": marks[2] - marks[1], "warm_calls": t_process + setup_s - marks[2]}

    state = {"blocks": 0, "calls": 0, "failed": 0, "latencies": [], "ends": []}
    marked = torch.profiler.record_function if traced else (lambda _name: contextlib.nullcontext())

    def one_call() -> int:
        try:
            with marked(trace.CALL):
                blocks, entries, seconds_ = driver.call()
        except Exception:  # a failing call ends the window; the run reports it
            state["failed"] += driver.batch
            log(traceback.format_exc())
            raise _Stop from None
        state["calls"] += 1
        state["blocks"] += len(blocks)
        state["latencies"].append(seconds_)
        state["ends"].append(time.perf_counter())
        for (seq, index), e in zip(blocks, entries):
            sample.offer(seq, index, e)
        return len(blocks)

    result: dict = {}
    try:
        if not traced:
            t0 = time.perf_counter()
            t_end = t0 + seconds
            while True:
                one_call()
                if time.perf_counter() >= t_end:
                    break
            _sync(devices)
            window_s = time.perf_counter() - t0
        else:
            # calls until the check's sample is full, and one more: the outputs
            # it keeps each hold a host block of the program's, which makes the
            # program allocate a new one (cudaHostAlloc) in the next call, until
            # the first output it drops frees one; no segment should time that
            while sample.seen <= sample.size:
                one_call()
            n = int(mix["trace_calls"])
            driver.ready(n)
            crossed0 = _xfer_bytes()
            plain, plain_blocks = trace.capture(lambda: sum(one_call() for _ in range(n)), False, devices)
            crossed = _xfer_bytes() - crossed0
            driver.ready(n)
            staged, staged_blocks = trace.capture(lambda: sum(one_call() for _ in range(n)), True, devices)
    except _Stop:
        _sync(devices)
    window_peak = _program_peak(driver, devices, sample.held)
    peak = max(setup_peak, window_peak)

    outputs = sample.outputs(log)
    withheld = driver.withheld
    limits = dict(check.LIMITS)
    if withheld is not None:
        # a sampled block (else the last handed over), its hand-over prepared again
        t_probe = time.perf_counter()
        altered = driver.altered_roots(outputs[0][0] if outputs else driver.seq, seed)
        probe_s = time.perf_counter() - t_probe
        limits.update(check.HANDOVER_LIMITS)
    driver = None
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    totals = check.total(check.compare([(got, pool.rebuild(index, seq)) for seq, index, got in outputs],
                                       devices[0]))
    check_s = time.perf_counter() - t_check
    if withheld is not None:
        totals["altered_roots_accepted"] = altered.count("accepted")
    correct = state["failed"] == 0 and bool(outputs) and check.passed(totals, limits)

    metrics = {}
    dev_info = {"platform": "gpu" if devices[0].type == "cuda" else devices[0].type,
                "kind": torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda" else "cpu",
                "count": len(devices), "memory_peak_bytes": int(peak)}
    counted = {"cell": cell.name, "calls": state["calls"], "blocks": state["blocks"],
               "checked_blocks": [[seq, index] for seq, index, _ in outputs], "check_s": check_s,
               "setup_s": setup_s, "setup_split_s": setup_split, "sample_held_bytes": sample.held}
    if withheld is not None:
        counted.update(checked_quadrants=[withheld.quadrants[seq] for seq, _, _ in outputs],
                       prepare_fill_s=withheld.fill_s, altered_roots=altered, altered_roots_s=probe_s)
    if state["failed"] == 0 and not traced:
        win = Window(cell, k, bool(mix["batched"]), setup_s, window_s, state["blocks"], state["calls"],
                     state["latencies"])
        counted.update(window_s=window_s, heights=0 if win.batched else state["calls"],
                       call_ms_quartiles=[q * 1e3 for q in np.quantile(state["latencies"], [0.25, 0.5, 0.75])],
                       fifths_mib_s=_fifths(state["ends"], t0, window_s, int(mix["batch"]) * k * k * 512))
        for m in cell.end_to_end:
            value = cell.reader(m, "e2e")(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif state["failed"] == 0:
        layer_files = spec_mod.layers(cell.bench_dir)
        trace.place(staged.ops, layer_files)
        ctx = Layers(cell, k, int(config["field_bits"]), len(devices), plain, plain_blocks, staged,
                     staged_blocks, trace.layer_seconds(staged), crossed, window_peak)
        for m in cell.per_layer:
            value = cell.reader(m, "metrics")(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = plain.busy_s()
        dev_info["busy_s"] = sum(busy.get(i, 0.0) for i in range(len(devices))) / len(devices) / 1e6
        dev_info["window_s"] = plain.window_s
        total = sum(ctx.layer_s.values())
        unplaced = ctx.layer_s.get(None, 0.0) / total if total else 0.0
        result["breakdown"] = {"device_ops": trace.device_ops(staged), "idle_gaps": trace.idle_gaps(plain),
                               "unplaced_share": unplaced}
        counted.update(plain_blocks=plain_blocks, staged_blocks=staged_blocks, unplaced_share=unplaced,
                       calls_before_segments=state["calls"] - 2 * int(mix["trace_calls"]),
                       kept_copy_s=plain.kept_s + staged.kept_s, trace_parse_s=plain.parse_s + staged.parse_s,
                       prepared_device_s=plain.prepared_s + staged.prepared_s,
                       prepared_host_s=[spans.total(seg.excluded) / 1e6 for seg in (plain, staged)])
    result = {"correct": correct, "attempted": state["blocks"] + state["failed"], "failed": state["failed"],
              "metrics": metrics, "device": dev_info, **result,
              "checks": {name: {"value": totals[name], "limit": limit} for name, limit in limits.items()}}
    result["_counted"] = counted
    return result


def _fifths(ends: list[float], t0: float, window_s: float, call_bytes: int) -> list[float]:
    """MiB/s of calls completed in each fifth of the window: drift within a
    run, against spread between runs."""
    edges = [t0 + window_s * i / 5 for i in range(6)]
    return [sum(a <= t < b for t in ends) * call_bytes / (b - a) / 2**20 for a, b in zip(edges, edges[1:])]


class _Stop(Exception):
    """A call failed: the window ends there."""
