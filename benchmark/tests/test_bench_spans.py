"""The readers of the port's own ranges (``metrics/host.launch_ms_per_block``,
``host.launches_per_block``, ``host.assemble_ms_per_block`` and
``device.idle_launch_ms_per_block``) on a hand-built segment whose ranges,
launches and busy spans are known, and on a profiled call of the program
on the CPU."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from benchmark import spans, spec, trace
from benchmark.tests.tiny import BENCH

READERS = ("host.launch_ms_per_block", "host.launches_per_block", "host.assemble_ms_per_block",
           "device.idle_launch_ms_per_block")

# (name, start, end) on the launching thread (1) and on another (2), in us
LAUNCHING = [("edscache.compute_entry", 50, 900), ("eds.extend", 100, 300),
             ("xfer.h2d:eds.pipeline", 150, 200), ("eds.trees", 400, 600), ("sharded.gather[0,1]", 500, 650),
             ("xfer.d2h:edscache.compute_entry", 700, 780), ("entry.assemble", 800, 880),
             ("eds.data_root", 990, 1100),  # clipped to the window's end
             ("cudaLaunchKernel", 120, 125), ("cudaMemcpyAsync", 130, 135),
             ("cudaLaunchKernelExC", 420, 425), ("cuLaunchKernelEx", 421, 424),  # one launch, seen twice
             ("cuLaunchKernel", 610, 612),  # a driver launch alone
             ("cudaLaunchKernel", 950, 955)]  # outside every entry range
OTHER = [("eds.leaves", 300, 400), ("entry.assemble", 10, 30), ("cudaLaunchKernel", 60, 61)]
BUSY = [(0, 100, 150), (0, 420, 180), (1, 0, 300)]  # (card, start, duration)


def segment(host: dict) -> trace.Segment:
    ops = [trace.Op(card, start, dur, "kernel", None) for card, start, dur in BUSY]
    host_ops = {tid: sorted((a, b, name) for name, a, b in evs) for tid, evs in host.items()}
    return trace.Segment((0.0, 1000.0), ops, host_ops, launch_tid=1)


def read(name: str, seg: trace.Segment, chips: int = 2, blocks: int = 2):
    ctx = types.SimpleNamespace(plain=seg, plain_blocks=blocks, chips=chips)
    return spec.load_reader(BENCH / "metrics" / f"{name}.py")(ctx)


def test_launch_time_is_the_stages_less_their_crossings():
    # stages [100,300] [400,650] [990,1000] less crossings [150,200]: 50 + 100 + 250 + 10 us
    assert read("host.launch_ms_per_block", segment({1: LAUNCHING, 2: OTHER})) == pytest.approx(0.410 / 2)


def test_launches_in_entries_count_a_runtime_and_driver_pair_once():
    assert read("host.launches_per_block", segment({1: LAUNCHING, 2: OTHER})) == 3 / 2


def test_assembly_is_summed_over_threads():
    assert read("host.assemble_ms_per_block", segment({1: LAUNCHING, 2: OTHER})) == pytest.approx(0.100 / 2)


@pytest.mark.parametrize("chips, idle_us", [(1, 130), (2, 130 + 260)])
def test_idle_under_launch_is_summed_over_the_cards(chips, idle_us):
    # card 0 idle [0,100] [250,420] [600,1000] meets the launch time in
    # [250,300] [400,420] [600,650] [990,1000]; card 1 idle [300,1000] in [400,650] [990,1000]
    got = read("device.idle_launch_ms_per_block", segment({1: LAUNCHING, 2: OTHER}), chips=chips)
    assert got == pytest.approx(idle_us / 1e3 / 2)


@pytest.mark.parametrize("name", READERS)
def test_no_range_reads_nothing(name):
    bare = [ev for ev in LAUNCHING if ev[0].startswith("cu")] + [("aten::copy_", 130, 140)]
    assert read(name, segment({1: bare})) is None


def test_interval_arithmetic():
    a = spans.union([(5, 8), (0, 2), (1, 3), (8, 9)])
    assert a == [(0, 3), (5, 9)]
    assert spans.minus(a, [(1, 2), (4, 6), (8, 20)]) == [(0, 1), (2, 3), (6, 8)]
    assert spans.overlap(a, [(2, 6), (7, 7.5)]) == [(2, 3), (5, 6), (7, 7.5)]
    assert spans.clip(a, (1, 6)) == [(1, 3), (5, 6)] and spans.total(a) == 7
    assert spans.covers(a, 9) and not spans.covers(a, 4)


def test_a_profiled_call_of_the_program_reaches_the_readers():
    """On the CPU the program's stages, crossings and assembly reach the
    readers through the trace's parser; there is no kernel launch and no
    card, so the thread is the one that holds the entry's range."""
    from celestia_app_tpu_torch.parallel import mesh_engine

    ods = np.zeros((2, 4, 4, 512), dtype=np.uint8)
    ods[..., 19:] = np.random.default_rng(7).integers(0, 256, size=(2, 4, 4, 512 - 19), dtype=np.uint8)
    cpu = torch.device("cpu")
    seg, blocks = trace.capture(lambda: len(mesh_engine.compute_entries_batched(ods, cpu)), False, [cpu])
    assert blocks == 2 and seg.launch_tid is None
    seg.launch_tid = next(tid for tid, evs in seg.host_ops.items()
                          if any(name == "mesh.compute_entries_batched" for *_, name in evs))
    got = {name: read(name, seg, chips=1) for name in READERS}
    assert got["host.launch_ms_per_block"] > 0 and got["host.assemble_ms_per_block"] > 0
    assert got["host.launches_per_block"] == 0 and got["device.idle_launch_ms_per_block"] is None
