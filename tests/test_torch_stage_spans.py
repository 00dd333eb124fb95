"""The port's spans on the device trace's clock, on the CPU.

`obs.stage` ranges and row-writing spans become ``torch.profiler``
``record_function`` ranges while a profiler records, and cost nothing but
a flag read otherwise. Under ``torch.profiler.profile`` (CPU activity) the
encode-and-commit path's ranges appear in the exported trace, nested and
in order: the entry functions (`compute_entry`, `compute_entries_batched`),
the one-device pipeline's four stages, the sharded pipeline's steps per
shard, the transfer ledger's crossings and the entry's assembly. The
outputs are byte-equal with and without the profiler.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from celestia_app_tpu_torch import obs
from celestia_app_tpu_torch.da import edscache
from celestia_app_tpu_torch.obs import spans
from celestia_app_tpu_torch.parallel import mesh as mesh_mod
from celestia_app_tpu_torch.parallel import mesh_engine, sharded_eds
from celestia_app_tpu_torch.utils import telemetry

CPU = torch.device("cpu")
EDS_STAGES = ["eds.extend", "eds.leaves", "eds.trees", "eds.data_root"]


def random_ods(k: int, seed: int, batch: int | None = None) -> np.ndarray:
    shape = (k, k, 512) if batch is None else (batch, k, k, 512)
    ods = np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)
    ods[..., 0] = 0
    ods[..., 1:19] = 0
    return ods


def traced(fn, tmp_path):
    """(fn's result, the exported trace's ranges as (start, end, name) on
    the calling thread, by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation")
    return out, ranges


def named(ranges, name):
    found = [r for r in ranges if r[2] == name]
    assert len(found) == 1, (name, [r[2] for r in ranges])
    return found[0]


def inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def in_order(ranges, names) -> bool:
    got = [named(ranges, n) for n in names]
    return all(a[1] <= b[0] for a, b in zip(got, got[1:]))


def same_entries(a, b) -> None:
    assert a.data_root == b.data_root and a.dah == b.dah
    np.testing.assert_array_equal(a.eds.squares, b.eds.squares)


# -- off: a flag read and the shared no-op ----------------------------------


class Unformattable(str):
    """A site whose name must not be built while no profiler records."""

    def __format__(self, spec):
        raise AssertionError("a stage's name was built with no profiler recording")


@pytest.mark.parametrize("index,kw", [((), {}), ((0, 3), {}),
                                      ((), {"site": Unformattable("eds.pipeline")})])
def test_a_stage_with_no_profiler_is_the_noop(index, kw):
    assert spans.stage("eds.extend", *index, **kw) is spans.NOOP
    assert obs.stage("sharded.row_pass", *index, **kw) is spans.NOOP


def test_no_range_is_entered_with_no_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tt = telemetry.TraceTables()
    with obs.span("da.extend_shares", traces=tt, k=4):
        with obs.stage("eds.extend"), obs.stage("sharded.gather", 0, 1):
            pass
    (row,) = tt.read("spans")
    assert row["name"] == "da.extend_shares" and row["k"] == 4
    # the whole encode-and-commit path, both entries, opens no range either
    entry = edscache.compute_entry(random_ods(4, 1), CPU)
    assert len(entry.dah.row_roots) == 8
    assert len(mesh_engine.compute_entries_batched(random_ods(4, 2, batch=2), CPU)) == 2


def test_recording_off_keeps_stages_off_under_a_profiler():
    obs.set_enabled(False)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert obs.stage("eds.trees") is spans.NOOP
    finally:
        obs.set_enabled(None)


# -- on: ranges on the trace's clock ----------------------------------------


def test_a_row_writing_span_is_a_range_of_its_name(tmp_path):
    tt = telemetry.TraceTables()

    def run():
        with obs.span("storage.save_commit", traces=tt, height=3):
            with obs.stage("eds.leaves"):
                pass

    _, ranges = traced(run, tmp_path)
    assert inside(named(ranges, "eds.leaves"), named(ranges, "storage.save_commit"))
    (row,) = tt.read("spans")
    assert row["name"] == "storage.save_commit" and row["height"] == 3


def test_batched_entries_carry_their_ranges_in_order(tmp_path):
    ods = random_ods(4, 3, batch=2)
    entries, ranges = traced(lambda: mesh_engine.compute_entries_batched(ods, CPU), tmp_path)
    whole = named(ranges, "mesh.compute_entries_batched")
    order = ["xfer.h2d:mesh.batched_dispatch", *EDS_STAGES, "xfer.d2h:mesh.batched_commitments",
             "entry.assemble"]
    assert all(inside(named(ranges, n), whole) for n in order)
    assert in_order(ranges, order)
    plain = mesh_engine.compute_entries_batched(ods, CPU)
    for a, b in zip(entries, plain, strict=True):
        same_entries(a, b)


def test_compute_entry_carries_its_ranges_in_order(tmp_path):
    ods = random_ods(4, 4)
    entry, ranges = traced(lambda: edscache.compute_entry(ods, CPU), tmp_path)
    whole = named(ranges, "edscache.compute_entry")
    order = ["xfer.h2d:eds.pipeline", *EDS_STAGES, "xfer.d2h:edscache.compute_entry", "entry.assemble"]
    assert all(inside(named(ranges, n), whole) for n in order)
    assert in_order(ranges, order)
    same_entries(entry, edscache.compute_entry(ods, CPU))


def test_a_mesh_entry_names_each_shards_steps(tmp_path):
    """compute_entry through a (1, 4) mesh: the entry ranges nest, and the
    sharded pipeline's steps come per shard, in order."""
    mesh = mesh_mod.make_mesh(devices=[CPU] * 4)  # (data, seq) = (1, 4)
    ods = random_ods(4, 5)
    entry, ranges = traced(lambda: edscache.compute_entry(ods, CPU, mesh=mesh), tmp_path)
    outer, inner = named(ranges, "edscache.compute_entry"), named(ranges, "mesh.compute_entry_mesh")
    assert inside(inner, outer)
    per_shard = {step: [f"sharded.{step}[0,{s}]" for s in range(4)]
                 for step in ("row_pass", "column_pass", "row_roots", "gather")}
    order = ["sharded.input", *per_shard["row_pass"], "sharded.transpose1", *per_shard["column_pass"],
             "sharded.transpose2", *(n for pair in zip(per_shard["row_roots"], per_shard["gather"]) for n in pair),
             "sharded.data_root", "xfer.d2h:mesh.entry_commitments", "entry.assemble"]
    assert all(inside(named(ranges, n), inner) for n in order) and in_order(ranges, order)
    uploads = [r for r in ranges if r[2] == "xfer.h2d:mesh.sharded_dispatch"]
    assert len(uploads) == 4 and all(inside(r, named(ranges, "sharded.input")) for r in uploads)
    same_entries(entry, edscache.compute_entry(ods, CPU, mesh=mesh))
