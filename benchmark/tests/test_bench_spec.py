"""BENCHMARK.json against the benchmark's contract, a cell, a mix and
metrics added as new files only, and the placement of device time on
layers."""

from __future__ import annotations

import json
import re
import time

import pytest

from benchmark import harness, spans, spec, trace
from benchmark.tests.tiny import BENCH, REPO, make_bench_dir

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text: str) -> bool:
    """1 to 200 characters on one line, with no tab."""
    return 1 <= len(text) <= 200 and not any(ch in text for ch in "\n\r\t")


def test_the_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("benchmark/")
        assert all(_line(c[k]) for k in ("source", "why")) and all(NAME.match(r) for r in c["reduced"])
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    cells = {w["name"]: w for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in names and _line(w["why"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and (BENCH / "metrics" / f"{m['name']}.py").exists() and _line(m["layer"])
        # every cell that reads the metric reports the end-to-end metric it moves
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]].get("workloads", cells))
        assert "roofline" not in m["name"] or (m["name"].endswith("_roofline") and m["unit"] == "%")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and (BENCH / "e2e" / f"{m['name']}.py").exists()
    for name in names + list(cells):
        assert NAME.match(name)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_with_its_readers(name):
    cell = spec.load(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    # a withheld-square cell reports the repair's own rate, every other cell the window's
    repairs = cell.traffic.get("handover") == "withheld-quadrant"
    assert ("repair_mib_s" in e2e) == repairs and ("throughput_mib_s" in e2e) == (not repairs)
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    for m in cell.end_to_end:
        assert callable(cell.reader(m, "e2e"))
    for m in cell.per_layer:
        assert callable(cell.reader(m, "metrics"))


def test_a_cell_a_mix_and_metrics_added_as_files_only(tmp_path):
    """A new mix (a third pool square, one warm call), a new end-to-end and
    a new per-layer metric, and a new cell naming them: files and entries
    added, none edited, and the harness runs the cell."""
    mix = json.loads((BENCH / "traffic" / "height-serial.json").read_text())
    mix.update(name="height-serial-p3", pool=3, warm_calls=1)
    root = make_bench_dir(tmp_path, extra_traffic={"height-serial-p3": mix})
    (root / "e2e" / "blocks_per_s.py").write_text("def read(win):\n    return win.blocks / win.window_s\n")
    (root / "metrics" / "dummy.blocks.py").write_text("def read(ctx):\n    return ctx.staged_blocks\n")
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["workloads"].append({"name": "tiny.height-p3", "config": "tiny-k8", "traffic": "height-serial-p3",
                           "chips": 1, "why": "test"})
    s["end_to_end"].append({"name": "blocks_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["tiny.height-p3"]})
    s["per_layer"].append({"name": "dummy.blocks", "unit": "1", "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "blocks_per_s", "workloads": ["tiny.height-p3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))

    cell = spec.load("tiny.height-p3", root / "BENCHMARK.json", root)
    assert cell.traffic["pool"] == 3 and "dummy.blocks" in {m["name"] for m in cell.per_layer}
    assert cell.reader({"name": "dummy.blocks"}, "metrics")(type("Ctx", (), {"staged_blocks": 4})) == 4
    r = harness.run(cell, 21, 0.3, False, "cpu", time.perf_counter())
    assert r["correct"] and r["metrics"]["blocks_per_s"]["value"] > 0
    assert {"setup_s", "throughput_mib_s", "height_ms_p90", "blocks_per_s"} == set(r["metrics"])
    other = spec.load("tiny.height", root / "BENCHMARK.json", root)
    assert "blocks_per_s" not in {m["name"] for m in other.end_to_end}


def _trace(events):
    return {"traceEvents": [{"cat": "user_annotation", "name": trace.SEGMENT, "ts": 0, "dur": 1000}, *events]}


def test_device_time_is_placed_on_layers_by_the_launching_frame():
    py = [("celestia_app_tpu_torch/da/eds.py(50): _pipeline", 0, 900),
          ("celestia_app_tpu_torch/ops/rs.py(137): gf16_mix", 10, 100),
          ("celestia_app_tpu_torch/ops/sha256.py(60): sha256", 200, 300),
          ("celestia_app_tpu_torch/ops/sha256_kernel.py(80): compress_words", 250, 50),
          ("celestia_app_tpu_torch/parallel/sharded_eds.py(160): place", 600, 50)]
    launches = [(20, 1), (220, 2), (260, 3), (610, 4), (700, 5)]
    kernels = [(1, "void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x256_128x3_tn_align16>(x)", 30, 40),
               (2, "void at::native::elementwise_kernel<128, 4>(x)", 230, 10),
               (3, "(anonymous namespace)::sha256_compress_kernel(unsigned int const*)", 270, 20),
               (4, "void at::native::elementwise_kernel<128, 4>(y)", 620, 30),
               (5, "Memcpy DtoH (Device -> Pageable)", 705, 100)]
    events = [{"cat": "python_function", "name": n, "ts": ts, "dur": d, "tid": 1} for n, ts, d in py]
    events += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": 1,
                "args": {"correlation": c}} for ts, c in launches]
    events += [{"cat": "user_annotation", "name": trace.CALL, "ts": 0, "dur": 900, "tid": 1},
               {"cat": "cpu_op", "name": "aten::copy_", "ts": 400, "dur": 100, "tid": 1}]
    events += [{"cat": "kernel" if not n.startswith("Memcpy") else "gpu_memcpy", "name": n, "ts": ts, "dur": d,
                "args": {"correlation": c, "device": 0}} for c, n, ts, d in kernels]
    seg = trace.parse(_trace(events), with_frames=True)
    trace.place(seg.ops, spec.layers())
    assert [op.frame for op in seg.ops] == ["ops/rs.py:gf16_mix", "ops/sha256.py:sha256",
                                            "ops/sha256_kernel.py:compress_words",
                                            "parallel/sharded_eds.py:place", "da/eds.py:_pipeline"]
    assert [op.layer for op in seg.ops] == ["rs", "glue", "sha256", "exchange", "copy"]
    assert seg.busy_s() == {0: 40 + 10 + 20 + 30 + 100}
    gaps = trace.idle_gaps(seg)
    assert gaps[:3] == [["cuda:0 aten::copy_ after sha256_compress_kernel", 330e-6],
                        ["cuda:0 benchmark between calls after Memcpy DtoH (Device -> Pageable)", 195e-6],
                        ["cuda:0 host Python in the entry after cutlass_80_tensorop_i16832gemm_s8_128x256_128x3_tn_align16",
                         160e-6]]


def test_the_checks_own_copies_are_left_out_of_the_trace():
    events = [{"cat": "user_annotation", "name": trace.KEEP, "ts": 100, "dur": 20, "tid": 1},
              {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 105, "dur": 2, "tid": 1,
               "args": {"correlation": 6}},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 300, "dur": 2, "tid": 1,
               "args": {"correlation": 7}},
              {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": 110, "dur": 40,
               "args": {"correlation": 6, "device": 0}},
              {"cat": "kernel", "name": "k", "ts": 310, "dur": 50, "args": {"correlation": 7, "device": 0}}]
    for with_frames in (False, True):
        seg = trace.parse(_trace(events), with_frames=with_frames)
        assert [op.name for op in seg.ops] == ["k"] and seg.kept_s == 40e-6 and seg.busy_s() == {0: 50}


def test_an_operation_no_layer_claims_is_unplaced():
    seg = trace.parse(_trace([{"cat": "kernel", "name": "mystery", "ts": 5, "dur": 5,
                               "args": {"correlation": 9, "device": 0}}]), with_frames=True)
    trace.place(seg.ops, spec.layers())
    assert seg.ops[0].layer is None and trace.layer_seconds(seg) == {None: 5e-6}


def test_a_hand_overs_preparation_is_cut_out_of_the_trace():
    """Operations launched inside ``benchmark.prepare`` are left out, and
    its interval is cut out of the window: no busy, idle or layer time."""
    events = [{"cat": "user_annotation", "name": trace.PREPARE, "ts": 100, "dur": 300, "tid": 1},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 2, "tid": 1,
               "args": {"correlation": 6}},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 500, "dur": 2, "tid": 1,
               "args": {"correlation": 7}},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "dur": 2, "tid": 1,
               "args": {"correlation": 8}},
              {"cat": "kernel", "name": "reference", "ts": 120, "dur": 200, "args": {"correlation": 6, "device": 0}},
              {"cat": "kernel", "name": "k", "ts": 510, "dur": 50, "args": {"correlation": 7, "device": 0}},
              # the program's operation runs on into the preparation's interval
              {"cat": "kernel", "name": "j", "ts": 30, "dur": 100, "args": {"correlation": 8, "device": 0}}]
    for with_frames in (False, True):
        seg = trace.parse(_trace(events), with_frames=with_frames)
        assert [op.name for op in seg.ops] == ["k", "j"] and seg.prepared_s == 200e-6
        assert seg.excluded == [(100, 400)] and seg.window_s == 700e-6
        assert seg.busy_spans() == {0: [(30, 100), (510, 560)]} and seg.busy_s() == {0: 120}
        assert [g[1] for g in trace.idle_gaps(seg)] == [440e-6, 110e-6, 30e-6]
        assert trace.layer_seconds(seg) == {None: pytest.approx(150e-6)}


def _merged_by_the_old_loop(intervals):
    """``busy_spans``' merge loop as it stood before it called spans.union."""
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for a, b in intervals[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@pytest.mark.parametrize("intervals", [
    [(10, 50), (40, 80), (70, 90)],  # overlapping
    [(10, 90), (20, 30), (40, 50), (15, 95)],  # nested
    [(10, 20), (20, 30), (30, 40), (50, 60)],  # touching
    [(5, 10), (300, 310), (0, 2), (8, 9), (9, 12), (100, 200), (150, 150), (120, 130)],
])
def test_busy_spans_merge_through_spans_union(intervals):
    ops = [trace.Op(0, a, b - a, "k", None) for a, b in intervals]
    seg = trace.Segment((0.0, 1000.0), ops)
    want = _merged_by_the_old_loop([(a, b) for a, b in intervals if b > a])
    assert seg.busy_spans() == {0: spans.union(intervals)} == {0: want}


def test_an_operation_of_the_repair_module_is_placed_on_the_repair_layer():
    ops = [trace.Op(0, 0, 5, "void at::native::index_elementwise_kernel<128, 4>(x)", "da/repair.py:_put_missing"),
           trace.Op(0, 5, 5, "(anonymous namespace)::rs_extend_kernel(x)", "ops/rs_kernel.py:extend_lines"),
           trace.Op(0, 10, 5, "void at::native::reduce_kernel<512, 1>(x)", "ops/nmt.py:eds_axis_roots"),
           trace.Op(0, 15, 5, "Memcpy DtoH (Device -> Pinned)", "obs/xfer.py:to_host")]
    trace.place(ops, spec.layers())
    assert [op.layer for op in ops] == ["repair", "rs", "glue", "copy"]
