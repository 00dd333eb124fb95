"""Tiny cells: the harness end to end on the CPU at k = 8, with the
program's plain path (``device="cpu"``), from a benchmark directory laid
out in a temporary directory: copies of the real traffic mixes, metrics
and layers, and a configuration cut to k = 8."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

TINY_MEMPOOL = {"txs": 5, "tx_bytes": [150, 400], "namespaces": 4, "blobs_per_pfb": [1, 3],
                "blob_bytes": [100, 4000], "pfb_tx_bytes": [250, 450], "fill": 1.1}


def make_bench_dir(root: Path, extra_traffic: dict | None = None) -> Path:
    """A benchmark directory under `root`: the real traffic, e2e, metrics
    and layers files, a k = 8 configuration, and a BENCHMARK.json whose
    cells ``tiny.catchup``, ``tiny.height`` and ``tiny.repair`` run the
    real mixes on it. A metric of the repair cell is the tiny repair
    cell's; every other metric applies to every tiny cell."""
    for sub in ("traffic", "metrics", "e2e", "layers"):
        shutil.copytree(BENCH / sub, root / sub)
    (root / "configs").mkdir()
    cfg = json.loads((BENCH / "configs" / "celestia-v3-k128.json").read_text())
    cfg.update(name="tiny-k8", square_size=8, max_square_size=8, mempool=TINY_MEMPOOL)
    (root / "configs" / "tiny-k8.json").write_text(json.dumps(cfg))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny-k8", "source": "a k = 8 cut of celestia-v3-k128",
                        "file": "configs/tiny-k8.json", "reduced": ["square_size"], "why": "test"}]
    spec["workloads"] = [
        {"name": "tiny.catchup", "config": "tiny-k8", "traffic": "catchup-b8", "chips": 1, "why": "test"},
        {"name": "tiny.height", "config": "tiny-k8", "traffic": "height-serial", "chips": 1, "why": "test"},
        {"name": "tiny.repair", "config": "tiny-k8", "traffic": "repair-quadrant", "chips": 1, "why": "test"},
    ]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "v3-k128.repair-quadrant" in m.pop("workloads", ()):
            m["workloads"] = ["tiny.repair"]
    for name, mix in (extra_traffic or {}).items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
