"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, ``traffic/<name>.json`` under
the benchmark's directory. A metric is read by ``e2e/<name>.py`` (an
end-to-end metric) or ``metrics/<name>.py`` (a per-layer one), each with
a ``read(ctx)`` that returns a number, or None where it finds nothing to
read. Device time is placed on layers by ``layers/<name>.json``. Adding a
cell, a mix, a metric or a layer adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable

BENCH_DIR = Path(__file__).resolve().parent
SPEC_FILE = BENCH_DIR.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the spec's metric entries this cell reports
    per_layer: list[dict]
    bench_dir: Path

    def reader(self, metric: dict, kind: str) -> Callable:
        return load_reader(self.bench_dir / kind / f"{metric['name']}.py")


def load_reader(path: Path) -> Callable:
    module_spec = importlib.util.spec_from_file_location(f"benchmark_reader_{path.stem}", path)
    if module_spec is None or module_spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell_name: str, spec_file: Path = SPEC_FILE, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `cell_name` of `spec_file`, its files read from
    `bench_dir` (configuration files relative to the spec's directory)."""
    spec = json.loads(Path(spec_file).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in {spec_file}; have {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((Path(spec_file).parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((Path(bench_dir) / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=cell_name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, cell_name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, cell_name)],
        bench_dir=Path(bench_dir),
    )


def layers(bench_dir: Path = BENCH_DIR) -> dict[str, dict]:
    """Every layer file, by name, in name order."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((Path(bench_dir) / "layers").glob("*.json"))}
