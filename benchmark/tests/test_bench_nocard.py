"""Without the cards a cell asks for, the command prints no result and
exits with a failing code; it never falls back to the CPU. In a directory
that holds only BENCHMARK.json and the benchmark's files it prints no
result either."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.tiny import BENCH, REPO


def _run(cwd, cell: str):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", str(2**33 + 3),
                           "--seconds", "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


@pytest.mark.parametrize("cell", ["v3-k128.catchup-b8", "bigblock-k512.height-4chip", "v3-k128.repair-quadrant"])
def test_no_card_no_result(cell):
    p = _run(REPO, cell)
    assert p.returncode == 2 and _no_result(p.stdout), p.stderr
    assert "no result" in p.stderr


def test_only_the_benchmarks_files_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _run(tmp_path, "v3-k128.catchup-b8")
    assert p.returncode != 0 and _no_result(p.stdout)


@pytest.mark.parametrize("visible, chips, pinned", [
    (None, 1, "0"), (None, 4, "0,1,2,3"), ("3,5,6,7,0", 4, "3,5,6,7"), ("2,3", 1, "2"), ("", 1, ""),
])
def test_the_run_sees_the_cells_cards_and_no_others(visible, chips, pinned):
    from benchmark.run import pin_cards

    environ = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    pin_cards(chips, environ)
    assert environ["CUDA_VISIBLE_DEVICES"] == pinned


@pytest.mark.parametrize("cell, count", [("bigblock-k512.height", 8), ("bigblock-k512.height", 0),
                                         ("bigblock-k512.height-4chip", 3), ("bigblock-k512.height-4chip", 8)])
def test_more_or_fewer_cards_than_the_cell_no_result(cell, count, monkeypatch, capsys):
    """Cards the pinning did not hide (here, counts patched in) give no
    result: a one-card cell never runs the sharded path unasked."""
    import torch

    from benchmark import harness, run, spec

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3,4,5,6,7")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(harness, "run", lambda *a, **kw: pytest.fail("a run on the wrong number of cards"))
    assert run.main(["--workload", cell, "--seed", "5", "--seconds", "1"]) == 2
    assert _no_result(capsys.readouterr().out)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ",".join(map(str, range(spec.load(cell).chips)))
