"""Fixtures of the benchmark's own tests: ``python3 -m pytest benchmark/tests``
from the repository root (CPU; the ``card`` tests skip without a card)."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from benchmark.tests.tiny import make_bench_dir


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def bench_dir(tmp_path) -> Path:
    return make_bench_dir(tmp_path)


@pytest.fixture
def tiny_cell(bench_dir):
    from benchmark import spec

    def load(name: str, **traffic):
        cell = spec.load(name, bench_dir / "BENCHMARK.json", bench_dir)
        cell.traffic.update(traffic)
        return cell

    return load
