"""On the card (skipped without one): a short run of each k = 128 cell is
correct, and the control in the program's place is not. Run on a machine
with a card: ``python3 -m pytest benchmark/tests -m card``."""

from __future__ import annotations

import time

import pytest

from benchmark import control, harness, spec

pytestmark = pytest.mark.card


def test_the_catchup_cell_is_correct_on_the_card(card):
    r = harness.run(spec.load("v3-k128.catchup-b8"), 2**32 + 17, 2.0, False, "cuda", time.perf_counter())
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["metrics"]["throughput_mib_s"]["value"] > 0


def test_the_control_is_not_correct_on_the_card(card):
    cell = spec.load("v3-k128.catchup-b8")
    r = harness.run(cell, 2**32 + 18, 0.5, False, "cuda", time.perf_counter(), entry=control.control_entry(True))
    assert not r["correct"] and r["checks"]["eds_shares_differ"]["value"] > 0


def test_the_repair_cell_is_correct_on_the_card(card):
    r = harness.run(spec.load("v3-k128.repair-quadrant"), 2**32 + 19, 2.0, False, "cuda", time.perf_counter())
    assert r["correct"] and r["metrics"]["repair_mib_s"]["value"] > 0 and "throughput_mib_s" not in r["metrics"]
    assert 0 < r["device"]["memory_peak_bytes"]


def test_the_repair_control_is_not_correct_on_the_card(card):
    cell = spec.load("v3-k128.repair-quadrant")
    r = harness.run(cell, 2**32 + 20, 0.5, False, "cuda", time.perf_counter(), entry=control.control_repair_entry())
    assert not r["correct"] and r["checks"]["eds_shares_differ"]["value"] > 0
