"""The comparison that decides ``correct``, shown to fail: the control in
the program's place, and the timed path broken underneath in each way a
cell can break, with the rest of a run driven as the benchmark drives it
(on the CPU, at k = 8, past the harness's look for a card)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, harness


def _run(cell, entry=None, seconds=0.3, seed=2**35 + 11):
    return harness.run(cell, seed, seconds, False, "cpu", time.perf_counter(), entry=entry)


@pytest.mark.parametrize("name", ["tiny.catchup", "tiny.height"])
def test_a_sound_run_is_correct(tiny_cell, name):
    r = _run(tiny_cell(name))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("name", ["tiny.catchup", "tiny.height"])
def test_the_control_is_not_correct(tiny_cell, name):
    cell = tiny_cell(name)
    r = _run(cell, entry=control.control_entry(bool(cell.traffic["batched"])))
    assert not r["correct"]
    checks = r["checks"]
    assert checks["eds_shares_differ"]["value"] > 0 and checks["axis_roots_differ"]["value"] > 0
    assert checks["data_roots_differ"]["value"] > 0


def test_a_step_that_returns_its_state_unchanged(tiny_cell, monkeypatch):
    from celestia_app_tpu_torch.da import edscache

    first, real = {}, edscache.compute_entry

    def stale(ods, device=None, **kw):
        return first.setdefault("entry", real(ods, device, **kw))

    monkeypatch.setattr(edscache, "compute_entry", stale)
    r = _run(tiny_cell("tiny.height"))
    assert not r["correct"] and r["checks"]["data_roots_differ"]["value"] > 0


def test_half_of_the_batch_left_out(tiny_cell, monkeypatch):
    from celestia_app_tpu_torch.parallel import mesh_engine

    real = mesh_engine.compute_entries_batched

    def half(batch, device=None, **kw):
        done = real(batch[: len(batch) // 2], device, **kw)
        return done + done  # the second half answered by the first

    monkeypatch.setattr(mesh_engine, "compute_entries_batched", half)
    r = _run(tiny_cell("tiny.catchup", check_blocks=1024))
    assert not r["correct"] and r["checks"]["data_roots_differ"]["value"] > 0


def test_the_exchange_between_cards_left_out(tiny_cell, monkeypatch):
    """The height cell through the sharded pipeline over four devices (CPU
    stand-ins for the four cards): sound, then with the transposes left out."""
    from celestia_app_tpu_torch.da import edscache
    from celestia_app_tpu_torch.parallel import mesh as mesh_mod
    from celestia_app_tpu_torch.parallel import sharded_eds

    mesh = mesh_mod.make_mesh(devices=[torch.device("cpu")] * 4)
    real = edscache.compute_entry
    monkeypatch.setattr(edscache, "compute_entry", lambda ods, device=None: real(ods, device, mesh=mesh))
    sound = _run(tiny_cell("tiny.height"))
    assert sound["correct"]
    monkeypatch.setattr(sharded_eds, "transpose", lambda srcs, dsts, exchange=None: None)
    r = _run(tiny_cell("tiny.height"))
    assert not r["correct"] and r["checks"]["eds_shares_differ"]["value"] > 0


@pytest.mark.parametrize("name", ["tiny.catchup", "tiny.height"])
def test_an_answer_altered_where_it_is_produced(tiny_cell, monkeypatch, name):
    """One byte of one parity share flipped as the extension writes it."""
    from celestia_app_tpu_torch.ops import rs

    real = rs.extend_square_fn

    def flipped(*args, **kw):
        extend = real(*args, **kw)

        def run(ods):
            eds = extend(ods)
            eds[..., -1, -1, 100] ^= 1
            return eds

        return run

    monkeypatch.setattr(rs, "extend_square_fn", flipped)
    r = _run(tiny_cell(name))
    assert not r["correct"] and r["checks"]["eds_shares_differ"]["value"] > 0
