"""The withheld-square hand-over (inputs/withheld.py) and the repair cell
on the CPU at k = 8, for each of the four quadrants: what is handed
over, the program's repair through the driver, the plain reference
decoder against the program's, the ``repair_mib_s`` reader, and the
comparison that decides ``correct`` failing the control and each fault."""

from __future__ import annotations

import json
import time
import types

import numpy as np
import pytest
import torch

from benchmark import control, harness, spec
from benchmark.inputs import pool as pool_mod
from benchmark.inputs import withheld
from benchmark.reference import decode
from benchmark.reference import eds as ref_eds
from benchmark.reference import leopard, nmt, sha256
from benchmark.tests.tiny import BENCH, TINY_MEMPOOL

QUADRANTS = range(4)


def _tiny_pool(seed: int = 2**35 + 3) -> pool_mod.Pool:
    cfg = json.loads((BENCH / "configs" / "celestia-v3-k128.json").read_text())
    cfg.update(square_size=8, max_square_size=8, mempool=TINY_MEMPOOL)
    return pool_mod.make(cfg, 1, seed)


def _span(q: int, k: int) -> tuple[slice, slice]:
    r, c = divmod(q, 2)
    return slice(r * k, (r + 1) * k), slice(c * k, (c + 1) * k)


@pytest.fixture
def fills_of(monkeypatch):
    def set_(blocks: int) -> None:
        monkeypatch.setattr(withheld, "BLOCKS_PER_FILL", blocks)

    return set_


@pytest.mark.parametrize("q", QUADRANTS)
def test_the_hand_over_holds_the_present_quadrant_and_zeros(q, fills_of):
    """The warm blocks take the quadrants in turn, so block q + 1 has
    quadrant q and follows a block with another one."""
    fills_of(4)
    pool = _tiny_pool()
    w = withheld.Withheld(pool, seed=5, device="cpu", warm_calls=4)
    for seq in range(1, q + 2):
        (symbols, present, rows, cols), entry = w.hand_over(seq, 0)
    k = pool.squares.shape[1]
    want = ref_eds.commit(torch.from_numpy(pool.rebuild(0, q + 1))[None])
    eds = want.eds[0].numpy()
    mask = np.zeros((2 * k, 2 * k), dtype=bool)
    mask[_span(q, k)] = True
    assert w.quadrants[q + 1] == q and np.array_equal(present, mask)
    assert np.array_equal(symbols[mask], eds[mask]) and not symbols[~mask].any()
    assert not symbols.flags.writeable and not present.flags.writeable
    with pytest.raises(ValueError):
        symbols[0, 0, 0] = 1
    assert rows == tuple(r.tobytes() for r in want.row_roots[0].numpy())
    assert cols == tuple(r.tobytes() for r in want.col_roots[0].numpy())
    assert entry.data_root == want.data_root[0].numpy().tobytes()


def test_window_blocks_draw_their_quadrant_from_the_seed(fills_of):
    pool = _tiny_pool()
    draws = []
    for blocks in (8, 5):
        fills_of(blocks)
        w = withheld.Withheld(pool, seed=2**40 + 1, device="cpu", warm_calls=2)
        w.fill(40)
        draws.append([w.quadrants[s] for s in range(1, 41)])
    assert draws[0] == draws[1] and draws[0][:2] == [0, 1] and set(draws[0][2:]) == set(QUADRANTS)
    w = withheld.Withheld(pool, seed=2**40 + 2, device="cpu", warm_calls=2)
    w.fill(40)
    assert [w.quadrants[s] for s in range(1, 41)] != draws[0]


@pytest.mark.parametrize("bits", [8, 16])
def test_the_stamp_columns_give_each_blocks_full_commitment(bits, fills_of, monkeypatch):
    """The preparation extends only the stamp's byte columns and rehashes
    only what they change; the full reference commitment of each block, in
    both fields, over two pool squares and fills that split them, is the
    oracle. A hand-over prepared again is the same."""
    monkeypatch.setattr(leopard, "protocol_field", lambda k: bits)
    fills_of(3)
    cfg = json.loads((BENCH / "configs" / "celestia-v3-k128.json").read_text())
    cfg.update(square_size=8, max_square_size=8, mempool=TINY_MEMPOOL)
    pool = pool_mod.make(cfg, 2, 2**33 + 7)
    w = withheld.Withheld(pool, seed=9, device="cpu", warm_calls=0)
    w.fill(7)
    got = list(w.queue)
    want = ref_eds.commit(torch.from_numpy(np.stack([pool.rebuild((p.seq - 1) % 2, p.seq) for p in got])),
                          bits=bits)
    assert [p.seq for p in got] == list(range(1, 8))
    for i, p in enumerate(got):
        assert np.array_equal(p.stamped, want.eds[i][..., withheld.STAMP].numpy())
        assert p.row_roots == tuple(r.tobytes() for r in want.row_roots[i].numpy())
        assert p.col_roots == tuple(r.tobytes() for r in want.col_roots[i].numpy())
        assert p.data_root == want.data_root[i].numpy().tobytes()
    for index in (0, 1):
        assert np.array_equal(w.pristine[index].eds.numpy(), ref_eds.commit(
            torch.from_numpy(pool.pristine[index])[None], bits=bits).eds[0].numpy())
    (symbols, present, rows, cols), entry = w.hand_over_again(5)
    eds = want.eds[4].numpy()
    assert np.array_equal(symbols[present], eds[present]) and not symbols[~present].any()
    assert rows == got[4].row_roots and cols == got[4].col_roots and entry.data_root == got[4].data_root


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("q", QUADRANTS)
def test_the_reference_decoder_agrees_with_the_programs_repair(q, bits):
    from celestia_app_tpu_torch.da import repair

    k = 8
    ods = torch.from_numpy(np.random.default_rng(10 * q + bits).integers(0, 256, (k, k, 512), dtype=np.uint8))
    eds = ref_eds.commit(ods[None], bits=bits)
    present = torch.zeros((2 * k, 2 * k), dtype=torch.bool)
    present[_span(q, k)] = True
    symbols = torch.where(present[..., None], eds.eds[0], torch.zeros_like(eds.eds[0]))
    rows = [r.tobytes() for r in eds.row_roots[0].numpy()]
    cols = [r.tobytes() for r in eds.col_roots[0].numpy()]
    theirs = repair.repair_eds(symbols.numpy(), present.numpy(), rows, cols, device="cpu", field=bits)
    ours = decode.repair(symbols, present, bits=bits)
    assert np.array_equal(ours.numpy(), theirs) and torch.equal(ours, eds.eds[0])


def test_the_reference_decoder_sweeps_a_scattered_pattern():
    """Half of the columns withheld in the top rows, half of the rows in the
    rest: rows then columns, over more than one sweep."""
    k = 4
    eds = leopard.extend_square(torch.from_numpy(np.random.default_rng(3).integers(0, 256, (k, k, 512),
                                                                                   dtype=np.uint8)))
    present = torch.ones((2 * k, 2 * k), dtype=torch.bool)
    present[:k, 1::2] = False
    present[k + 1:, :] = False
    got = decode.repair(torch.where(present[..., None], eds, torch.zeros_like(eds)), present)
    assert torch.equal(got, eds)
    present[:, :k + 1] = False
    present[:k + 1, :] = False
    with pytest.raises(ValueError):
        decode.repair(eds, present)


def test_repair_mib_s_is_the_blocks_over_the_calls_seconds():
    read = spec.load_reader(BENCH / "e2e" / "repair_mib_s.py")
    win = types.SimpleNamespace(k=128, blocks=4, window_s=100.0, latencies_s=[0.05, 0.06, 0.04, 0.05])
    assert read(win) == pytest.approx(4 * 8 / 0.2)  # 8 MiB a block, 0.2 s of calls
    assert read(types.SimpleNamespace(k=128, blocks=0, window_s=1.0, latencies_s=[])) is None


def _run(cell, entry=None, seconds=0.2, seed=2**35 + 11):
    return harness.run(cell, seed, seconds, False, "cpu", time.perf_counter(), entry=entry)


@pytest.fixture
def repair_cell(tiny_cell, monkeypatch):
    """The tiny repair cell with every block's quadrant forced, its
    hand-overs prepared two to a reference call."""

    def load(q: int, **traffic):
        monkeypatch.setattr(withheld.Withheld, "_quadrant", lambda self, seq: q)
        monkeypatch.setattr(withheld, "BLOCKS_PER_FILL", 2)
        return tiny_cell("tiny.repair", **traffic)

    return load


@pytest.mark.parametrize("q", QUADRANTS)
def test_the_programs_repair_through_the_driver_is_correct(repair_cell, q):
    r = _run(repair_cell(q))
    counted = r["_counted"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert counted["checked_quadrants"] == [q] * len(counted["checked_blocks"])
    assert counted["altered_roots"] == ["BadEncodingError"] * 4
    assert r["checks"]["altered_roots_accepted"] == {"value": 0, "limit": 0}
    assert "repair_mib_s" in r["metrics"] and r["metrics"]["repair_mib_s"]["value"] > 0
    split = counted["setup_split_s"]
    assert sum(split.values()) == pytest.approx(counted["setup_s"]) and min(split.values()) >= 0


def _repair():
    from celestia_app_tpu_torch.da import repair

    return repair.repair_eds


def _unrepaired(symbols, present, row_roots, col_roots, device=None):
    return np.array(symbols)


def _stale():
    first = {}

    def entry(*args, device=None):
        return first.setdefault("square", _repair()(*args, device=device))

    return entry


def _flipped(q: int):
    def entry(*args, device=None):
        out = _repair()(*args, device=device)
        k = out.shape[0] // 2
        withheld_q = (q + 1) % 4
        r, c = divmod(withheld_q, 2)
        out[r * k + 1, c * k + 2, 100] ^= 1
        return out

    return entry


@pytest.mark.parametrize("q", QUADRANTS)
@pytest.mark.parametrize("fault", ["control", "unrepaired", "stale", "flipped"])
def test_the_control_and_each_fault_are_not_correct(repair_cell, q, fault):
    entry = {"control": control.control_repair_entry(), "unrepaired": _unrepaired, "stale": _stale(),
             "flipped": _flipped(q)}[fault]
    r = _run(repair_cell(q, check_blocks=1024), entry=entry)
    assert not r["correct"] and r["checks"]["eds_shares_differ"]["value"] > 0
    if fault == "flipped":
        assert r["checks"]["eds_shares_differ"]["value"] == len(r["_counted"]["checked_blocks"])


def _unverified(symbols, present, row_roots, col_roots, device=None):
    """The plain decoder over the consensus code: the right square from an
    honest hand-over, and no root checked."""
    return decode.repair(torch.from_numpy(np.array(symbols)), torch.from_numpy(np.array(present))).numpy()


def _rows_verified(symbols, present, row_roots, col_roots, device=None):
    """`_unverified`, then the row roots checked and the column roots not."""
    out = _unverified(symbols, present, row_roots, col_roots)
    rows, _ = nmt.axis_roots(torch.from_numpy(out)[None], sha256.digest_hashlib)
    if tuple(r.tobytes() for r in rows[0].numpy()) != tuple(row_roots):
        raise ValueError("a row root does not match")
    return out


@pytest.mark.parametrize("q", QUADRANTS)
@pytest.mark.parametrize("fault, accepted", [(_unverified, 4), (_rows_verified, 2)])
def test_a_repair_that_skips_root_verification_is_not_correct(repair_cell, q, fault, accepted):
    """Its squares are right, so only the calls with an altered root can
    tell: each of those it answers is counted against the limit 0."""
    r = _run(repair_cell(q), entry=fault)
    assert r["checks"]["eds_shares_differ"]["value"] == 0 and r["checks"]["axis_roots_differ"]["value"] == 0
    assert r["checks"]["altered_roots_accepted"]["value"] == accepted and not r["correct"]
