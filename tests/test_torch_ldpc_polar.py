"""The port's LDGM and polar codes (ops/ldpc.py, ops/polar.py) against the
JAX package (tolerance: exact bytes): the construction tables and the
pruned polar geometry, encode, the peel (bytes, known and sweeps, on random
erasures and with one flipped symbol, against the reference's host engine
and its jitted engine on jax-cpu) and the equation audit, at n_data <= 4096."""

import numpy as np
import pytest
import torch

from celestia_app_tpu.ops import ldpc as jax_ldpc
from celestia_app_tpu.ops import polar as jax_polar
from celestia_app_tpu_torch.ops import ldpc, polar

N_DATA = (1, 2, 16, 100, 256, 4096)
JITTED_N_DATA = (16, 128)  # the reference's dense device engine, kept small on the CPU


def _symbols(n: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, s), dtype=np.uint8)


def _erase(n: int, frac: float, seed: int) -> np.ndarray:
    known = np.ones(n, dtype=bool)
    known[np.random.default_rng(seed).choice(n, size=max(1, int(n * frac)), replace=False)] = False
    return known


def _same_peel(got, want):
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("n_data", N_DATA)
def test_ldpc_tables_match_reference(n_data):
    idx = ldpc.parity_indices(n_data)
    assert idx is ldpc.parity_indices(n_data) and not idx.flags.writeable
    np.testing.assert_array_equal(idx, jax_ldpc.parity_indices(n_data))
    assert ldpc.DEGREE == jax_ldpc.DEGREE
    members = ldpc.members_table(n_data)
    assert members.shape == (n_data, min(ldpc.DEGREE, n_data) + 1)
    if n_data <= 256:
        m = ldpc.membership(n_data)
        np.testing.assert_array_equal(m, jax_ldpc.membership(n_data))
        assert (m.sum(axis=1) == members.shape[1]).all()
    for row in members[:64]:
        assert len(set(row.tolist())) == members.shape[1]
    np.testing.assert_array_equal(ldpc.parity_indices(n_data, 4, b"x"), jax_ldpc.parity_indices(n_data, 4, b"x"))


@pytest.mark.parametrize("n_data", N_DATA)
@pytest.mark.parametrize("sym", [64, 512, 3])
def test_ldpc_encode_matches_reference(n_data, sym):
    data = _symbols(n_data, sym, seed=n_data + sym)
    got = ldpc.encode(data, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), jax_ldpc.encode_host(data))
    np.testing.assert_array_equal(ldpc.encode_host(data), jax_ldpc.encode_host(data))
    if n_data in JITTED_N_DATA:
        np.testing.assert_array_equal(got.numpy(), jax_ldpc.encode(data, "device"))


@pytest.mark.parametrize("n_data", N_DATA)
@pytest.mark.parametrize("frac", [0.25, 0.6])
def test_ldpc_peel_matches_reference(n_data, frac):
    data = _symbols(n_data, 64, seed=3 * n_data)
    coded = np.concatenate([data, jax_ldpc.encode_host(data)])
    known = _erase(2 * n_data, frac, seed=n_data)
    # arbitrary bytes at the unknown positions, and a flipped present parity
    noisy = np.where(known[:, None], coded, _symbols(2 * n_data, 64, seed=9))
    flipped = noisy.copy()
    flip = n_data + int(np.flatnonzero(known[n_data:])[0]) if known[n_data:].any() else 0
    flipped[flip, 0] ^= 0xFF
    for syms in (noisy, flipped):
        before = ldpc.peel_members.syncs
        got = ldpc.peel(syms, known, device="cpu")
        want = jax_ldpc.peel_host(syms, known)
        _same_peel(got, want)
        _same_peel(ldpc.peel_host(syms, known), want)
        assert ldpc.peel_members.syncs - before == got[2] + 1
        if n_data in JITTED_N_DATA:
            _same_peel(got, jax_ldpc.peel(syms, known, "device"))
        np.testing.assert_array_equal(ldpc.check_equations(got[0], got[1]),
                                      jax_ldpc.check_equations(got[0], got[1]))
    if frac == 0.25 and n_data >= 16:
        assert got[1].all()  # 1/4 erased peels
        np.testing.assert_array_equal(ldpc.peel(noisy, known, device="cpu")[0], coded)
    all_known = np.ones(2 * n_data, dtype=bool)
    audit = ldpc.check_equations(flipped, all_known)
    np.testing.assert_array_equal(audit, jax_ldpc.check_equations(flipped, all_known))


def test_ldpc_peel_does_not_touch_its_inputs():
    data = _symbols(64, 16, seed=1)
    coded = np.concatenate([data, ldpc.encode_host(data)])
    known = _erase(128, 0.25, seed=2)
    syms, kn = coded.copy(), known.copy()
    ldpc.peel(syms, kn, device="cpu")
    np.testing.assert_array_equal(syms, coded)
    np.testing.assert_array_equal(kn, known)
    t, tk = torch.from_numpy(syms), torch.from_numpy(kn)
    ldpc.peel(t, tk, device="cpu")
    np.testing.assert_array_equal(t.numpy(), coded)
    np.testing.assert_array_equal(tk.numpy(), known)


@pytest.mark.parametrize("n_data", N_DATA + (3, 1024))
def test_polar_geometry_matches_reference(n_data):
    g, want = polar.geometry(n_data), jax_polar.geometry(n_data)
    assert g is polar.geometry(n_data)
    assert (g.n, g.m, g.n_data, g.C) == (want.n, want.m, want.n_data, want.C)
    for field in ("A", "reps", "checks", "data_class"):
        np.testing.assert_array_equal(getattr(g, field), getattr(want, field))
        assert not getattr(g, field).flags.writeable
    n = g.n
    np.testing.assert_array_equal(polar.reliability(n), jax_polar.reliability(n))
    np.testing.assert_array_equal(polar.info_set(n, n_data), jax_polar.info_set(n, n_data))
    assert polar.FROZEN_TAG == jax_polar.FROZEN_TAG


def test_polar_geometry_counts():
    assert (polar.geometry(16).C, polar.geometry(64).C, polar.geometry(256).C) == (76, 431, 2227)
    assert len(polar.geometry(1).checks) == 0  # the k = 1 empty block
    with pytest.raises(ValueError):
        polar.geometry(0)


@pytest.mark.parametrize("n_data", N_DATA)
@pytest.mark.parametrize("sym", [32, 512, 5])
def test_polar_encode_matches_reference(n_data, sym):
    g = polar.geometry(n_data)
    data = _symbols(n_data, sym, seed=n_data * 7 + sym)
    got = polar.encode(data, device="cpu").numpy()
    want = jax_polar.encode_host(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(polar.encode_host(data), want)
    np.testing.assert_array_equal(got[g.data_class], data)  # systematic
    if n_data in JITTED_N_DATA:
        np.testing.assert_array_equal(got, jax_polar.encode(data, "device"))


@pytest.mark.parametrize("n_data", N_DATA)
@pytest.mark.parametrize("frac", [0.25, 0.6])
def test_polar_peel_matches_reference(n_data, frac):
    g = polar.geometry(n_data)
    vals = jax_polar.encode_host(_symbols(n_data, 32, seed=n_data + 5))
    known = _erase(g.C, frac, seed=n_data + 1)
    noisy = np.where(known[:, None], vals, _symbols(g.C, 32, seed=4))
    flipped = noisy.copy()
    if len(g.checks):
        flipped[int(g.checks[len(g.checks) // 2, 0]), 0] ^= 0xFF
    for syms in (noisy, flipped):
        got = polar.peel(n_data, syms, known, device="cpu")
        want = jax_polar.peel_host(n_data, syms, known)
        _same_peel(got, want)
        _same_peel(polar.peel_host(n_data, syms, known), want)
        if n_data in JITTED_N_DATA:
            _same_peel(got, jax_polar.peel(n_data, syms, known, "device"))
        np.testing.assert_array_equal(polar.check_equations(n_data, got[0], got[1]),
                                      jax_polar.check_equations(n_data, got[0], got[1]))
    all_known = np.ones(g.C, dtype=bool)
    np.testing.assert_array_equal(polar.check_equations(n_data, flipped, all_known),
                                  jax_polar.check_equations(n_data, flipped, all_known))
    if len(g.checks):
        assert polar.check_equations(n_data, flipped, all_known).size


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _symbols(16, 8, seed=0)
    for call in (lambda: ldpc.encode(data), lambda: polar.encode(data),
                 lambda: ldpc.peel(np.zeros((32, 8), np.uint8), np.zeros(32, bool)),
                 lambda: polar.peel(16, np.zeros((76, 8), np.uint8), np.zeros(76, bool))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
