"""The port's tunable-rate RS (ops/rs_tunable.py) against the JAX package
(tolerance: exact bytes, equal floats for the analytics): the field tables,
the encode, decode and bit matrices, the axis encode against the
reference's host and jitted engines, extend_2d rectangles, any-k-of-n
recovery, the field cap and the closed-form analytics."""

import numpy as np
import pytest
import torch

from celestia_app_tpu.ops import rs_tunable as jax_rst
from celestia_app_tpu_torch.ops import rs_tunable as rst

KN = [(1, 2), (4, 6), (4, 8), (8, 11), (8, 24), (16, 20), (16, 32), (40, 100)]


def _data(k: int, d: int = 64, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, size=(k, d), dtype=np.uint8)


def test_field_tables_match_reference():
    np.testing.assert_array_equal(rst._EXP, jax_rst._EXP)
    np.testing.assert_array_equal(rst._LOG, jax_rst._LOG)
    for a in range(256):
        for b in (0, 1, 2, 7, 0x53, 0xCA, 255):
            assert rst.gf_mul(a, b) == jax_rst.gf_mul(a, b)
        if a:
            assert rst.gf_inv(a) == jax_rst.gf_inv(a) and rst.gf_mul(a, rst.gf_inv(a)) == 1
    with pytest.raises(ZeroDivisionError):
        rst.gf_inv(0)


@pytest.mark.parametrize("k,n", KN[:-1])
def test_matrices_match_reference(k, n):
    enc = rst.encode_matrix(k, n)
    np.testing.assert_array_equal(enc, jax_rst.encode_matrix(k, n))
    assert not enc.flags.writeable
    use = tuple(sorted(np.random.RandomState(k + n).choice(n, size=k, replace=False).tolist()))
    np.testing.assert_array_equal(rst.decode_matrix(k, n, use), jax_rst.decode_matrix(k, n, use))
    if k <= 16:
        np.testing.assert_array_equal(rst._to_bit_matrix(enc), jax_rst._to_bit_matrix(enc))
    data = _data(k, d=8, seed=n)
    np.testing.assert_array_equal(rst.gf_matmul(enc, data), jax_rst.gf_matmul(enc, data))


@pytest.mark.parametrize("k,n", KN)
def test_encode_axis_matches_reference(k, n):
    data = _data(k, seed=3 * k + n)
    got = rst.encode_axis(data, n, device="cpu")
    want = jax_rst.encode_axis_host(data, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rst.encode_axis_host(data, n), want)
    if k <= 16:
        np.testing.assert_array_equal(got, jax_rst.encode_axis(data, n, "device"))
    coded = rst.extend_axis(data, n, device="cpu")
    np.testing.assert_array_equal(coded, jax_rst.extend_axis(data, n, "host"))
    np.testing.assert_array_equal(coded[:k], data)


def test_all_ones_data_is_exact():
    # every product bit set: the largest sums the float32 product meets
    k, n = 40, 100
    data = np.full((k, 16), 0xFF, dtype=np.uint8)
    np.testing.assert_array_equal(rst.encode_axis(data, n, device="cpu"), jax_rst.encode_axis_host(data, n))


@pytest.mark.parametrize("k,n", [(4, 6), (4, 12), (8, 11), (8, 24), (16, 20)])
def test_recover_axis_matches_reference(k, n):
    coded = rst.extend_axis(_data(k, seed=k * 100 + n), n, device="cpu")
    rng = np.random.RandomState(7)
    subsets = [list(range(k)), list(range(n - k, n))]
    subsets += [sorted(rng.choice(n, size=k, replace=False).tolist()) for _ in range(3)]
    for use in subsets:
        wiped = np.zeros_like(coded)
        wiped[use] = coded[use]
        got = rst.recover_axis(wiped, use, k)
        np.testing.assert_array_equal(got, coded)
        np.testing.assert_array_equal(got, jax_rst.recover_axis(wiped, use, k))


@pytest.mark.parametrize("k,n_r,n_c", [(4, 6, 10), (4, 8, 8), (8, 12, 24), (8, 24, 11), (1, 2, 3)])
def test_extend_2d_matches_reference(k, n_r, n_c):
    ods = np.random.RandomState(5).randint(0, 256, size=(k, k, 512), dtype=np.uint8)
    got = rst.extend_2d(ods, n_r, n_c, device="cpu")
    assert got.shape == (n_r, n_c, 512)
    np.testing.assert_array_equal(got, jax_rst.extend_2d(ods, n_r, n_c, "host"))
    np.testing.assert_array_equal(got[:k, :k], ods)
    if k == 4:
        np.testing.assert_array_equal(got, jax_rst.extend_2d(ods, n_r, n_c, "device"))


def test_field_cap_is_loud():
    for call in (lambda m: m.encode_matrix(128, 257), lambda m: m.encode_matrix(8, 8),
                 lambda m: m.recover_axis(np.zeros((8, 4), dtype=np.uint8), [0, 1], 4),
                 lambda m: m.decode_matrix(4, 8, (0, 1, 2, 2)), lambda m: m.analytics(8, 8, 16),
                 lambda m: m.analytics(1, 2, 2)):  # nothing survives: no finite sample count
        with pytest.raises(ValueError) as got:  # the reference's own error
            call(rst)
        with pytest.raises(ValueError) as want:
            call(jax_rst)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="point budget"):
        rst.encode_axis(_data(8), 300, device="cpu")
    with pytest.raises(ValueError, match="k < n"):
        rst.extend_2d(np.zeros((4, 4, 512), dtype=np.uint8), 4, 8, device="cpu")


@pytest.mark.parametrize("k,n_r,n_c", [(8, 16, 16), (8, 24, 24), (8, 11, 11), (8, 12, 24), (128, 256, 256), (2, 3, 3)])
def test_analytics_match_reference(k, n_r, n_c):
    assert rst.analytics(k, n_r, n_c) == jax_rst.analytics(k, n_r, n_c)


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: rst.encode_axis(_data(4), 8), lambda: rst.extend_axis(_data(4), 8),
                 lambda: rst.extend_2d(np.zeros((4, 4, 512), dtype=np.uint8), 8, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
