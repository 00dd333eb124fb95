"""The reference against the program's CPU path at small k, in both fields,
and its SHA-256 against hashlib."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import eds as ref_eds
from benchmark.reference import leopard, nmt, sha256


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 65, 91, 181, 542])
def test_sha256_matches_hashlib(length):
    rng = np.random.default_rng(length)
    msgs = torch.from_numpy(rng.integers(0, 256, (7, length), dtype=np.uint8))
    assert torch.equal(sha256.digest(msgs), sha256.digest_hashlib(msgs))


def _ods(k: int, seed: int) -> np.ndarray:
    ods = np.random.default_rng(seed).integers(0, 256, (k, k, 512), dtype=np.uint8)
    ods[k // 2:, :, :29] = 0xFF  # some leaves share a namespace, some are the largest
    return ods


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_commitment_matches_the_program_in_gf8(k):
    from celestia_app_tpu_torch.da import eds as port_eds

    ods = _ods(k, k)
    want = port_eds.pipeline(ods, "cpu")
    got = ref_eds.commit(torch.from_numpy(ods)[None])
    for g, w in zip((got.eds, got.row_roots, got.col_roots, got.data_root), want):
        assert torch.equal(g[0], w)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_extension_matches_the_program_in_gf16(k):
    """The 16-bit field forced at small k, as the program's tests force it."""
    from celestia_app_tpu_torch.ops import rs

    ods = torch.from_numpy(_ods(k, 100 + k))
    want = rs.extend_square_fn(k, "cpu", field=16)(ods)
    assert torch.equal(leopard.extend_square(ods, bits=16), want)


@pytest.mark.parametrize("k", [2, 8])
def test_roots_through_torch_sha256_match_hashlib(k):
    eds = leopard.extend_square(torch.from_numpy(_ods(k, 200 + k)), bits=16)[None]
    got = nmt.axis_roots(eds, sha256.digest)
    want = nmt.axis_roots(eds, sha256.digest_hashlib)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(nmt.data_root(*got, sha256.digest), nmt.data_root(*want, sha256.digest_hashlib))


def test_a_batch_commits_as_its_squares_do():
    odss = torch.from_numpy(np.stack([_ods(4, s) for s in range(3)]))
    whole = ref_eds.commit(odss)
    for i in range(3):
        one = ref_eds.commit(odss[i:i + 1])
        assert torch.equal(one.eds[0], whole.eds[i]) and torch.equal(one.data_root[0], whole.data_root[i])


@pytest.mark.parametrize("bits", [8, 16])
def test_the_control_code_differs_and_is_still_a_code(bits):
    """The control's extension differs from the protocol's, and like it maps
    a constant axis to a constant parity (a degree-0 polynomial)."""
    ods = torch.from_numpy(_ods(8, 300 + bits))
    assert not torch.equal(leopard.extend_square(ods, bits, control=True), leopard.extend_square(ods, bits))
    const = torch.full((8, 8, 512), 0x5A, dtype=torch.uint8)
    assert torch.equal(leopard.extend_square(const, bits, control=True), leopard.extend_square(const, bits))
