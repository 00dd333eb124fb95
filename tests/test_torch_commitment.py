"""The port's blob share commitments against the JAX package, byte for byte
(tolerance: exact): the MMR plan, the hashlib path and the batched device
path (on the CPU, through K1's plain version), on blob sizes that give
1-share subtrees, multi-share and multi-subtree blobs and
non-power-of-two MMR tails, and on empty input."""

import numpy as np
import pytest
import torch

from celestia_app_tpu.da import blob as jax_blob
from celestia_app_tpu.da import commitment as jax_commitment
from celestia_app_tpu.da import commitment_device as jax_commitment_device
from celestia_app_tpu.da import namespace as jax_namespace
from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.da import blob, commitment, commitment_device, namespace

THRESHOLD = appconsts.SUBTREE_ROOT_THRESHOLD
MIXED_SIZES = [10, 500, 2000, 480 * 9, 480 * 30, 7]


def _blobs(seed, sizes):
    """(port blobs, JAX blobs) with the same bytes, one namespace each."""
    rng = np.random.default_rng(seed)
    # version 0: the version byte and 18 zero bytes, then 10 user bytes
    raw = [(bytes(19) + bytes([i + 1]) * 10, rng.bytes(size)) for i, size in enumerate(sizes)]
    return (
        [blob.Blob(namespace.Namespace(ns), data) for ns, data in raw],
        [jax_blob.Blob(jax_namespace.Namespace(ns), data) for ns, data in raw],
    )


@pytest.mark.parametrize("sizes", [MIXED_SIZES, [1], [478], [479], [482 * 64 + 478], [100] * 5],
                         ids=["mixed", "1B", "one-share", "two-shares", "65-shares", "repeated"])
def test_commitments_match_reference(sizes):
    blobs, jax_blobs = _blobs(len(sizes), sizes)
    want = jax_commitment.create_commitments(jax_blobs, THRESHOLD)
    assert commitment.create_commitments(blobs, THRESHOLD) == want
    assert commitment_device.commitments_device(blobs, THRESHOLD, device="cpu") == want
    assert jax_commitment_device.commitments_device(jax_blobs, THRESHOLD) == want


@pytest.mark.parametrize("threshold", [1, 8, 64])
def test_commitments_follow_the_threshold(threshold):
    blobs, jax_blobs = _blobs(3, MIXED_SIZES)
    want = jax_commitment.create_commitments(jax_blobs, threshold)
    assert commitment_device.commitments_device(blobs, threshold, device="cpu") == want


def test_empty_input():
    assert commitment_device.commitments_device([], THRESHOLD, device="cpu") == []
    assert commitment.create_commitments([], THRESHOLD) == []
    assert jax_commitment_device.commitments_device([], THRESHOLD) == []


@pytest.mark.parametrize("total", [1, 2, 3, 7, 8, 9, 64, 65, 127, 300])
@pytest.mark.parametrize("cap", [1, 2, 4, 16, 128])
def test_mmr_sizes_match_reference(total, cap):
    got = commitment.merkle_mountain_range_sizes(total, cap)
    assert got == jax_commitment.merkle_mountain_range_sizes(total, cap)
    assert sum(got) == total and all(s <= cap and s & (s - 1) == 0 for s in got)


def test_plan_groups_subtrees_by_size():
    blobs, _ = _blobs(4, MIXED_SIZES)
    plans, groups = commitment_device.plan(blobs, THRESHOLD)
    assert len(plans) == len(blobs)
    for b, p in zip(blobs, plans):
        n = b.share_count()
        width = commitment.subtree_width(n, THRESHOLD)
        assert [size for size, _ in p] == commitment.merkle_mountain_range_sizes(n, width)
    for size, chunks in groups.items():
        assert all(c.shape == (size, appconsts.SHARE_SIZE) for c in chunks)
    assert sum(len(c) for c in groups.values()) == sum(len(p) for p in plans)
    # every subtree size has its slots in blob order
    for size in groups:
        slots = [slot for p in plans for s, slot in p if s == size]
        assert slots == list(range(len(groups[size])))


def test_commitments_device_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blobs, _ = _blobs(5, [10])
    with pytest.raises(RuntimeError):
        commitment_device.commitments_device(blobs, THRESHOLD)
