"""Blob share commitments of every blob of a block, batched on the card.

Port of celestia_app_tpu/da/commitment_device.py. Computes the same
commitments as da/commitment.py (go-square `inclusion.CreateCommitment`,
x/blob/types/payforblob.go:53) for all blobs at once: the MMR plan gives
each blob a handful of power-of-two NMT subtrees (width <= SubtreeWidth),
all subtrees of one size s across all blobs go through one batched
`ops/nmt.nmt_roots` on the device (kernel K1: one leaf launch and log2(s)
inner launches), and each blob's commitment is a host Merkle fold over its
few 90-byte subtree roots.

The JAX module pads each size's tree count T to a power of two so that XLA
compiles few programs. The port does not pad: nothing is compiled per
shape, and K1 takes any message count N.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da import commitment as commitment_mod
from celestia_app_tpu_torch.da import shares as shares_mod
from celestia_app_tpu_torch.da.blob import Blob
from celestia_app_tpu_torch.ops import nmt
from celestia_app_tpu_torch.utils import merkle_host

NS = appconsts.NAMESPACE_SIZE
SHARE = appconsts.SHARE_SIZE


def plan(blobs: list[Blob], subtree_root_threshold: int) -> tuple[
    list[list[tuple[int, int]]], dict[int, list[np.ndarray]]
]:
    """Host MMR planning: per blob the ordered [(size, slot)] of its
    subtrees, and per subtree size the (size, 512) share chunks in slot
    order."""
    plans: list[list[tuple[int, int]]] = []
    groups: dict[int, list[np.ndarray]] = {}
    for blob in blobs:
        blob_shares = shares_mod.split_blob(blob.namespace, blob.data, blob.share_version)
        raw = np.frombuffer(b"".join(s.raw for s in blob_shares), dtype=np.uint8)
        raw = raw.reshape(len(blob_shares), SHARE)
        width = commitment_mod.subtree_width(len(blob_shares), subtree_root_threshold)
        blob_plan = []
        cursor = 0
        for size in commitment_mod.merkle_mountain_range_sizes(len(blob_shares), width):
            chunks = groups.setdefault(size, [])
            blob_plan.append((size, len(chunks)))
            chunks.append(raw[cursor : cursor + size])
            cursor += size
        plans.append(blob_plan)
    return plans, groups


def commitments_device(
    blobs: list[Blob], subtree_root_threshold: int, device=None
) -> list[bytes]:
    """Share commitments of all `blobs`, one batched NMT pass per distinct
    subtree size on `device` (the card unless the caller asks for the CPU)."""
    dev = device_mod.resolve(device)
    if not blobs:
        return []
    plans, groups = plan(blobs, subtree_root_threshold)
    roots_by_size: dict[int, np.ndarray] = {}
    for size, chunks in groups.items():
        data = torch.from_numpy(np.stack(chunks)).to(dev)  # (T, size, 512)
        # A blob share begins with its blob's namespace, and every leaf of
        # a subtree is namespaced by it: the leaf namespaces are the
        # shares' own first 29 bytes.
        roots_by_size[size] = nmt.nmt_roots(data[:, :, :NS], data).cpu().numpy()
    return [
        merkle_host.hash_from_leaves([roots_by_size[size][slot].tobytes() for size, slot in p])
        for p in plans
    ]
