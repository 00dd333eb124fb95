"""Blob share commitments: the Merkle mountain range over NMT subtree roots.

Copied from celestia_app_tpu/da/commitment.py. Reference parity: go-square
`inclusion.CreateCommitment` (x/blob/types/payforblob.go:53) per the spec's
"Blob Share Commitment Rules" (specs/src/specs/data_square_layout.md:38-58):

  SubtreeWidth  = min(roundUpPow2(ceil(shares / SubtreeRootThreshold)),
                      minSquareSize(shares))
  tree sizes    = MMR decomposition of the share count with max width
                  SubtreeWidth (full-width trees, then descending powers of 2)
  subtree roots = NMT roots over each chunk's ns-prefixed shares
  commitment    = RFC-6962 Merkle root over the serialized (90 B) subtree roots

This is the hashlib path, one blob at a time; da/commitment_device.py
computes the same commitments for every blob of a block in a few batched
SHA-256 launches on the card.
"""

from __future__ import annotations

import math

from celestia_app_tpu_torch.da import shares as shares_mod
from celestia_app_tpu_torch.da.blob import Blob
from celestia_app_tpu_torch.utils import merkle_host, nmt_host


def round_up_pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def min_square_size(share_count: int) -> int:
    """Smallest power-of-two square edge that fits `share_count` shares."""
    return round_up_pow2(math.isqrt(share_count - 1) + 1 if share_count > 1 else 1)


def subtree_width(share_count: int, subtree_root_threshold: int) -> int:
    s = -(-share_count // subtree_root_threshold)  # ceil
    return min(round_up_pow2(s), min_square_size(share_count))


def merkle_mountain_range_sizes(total: int, max_tree_size: int) -> list[int]:
    """Decompose `total` leaves into MMR tree sizes with cap `max_tree_size`."""
    sizes = []
    while total >= max_tree_size:
        sizes.append(max_tree_size)
        total -= max_tree_size
    p = max_tree_size
    while total:
        while p > total:
            p //= 2
        sizes.append(p)
        total -= p
    return sizes


def create_commitment(blob: Blob, subtree_root_threshold: int) -> bytes:
    """32-byte share commitment of a blob."""
    blob_shares = shares_mod.split_blob(blob.namespace, blob.data, blob.share_version)
    width = subtree_width(len(blob_shares), subtree_root_threshold)
    subtree_roots: list[bytes] = []
    cursor = 0
    for size in merkle_mountain_range_sizes(len(blob_shares), width):
        tree = nmt_host.NmtTree()
        for s in blob_shares[cursor : cursor + size]:
            tree.push(blob.namespace.raw, s.raw)
        subtree_roots.append(nmt_host.serialize(tree.root()))
        cursor += size
    return merkle_host.hash_from_leaves(subtree_roots)


def create_commitments(blobs: list[Blob], subtree_root_threshold: int) -> list[bytes]:
    return [create_commitment(b, subtree_root_threshold) for b in blobs]
