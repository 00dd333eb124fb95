"""Host RFC-6962 binary Merkle tree over arbitrary leaves (hashlib), with
inclusion proofs.

Copied from celestia_app_tpu/utils/merkle_host.py (go-square/merkle
semantics, specs/src/specs/data_structures.md): leaf ``SHA256(0x00 || d)``,
inner ``SHA256(0x01 || l || r)``, empty ``SHA256("")``, split point =
largest power of two strictly less than n. The proofs are those of the
axis roots under the data root (pkg/proof/row_proof.go).
"""

from __future__ import annotations

import dataclasses
import hashlib


def _sha(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def leaf_hash(leaf: bytes) -> bytes:
    return _sha(b"\x00" + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha(b"\x01" + left + right)


def split_point(n: int) -> int:
    """Largest power of two strictly less than n (n >= 2)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_leaves(leaves: list[bytes]) -> bytes:
    n = len(leaves)
    if n == 0:
        return _sha(b"")
    if n == 1:
        return leaf_hash(leaves[0])
    k = split_point(n)
    return inner_hash(hash_from_leaves(leaves[:k]), hash_from_leaves(leaves[k:]))


@dataclasses.dataclass
class Proof:
    """CometBFT-style Merkle proof: sibling hashes from the leaf upward."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes]

    def root(self) -> bytes:
        return _compute_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if not (0 <= self.index < self.total):
            return False
        return self.leaf_hash == leaf_hash(leaf) and self.root() == root


def _compute_from_aunts(index: int, total: int, lh: bytes, aunts: list[bytes]) -> bytes:
    if total == 1:
        if aunts:
            raise ValueError("unexpected aunts for single-leaf tree")
        return lh
    if not aunts:
        raise ValueError("proof too short")
    k = split_point(total)
    if index < k:
        left = _compute_from_aunts(index, k, lh, aunts[:-1])
        return inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, lh, aunts[:-1])
    return inner_hash(aunts[-1], right)


def proofs_from_leaves(leaves: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root plus one inclusion proof per leaf."""
    n = len(leaves)
    proofs = [Proof(total=n, index=i, leaf_hash=leaf_hash(leaves[i]), aunts=[])
              for i in range(n)]

    def build(lo: int, hi: int) -> bytes:
        if hi - lo == 1:
            return proofs[lo].leaf_hash
        k = split_point(hi - lo)
        left = build(lo, lo + k)
        right = build(lo + k, hi)
        for i in range(lo, lo + k):
            proofs[i].aunts.append(right)
        for i in range(lo + k, hi):
            proofs[i].aunts.append(left)
        return inner_hash(left, right)

    if n == 0:
        return _sha(b""), []
    return build(0, n), proofs
