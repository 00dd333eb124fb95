"""Namespace data retrieval with presence, completeness and absence proofs.

Copied from celestia_app_tpu/da/namespace_data.py (celestia-node's
GetSharesByNamespace; nmt ProveNamespace / VerifyNamespace). Given a
block's DAH, return EVERY share of a namespace with a proof that the set is
complete, or a proof that the namespace is absent from the block.

The square is namespace-sorted (data_square_layout.md), so a namespace's
shares form one contiguous row-major range; NMT proof nodes serialize as
min_ns || max_ns || hash (90 bytes), so a verifier reads each out-of-range
subtree's namespace window off the proof; the DAH's row roots carry the
[min, max] windows of whole rows.

Verification (nmt VerifyNamespace semantics):
- presence: the ShareProof chains to the data root, every returned share
  carries the target namespace, every OTHER row's root window excludes it,
  and every out-of-range proof node inside the touched rows excludes it;
- absence, no covering row: every row root window excludes the target;
- absence, straddling row (min < target < max, no exact match): a one-leaf
  proof of the SUCCESSOR share (the first leaf with ns > target). The
  proof nodes left of it have max < target, and the successor's own ns is
  above the target.
"""

from __future__ import annotations

import dataclasses

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
from celestia_app_tpu_torch.da.proof import ShareProof

NS = appconsts.NAMESPACE_SIZE


@dataclasses.dataclass
class NamespaceData:
    """Shares and their presence proof, or an absence witness."""

    namespace: bytes
    shares: list[bytes]  # [] when absent
    proof: ShareProof | None  # presence proof, or successor proof (absence)


def _root_window(root90: bytes) -> tuple[bytes, bytes]:
    return root90[:NS], root90[NS : 2 * NS]


def _out_of_range_subtrees(total: int, start: int, end: int) -> list[tuple[int, int]]:
    """Maximal out-of-range subtrees of the perfect `total`-leaf tree for
    range [start, end), in the order the prover emits proof nodes."""
    out: list[tuple[int, int]] = []

    def walk(lo: int, hi: int) -> None:
        if hi <= start or lo >= end:
            out.append((lo, hi))
            return
        if hi - lo == 1:
            return
        mid = lo + (hi - lo) // 2
        walk(lo, mid)
        walk(mid, hi)

    walk(0, total)
    return out


def absence_data(prover, namespace: bytes) -> NamespaceData:
    """The absence walk: the first Q0 row whose root window straddles the
    namespace gives a one-leaf successor proof; with no such row, no proof
    is needed."""
    k = prover.k
    ods = prover.eds.squares
    for r in range(k):
        lo, hi = _root_window(prover.dah.row_roots[r])
        if lo <= namespace <= hi:
            # the successor exists: hi >= namespace and no share matches
            succ = next(c for c in range(k) if ods[r, c, :NS].tobytes() > namespace)
            pf = prover.prove_shares(r * k + succ, r * k + succ + 1, ods[r, succ, :NS].tobytes())
            return NamespaceData(namespace=namespace, shares=[], proof=pf)
    return NamespaceData(namespace=namespace, shares=[], proof=None)


def presence_data(prover, namespace: bytes, start: int, end: int) -> NamespaceData:
    """The namespace's shares [start, end) with their presence proof."""
    pf = prover.prove_shares(start, end, namespace)
    return NamespaceData(namespace=namespace, shares=[bytes(s) for s in pf.data], proof=pf)


def get_namespace_data(prover, namespace: bytes) -> NamespaceData:
    """All shares of `namespace` in the prover's block, with proof: the
    host scan, one share at a time. `prover` is a
    da/proof_device.BlockProver."""
    if len(namespace) != NS:
        raise ValueError(f"namespace must be {NS} bytes")
    k = prover.k
    ods = prover.eds.squares
    hits = [r * k + c for r in range(k) for c in range(k) if ods[r, c, :NS].tobytes() == namespace]
    if not hits:
        return absence_data(prover, namespace)
    start, end = hits[0], hits[-1] + 1
    if hits != list(range(start, end)):
        raise AssertionError("namespace shares are not contiguous: square is not sorted")
    return presence_data(prover, namespace, start, end)


def verify_namespace_data(
    dah: DataAvailabilityHeader, namespace: bytes, nd: NamespaceData
) -> bool:
    """True iff `nd` proves its claim (present and complete, or absent)
    against the trusted DAH."""
    if nd.namespace != namespace or len(namespace) != NS:
        return False
    data_root = dah.hash()
    k = len(dah.row_roots) // 2

    def rows_exclude(rows) -> bool:
        for r in rows:
            lo, hi = _root_window(dah.row_roots[r])
            if lo <= namespace <= hi:
                return False
        return True

    def rows_bound(pf) -> bool:
        """The proof's row roots must BE the DAH's roots of the claimed rows,
        or start_row / end_row are labels an attacker chose."""
        want = [dah.row_roots[r] for r in range(pf.row_proof.start_row, pf.row_proof.end_row + 1)]
        return list(pf.row_proof.row_roots) == want

    if nd.shares:
        pf = nd.proof
        if pf is None or pf.data != nd.shares:
            return False
        if not pf.verify(data_root) or not rows_bound(pf):
            return False
        if any(s[:NS] != namespace for s in nd.shares):
            return False
        start_row, end_row = pf.row_proof.start_row, pf.row_proof.end_row
        # complete outside the touched rows
        if not rows_exclude(r for r in range(2 * k) if not start_row <= r <= end_row):
            return False
        # complete inside them: no out-of-range proof node's window holds it
        for nproof in pf.share_proofs:
            for node in nproof.nodes:
                lo, hi = _root_window(node)
                if lo <= namespace <= hi:
                    return False
        return True

    if nd.proof is None:
        return rows_exclude(range(2 * k))  # absent, no covering row

    # absent, with a successor proof in a straddling row
    pf = nd.proof
    if len(pf.data) != 1 or not pf.verify(data_root) or not rows_bound(pf):
        return False
    if not pf.data[0][:NS] > namespace:
        return False
    row = pf.row_proof.start_row
    if row != pf.row_proof.end_row or row >= k:
        return False
    if not rows_exclude(r for r in range(2 * k) if r != row):
        return False
    nproof = pf.share_proofs[0]
    subtrees = _out_of_range_subtrees(nproof.total, nproof.start, nproof.end)
    if len(subtrees) != len(nproof.nodes):
        return False
    for (_, hi_pos), node in zip(subtrees, nproof.nodes):
        lo, hi = _root_window(node)
        if hi_pos <= nproof.start:  # left of the successor: max below the target
            if hi >= namespace:
                return False
        elif lo <= namespace:  # right of it: min above the target
            return False
    return True
