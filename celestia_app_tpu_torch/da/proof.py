"""Share and tx inclusion proofs against the data root.

Copied from celestia_app_tpu/da/proof.py. Reference parity: pkg/proof
(proof.go:23-202, row_proof.go, share_proof.go). A proof that a range of
original-square shares is committed by the block's data root consists of:

  1. per touched row, an NMT range proof of those leaves under the row root
     (parity subtree roots appear as proof nodes), and
  2. a RowProof: RFC-6962 Merkle proofs of each row root into the 4k axis
     roots behind the data root (row r = leaf r of rowRoots || colRoots).

Tx inclusion proofs locate the tx's bytes inside the compact-share
sequences (TRANSACTION_NAMESPACE for normal txs, PAY_FOR_BLOB_NAMESPACE for
wrapped PFBs, square.FindTxShareRange) and reduce to a share proof.

`new_share_inclusion_proof` is the host path: it rebuilds each touched row's
NMT with hashlib. da/proof_device.BlockProver gives the same proofs from
the row trees computed once on the card.
"""

from __future__ import annotations

import dataclasses

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.da import namespace as ns_mod
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader, ExtendedDataSquare
from celestia_app_tpu_torch.da.shares import uvarint
from celestia_app_tpu_torch.da.square import Square
from celestia_app_tpu_torch.utils import merkle_host, nmt_host

NS = appconsts.NAMESPACE_SIZE


@dataclasses.dataclass
class RowProof:
    row_roots: list[bytes]  # 90-byte serialized NMT roots
    proofs: list[merkle_host.Proof]
    start_row: int
    end_row: int  # inclusive, mirroring the reference

    def verify(self, data_root: bytes) -> bool:
        if len(self.row_roots) != len(self.proofs):
            return False
        if len(self.row_roots) != self.end_row - self.start_row + 1:
            return False
        for i, (root, proof) in enumerate(zip(self.row_roots, self.proofs)):
            # The leaf index must BE the claimed row (row r is leaf r of the
            # 4k-leaf rowRoots || colRoots tree): otherwise a prover could
            # label row 2's proof as row 3.
            if proof.index != self.start_row + i:
                return False
            if not proof.verify(data_root, root):
                return False
        return True


@dataclasses.dataclass
class ShareProof:
    data: list[bytes]  # the raw 512-byte shares being proven
    share_proofs: list[nmt_host.NmtRangeProof]  # one per touched row
    namespace: bytes  # 29-byte namespace of the proven shares
    row_proof: RowProof
    start_share: int  # ODS-global start index (row-major)
    end_share: int  # exclusive

    def verify(self, data_root: bytes) -> bool:
        if not self.data or len(self.share_proofs) != len(self.row_proof.row_roots):
            return False
        if not self.row_proof.verify(data_root):
            return False
        cursor = 0
        for row_root, nproof in zip(self.row_proof.row_roots, self.share_proofs):
            count = nproof.end - nproof.start
            row_shares = self.data[cursor : cursor + count]
            if len(row_shares) != count:
                return False
            # ODS leaves are namespaced by their own share prefix; the NMT
            # leaf hash binds it, so tampering with either fails.
            if not nproof.verify(row_root, [(s[:NS], s) for s in row_shares]):
                return False
            cursor += count
        return cursor == len(self.data)

    def all_shares_in_namespace(self) -> bool:
        """True iff every proven share carries this proof's namespace (blob
        proofs; tx ranges may span several namespaces)."""
        return all(s[:NS] == self.namespace for s in self.data)


def _row_tree(eds: ExtendedDataSquare, row: int) -> nmt_host.NmtTree:
    """The NMT of one extended row (pkg/wrapper semantics: Q0 leaves keep
    their own namespace prefix, parity leaves take PARITY)."""
    k = eds.width // 2
    tree = nmt_host.NmtTree()
    for c in range(eds.width):
        share = eds.squares[row, c].tobytes()
        tree.push(share[:NS] if (row < k and c < k) else ns_mod.PARITY_NS_RAW, share)
    return tree


def row_proof(dah: DataAvailabilityHeader, root_proofs: list[merkle_host.Proof],
              start_row: int, end_row: int) -> RowProof:
    """RowProof of rows [start_row, end_row] from the 4k axis-root proofs."""
    rows = range(start_row, end_row + 1)
    return RowProof(
        row_roots=[dah.row_roots[r] for r in rows],
        proofs=[root_proofs[r] for r in rows],
        start_row=start_row,
        end_row=end_row,
    )


def row_spans(k: int, start_share: int, end_share: int) -> list[tuple[int, int, int]]:
    """[(row, col_start, col_end)] of ODS shares [start_share, end_share)."""
    if not (0 <= start_share < end_share <= k * k):
        raise ValueError(f"invalid share range [{start_share}, {end_share})")
    start_row, end_row = start_share // k, (end_share - 1) // k
    return [
        (row,
         start_share - row * k if row == start_row else 0,
         end_share - row * k if row == end_row else k)
        for row in range(start_row, end_row + 1)
    ]


def new_share_inclusion_proof(
    eds: ExtendedDataSquare,
    dah: DataAvailabilityHeader,
    start_share: int,
    end_share: int,
    namespace: bytes,
) -> ShareProof:
    """Prove ODS shares [start_share, end_share) (row-major over the k x k
    original square) against the data root."""
    spans = row_spans(eds.width // 2, start_share, end_share)
    data: list[bytes] = []
    nmt_proofs: list[nmt_host.NmtRangeProof] = []
    for row, col_start, col_end in spans:
        nmt_proofs.append(_row_tree(eds, row).prove_range(col_start, col_end))
        data += [eds.squares[row, c].tobytes() for c in range(col_start, col_end)]
    _, root_proofs = merkle_host.proofs_from_leaves(list(dah.row_roots) + list(dah.col_roots))
    return ShareProof(
        data=data,
        share_proofs=nmt_proofs,
        namespace=namespace,
        row_proof=row_proof(dah, root_proofs, spans[0][0], spans[-1][0]),
        start_share=start_share,
        end_share=end_share,
    )


# -- tx -> share range (square.FindTxShareRange) -----------------------------


def _share_index_of_byte(offset: int) -> int:
    first = appconsts.FIRST_COMPACT_SHARE_CONTENT_SIZE
    if offset < first:
        return 0
    return 1 + (offset - first) // appconsts.CONTINUATION_COMPACT_SHARE_CONTENT_SIZE


def tx_share_range(square: Square, tx_index: int) -> tuple[int, int]:
    """ODS share range [start, end) holding tx `tx_index`, counting normal
    txs first, then wrapped PFB txs (block tx order)."""
    n_normal = len(square.txs)
    if tx_index < n_normal:
        units, base, j = square.txs, 0, tx_index
    else:
        units, base, j = square.wrapped_pfb_txs(), square.tx_shares_len, tx_index - n_normal
        if j >= len(units):
            raise ValueError(f"tx index {tx_index} out of range")
    start_byte = sum(len(uvarint(len(u))) + len(u) for u in units[:j])
    end_byte = start_byte + len(uvarint(len(units[j]))) + len(units[j])
    return (
        base + _share_index_of_byte(start_byte),
        base + _share_index_of_byte(end_byte - 1) + 1,
    )


def tx_namespace(square: Square, tx_index: int) -> bytes:
    """The compact-share namespace tx `tx_index` is written under."""
    if tx_index < len(square.txs):
        return ns_mod.TX_NAMESPACE.raw
    return ns_mod.PAY_FOR_BLOB_NAMESPACE.raw


def new_tx_inclusion_proof(
    square: Square,
    eds: ExtendedDataSquare,
    dah: DataAvailabilityHeader,
    tx_index: int,
) -> ShareProof:
    start, end = tx_share_range(square, tx_index)
    return new_share_inclusion_proof(eds, dah, start, end, tx_namespace(square, tx_index))


def blob_share_range(square: Square, pfb_index: int, blob_index: int) -> tuple[int, int]:
    """ODS share range of one blob of one PFB (square.BlobShareRange)."""
    start = square.blob_start_indexes[(pfb_index, blob_index)]
    return start, start + square.pfbs[pfb_index].blobs[blob_index].share_count()
