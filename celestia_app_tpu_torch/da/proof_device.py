"""Share, tx and cell proofs from row trees computed once on the card.

Port of celestia_app_tpu/da/proof_device.py. The host path (da/proof.py)
rebuilds one NMT per touched row with hashlib for every proof. Here
`row_levels` computes every node of every row tree of the extended square
in one level-synchronous pass (ops/nmt.nmt_levels: kernel K1, one leaf
launch and log2(2k) inner launches, 9 at k = 128), the level tensors come
to the host once as numpy (`levels_to_host`: one copy, 11.8 MB at k = 128),
and each proof is then index arithmetic: the range proof's nodes are the
maximal out-of-range subtree roots of a perfect binary tree, addressed as
(level, index), with no hashing per proof.

The proofs are byte-identical to da/proof.py's and verify with the same
NmtRangeProof / RowProof code.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da import commitment as commitment_mod
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.da import proof as proof_mod
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader, ExtendedDataSquare
from celestia_app_tpu_torch.da.proof import ShareProof
from celestia_app_tpu_torch.da.square import Square
from celestia_app_tpu_torch.ops import nmt
from celestia_app_tpu_torch.utils import merkle_host, nmt_host

Levels = list[tuple[np.ndarray, np.ndarray, np.ndarray]]


def row_levels(
    squares: np.ndarray | torch.Tensor, device=None
) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(2k, 2k, 512) u8 extended square -> every level of its 2k row trees
    on `device`, leaves first: [(mins (2k, 2k/2^i, 29), maxs, vs (.., 32))].

    A host array may be a strided view (the transposed square of a column
    prover): it is copied to the device as it lies and made contiguous
    there, so the transpose runs on the device."""
    dev = device_mod.resolve(device)
    if not isinstance(squares, torch.Tensor):
        squares = torch.from_numpy(squares if squares.flags.writeable else squares.copy())
    squares = squares.to(dev).contiguous()
    k = squares.shape[0] // 2
    return nmt.nmt_levels(eds_mod._axis_leaf_ns(squares, k), squares)


def levels_to_host(levels) -> Levels:
    """Device level tensors -> host numpy arrays, in one device-to-host copy."""
    flat = torch.cat([t.reshape(-1) for level in levels for t in level]).cpu().numpy()
    out, at = [], 0
    for level in levels:
        arrays = []
        for t in level:
            arrays.append(flat[at : at + t.numel()].reshape(tuple(t.shape)))
            at += t.numel()
        out.append(tuple(arrays))
    return out


class BlockProver:
    """Per-block proof factory: one device pass, then index-only proofs."""

    def __init__(self, eds: ExtendedDataSquare, dah: DataAvailabilityHeader,
                 levels: Levels | None = None, device=None):
        """`levels`, when given, are the host row levels (as `levels_to_host`
        returns them) and no level pass runs; else one runs on `device`
        (the card unless the caller asks for the CPU)."""
        self.eds = eds
        self.dah = dah
        self.k = eds.width // 2
        if levels is None:
            levels = levels_to_host(row_levels(eds.squares, device))
        # host [(mins, maxs, vs)], node counts 2k, k, ..., 1 per row tree
        self.levels: Levels = levels
        _, self._root_proofs = merkle_host.proofs_from_leaves(
            list(dah.row_roots) + list(dah.col_roots)
        )

    def _node(self, row: int, level: int, idx: int) -> bytes:
        m, x, v = self.levels[level]
        return m[row, idx].tobytes() + x[row, idx].tobytes() + v[row, idx].tobytes()

    def _range_proof(self, row: int, p_start: int, p_end: int) -> nmt_host.NmtRangeProof:
        """Maximal out-of-range subtree roots of the perfect 2k-leaf tree."""
        total = 2 * self.k
        nodes: list[bytes] = []

        def walk(lo: int, hi: int) -> None:
            if hi <= p_start or lo >= p_end:
                level = (hi - lo).bit_length() - 1
                nodes.append(self._node(row, level, lo >> level))
                return
            if hi - lo == 1:
                return  # in-range leaf: the verifier recomputes it
            mid = lo + (hi - lo) // 2  # split point of a power of two
            walk(lo, mid)
            walk(mid, hi)

        walk(0, total)
        return nmt_host.NmtRangeProof(start=p_start, end=p_end, total=total, nodes=nodes)

    def prove_cell(self, row: int, col: int) -> tuple[bytes, nmt_host.NmtRangeProof]:
        """One cell of the EXTENDED square (any quadrant) with its NMT proof
        under the row root: the unit a sampler requests."""
        width = 2 * self.k
        if not (0 <= row < width and 0 <= col < width):
            raise ValueError(f"cell ({row}, {col}) outside the {width}x{width} square")
        return self.eds.squares[row, col].tobytes(), self._range_proof(row, col, col + 1)

    def prove_shares(self, start_share: int, end_share: int, namespace: bytes) -> ShareProof:
        """ShareProof for ODS shares [start_share, end_share), row-major."""
        spans = proof_mod.row_spans(self.k, start_share, end_share)
        data: list[bytes] = []
        nmt_proofs: list[nmt_host.NmtRangeProof] = []
        for row, col_start, col_end in spans:
            nmt_proofs.append(self._range_proof(row, col_start, col_end))
            data += [self.eds.squares[row, c].tobytes() for c in range(col_start, col_end)]
        return ShareProof(
            data=data,
            share_proofs=nmt_proofs,
            namespace=namespace,
            row_proof=proof_mod.row_proof(self.dah, self._root_proofs, spans[0][0], spans[-1][0]),
            start_share=start_share,
            end_share=end_share,
        )

    def commitment_from_eds(
        self, square: Square, pfb_index: int, blob_index: int, subtree_root_threshold: int,
    ) -> bytes:
        """Blob share commitment from the committed square's row trees: no
        hashing beyond the final MMR fold.

        Reference: pkg/inclusion/get_commit.go:12-30 with the
        EDSSubTreeRootCacher. The non-interactive defaults align every MMR
        chunk of a blob to a subtree of its row NMT, so every subtree root
        is a node the level pass already computed."""
        start, end = proof_mod.blob_share_range(square, pfb_index, blob_index)
        n_shares = end - start
        width = commitment_mod.subtree_width(n_shares, subtree_root_threshold)
        k = self.k
        subtree_roots: list[bytes] = []
        cursor = start
        for size in commitment_mod.merkle_mountain_range_sizes(n_shares, width):
            row, col = cursor // k, cursor % k
            if col % size != 0 or col + size > k:
                raise ValueError("blob chunk not aligned to a row subtree (layout violation)")
            level = size.bit_length() - 1
            subtree_roots.append(self._node(row, level, col >> level))
            cursor += size
        return merkle_host.hash_from_leaves(subtree_roots)

    def prove_tx(self, square: Square, tx_index: int) -> ShareProof:
        """Tx inclusion proof (pkg/proof/proof.go:NewTxInclusionProof)."""
        start, end = proof_mod.tx_share_range(square, tx_index)
        return self.prove_shares(start, end, proof_mod.tx_namespace(square, tx_index))
