"""Host-only (numpy + hashlib) implementation of the full DA pipeline: the
port of celestia_app_tpu/utils/refimpl.py.

Mirrors da/eds.py step for step: 2D RS extension via GF(256) byte-domain
matmuls, per-axis NMT roots via utils.nmt_host, data root via
utils.merkle_host. The golden oracle of the block pipeline in the tests;
nothing on the card's path calls it. Slow by design (pure Python hashing).
"""

from __future__ import annotations

import numpy as np

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.da import namespace as ns_mod
from celestia_app_tpu_torch.ops import leopard
from celestia_app_tpu_torch.utils import merkle_host, nmt_host

NS = appconsts.NAMESPACE_SIZE


def extend_square_host(ods: np.ndarray) -> np.ndarray:
    """(k, k, 512) -> (2k, 2k, 512), identical to ops/rs.py extension."""
    k = ods.shape[0]
    if k > 128:
        raise ValueError(
            "refimpl covers the GF(2^8) range (k <= 128, all protocol-legal "
            "squares); use ops.rs.extend_square_np for benchmark-scale squares"
        )
    e = leopard.encode_matrix(k)
    q1 = np.stack([leopard.matmul(e, ods[r]) for r in range(k)])
    q2 = np.stack([leopard.matmul(e, ods[:, c, :]) for c in range(k)], axis=1)
    q3 = np.stack([leopard.matmul(e, q2[r]) for r in range(k)])
    top = np.concatenate([ods, q1], axis=1)
    bottom = np.concatenate([q2, q3], axis=1)
    return np.concatenate([top, bottom], axis=0)


def axis_roots_host(eds: np.ndarray) -> tuple[list[bytes], list[bytes]]:
    """Row and column NMT roots (90-byte serialized) of an extended square."""
    two_k = eds.shape[0]
    k = two_k // 2

    def tree_root(axis_get, axis_index) -> bytes:
        tree = nmt_host.NmtTree()
        for j in range(two_k):
            share = axis_get(j).tobytes()
            in_q0 = axis_index < k and j < k
            ns = share[:NS] if in_q0 else ns_mod.PARITY_NS_RAW
            tree.push(ns, share)
        return nmt_host.serialize(tree.root())

    rows = [tree_root(lambda j, r=r: eds[r, j], r) for r in range(two_k)]
    cols = [tree_root(lambda j, c=c: eds[j, c], c) for c in range(two_k)]
    return rows, cols


def pipeline_host(ods: np.ndarray):
    """Full host pipeline: ODS -> (eds, row_roots, col_roots, data_root)."""
    eds = extend_square_host(ods)
    rows, cols = axis_roots_host(eds)
    data_root = merkle_host.hash_from_leaves(rows + cols)
    return eds, rows, cols, data_root
