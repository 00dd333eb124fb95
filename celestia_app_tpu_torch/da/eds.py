"""The compute core: ODS -> extended square -> axis roots -> data root.

Port of celestia_app_tpu/da/eds.py:pipeline_fn. For one (k, k, 512) square:

  1. 2D Reed-Solomon extension to 2k x 2k (ops/rs.py, two K2 launches);
  2. all 2k row and 2k column NMT roots (ops/nmt.py), Q0 leaves namespaced
     by their own share prefix and parity leaves by PARITY_SHARE_NAMESPACE
     (pkg/wrapper/nmt_wrapper.go:93-114 semantics);
  3. the RFC-6962 Merkle root over rowRoots || colRoots, the data root
     (pkg/da/data_availability_header.go:100-107).

Everything stays on the device between stages. `roots_only` is the same
pass for a caller that needs the commitments and not the square.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.ops import merkle, nmt, rs

NS = appconsts.NAMESPACE_SIZE


def _axis_leaf_ns(eds: torch.Tensor, k: int) -> torch.Tensor:
    """Leaf namespaces for row trees of an EDS: own prefix in Q0, else parity.

    Symmetric under transpose (position (r, c) is in Q0 iff r < k and c < k),
    so the same function serves column trees on the transposed square."""
    idx = torch.arange(2 * k, device=eds.device)
    in_q0 = (idx[:, None] < k) & (idx[None, :] < k)  # (2k, 2k)
    return torch.where(in_q0.unsqueeze(-1), eds[:, :, :NS], nmt.parity_ns(eds.device))


def pipeline(
    ods: np.ndarray | torch.Tensor, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, k, 512) u8 ODS -> (eds, row_roots, col_roots, data_root) tensors
    on `device`: (2k, 2k, 512), (2k, 90), (2k, 90), (32,)."""
    dev = device_mod.resolve(device)
    if not isinstance(ods, torch.Tensor):
        ods = torch.from_numpy(np.array(ods))  # own writable copy
    ods = ods.to(dev)
    k = ods.shape[0]
    if ods.dtype != torch.uint8 or ods.shape != (k, k, appconsts.SHARE_SIZE):
        raise ValueError(f"ODS must be (k, k, 512) uint8, got {tuple(ods.shape)} {ods.dtype}")
    eds = rs.extend_square_fn(k, dev)(ods.contiguous())
    # Leaf (r, c) has the SAME preimage (0x00 || ns || share) in row tree
    # r and column tree c: hash the 2k x 2k leaf grid once and transpose
    # the digests for the column trees. One 4k-tree reduction then covers
    # both orientations, so each level's SHA-256 launch sees twice the
    # messages.
    mins, maxs, vs = nmt.leaf_nodes(_axis_leaf_ns(eds, k), eds)
    m4 = torch.cat([mins, mins.transpose(0, 1)], dim=0)
    x4 = torch.cat([maxs, maxs.transpose(0, 1)], dim=0)
    v4 = torch.cat([vs, vs.transpose(0, 1)], dim=0)
    axis_roots = nmt.roots_from_leaf_nodes(m4, x4, v4)  # (4k, 90)
    row_roots, col_roots = axis_roots[: 2 * k], axis_roots[2 * k:]
    data_root = merkle.merkle_root_pow2(axis_roots)
    return eds, row_roots, col_roots, data_root


def roots_only(
    ods: np.ndarray | torch.Tensor, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, k, 512) u8 ODS -> (row_roots, col_roots, data_root) on `device`,
    without the extended square: the EDS is dropped on the device and never
    copied back."""
    _, row_roots, col_roots, data_root = pipeline(ods, device)
    return row_roots, col_roots, data_root
