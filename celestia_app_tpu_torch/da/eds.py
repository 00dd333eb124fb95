"""The compute core: ODS -> extended square -> axis roots -> data root.

Port of celestia_app_tpu/da/eds.py:pipeline_fn. For one (k, k, 512) square:

  1. 2D Reed-Solomon extension to 2k x 2k (ops/rs.py, two K2 launches);
  2. all 2k row and 2k column NMT roots (ops/nmt.py), Q0 leaves namespaced
     by their own share prefix and parity leaves by PARITY_SHARE_NAMESPACE
     (pkg/wrapper/nmt_wrapper.go:93-114 semantics);
  3. the RFC-6962 Merkle root over rowRoots || colRoots, the data root
     (pkg/da/data_availability_header.go:100-107).

Everything stays on the device between stages; while a profiler records,
each stage sits in a row-less range (obs/spans.stage): ``eds.extend``,
``eds.leaves``, ``eds.trees``, ``eds.data_root``. `pipeline_batched` runs
B squares through the same launches (the port of jitted_pipeline_batched),
and `roots_only` / `roots_only_batched` are the same passes for a caller
that needs the commitments and not the square.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.obs import spans, xfer
from celestia_app_tpu_torch.ops import merkle, nmt, rs

NS = appconsts.NAMESPACE_SIZE


def _axis_leaf_ns(eds: torch.Tensor, k: int) -> torch.Tensor:
    """Leaf namespaces for row trees of an EDS (or of each EDS of a
    (B, 2k, 2k, 512) batch): own prefix in Q0, else parity.

    Symmetric under transpose (position (r, c) is in Q0 iff r < k and c < k),
    so the same function serves column trees on the transposed square."""
    idx = torch.arange(2 * k, device=eds.device)
    in_q0 = (idx[:, None] < k) & (idx[None, :] < k)  # (2k, 2k)
    return torch.where(in_q0.unsqueeze(-1), eds[..., :NS], nmt.parity_ns(eds.device))


def ods_on_device(ods, dev: torch.device, site: str = "eds.pipeline") -> torch.Tensor:
    """The ODS as a tensor on `dev`: a tensor already there is taken as it
    lies, anything else is copied through the transfer ledger under
    `site`."""
    if isinstance(ods, torch.Tensor) and ods.device == device_mod.concrete(dev):
        return ods
    # the asarray takes only a host value, on its way through the ledger
    return xfer.to_device(ods if isinstance(ods, torch.Tensor) else np.asarray(ods), site,  # lint: disable=xfer-reach
                          device=dev)


def _pipeline(ods: torch.Tensor):
    """(B, k, k, 512) on its device -> (eds, row_roots, col_roots,
    data_roots) of every square: (B, 2k, 2k, 512), (B, 2k, 90) twice,
    (B, 32). One extension (two K2 launches in GF(2^8)), one leaf launch,
    log2(2k) inner launches and 1 + log2(4k) Merkle launches of K1,
    whatever B is."""
    b, k = ods.shape[0], ods.shape[1]
    if ods.dtype != torch.uint8 or ods.shape[1:] != (k, k, appconsts.SHARE_SIZE):
        raise ValueError(f"ODS must be (k, k, 512) uint8, got {tuple(ods.shape[1:])} {ods.dtype}")
    with spans.stage("eds.extend"):
        eds = rs.extend_square_fn(k, ods.device)(ods)
    # Leaf (r, c) has the SAME preimage (0x00 || ns || share) in row tree
    # r and column tree c: hash the 2k x 2k leaf grid once and transpose
    # the digests for the column trees. One 4k-tree reduction per square,
    # all B squares in one, then covers both orientations, so each level's
    # SHA-256 launch sees every tree's messages.
    two_k = 2 * k
    with spans.stage("eds.leaves"):
        mins, maxs, vs = nmt.leaf_nodes(_axis_leaf_ns(eds, k).reshape(b * two_k, two_k, NS),
                                        eds.reshape(b * two_k, two_k, appconsts.SHARE_SIZE))

    def both(t: torch.Tensor) -> torch.Tensor:  # (B*2k, 2k, .) -> (B*4k, 2k, .)
        t = t.reshape(b, two_k, two_k, -1)
        return torch.cat([t, t.transpose(1, 2)], dim=1).reshape(2 * b * two_k, two_k, -1)

    with spans.stage("eds.trees"):
        axis_roots = nmt.roots_from_leaf_nodes(both(mins), both(maxs), both(vs)).reshape(b, 2 * two_k, -1)
    with spans.stage("eds.data_root"):
        data_roots = merkle.merkle_root_pow2(axis_roots)  # (B, 32)
    return eds, axis_roots[:, :two_k], axis_roots[:, two_k:], data_roots


def pipeline(
    ods: np.ndarray | torch.Tensor, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, k, 512) u8 ODS -> (eds, row_roots, col_roots, data_root) tensors
    on `device`: (2k, 2k, 512), (2k, 90), (2k, 90), (32,)."""
    ods = ods_on_device(ods, device_mod.resolve(device))
    if ods.dim() != 3:
        raise ValueError(f"ODS must be (k, k, 512) uint8, got {tuple(ods.shape)} {ods.dtype}")
    eds, rows, cols, roots = _pipeline(ods[None])
    return eds[0], rows[0], cols[0], roots[0]


def pipeline_batched(
    ods_batch: np.ndarray | torch.Tensor, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, k, k, 512) u8 -> (eds, row_roots, col_roots, data_roots) on
    `device`: (B, 2k, 2k, 512), (B, 2k, 90), (B, 2k, 90), (B, 32), the
    port of jitted_pipeline_batched (a vmap of the single-square program
    there). Every block is byte-equal to one `pipeline` call, and the batch
    takes the launches of one block: 2 K2 and 1 + log2(2k) + 1 + log2(4k)
    K1 (19 at k = 128)."""
    ods = ods_on_device(ods_batch, device_mod.resolve(device))
    if ods.dim() != 4 or ods.shape[0] < 1:
        raise ValueError(f"ODS batch must be (B, k, k, 512) uint8, got {tuple(ods.shape)} {ods.dtype}")
    return _pipeline(ods)


def roots_only(
    ods: np.ndarray | torch.Tensor, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, k, 512) u8 ODS -> (row_roots, col_roots, data_root) on `device`,
    without the extended square: the EDS is dropped on the device and never
    copied back."""
    _, row_roots, col_roots, data_root = pipeline(ods, device)
    return row_roots, col_roots, data_root


def roots_only_batched(
    ods_batch: np.ndarray | torch.Tensor, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`roots_only` over a (B, k, k, 512) batch: (B, 2k, 90) twice and
    (B, 32) on `device`."""
    _, row_roots, col_roots, data_roots = pipeline_batched(ods_batch, device)
    return row_roots, col_roots, data_roots
