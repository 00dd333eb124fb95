"""2D Reed-Solomon extension of the data square: the port of
celestia_app_tpu/ops/rs.py (GF(2^8), k <= 128) and of the pass schedule of
celestia_app_tpu/ops/rs_pallas.py:78-95.

    Q1 = RS-extend each row of Q0
    Q2 = RS-extend each column of Q0
    Q3 = RS-extend each row of Q2
    (specs/src/specs/data_structures.md "2D Reed-Solomon Encoding Scheme")

The square is extended in place in two launches of kernel K2
(ops/rs_kernel.py): rows and columns of Q0 together, then rows of Q2. K2
reads and writes the quadrants with strides, so no transpose or
concatenation is copied. GF(2^16) (k > 128) is not ported yet and raises.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.ops import leopard, rs_kernel


def operand_from_bit_matrix(mat: np.ndarray, device) -> torch.Tensor:
    """(8k, 8k) 0/1 matrix (``leopard.bit_matrix(k)``) -> K2's operand on
    `device`: (kpad, kpad) uint8, the matrix in its top-left block, zeros
    elsewhere (``rs_kernel.padded``)."""
    mat = np.asarray(mat)
    rows = mat.shape[0] if mat.ndim else 0
    if mat.ndim != 2 or mat.shape != (rows, rows) or rows % 8 or not rows:
        raise ValueError(f"bit matrix must be (8k, 8k), got {mat.shape}")
    if not np.isin(mat, (0, 1)).all():
        raise ValueError("bit matrix entries must be 0 or 1")
    side = rs_kernel.padded(rows // 8)
    out = np.zeros((side, side), dtype=np.uint8)
    out[:rows, :rows] = mat
    return torch.from_numpy(out).to(device)


def _concrete(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _operand(k: int, device: torch.device) -> torch.Tensor:
    return operand_from_bit_matrix(leopard.bit_matrix(k), device)


def bit_operand(k: int, device) -> torch.Tensor:
    """K2's operand for ``leopard.bit_matrix(k)`` on `device`, built and
    checked once per (k, device) and cached. Callers must not write to it."""
    return _operand(k, _concrete(device))


def extend_square_fn(
    k: int, device=None, operand: torch.Tensor | None = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """(k, k, 512) uint8 ODS -> (2k, 2k, 512) uint8 EDS, two K2 launches.

    `operand` is K2's operand (`operand_from_bit_matrix`); by default the
    cached one of the port's own ``leopard.bit_matrix(k)``."""
    if leopard.uses_gf16(k):
        raise ValueError("the port's RS extend covers the GF(2^8) field (k <= 128)")
    if k < 1 or k & (k - 1):
        raise ValueError(f"k must be a power of two, got {k}")
    dev = device_mod.resolve(device)
    if operand is None:
        operand = bit_operand(k, dev)

    def extend(ods: torch.Tensor) -> torch.Tensor:
        eds = torch.empty((2 * k, 2 * k, ods.shape[-1]), dtype=ods.dtype, device=ods.device)
        eds[:k, :k].copy_(ods)
        rs_kernel.extend_eds(eds, "rows_cols", operand)
        rs_kernel.extend_eds(eds, "q3", operand)
        return eds

    return extend
