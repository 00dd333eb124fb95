"""The reference commitment of one original data square: extended square,
axis roots and data root, all computed here from the ODS alone."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import leopard, nmt, sha256


@dataclasses.dataclass
class Commitment:
    """Of B squares: (B, 2k, 2k, 512), (B, 2k, 90) twice, (B, 32), uint8."""

    eds: torch.Tensor
    row_roots: torch.Tensor
    col_roots: torch.Tensor
    data_root: torch.Tensor


def commit(ods: torch.Tensor, hash_fn: nmt.HashFn = sha256.digest, bits: int | None = None,
           control: bool = False) -> Commitment:
    """(B, k, k, 512) uint8 ODSs on any device -> their Commitment there.
    `bits` forces a field (the protocol's choice by default); `control`
    encodes with the control's code (reference/leopard.CONTROL_FIELDS)."""
    eds = torch.stack([leopard.extend_square(o, bits=bits, control=control) for o in ods])
    rows, cols = nmt.axis_roots(eds, hash_fn)
    return Commitment(eds, rows, cols, nmt.data_root(rows, cols, hash_fn))
