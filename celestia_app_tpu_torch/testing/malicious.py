"""Malicious producers of the codec plane: entries that commit an invalid
codeword, so that sampling alone verifies every symbol and only a peeling
decoder's equation audit can convict. The port of
celestia_app_tpu/testing/malicious.py's cmt_bad_parity_entry (:101) and
pcmt_bad_parity_entry (:135); the rest of that module is not ported."""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da import cmt, pcmt
from celestia_app_tpu_torch.ops import ldpc, polar


def cmt_bad_parity_entry(ods: np.ndarray, equation: int, xor_byte: int = 0x5A,
                         device=None) -> cmt.CmtEntry:
    """Encode the ODS honestly on `device` (the card unless the caller asks
    for the CPU), flip `xor_byte` into the first byte of base-layer parity
    symbol `equation` before hashing, and commit a self-consistent tree over
    the corrupt base: the fraud is at (0, equation)."""
    dev = device_mod.resolve(device)
    k = ods.shape[0]
    data = ldpc.to_device(cmt.ods_symbols(ods), dev)
    base = torch.cat([data, ldpc.encode(data, dev)])
    base[k * k + equation, 0] ^= xor_byte
    return cmt.build_from_base(k, base, dev)


def pcmt_bad_parity_entry(ods: np.ndarray, equation: int | None = None, xor_byte: int = 0x5A,
                          device=None) -> pcmt.PcmtEntry:
    """Polar-encode the ODS honestly on `device` (the card unless the caller
    asks for the CPU), corrupt one non-data committed class before hashing
    and grow the whole tree over the result. With ``equation`` the corrupt
    class is that check's lowest non-data member; by default the lowest
    check-constrained non-data class. The provable location, (0, the lowest
    check holding the corrupt class), is ``entry.fraud_location``."""
    dev = device_mod.resolve(device)
    k = ods.shape[0]
    g = polar.geometry(k * k)
    base = polar.encode(cmt.ods_symbols(ods), dev)
    is_data = np.zeros(g.C, dtype=bool)
    is_data[g.data_class] = True
    if equation is None:
        in_check = np.zeros(g.C, dtype=bool)
        in_check[g.checks.ravel()] = True
        target = int(np.flatnonzero(~is_data & in_check)[0])
    else:
        cand = [int(x) for x in g.checks[equation] if not is_data[x]]
        if not cand:
            raise ValueError(f"check {equation} has only data members; pick another")
        target = min(cand)
    base[target, 0] ^= xor_byte
    entry = pcmt.build_from_base(ods, base, dev)
    entry.fraud_location = (0, int(np.flatnonzero((g.checks == target).any(axis=1))[0]))
    return entry
