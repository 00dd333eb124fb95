"""Malicious-proposer fixtures: blocks and entries that honest validators and
light nodes must reject. The port of celestia_app_tpu/testing/malicious.py.

Reference parity: test/util/malicious/ —
  tree.go:19-60            BlindTree: an NMT that skips namespace-ordering
                           verification (ForceAddLeaf instead of Push), so a
                           malicious proposer can still produce axis roots
                           over an invalid share ordering.
  out_of_order_builder.go  OutOfOrderExport: swaps two blobs in the square.
  out_of_order_prepare.go  OutOfOrderPrepareProposal: honest tx filtering,
                           malicious square + commitment.

The codec plane's producers commit an invalid codeword, so that sampling
alone verifies every symbol and only a BEFP or a peeling decoder's equation
audit can convict. Every producer that hashes or extends runs on `device`
(the card unless the caller asks for the CPU): K2 extends, K1 hashes.
``incorrect_coding_fixture`` is the one scheme-keyed hook the scenario plane
(sim/scenarios.py) drives."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.chain.block import Block
from celestia_app_tpu_torch.da import cmt, pcmt
from celestia_app_tpu_torch.da import dah as dah_mod
from celestia_app_tpu_torch.da import edscache as edscache_mod
from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.ops import ldpc, nmt, polar, rs
from celestia_app_tpu_torch.utils import nmt_host


class BlindNmtTree(nmt_host.NmtTree):
    """NMT that accepts leaves in any namespace order (malicious/tree.go)."""

    def push(self, ns: bytes, data: bytes) -> None:  # ForceAddLeaf
        self.leaves.append((ns, data))


def swap_first_two_blobs(square) -> list[bytes]:
    """Square share list with the first two blobs' share ranges swapped
    (OutOfOrderExport, out_of_order_builder.go:62-79). Requires >= 2 blobs."""
    shares = list(square.share_bytes())
    keys = sorted(square.blob_start_indexes.keys())
    if len(keys) < 2:
        raise ValueError("need at least two blobs to swap")
    (i0, j0), (i1, j1) = keys[0], keys[1]
    s0 = square.blob_start_indexes[(i0, j0)]
    c0 = square.pfbs[i0].blobs[j0].share_count()
    s1 = square.blob_start_indexes[(i1, j1)]
    c1 = square.pfbs[i1].blobs[j1].share_count()
    if c0 != c1:
        # swap equal-length prefixes so the layout geometry stays identical
        c0 = c1 = min(c0, c1)
    a, b = shares[s0:s0 + c0], shares[s1:s1 + c1]
    shares[s0:s0 + c0], shares[s1:s1 + c1] = b, a
    return shares


def blind_dah(ods: np.ndarray, device=None):
    """(DAH, data root) over an (invalidly ordered) ODS, as blind trees give
    them: one `eds.pipeline` pass on `device`. Its NMT takes the true min and
    max of the children's namespaces and checks no order (ops/nmt.py), which
    is what a BlindNmtTree's host hash computes; an honest NmtTree would
    raise on the same leaves."""
    dah, _eds, root = dah_mod.new_dah_from_ods(ods, device)
    return dah, root


def out_of_order_prepare(app, raw_txs: list[bytes], t: float) -> Block:
    """Malicious PrepareProposal: honest filtering and square build, then the
    first two blobs swapped and the data root recomputed with blind trees
    (out_of_order_prepare.go:18-76), on the App's device."""
    honest = app.prepare_proposal(raw_txs, t=t)
    sq = honest.square if hasattr(honest, "square") else None
    block = honest.block if hasattr(honest, "block") else honest
    if sq is None:
        raise ValueError("prepare_proposal result carries no square")
    shares = swap_first_two_blobs(sq)
    ods = dah_mod.shares_to_ods(shares)
    _, root = blind_dah(ods, app.device)
    # replace ONLY the data root: every other header field stays honest, so
    # ProcessProposal's rejection exercises the data-root check alone
    forged = dataclasses.replace(block.header, data_hash=root)
    return Block(header=forged, txs=block.txs)


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


def incorrect_coding_fixture(scheme: str, ods: np.ndarray, device=None):
    """THE scheme-keyed committed-non-codeword fixture: returns (entry,
    location, withheld_cells, wire_id) for any registered scheme, built on
    `device`. ``location`` is what the scheme's repair provably raises;
    ``withheld_cells`` is a quarter-ish withholding set that forces samplers
    to escalate while keeping the fraud location's members served (the proof
    must stay assemblable from served symbols)."""
    k = ods.shape[0]
    if scheme == "rs2d-nmt":
        entry = rs2d_bad_parity_entry(ods, row=1, device=device)
        # half the bad row withheld: samplers escalate, yet the
        # orthogonal-proof BEFP still finds its k members
        return entry, ("row", 1), [(1, j) for j in range(k)], 0
    if scheme == "cmt-ldpc":
        bad_eq = 3
        entry = cmt_bad_parity_entry(ods, equation=bad_eq, device=device)
        comm = entry.commitments
        members = set(cmt.equation_members(comm, 0, bad_eq))
        candidates = [i for i in range(comm.n_base) if i not in members]
        withheld = [(0, i) for i in candidates[: comm.n_base // 4]]
        return entry, (0, bad_eq), withheld, 1
    if scheme == "pcmt-polar":
        entry = pcmt_bad_parity_entry(ods, device=device)
        location = entry.fraud_location
        comm = entry.commitments
        members = set(pcmt.equation_members(comm, location[0], location[1]))
        candidates = [i for i in range(comm.n_base) if i not in members]
        withheld = [(0, i) for i in candidates[: comm.n_base // 4]]
        return entry, location, withheld, 2
    raise ValueError(f"no malicious fixture for scheme {scheme!r}")


def rs2d_bad_parity_entry(ods: np.ndarray, row: int = 1, xor_byte: int = 0x5A,
                          device=None) -> edscache_mod.EdsCacheEntry:
    """Malicious 2D-RS producer: extend honestly on `device` (K2), corrupt
    parity cell (row, k + 2), and commit NMT trees over the RESULT (K1,
    ``ops/nmt.eds_axis_roots``) — a committed non-codeword whose samples all
    verify, convictable only by a BEFP. 2 K2 and 2 (1 + log2 2k) K1
    launches."""
    dev = device_mod.resolve(device)
    k = ods.shape[0]
    eds = rs.extend_square_fn(k, dev)(xfer.to_device(
        np.ascontiguousarray(ods, dtype=np.uint8), "malicious.rs2d_bad_parity_entry", device=dev))
    eds[row, k + 2] ^= xor_byte
    axes = range(2 * k)
    rows = nmt.eds_axis_roots(eds, axes, k, dev)
    cols = nmt.eds_axis_roots(eds.transpose(0, 1), axes, k, dev)
    dah = dah_mod.DataAvailabilityHeader(
        row_roots=tuple(bytes(r) for r in rows),
        col_roots=tuple(bytes(c) for c in cols),
    )
    eds_h = xfer.to_host(eds, "malicious.rs2d_bad_parity_entry")
    return edscache_mod.EdsCacheEntry(dah_mod.ExtendedDataSquare(eds_h), dah, dah.hash())
