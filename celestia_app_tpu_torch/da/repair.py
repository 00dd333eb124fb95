"""2D EDS repair: rebuild a damaged extended square from any sufficient
subset of its shares, verifying every axis against its committed NMT root.
The port of celestia_app_tpu/da/repair.py.

Reference parity: rsmt2d's `ExtendedDataSquare.Repair` (repair.go
`solveCrossword`), the crossword fixpoint: any row or column with at least
k of its 2k shares is decoded, its NMT root is recomputed and compared with
the DAH's root, and the recovered shares unlock further axes, until nothing
changes.

Two engines give the same bytes, the same error and the same attribution:

- **batched** (default): the sweep engine, with the square on the device
  across sweeps (one upload, one download). Per sweep and orientation, the
  unverified axes are grouped by erasure pattern, and every group, a group
  of one included, is decoded in one `ops/rs.repair_axes_fn` call (2
  launches of K2 on the card in GF(2^8), one int8 product in GF(2^16)). The roots of every axis completed in the
  phase are one `ops/nmt.eds_axis_roots` reduction (K1, 1 + log2(2k)
  launches), and the fully-present axes' codeword check is one more
  `repair_axes_fn` call over the pattern "all present" (2 launches of K2).
- **scalar** (engine="scalar"): the per-axis host reference, Leopard's
  FWHT decode (ops/rs.repair_axis) and a hashlib NMT per axis.

The erasure mask stays on the host: it is the control state the host
groups patterns by. No share data crosses to the host before the result.

Byzantine detection: with authentic input shares (each proven against the
DAH by the caller, as in DAS), a root mismatch on a repaired or fully
present axis means the producer committed a non-codeword, and the raised
`BadEncodingError` carries the (axis, index) that `da/fraud.generate_befp`
needs. Root gating alone does not suffice under batching: the decode
re-encodes from the first k sorted present positions, and a corrupt
present share outside that use set would leave a root that matches the
committed non-codeword. So the batched engine compares the re-encode with
every present position; an axis that disagrees holds inconsistent shares
and takes the FWHT decoder's own linear map instead
(`RepairAxes.decode_fwht`, K2 on the same device), so its bytes, and its
root verdict, are the scalar engine's. Only the missing positions of an
axis are written back. Attribution is deterministic in both engines: rows
before columns within a sweep, each in ascending index order, and for a
fully-present axis the codeword check before the root check.

Spans and telemetry are the reference's: every sweep is a
``da.repair.sweep`` span and every batched verification a
``da.repair.verify_roots`` span, written to the `traces` the caller passes
(a light node passes its own TraceTables); decoded axes count in
``repair.axes_batched``, ``repair.axes_scalar`` and
``repair.inconsistent_axes``. The same counts stay in the module's plain
`counters` dict. The batched engine decodes an inconsistent axis on the
device too, so its ``repair.axes_batched`` counts every axis it decoded,
inconsistent ones included. The reference's CELESTIA_REPAIR_ENGINE and
CELESTIA_REPAIR_MIN_BATCH settings are not read (the `engine` argument
picks the engine).
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts, obs
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da import fraud
from celestia_app_tpu_torch.ops import leopard, nmt, rs
from celestia_app_tpu_torch.utils import nmt_host, telemetry

NS = appconsts.NAMESPACE_SIZE
SHARE = appconsts.SHARE_SIZE

counters = {"axes_batched": 0, "axes_scalar": 0, "inconsistent_axes": 0}


def _count(name: str, by: int) -> None:
    """One count in both the module's `counters` and the ``repair.*``
    telemetry."""
    counters[name] += by
    telemetry.incr(f"repair.{name}", by)


class BadEncodingError(Exception):
    """A verified-share axis failed its committed root: the producer
    committed a non-codeword (rsmt2d ErrByzantineData). Carries what
    generate_befp needs to build the fraud proof."""

    def __init__(self, axis: str, index: int):
        self.axis = axis
        self.index = index
        super().__init__(
            f"{axis} {index} does not match its committed root: "
            "the square is not a valid codeword (bad encoding)"
        )


def _axis_root(slab: np.ndarray, axis: str, index: int, k: int) -> bytes:
    """The root of one full axis of 2k shares on the host, with the leaf
    namespace rule of the fraud prover (da/fraud.leaf_ns): repair and BEFP
    verification must agree on the leaves."""
    tree = nmt_host.NmtTree()
    for j in range(2 * k):
        r, c = (index, j) if axis == "row" else (j, index)
        share = slab[j].tobytes()
        tree.leaves.append((fraud.leaf_ns(r, c, share, k), share))
    return nmt_host.serialize(tree.root())


def _validate(symbols, present, row_roots, col_roots):
    symbols = np.array(symbols, dtype=np.uint8, copy=True)
    present = np.array(present, dtype=bool, copy=True)
    two_k = symbols.shape[0]
    if symbols.shape != (two_k, two_k, SHARE):
        raise ValueError(f"bad square shape {symbols.shape}")
    if present.shape != (two_k, two_k):
        raise ValueError(f"bad mask shape {present.shape}")
    if len(row_roots) != two_k or len(col_roots) != two_k:
        raise ValueError("need 2k row roots and 2k col roots")
    return symbols, present, two_k


def _unsolvable(present: np.ndarray) -> ValueError:
    missing = int((~present).sum())
    return ValueError(
        f"unsolvable erasure pattern: {missing} shares still "
        "missing and no row or column has k known shares"
    )


def repair_eds(
    symbols: np.ndarray,
    present: np.ndarray,
    row_roots: list[bytes],
    col_roots: list[bytes],
    *,
    engine: str = "batched",
    device=None,
    field: int | None = None,
    traces=None,
) -> np.ndarray:
    """Rebuild the full (2k, 2k, 512) EDS from the shares marked present.

    `symbols` may hold anything at missing positions; `present` is the
    (2k, 2k) bool mask of authentic shares. Raises ValueError when the
    erasure pattern is unsolvable, BadEncodingError when a completed axis
    contradicts its committed root. Returns the repaired square as a host
    array; on success every row and column root has been verified.

    `engine` picks "batched" (the sweep engine on `device`: the card
    unless the caller asks for the CPU) or "scalar" (the per-axis host
    reference, which uses no device). `field` forces the code's field
    (8 or 16 bits); by default the protocol's choice for k, so squares
    wider than 128 decode in GF(2^16). `traces` pins the span sink (a
    light node passes its own TraceTables)."""
    if engine not in ("batched", "scalar"):
        raise ValueError(f"repair engine must be 'batched' or 'scalar', not {engine!r}")
    symbols, present, two_k = _validate(symbols, present, row_roots, col_roots)
    field = leopard.field_for(two_k // 2, field)
    if engine == "scalar":
        return _repair_scalar(symbols, present, row_roots, col_roots, two_k, field, traces)
    return _repair_batched(symbols, present, row_roots, col_roots, two_k,
                           device_mod.resolve(device), field, traces)


# ---------------------------------------------------------------------------
# scalar engine: the per-axis host reference (FWHT decode + hashlib NMT)
# ---------------------------------------------------------------------------


def _repair_scalar(symbols, present, row_roots, col_roots, two_k, field, traces) -> np.ndarray:
    k = two_k // 2
    verified_rows = [False] * two_k
    verified_cols = [False] * two_k

    def _is_codeword(slab: np.ndarray) -> bool:
        """rsmt2d's re-encode check: a fully-present axis must itself be a
        codeword (re-extend its systematic half, demand byte identity);
        committed trees over a non-codeword match their own leaves, so a
        root match alone would let it through."""
        rec = rs.repair_axis(slab, list(range(k)), field)
        return bool(np.array_equal(rec.reshape(two_k, SHARE), np.asarray(slab)))

    def _finish_row(r: int, check_rs: bool = False) -> None:
        if check_rs and not _is_codeword(symbols[r]):
            raise BadEncodingError("row", r)
        if _axis_root(symbols[r], "row", r, k) != row_roots[r]:
            raise BadEncodingError("row", r)
        verified_rows[r] = True

    def _finish_col(c: int, check_rs: bool = False) -> None:
        if check_rs and not _is_codeword(symbols[:, c, :]):
            raise BadEncodingError("col", c)
        if _axis_root(symbols[:, c, :], "col", c, k) != col_roots[c]:
            raise BadEncodingError("col", c)
        verified_cols[c] = True

    sweep = 0
    while True:
        sweep += 1
        progress = False
        with obs.span("da.repair.sweep", traces=traces, engine="scalar", sweep=sweep):
            for r in range(two_k):
                if verified_rows[r]:
                    continue
                n = int(present[r].sum())
                if n == two_k:
                    _finish_row(r, check_rs=True)
                    progress = True
                elif n >= k:
                    rec = rs.repair_axis(symbols[r], list(np.flatnonzero(present[r])), field)
                    symbols[r] = rec.reshape(two_k, SHARE)
                    _count("axes_scalar", 1)
                    _finish_row(r)
                    present[r] = True
                    progress = True
            for c in range(two_k):
                if verified_cols[c]:
                    continue
                n = int(present[:, c].sum())
                if n == two_k:
                    _finish_col(c, check_rs=True)
                    progress = True
                elif n >= k:
                    rec = rs.repair_axis(symbols[:, c, :], list(np.flatnonzero(present[:, c])), field)
                    symbols[:, c, :] = rec.reshape(two_k, SHARE)
                    _count("axes_scalar", 1)
                    _finish_col(c)
                    present[:, c] = True
                    progress = True
        if all(verified_rows) and all(verified_cols):
            return symbols
        if not progress:
            raise _unsolvable(present)


# ---------------------------------------------------------------------------
# batched engine: the square on the device, per-pattern K2 decode and
# per-phase batched verification
# ---------------------------------------------------------------------------


def _select(axes: list[int], device: torch.device):
    """Axis selector: a slice for consecutive indices (a view, no upload),
    else an index tensor."""
    if axes == list(range(axes[0], axes[0] + len(axes))):
        return slice(axes[0], axes[0] + len(axes))
    return torch.tensor(axes, dtype=torch.int64, device=device)


def _take(sym: torch.Tensor, axis: str, sel) -> torch.Tensor:
    """(n, 2k, 512) slabs of the selected rows or columns (columns as a
    transposed view)."""
    if isinstance(sel, slice):
        return sym[sel] if axis == "row" else sym[:, sel].transpose(0, 1)
    return sym.index_select(0, sel) if axis == "row" else sym.index_select(1, sel).transpose(0, 1)


def _put_missing(sym: torch.Tensor, axis: str, sel, missing: torch.Tensor, values: torch.Tensor) -> None:
    """Writes values (n, m, 512) at the m missing positions of the selected axes."""
    if axis == "row":
        if isinstance(sel, slice):
            sym[sel][:, missing] = values
        else:
            sym[sel[:, None], missing[None, :]] = values
    elif isinstance(sel, slice):
        sym[:, sel][missing] = values.transpose(0, 1)
    else:
        sym[missing[:, None], sel[None, :]] = values.transpose(0, 1)


def _equal_per_axis(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """(n, m, 512) x (n, m, 512) -> (n,) host bools: axis b equal in a and b."""
    return (a == b).flatten(1).all(dim=1).cpu().numpy()


def _decode_phase(sym, present, axis: str, verified, two_k: int, field: int) -> tuple:
    """Decode every repairable axis of one orientation. Returns
    (completed, full_set): `completed` is the ascending list of axis
    indices now holding all 2k shares (decoded in this phase or fully
    present on entry), `full_set` those that were fully present (they owe
    the codeword check)."""
    k = two_k // 2
    counts = present.sum(axis=1) if axis == "row" else present.sum(axis=0)
    full, patterns = [], {}
    for i in range(two_k):
        if verified[i]:
            continue
        n = int(counts[i])
        if n == two_k:
            full.append(i)
        elif n >= k:
            mask = present[i] if axis == "row" else present[:, i]
            patterns.setdefault(tuple(np.flatnonzero(mask).tolist()), []).append(i)
    decoded = []
    for pattern, axes in patterns.items():
        # one decode and re-encode for the whole group. The re-encode from
        # the first k sorted present positions must reproduce every present
        # share (at the use positions it does by construction): an axis
        # that disagrees holds inconsistent authentic shares, and takes the
        # FWHT decode's own map so that its bytes, and its root verdict,
        # are the scalar engine's. Only missing positions are written back.
        run = rs.repair_axes_fn(k, pattern, sym.device, field)
        sel = _select(axes, sym.device)
        batch = _take(sym, axis, sel)
        out = run(batch)
        ok = _equal_per_axis(out.index_select(1, run.present_index),
                             batch.index_select(1, run.present_index))
        values = out.index_select(1, run.missing_index)
        bad = np.flatnonzero(~ok)
        if bad.size:
            pick = torch.from_numpy(bad).to(sym.device)
            values.index_copy_(0, pick, run.decode_fwht(batch.index_select(0, pick)))
            _count("inconsistent_axes", int(bad.size))
        _put_missing(sym, axis, sel, run.missing_index, values)
        _count("axes_batched", len(axes))
        decoded += axes
    return sorted(full + decoded), set(full)


def _verify_phase(sym, present, axis: str, verified, roots, completed, full_set, two_k: int,
                  field: int, traces) -> bool:
    """Batched verification of every axis completed in this phase: one
    eds_axis_roots reduction recomputes all their roots, one decode over
    the pattern "all present" covers the fully-present axes' codeword
    checks. Raises BadEncodingError at the lowest failing index
    (fully-present axes fail their codeword check before their root
    check, as in the scalar engine)."""
    if not completed:
        return False
    k = two_k // 2
    slabs = _take(sym, axis, _select(completed, sym.device))
    with obs.span("da.repair.verify_roots", traces=traces, axis=axis, axes=len(completed)):
        codeword_ok = {}
        if full_set:
            ordered = sorted(full_set)
            if len(ordered) == len(completed):
                full_slabs = slabs
            else:
                pos = {i: b for b, i in enumerate(completed)}
                pick = torch.tensor([pos[i] for i in ordered], dtype=torch.int64, device=sym.device)
                full_slabs = slabs.index_select(0, pick)
            rec = rs.repair_axes_fn(k, tuple(range(two_k)), sym.device, field)(full_slabs)
            codeword_ok = dict(zip(ordered, _equal_per_axis(rec, full_slabs)))
        got = nmt.eds_axis_roots(slabs, completed, k, sym.device)
    for b, i in enumerate(completed):
        if i in full_set and not codeword_ok[i]:
            raise BadEncodingError(axis, i)
        if got[b].tobytes() != roots[i]:
            raise BadEncodingError(axis, i)
        verified[i] = True
        if axis == "row":
            present[i] = True
        else:
            present[:, i] = True
    return True


def _repair_batched(symbols, present, row_roots, col_roots, two_k, device, field, traces) -> np.ndarray:
    sym = torch.from_numpy(symbols).to(device)
    verified_rows = [False] * two_k
    verified_cols = [False] * two_k
    sweep = 0
    while True:
        sweep += 1
        progress = False
        with obs.span("da.repair.sweep", traces=traces, engine="batched", sweep=sweep) as sp:
            for axis, verified, roots in (("row", verified_rows, row_roots),
                                          ("col", verified_cols, col_roots)):
                completed, full_set = _decode_phase(sym, present, axis, verified, two_k, field)
                if _verify_phase(sym, present, axis, verified, roots, completed, full_set, two_k, field,
                                 traces):
                    progress = True
            sp.set(progress=progress)
        if all(verified_rows) and all(verified_cols):
            return sym.cpu().numpy()
        if not progress:
            raise _unsolvable(present)
