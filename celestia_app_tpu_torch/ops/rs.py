"""2D Reed-Solomon extension of the data square: the port of
celestia_app_tpu/ops/rs.py (both fields) and of the pass schedule of
celestia_app_tpu/ops/rs_pallas.py:78-95.

    Q1 = RS-extend each row of Q0
    Q2 = RS-extend each column of Q0
    Q3 = RS-extend each row of Q2
    (specs/src/specs/data_structures.md "2D Reed-Solomon Encoding Scheme")

GF(2^8) (k <= 128): the square is extended in place in two launches of
kernel K2 (ops/rs_kernel.py): rows and columns of Q0 together, then rows
of Q2. K2 reads and writes the quadrants with strides, so no transpose or
concatenation is copied, and a batch of B squares takes the same two
launches.

GF(2^16) (k >= 256, or any k with ``field=16``): shares are 256
little-endian uint16 symbols and each pass is one GF(2) product of the
(16k, 16k) bit matrix ``leopard.bit_matrix16(k)`` with the symbols' bits.
The TPU ran it as plain XLA (its Pallas pass covers the 8-bit field), so
here it is `torch._int_mm` (int8 x int8 -> int32): the inner dimension is
16k (8,192 at k = 512), and only an exact sum may be taken mod 2 (an fp16
or bf16 output would round sums above 2,048 or 256). The lines of a pass
go through in chunks that bound the int32 product (`GF16_CHUNK_BYTES`).

`field` forces a field where the protocol's choice (``leopard.field_for``)
is not wanted: the tests run the 16-bit code at small k with it, as the
reference's tests do with CELESTIA_GF16_THRESHOLD. Every cache is keyed on
the resolved field.

The repair side (the port of the reference module's host decode and of
`repair_axes_fn`): `repair_axis` is Leopard's FWHT decode of one axis on
the host, `repair_axis_matrix` the independent matrix-inversion decode,
and `repair_axes_fn(k, present)` the batched decode of every axis that
shares one erasure pattern, on the card (through K2 in GF(2^8), through
the int8 product in GF(2^16)). The reference's batch padding and its
compiled-shape gate existed because jax.jit compiles per shape; nothing
compiles here, so neither is ported.
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Callable

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.ops import leopard, leopard_decode, rs_kernel

SHARE = rs_kernel.SHARE
SYMBOLS = SHARE // 2  # uint16 symbols per share in GF(2^16)
GF16_CHUNK_BYTES = 1 << 29  # the int32 product of one chunk of lines at most


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


@functools.lru_cache(maxsize=None)
def _operand(k: int, device: torch.device) -> torch.Tensor:
    return operand_from_bit_matrix(leopard.bit_matrix(k), device)


def bit_operand(k: int, device) -> torch.Tensor:
    """K2's operand for ``leopard.bit_matrix(k)`` on `device`, built and
    checked once per (k, device) and cached. Callers must not write to it."""
    return _operand(k, device_mod.concrete(device))


def bit_matrix16_on(labels: np.ndarray, device) -> torch.Tensor:
    """``leopard.to_bit_matrix16(labels)`` built on `device`: the host
    computes the (r, c, 16) products ``leopard.bit_products16`` (2 bytes per
    16 bits of the expansion) and the bit planes are cut on the device, one
    plane per step, so the upload is an eighth of the (16r, 16c) int8
    matrix and no host copy of it is made."""
    prod = torch.from_numpy(leopard.bit_products16(labels).view(np.int16)).to(device)
    r, c = prod.shape[:2]
    out = torch.empty((r, 16, c, 16), dtype=torch.int8, device=prod.device)
    for i in range(16):  # the arithmetic shift of int16 leaves bit i at bit 0
        out[:, i] = (prod >> i) & 1
    return out.reshape(16 * r, 16 * c)


@functools.lru_cache(maxsize=None)
def _operand16(k: int, device: torch.device) -> torch.Tensor:
    return bit_matrix16_on(leopard.encode_matrix16(k), device)


def bit_operand16(k: int, device) -> torch.Tensor:
    """``leopard.bit_matrix16(k)`` as a (16k, 16k) int8 0/1 tensor on
    `device`, built once per (k, device) and cached. Callers must not
    write to it."""
    return _operand16(k, device_mod.concrete(device))


bit_operand16.cache_clear = _operand16.cache_clear


def bytes_to_bits16(x: torch.Tensor) -> torch.Tensor:
    """(..., n, 512) uint8 shares -> (..., 256, 16n) int8 bits of their
    little-endian uint16 symbols: row p is symbol position p, column
    16l + b is bit b of shard l's symbol (bit b % 8 of byte 2p + b // 8).
    The reference's ``bytes_to_bits16`` layout, transposed: the left
    operand of the product."""
    n = x.shape[-2]
    sym = x.reshape(*x.shape[:-2], n, SYMBOLS, 2).movedim(-2, -3)  # (..., 256, n, 2)
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (sym.unsqueeze(-1) >> shifts) & 1  # (..., 256, n, 2, 8)
    return bits.reshape(*x.shape[:-2], SYMBOLS, 16 * n).view(torch.int8)


def bits_to_bytes16(b: torch.Tensor) -> torch.Tensor:
    """Inverse of `bytes_to_bits16` on integer bits (only bit 0 of each
    entry is read): (..., 256, 16n) -> (..., n, 512) uint8."""
    n = b.shape[-1] // 16
    bits = (b & 1).to(torch.uint8).reshape(*b.shape[:-1], n, 2, 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=b.device)
    by = (bits << shifts).sum(dim=-1, dtype=torch.uint8)  # (..., 256, n, 2)
    return by.movedim(-3, -2).reshape(*b.shape[:-2], n, SHARE)


def gf16_mix(src: torch.Tensor, matrix: torch.Tensor, dst: torch.Tensor) -> None:
    """The GF(2^16) product of lines, the 16-bit pass: dst <- M ·gf src
    line by line, with `matrix` the (16m, 16s) int8 0/1 bit matrix M,
    `src` (n, s, 512) and `dst` (n, m, 512) uint8 views (any strides; dst
    is written in place). One `torch._int_mm` per chunk of lines: the bits
    of the chunk's symbols (rows) against M^T as a column-major view, an
    exact int32 sum of at most 16s ones, then & 1 and the pack."""
    n, s = src.shape[:2]
    m = dst.shape[1]
    if matrix.shape != (16 * m, 16 * s) or matrix.dtype != torch.int8:
        raise ValueError(f"matrix must be ({16 * m}, {16 * s}) int8, got "
                         f"{tuple(matrix.shape)} {matrix.dtype}")
    per = max(1, GF16_CHUNK_BYTES // (SYMBOLS * 16 * m * 4))
    for lo in range(0, n, per):
        x = bytes_to_bits16(src[lo:lo + per]).reshape(-1, 16 * s)
        acc = torch._int_mm(x, matrix.t())  # (lines * 256, 16m) int32
        dst[lo:lo + per] = bits_to_bytes16(acc.view(-1, SYMBOLS, 16 * m))


def extend_square_fn(
    k: int, device=None, operand: torch.Tensor | None = None, field: int | None = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """(k, k, 512) uint8 ODS -> (2k, 2k, 512) uint8 EDS, or a batch
    (B, k, k, 512) -> (B, 2k, 2k, 512).

    GF(2^8): two K2 launches whatever B is. `operand` is K2's operand
    (`operand_from_bit_matrix`); by default the cached one of the port's
    own ``leopard.bit_matrix(k)``. GF(2^16): three passes of `gf16_mix`
    per square (`operand` is not taken)."""
    field = leopard.field_for(k, field)
    dev = device_mod.resolve(device)
    if field == 16:
        if operand is not None:
            raise ValueError("operand is K2's, which computes the GF(2^8) code")
        matrix = bit_operand16(k, dev)
    elif operand is None:
        operand = bit_operand(k, dev)

    def extend(ods: torch.Tensor) -> torch.Tensor:
        lead = ods.shape[:-3]
        if ods.shape[-3:] != (k, k, SHARE) or len(lead) > 1:
            raise ValueError(f"ODS must be ({k}, {k}, {SHARE}) or (B, {k}, {k}, {SHARE}), "
                             f"got {tuple(ods.shape)}")
        eds = torch.empty((*lead, 2 * k, 2 * k, ods.shape[-1]), dtype=ods.dtype, device=ods.device)
        eds[..., :k, :k, :].copy_(ods)
        if field == 8:
            rs_kernel.extend_eds(eds, "rows_cols", operand)
            rs_kernel.extend_eds(eds, "q3", operand)
            return eds
        for sq in eds.reshape(-1, 2 * k, 2 * k, ods.shape[-1]):
            gf16_mix(sq[:k, :k], matrix, sq[:k, k:])
            gf16_mix(sq[:k, :k].transpose(0, 1), matrix, sq[k:, :k].transpose(0, 1))
            gf16_mix(sq[k:, :k], matrix, sq[k:, k:])
        return eds

    return extend


class RepairAxes:
    """The batched decode of one erasure pattern on one device.

    GF(2^8): `fused_decode_matrix(k, use)` (2k x k labels, use = the first
    k sorted present positions) expands to a (16k, 8k) GF(2) matrix in the
    bit order of ``leopard.to_bit_matrix`` (row 8 * shard + bit,
    LSB-first). Its top half gives shards [0, k) and its bottom half
    shards [k, 2k) from the k use shards, so each half is an ordinary K2
    operand. GF(2^16): the (32k, 16k) expansion (``to_bit_matrix16``) is
    one `gf16_mix` matrix, `decode16`. `decode_fwht` gives the FWHT
    decoder's bytes instead, for axes whose present shares disagree with
    the re-encode. Built once per (k, pattern, device, field) by
    `repair_axes_fn`; callers must not write to its tensors."""

    def __init__(self, k: int, present: tuple[int, ...], device: torch.device,
                 field: int | None = None):
        self.field = leopard.field_for(k, field)
        if len(present) < k:
            raise ValueError(f"need at least {k} of {2 * k} symbols")
        self.k = k
        self.present = tuple(sorted(present))
        self.use = self.present[:k]
        self.missing = tuple(sorted(set(range(2 * k)) - set(present)))
        self.device = device
        fused = leopard_decode.fused_decode_matrix(k, self.use, self.field)
        if self.field == 16:
            self.decode16 = bit_matrix16_on(fused, device)
        else:
            bits = leopard.to_bit_matrix(fused)
            self.top = operand_from_bit_matrix(bits[: 8 * k], device)
            self.bottom = operand_from_bit_matrix(bits[8 * k:], device)
        # index tensors built once: each upload from host memory syncs the stream
        self.use_index = torch.tensor(self.use, dtype=torch.int64, device=device)
        self.present_index = torch.tensor(self.present, dtype=torch.int64, device=device)
        self.missing_index = torch.tensor(self.missing, dtype=torch.int64, device=device)
        self._fwht = None  # decode_fwht's operands, built on its first call

    def __call__(self, batch: torch.Tensor, mesh=None) -> torch.Tensor:
        """(n, 2k, 512) uint8 axes on this device, any strides, anything at
        the missing positions -> (n, 2k, 512) full codewords re-encoded from
        the use positions, in a fresh tensor: one gather of the use shards
        into a contiguous (n, k, 512) source (K2 needs one shard stride),
        then two launches of K2, one per operand half (in GF(2^16), one
        `gf16_mix`).

        The output is the re-encode: where the input holds more than k
        present shares, the extra ones are overwritten, not passed through
        (da/repair.py compares them to detect inconsistent axes).

        When the mesh plane is active for k (`mesh`, a parallel/mesh.Mesh,
        or ``None`` for the auto rule: parallel/mesh_engine), the batch is
        split over the mesh's flat device list and each part decodes on its
        own device with that device's operands (two K2 launches per part);
        the parts are gathered on this device."""
        k = self.k
        if batch.dtype != torch.uint8 or batch.dim() != 3 or batch.shape[1:] != (2 * k, SHARE):
            raise ValueError(f"batch must be (n, {2 * k}, {SHARE}) uint8, got "
                             f"{tuple(batch.shape)} {batch.dtype}")
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, decode operands on {self.device}")
        from celestia_app_tpu_torch.parallel import mesh_engine

        parts = mesh_engine.maybe_shard_batch(batch, k, mesh, self.device)
        if parts is not None:
            return mesh_engine.gather(
                [repair_axes_fn(k, self.present, p.device, self.field)._decode(p) for p in parts],
                self.device)
        return self._decode(batch)

    def _decode(self, batch: torch.Tensor) -> torch.Tensor:
        """`__call__` on this device, the batch checked."""
        k = self.k
        out = torch.empty((batch.shape[0], 2 * k, SHARE), dtype=torch.uint8, device=self.device)
        if batch.shape[0]:
            src = batch.index_select(1, self.use_index)
            if self.field == 16:
                gf16_mix(src, self.decode16, out)
            else:
                rs_kernel.extend_lines(((src, out[:, :k]),), self.top)
                rs_kernel.extend_lines(((src, out[:, k:]),), self.bottom)
        return out

    def _fwht_operands(self) -> tuple:
        """K2 operands of `leopard_decode.fwht_decode_matrix`: its (m, P)
        matrix split at column k into the part over the use shards and the
        part over the other P - k present shards, each zero-padded to
        (k, k) labels, and the gather index of those other shards, padded
        to k with a position the zero columns ignore. In GF(2^16): the
        (16m, 16P) expansion of the whole matrix, one `gf16_mix` matrix."""
        if self._fwht is None:
            k, m = self.k, len(self.missing)
            mat = leopard_decode.fwht_decode_matrix(k, self.present, self.field)
            if self.field == 16:
                self._fwht = (bit_matrix16_on(mat, self.device),)
                return self._fwht
            over_use = np.zeros((k, k), dtype=np.uint8)
            over_use[:m] = mat[:, :k]
            over_rest = np.zeros((k, k), dtype=np.uint8)
            over_rest[:m, : k - m] = mat[:, k:]
            rest = self.present[k:] + (self.present[0],) * m
            self._fwht = (operand_from_bit_matrix(leopard.to_bit_matrix(over_use), self.device),
                          operand_from_bit_matrix(leopard.to_bit_matrix(over_rest), self.device),
                          torch.tensor(rest, dtype=torch.int64, device=self.device))
        return self._fwht

    def nbytes(self) -> int:
        """Bytes this entry holds on its device: the decode operands, the
        index tensors and, once built, `decode_fwht`'s operands."""
        held = [getattr(self, name) for name in ("decode16", "top", "bottom") if hasattr(self, name)]
        held += [self.use_index, self.present_index, self.missing_index, *(self._fwht or ())]
        return sum(t.numel() * t.element_size() for t in held)

    def decode_fwht(self, batch: torch.Tensor) -> torch.Tensor:
        """(n, 2k, 512) uint8 axes -> (n, m, 512): what Leopard's FWHT
        decoder (`repair_axis`) gives at the m missing positions, from every
        present share. Where the present shares are not one codeword this
        differs from the re-encode of `__call__`; da/repair.py takes it for
        such axes. Two launches of K2 (one when exactly k are present) and
        an XOR of their outputs, all on the batch's device; in GF(2^16) one
        `gf16_mix` over the gathered present shares."""
        k, m = self.k, len(self.missing)
        if batch.dtype != torch.uint8 or batch.dim() != 3 or batch.shape[1:] != (2 * k, SHARE):
            raise ValueError(f"batch must be (n, {2 * k}, {SHARE}) uint8, got "
                             f"{tuple(batch.shape)} {batch.dtype}")
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, decode operands on {self.device}")
        if self.field == 16:
            (matrix,) = self._fwht_operands()
            out = torch.empty((batch.shape[0], m, SHARE), dtype=torch.uint8, device=self.device)
            if batch.shape[0]:
                gf16_mix(batch.index_select(1, self.present_index), matrix, out)
            return out
        over_use, over_rest, rest_index = self._fwht_operands()
        out = torch.empty((batch.shape[0], k, SHARE), dtype=torch.uint8, device=self.device)
        if batch.shape[0]:
            rs_kernel.extend_lines(((batch.index_select(1, self.use_index), out),), over_use)
            if m < k:
                part = torch.empty_like(out)
                rs_kernel.extend_lines(((batch.index_select(1, rest_index), part),), over_rest)
                out[:, :m] ^= part[:, :m]
        return out[:, :m]


# (k, pattern, device, field) -> RepairAxes. Each entry pins its operands on
# its device: 2 MiB at k = 128 in GF(2^8), but a (32k, 16k) int8 matrix in
# GF(2^16), 32 MiB at k = 256 and 128 MiB at k = 512, and as much again once
# `decode_fwht` has run. So the LRU is bounded by entries and by bytes, and
# counts its hits and misses.
_AXES_FN_LOCK = threading.Lock()
_AXES_FN_CACHE: collections.OrderedDict[tuple, RepairAxes] = collections.OrderedDict()
_AXES_FN_MAXSIZE = 64
_AXES_FN_MAX_BYTES = 512 << 20


def repair_axes_cache_clear() -> None:
    with _AXES_FN_LOCK:
        _AXES_FN_CACHE.clear()


def repair_axes_cache_nbytes() -> int:
    """Device bytes that the cached `RepairAxes` entries hold."""
    with _AXES_FN_LOCK:
        return sum(run.nbytes() for run in _AXES_FN_CACHE.values())


def _evict() -> None:
    """Drop least recently used entries, never the newest, until at most
    `_AXES_FN_MAXSIZE` entries hold at most `_AXES_FN_MAX_BYTES` (lock
    held). Sizes are read anew each time: `decode_fwht` grows an entry
    after it was cached."""
    held = sum(run.nbytes() for run in _AXES_FN_CACHE.values())
    while len(_AXES_FN_CACHE) > 1 and (len(_AXES_FN_CACHE) > _AXES_FN_MAXSIZE or held > _AXES_FN_MAX_BYTES):
        _, run = _AXES_FN_CACHE.popitem(last=False)
        held -= run.nbytes()


def repair_axes_fn(k: int, present: tuple[int, ...], device=None,
                   field: int | None = None) -> RepairAxes:
    """The batched erasure repair of every axis that shares one pattern
    (`present`, the known positions of 2k), on `device` (the card unless
    the caller asks for the CPU): the common DA-repair shape, where whole
    columns are missing and every row has the same pattern. Returns a
    `RepairAxes`: (n, 2k, 512) uint8 -> (n, 2k, 512), two K2 launches per
    call whatever n is in GF(2^8), one `gf16_mix` in GF(2^16) (`field`
    forces a field; by default the protocol's choice for k).

    LRU-cached per (k, pattern, device, field), at most `_AXES_FN_MAXSIZE`
    entries holding at most `_AXES_FN_MAX_BYTES` on their devices (the
    entry returned stays, whatever its size); hits and misses count into
    ``repair_axes_fn.hits`` and ``repair_axes_fn.misses``."""
    field = leopard.field_for(k, field)
    dev = device_mod.concrete(device_mod.resolve(device))
    key = (k, tuple(present), dev, field)
    with _AXES_FN_LOCK:
        run = _AXES_FN_CACHE.get(key)
        if run is not None:
            _AXES_FN_CACHE.move_to_end(key)
            repair_axes_fn.hits += 1
            _evict()
            return run
        repair_axes_fn.misses += 1
    run = RepairAxes(k, tuple(present), dev, field)
    with _AXES_FN_LOCK:
        run = _AXES_FN_CACHE.setdefault(key, run)
        _AXES_FN_CACHE.move_to_end(key)
        _evict()
    return run


repair_axes_fn.hits = 0
repair_axes_fn.misses = 0


def _symbols(block: np.ndarray, field: int) -> np.ndarray:
    """Byte shards (n, ..., 512) as the field's symbols: uint8 as they are,
    little-endian uint16 in GF(2^16)."""
    block = np.ascontiguousarray(block, dtype=np.uint8)
    return block.view("<u2") if field == 16 else block


def repair_axis(symbols: np.ndarray, present: list[int], field: int | None = None) -> np.ndarray:
    """Recover all 2k symbols of one row or column from any k known ones,
    on the host: `symbols` is (2k, S) with anything at the missing
    positions, `present` lists the >= k known positions. Leopard's own
    O(n log n) FWHT error-locator decoder (ops/leopard_decode.py)."""
    two_k = symbols.shape[0]
    k = two_k // 2
    field = leopard.field_for(k, field)
    if len(present) < k:
        raise ValueError(f"need at least {k} of {two_k} symbols, got {len(present)}")
    if field == 16:
        out = leopard_decode.decode16(_symbols(symbols, 16), list(present))
        return out.view(np.uint8)
    return leopard_decode.decode8(np.ascontiguousarray(symbols), list(present))


def repair_axis_matrix(symbols: np.ndarray, present: list[int], field: int | None = None) -> np.ndarray:
    """Matrix-inversion repair of one axis on the host (independent of the
    FFT decode path)."""
    two_k = symbols.shape[0]
    k = two_k // 2
    field = leopard.field_for(k, field)
    if len(present) < k:
        raise ValueError(f"need at least {k} of {two_k} symbols, got {len(present)}")
    use = tuple(sorted(present)[:k])
    if field == 16:
        sym = _symbols(symbols, 16)
        data = leopard.matmul16(leopard.decode_matrix16(k, use), sym[list(use)])
        return np.concatenate([data, leopard.encode16(data)], axis=0).view(np.uint8)
    data = leopard.matmul(leopard.decode_matrix(k, use), symbols[list(use)])
    parity = leopard.matmul(leopard.encode_matrix(k), data)
    return np.concatenate([data, parity], axis=0)


def _encode_lines_np(lines: np.ndarray, field: int | None = None) -> np.ndarray:
    """Host Leopard encode of many lines at once: (k, L, 512) uint8, data
    shard j of line l at [j, l] -> (k, L, 512) parity. One `encode` /
    `encode16` call over the whole stack (vectorised over the lines)."""
    k = lines.shape[0]
    field = leopard.field_for(k, field)
    if field == 16:
        return leopard.encode16(_symbols(lines, 16)).view(np.uint8)
    return leopard.encode(np.ascontiguousarray(lines, dtype=np.uint8))


def extend_square_np(ods: np.ndarray, field: int | None = None) -> np.ndarray:
    """The host yardstick of the extension: (k, k, 512) uint8 ODS ->
    (2k, 2k, 512), each pass one `_encode_lines_np` over all its lines."""
    k = ods.shape[0]
    if ods.shape != (k, k, SHARE):
        raise ValueError(f"ODS must be (k, k, {SHARE}), got {ods.shape}")
    ods = np.asarray(ods, dtype=np.uint8)
    q1 = _encode_lines_np(ods.swapaxes(0, 1), field).swapaxes(0, 1)  # rows
    q2 = _encode_lines_np(ods, field)  # columns
    q3 = _encode_lines_np(q2.swapaxes(0, 1), field).swapaxes(0, 1)  # rows of Q2
    top = np.concatenate([ods, q1], axis=1)
    bottom = np.concatenate([q2, q3], axis=1)
    return np.concatenate([top, bottom], axis=0)
