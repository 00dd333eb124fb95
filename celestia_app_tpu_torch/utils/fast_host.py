"""Fast CPU implementation of the DA pipeline (numpy BLAS + hashlib): the
port of celestia_app_tpu/utils/fast_host.py.

The host yardstick and oracle of the block pipeline: the same codewords as
``ops/rs.extend_square_fn`` and the same roots as ``da/eds.pipeline``, on
the host only. The port's own hashing and extension run on the card.

- RS extension: the GF(256) generator as an (8k, 8k) GF(2) bit matrix,
  applied as one float32 BLAS matmul per axis pass (exact: dot products of
  0/1 vectors of length <= 2048 are well inside f32's integer range).
- NMT/Merkle hashing: level-synchronous; preimages for a whole tree level
  are assembled as one contiguous array and hashed with hashlib over
  memoryview slices (``sha_many``).
"""

from __future__ import annotations

import hashlib

import numpy as np

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.da import namespace as ns_mod
from celestia_app_tpu_torch.ops import leopard
from celestia_app_tpu_torch.utils import merkle_host

NS = appconsts.NAMESPACE_SIZE
SHARE = appconsts.SHARE_SIZE
PARITY = np.frombuffer(ns_mod.PARITY_NS_RAW, dtype=np.uint8)


def sha_many(preimages: np.ndarray) -> np.ndarray:
    """(N, L) u8 -> (N, 32) u8, hashlib over contiguous memoryview slices."""
    n, length = preimages.shape
    buf = memoryview(np.ascontiguousarray(preimages).reshape(-1).data)
    out = np.empty((n, 32), dtype=np.uint8)
    sha = hashlib.sha256
    for i in range(n):
        out[i] = np.frombuffer(sha(buf[i * length:(i + 1) * length]).digest(), np.uint8)
    return out


def _bits(x: np.ndarray) -> np.ndarray:
    """(..., n, S) u8 -> (..., 8n, S) f32 bits, LSB-first (as ops/rs.py)."""
    n, s = x.shape[-2], x.shape[-1]
    b = np.unpackbits(x[..., None], axis=-1, bitorder="little")  # (..., n, S, 8)
    return np.swapaxes(b, -1, -2).reshape(*x.shape[:-2], 8 * n, s).astype(np.float32)


def _bytes(b: np.ndarray) -> np.ndarray:
    """Inverse of _bits for integer-valued bit arrays."""
    n, s = b.shape[-2] // 8, b.shape[-1]
    u = b.astype(np.uint8).reshape(*b.shape[:-2], n, 8, s)
    return np.packbits(np.swapaxes(u, -1, -2), axis=-1, bitorder="little")[..., 0]


def extend_square_fast(ods: np.ndarray) -> np.ndarray:
    """(k, k, 512) -> (2k, 2k, 512); same codewords as ops/rs.extend_square_fn."""
    k = ods.shape[0]
    if leopard.uses_gf16(k):
        raise ValueError(
            "fast_host's BLAS formulation covers the GF(2^8) range (k <= 128);"
            " use ops.rs.extend_square_np for wider squares"
        )
    bm = leopard.bit_matrix(k).astype(np.float32)  # (8k, 8k)

    def mix(rows: np.ndarray) -> np.ndarray:
        # rows: (m, k, S) -> parity (m, k, S); one (8k,8k)@(8k, m*S) matmul.
        m = rows.shape[0]
        rb = _bits(rows)  # (m, 8k, S)
        flat = np.moveaxis(rb, 1, 0).reshape(8 * k, m * SHARE)
        par = bm @ flat
        par = np.moveaxis(par.reshape(8 * k, m, SHARE), 0, 1)
        return _bytes(par.astype(np.int64) & 1)

    q1 = mix(ods)  # row pass
    q2 = np.swapaxes(mix(np.swapaxes(ods, 0, 1)), 0, 1)  # column pass
    q3 = mix(q2)  # Q3 = row-extend Q2
    top = np.concatenate([ods, q1], axis=1)
    bottom = np.concatenate([q2, q3], axis=1)
    return np.concatenate([top, bottom], axis=0)


def _ns_lt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic a < b over (..., 29) u8 arrays."""
    lt = np.zeros(a.shape[:-1], dtype=bool)
    eq = np.ones(a.shape[:-1], dtype=bool)
    for i in range(NS):
        lt |= eq & (a[..., i] < b[..., i])
        eq &= a[..., i] == b[..., i]
    return lt


def nmt_levels_fast(
    leaf_ns: np.ndarray, leaf_data: np.ndarray
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """All NMT tree levels, leaves first: the host twin of ops/nmt.py
    nmt_levels (same (mins, maxs, vs) shape per level)."""
    t, l, d = leaf_data.shape
    pre = np.concatenate(
        [
            np.zeros((t * l, 1), np.uint8),
            leaf_ns.reshape(t * l, NS),
            leaf_data.reshape(t * l, d),
        ],
        axis=1,
    )
    vs = sha_many(pre).reshape(t, l, 32)
    mins = leaf_ns.copy()
    maxs = leaf_ns.copy()
    levels = [(mins, maxs, vs)]
    while vs.shape[1] > 1:
        lm, rm = mins[:, 0::2], mins[:, 1::2]
        lx, rx = maxs[:, 0::2], maxs[:, 1::2]
        lv, rv = vs[:, 0::2], vs[:, 1::2]
        half = lv.shape[1]
        pre = np.concatenate(
            [
                np.ones((t * half, 1), np.uint8),
                lm.reshape(-1, NS), lx.reshape(-1, NS), lv.reshape(-1, 32),
                rm.reshape(-1, NS), rx.reshape(-1, NS), rv.reshape(-1, 32),
            ],
            axis=1,
        )
        vs = sha_many(pre).reshape(t, half, 32)
        lt = _ns_lt(lm, rm)[..., None]
        mins = np.where(lt, lm, rm)
        l_par = np.all(lm == PARITY, axis=-1)[..., None]
        r_par = np.all(rm == PARITY, axis=-1)[..., None]
        mx = np.where(_ns_lt(lx, rx)[..., None], rx, lx)
        maxs = np.where(l_par, PARITY, np.where(r_par, lx, mx))
        levels.append((mins, maxs, vs))
    return levels


def nmt_roots_fast(leaf_ns: np.ndarray, leaf_data: np.ndarray) -> np.ndarray:
    """Batched NMT roots (T, L, 29)+(T, L, D) -> (T, 90); NMT semantics as in
    ops/nmt.py (IgnoreMaxNamespace=true, parity propagation)."""
    mins, maxs, vs = nmt_levels_fast(leaf_ns, leaf_data)[-1]
    return np.concatenate([mins[:, 0], maxs[:, 0], vs[:, 0]], axis=1)


def _axis_leaf_ns(axis_major: np.ndarray, k: int) -> np.ndarray:
    """(2k, 2k, SHARE) axis-major slab -> (2k, 2k, 29) leaf namespaces."""
    idx = np.arange(2 * k)
    in_q0 = (idx[:, None] < k) & (idx[None, :] < k)
    return np.where(in_q0[..., None], axis_major[:, :, :NS], PARITY)


def axis_roots_fast(eds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """EDS -> (row_roots (2k, 90), col_roots (2k, 90))."""
    k = eds.shape[0] // 2
    rows = nmt_roots_fast(_axis_leaf_ns(eds, k), eds)
    eds_t = np.swapaxes(eds, 0, 1)
    cols = nmt_roots_fast(_axis_leaf_ns(eds_t, k), eds_t)
    return rows, cols


def pipeline_fast(ods: np.ndarray):
    """(k, k, 512) -> (eds, row_roots, col_roots, data_root) on the host."""
    eds = extend_square_fast(ods)
    rows, cols = axis_roots_fast(eds)
    leaves = [bytes(r) for r in rows] + [bytes(c) for c in cols]
    data_root = merkle_host.hash_from_leaves(leaves)
    return eds, rows, cols, np.frombuffer(data_root, dtype=np.uint8)
