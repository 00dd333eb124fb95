"""Tunable-rate Reed-Solomon, the protocol trade study of arXiv:2201.08261:
the port of celestia_app_tpu/ops/rs_tunable.py.

A systematic GF(2^8) evaluation RS code with a parametrised (k, n) per axis,
n_r x n_c rectangles included: data shard j sits at evaluation point j and
the codeword is the degree-(k-1) interpolating polynomial at points 0..n-1,
so any k of n shards recover all n. n is capped at 256 points. It is a
measurement instrument, not a registered codec.

The field tables, Lagrange matrices and the host engine are numpy, copied.
On the card the (n-k, k) encode matrix is lifted to its (8(n-k), 8k) GF(2)
bit matrix and one product runs per axis pass, as the reference's device
engine does (:170), in float32 on 0/1 operands: every sum is at most
8k < 2^11, exact in float32's 24-bit mantissa, so ``& 1`` reads the right
parity bit. It was a plain XLA einsum on the TPU and stays plain PyTorch.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.ops import rs_kernel

# GF(2^8) modulus x^8+x^4+x^3+x^2+1 (0x11D), independent of the production
# codec's field (ops/leopard.py)
GF_POLY = 0x11D
FIELD = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]  # exp[(la + lb) % 255] without the mod
    return exp, log


_EXP, _LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[int(_LOG[a]) + int(_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(_EXP[255 - int(_LOG[a])])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m, k) u8 GF matrix x (k, D) u8 shards -> (m, D) u8, exact GF(256)
    table arithmetic on the host, one outer product per data shard."""
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for j in range(a.shape[1]):
        col = a[:, j]
        row = b[j]
        nz = col != 0
        if not nz.any():
            continue
        prod = _EXP[_LOG[col[nz]][:, None] + _LOG[row][None, :]]
        prod = np.where(row[None, :] == 0, 0, prod)
        out[nz] ^= prod
    return out


def _lagrange_row(xs: list[int], x_eval: int) -> list[int]:
    """Coefficients c_i with p(x_eval) = XOR_i c_i * p(xs[i]) for every
    polynomial of degree < len(xs)."""
    coeffs = []
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for m, xm in enumerate(xs):
            if m == i:
                continue
            num = gf_mul(num, x_eval ^ xm)
            den = gf_mul(den, xi ^ xm)
        coeffs.append(gf_mul(num, gf_inv(den)))
    return coeffs


def _check_kn(k: int, n: int) -> None:
    if not 1 <= k < n:
        raise ValueError(f"need 1 <= k < n, got k={k} n={n}")
    if n > FIELD:
        raise ValueError(f"n={n} exceeds the GF(256) point budget ({FIELD}); "
                         f"sweeps must skip (and log) this combination")


@functools.lru_cache(maxsize=256)
def encode_matrix(k: int, n: int) -> np.ndarray:
    """(n-k, k) u8: parity shard r (point k+r) from the k data shards."""
    _check_kn(k, n)
    xs = list(range(k))
    mat = np.array([_lagrange_row(xs, x) for x in range(k, n)], dtype=np.uint8)
    mat.setflags(write=False)
    return mat


@functools.lru_cache(maxsize=256)
def decode_matrix(k: int, n: int, use: tuple[int, ...]) -> np.ndarray:
    """(k, k) u8: the data shards from any k distinct present points."""
    _check_kn(k, n)
    if len(use) != k or len(set(use)) != k or not all(0 <= u < n for u in use):
        raise ValueError(f"use must be k={k} distinct points < {n}")
    xs = list(use)
    mat = np.array([_lagrange_row(xs, x) for x in range(k)], dtype=np.uint8)
    mat.setflags(write=False)
    return mat


def _to_bit_matrix(gf_mat: np.ndarray) -> np.ndarray:
    """The (8m, 8k) GF(2) bit matrix of an (m, k) GF(256) matrix under
    LSB-first bit packing: bit (8r+a) of the output depends on bit (8j+b)
    of the input iff bit a of gf_mul(M[r, j], 1 << b) is set."""
    m, k = gf_mat.shape
    out = np.zeros((8 * m, 8 * k), dtype=np.int8)
    for r in range(m):
        for j in range(k):
            c = int(gf_mat[r, j])
            if c == 0:
                continue
            for b in range(8):
                prod = gf_mul(c, 1 << b)
                for a in range(8):
                    if (prod >> a) & 1:
                        out[8 * r + a, 8 * j + b] = 1
    return out


def encode_axis_host(data: np.ndarray, n: int) -> np.ndarray:
    """(k, D) u8 data shards -> (n-k, D) parity shards, on the host."""
    return gf_matmul(encode_matrix(data.shape[0], n), data)


@functools.lru_cache(maxsize=64)
def _bit_operand(k: int, n: int, device: torch.device) -> torch.Tensor:
    """The float32 0/1 bit matrix of encode_matrix(k, n) on `device`."""
    return torch.from_numpy(_to_bit_matrix(encode_matrix(k, n)).astype(np.float32)).to(device)


def _encode_lines(x: torch.Tensor, n: int) -> torch.Tensor:
    """(L, k, D) u8 lines of data shards on a device -> (L, n-k, D) parity,
    one float32 bit product for all lines."""
    bits = rs_kernel.bytes_to_bits(x).to(torch.float32)  # (L, 8k, D)
    operand = _bit_operand(x.shape[1], n, device_mod.concrete(x.device))
    out = torch.matmul(operand, bits).to(torch.int32) & 1  # (L, 8(n-k), D)
    return rs_kernel.bits_to_bytes(out)


def _lines_to_device(data: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(data, dtype=np.uint8)).to(dev)


def encode_axis(data: np.ndarray, n: int, device=None) -> np.ndarray:
    """(k, D) u8 data shards -> (n-k, D) parity, computed on `device` (the
    card unless the caller asks for the CPU)."""
    dev = device_mod.resolve(device)
    _check_kn(data.shape[0], n)
    return _encode_lines(_lines_to_device(data, dev)[None], n)[0].cpu().numpy()


def extend_axis(data: np.ndarray, n: int, device=None) -> np.ndarray:
    """(k, D) -> (n, D): the systematic codeword (data, then parity)."""
    return np.concatenate([np.ascontiguousarray(data, dtype=np.uint8), encode_axis(data, n, device)], axis=0)


def recover_axis(symbols: np.ndarray, present: list[int], k: int) -> np.ndarray:
    """The full n-shard codeword from any >= k known shards ((n, D) with
    any bytes at missing positions), on the host."""
    n = symbols.shape[0]
    if len(present) < k:
        raise ValueError(f"need at least {k} of {n} shards, got {len(present)}")
    use = tuple(sorted(present)[:k])
    data = gf_matmul(decode_matrix(k, n, use), symbols[list(use)])
    return np.concatenate([data, encode_axis_host(data, n)], axis=0)


def extend_2d(ods: np.ndarray, n_r: int, n_c: int, device=None) -> np.ndarray:
    """(k, k, S) ODS -> (n_r, n_c, S) rectangle: rows stretched to n_c, then
    every column of the n_c-wide intermediate stretched to n_r, computed on
    `device` (the card unless the caller asks for the CPU) with one product
    per pass over all its lines."""
    dev = device_mod.resolve(device)
    k = ods.shape[0]
    _check_kn(k, n_r)
    _check_kn(k, n_c)
    x = _lines_to_device(ods, dev)  # (k rows, k cols, S)
    rows = torch.cat([x, _encode_lines(x, n_c)], dim=1)  # (k, n_c, S)
    cols = rows.transpose(0, 1)  # (n_c lines, k, S)
    out = torch.cat([cols, _encode_lines(cols, n_r)], dim=1)  # (n_c, n_r, S)
    return out.transpose(0, 1).contiguous().cpu().numpy()


def analytics(k: int, n_r: int, n_c: int) -> dict:
    """The protocol economics of one (k, n_r, n_c) point, closed form: rate,
    the smallest unrecoverable withholding (an (n_r-k+1) x (n_c-k+1)
    sub-rectangle), the per-sample catch probability, samples to 99 %
    confidence, commitment bytes and a model of the proof bytes."""
    _check_kn(k, n_r)
    _check_kn(k, n_c)
    min_unrec = (n_r - k + 1) * (n_c - k + 1)
    catch = min_unrec / (n_r * n_c)
    node = 32 + 2 * appconsts.NAMESPACE_SIZE
    return {
        "k": k,
        "n_rows": n_r,
        "n_cols": n_c,
        "rate": (k * k) / (n_r * n_c),
        "min_unrecoverable": min_unrec,
        "catch_probability": catch,
        "samples_99": max(1, math.ceil(math.log(0.01) / math.log(1.0 - catch))),
        "commitment_bytes": (n_r + n_c) * 32,
        "proof_bytes_model": appconsts.SHARE_SIZE + math.ceil(math.log2(n_c)) * node,
    }
