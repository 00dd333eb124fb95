"""Leopard-RS encode over GF(2^8) and GF(2^16) in plain torch: the
reference for the extended square.

The code is the one celestia-app commits to (rsmt2d's ``NewLeoRSCodec``,
klauspost/reedsolomon in Leopard mode: the additive-FFT code of Lin,
Chung and Han): GF(2^8)/0x11D for squares of k <= 128 and GF(2^16)/0x1002D
beyond, each in the "label space" of its Cantor basis, where the FFT
point of index i is the label i. For k data shards the data are the
evaluations at points [k, 2k) and the parity those at [0, k): coefficients
= IFFT over the coset at k, parity = FFT of them over the coset at 0. A
GF(2^16) symbol is two bytes of a share, little-endian.

The field tables and the skew basis are a frozen copy of the construction
in the program's host codec; the butterflies are written here once more,
one vectorised step per layer over every block of the layer, so the same
code runs on the CPU in the tests and on a card after a run.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Field:
    bits: int
    poly: int
    cantor_basis: tuple[int, ...]

    @property
    def order(self) -> int:
        return 1 << self.bits

    @property
    def modulus(self) -> int:
        return self.order - 1


GF8 = Field(8, 0x11D, (1, 214, 152, 146, 86, 200, 88, 230))
GF16 = Field(16, 0x1002D, (
    0x0001, 0xACCA, 0x3C0E, 0x163E, 0xC582, 0xED2E, 0x914C, 0x4012,
    0x6C98, 0x10D8, 0x6A72, 0xB900, 0xFDB8, 0xFB34, 0xFF38, 0x991E,
))
FIELDS = {8: GF8, 16: GF16}
# The control's fields: the same polynomials and the same additive FFT over
# the standard basis (label bit b is the element 2^b) in place of the Cantor
# basis. Still a Reed-Solomon code, maximum-distance-separable, so a faster
# encoder could be tempted by it; but not the bytes consensus commits to.
CONTROL_FIELDS = {bits: Field(f.bits, f.poly, tuple(1 << b for b in range(f.bits))) for bits, f in FIELDS.items()}


def protocol_field(k: int) -> int:
    """The field celestia-app uses for k data shards per axis: 8 bits up to
    256 shards in all (k <= 128), 16 bits beyond."""
    return 8 if k <= 128 else 16


@functools.lru_cache(maxsize=None)
def tables(f: Field) -> tuple[np.ndarray, np.ndarray]:
    """(LOG, EXP) on labels: LOG[x] is the discrete log (base 2 in the
    polynomial representation) of the Cantor-mapped label x, LOG[0] =
    modulus as the zero sentinel; EXP is the inverse permutation."""
    lfsr_log = np.zeros(f.order, dtype=np.int64)
    state = 1
    for i in range(f.modulus):
        lfsr_log[state] = i
        state <<= 1
        if state & f.order:
            state ^= f.poly
    lfsr_log[0] = f.modulus
    cantor = np.zeros(f.order, dtype=np.int64)
    for b in range(f.bits):
        w = 1 << b
        cantor[w:2 * w] = cantor[:w] ^ f.cantor_basis[b]
    log = lfsr_log[cantor]
    exp = np.zeros(f.order, dtype=np.int64)
    exp[log] = np.arange(f.order)
    return log, exp


def mul(f: Field, a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    log, exp = tables(f)
    return int(exp[(int(log[a]) + int(log[b])) % f.modulus])


def inv(f: Field, a: int) -> int:
    log, exp = tables(f)
    return int(exp[(f.modulus - int(log[a])) % f.modulus])


@functools.lru_cache(maxsize=None)
def skew_basis(f: Field) -> np.ndarray:
    """S[d, b] = s_d(label 2^b) / s_d(label 2^d) for b >= d, where s_d is the
    subspace polynomial of U_d = {0 .. 2^d - 1}, by s_{d+1}(x) = s_d(x)
    s_d(x ^ 2^d)."""
    s = np.zeros((f.bits, f.bits), dtype=np.int64)
    cache: dict[tuple[int, int], int] = {}

    def s_d_at(d: int, x: int) -> int:
        if d == 0:
            return x
        key = (d, x)
        if key not in cache:
            cache[key] = mul(f, s_d_at(d - 1, x), s_d_at(d - 1, x ^ (1 << (d - 1))))
        return cache[key]

    for d in range(f.bits):
        norm = inv(f, s_d_at(d, 1 << d))
        for b in range(d, f.bits):
            s[d, b] = mul(f, s_d_at(d, 1 << b), norm)
    return s


def skew(f: Field, d: int, gamma: int) -> int:
    """The butterfly multiplier of layer d at block offset gamma: the XOR of
    S[d, b] over the set bits b >= d of gamma."""
    s = skew_basis(f)
    acc, b, g = 0, d, gamma >> d
    while g:
        if g & 1:
            acc ^= int(s[d, b])
        g >>= 1
        b += 1
    return acc


class _Tables:
    """The field's tables as torch tensors on one device, with a log table
    whose zero maps past every product so that EXPZ[LOG[w] + LOGZ[x]] is
    w * x for w != 0, x = 0 included."""

    def __init__(self, f: Field, device: torch.device):
        log, exp = tables(f)
        m = f.modulus
        logz = log.copy()
        logz[0] = 2 * m
        expz = np.zeros(5 * f.order, dtype=np.int64)
        expz[:2 * m] = exp[np.arange(2 * m) % m]
        self.log = log
        self.logz = torch.from_numpy(logz).to(device)
        self.expz = torch.from_numpy(expz).to(device)
        self.zero_log = 2 * m  # a multiplier of 0: every product lands past 2m


@functools.lru_cache(maxsize=8)
def _device_tables(f: Field, device: torch.device) -> _Tables:
    return _Tables(f, device)


def _block_logs(f: Field, t: _Tables, d: int, offset: int, n: int, device) -> torch.Tensor:
    """log of every block's multiplier at layer d, shaped to broadcast over
    (blocks, half, lines)."""
    half = 1 << d
    ws = [skew(f, d, offset + j) for j in range(0, n, 2 * half)]
    logs = [int(t.log[w]) if w else t.zero_log for w in ws]
    return torch.tensor(logs, dtype=torch.int64, device=device).view(-1, 1, 1)


def _mul_blocks(t: _Tables, wlog: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return t.expz[wlog + t.logz[y]]


def ifft(f: Field, buf: torch.Tensor, offset: int) -> torch.Tensor:
    """(n, L) int64 symbols, evaluations at [offset, offset + n) -> the
    novel-basis coefficients."""
    n = buf.shape[0]
    t = _device_tables(f, buf.device)
    out = buf.clone(memory_format=torch.contiguous_format)
    for d in range(n.bit_length() - 1):
        half = 1 << d
        v = out.view(n // (2 * half), 2, half, -1)
        x, y = v[:, 0], v[:, 1]
        y ^= x
        x ^= _mul_blocks(t, _block_logs(f, t, d, offset, n, buf.device), y)
    return out


def fft(f: Field, buf: torch.Tensor, offset: int) -> torch.Tensor:
    """(n, L) int64 coefficients -> evaluations at [offset, offset + n)."""
    n = buf.shape[0]
    t = _device_tables(f, buf.device)
    out = buf.clone(memory_format=torch.contiguous_format)
    for d in reversed(range(n.bit_length() - 1)):
        half = 1 << d
        v = out.view(n // (2 * half), 2, half, -1)
        x, y = v[:, 0], v[:, 1]
        x ^= _mul_blocks(t, _block_logs(f, t, d, offset, n, buf.device), y)
        y ^= x
    return out


def encode(f: Field, data: torch.Tensor) -> torch.Tensor:
    """(k, L) int64 data symbols -> (k, L) parity symbols."""
    k = data.shape[0]
    if k & (k - 1) or not 1 <= k <= f.order // 2:
        raise ValueError(f"k must be a power of two in [1, {f.order // 2}], got {k}")
    if k == 1:
        return data.clone()
    return fft(f, ifft(f, data, k), 0)


def _to_symbols(shares: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., 512) uint8 -> (..., 512 / (bits / 8)) int64 symbols."""
    if bits == 8:
        return shares.to(torch.int64)
    lo, hi = shares[..., 0::2].to(torch.int64), shares[..., 1::2].to(torch.int64)
    return lo | (hi << 8)


def _to_bytes(symbols: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 8:
        return symbols.to(torch.uint8)
    out = torch.empty((*symbols.shape[:-1], 2 * symbols.shape[-1]), dtype=torch.uint8,
                      device=symbols.device)
    out[..., 0::2] = (symbols & 0xFF).to(torch.uint8)
    out[..., 1::2] = (symbols >> 8).to(torch.uint8)
    return out


def extend_axis(shards: torch.Tensor, bits: int, control: bool = False,
                lines_per_step: int = 64) -> torch.Tensor:
    """(k, lines, 512) uint8, shards along axis 0 -> (k, lines, 512) parity,
    encoded in steps of `lines_per_step` lines so that the int64 symbols
    of a k = 512 pass fit beside a run's leftovers."""
    f = (CONTROL_FIELDS if control else FIELDS)[bits]
    k, lines = shards.shape[:2]
    out = torch.empty_like(shards)
    for lo in range(0, lines, lines_per_step):
        sym = _to_symbols(shards[:, lo:lo + lines_per_step], bits)
        shape = sym.shape
        parity = encode(f, sym.reshape(k, -1))
        out[:, lo:lo + lines_per_step] = _to_bytes(parity.view(shape), bits)
    return out


def extend_square(ods: torch.Tensor, bits: int | None = None, control: bool = False) -> torch.Tensor:
    """(k, k, 512) uint8 ODS -> (2k, 2k, 512) EDS, rsmt2d's quadrant order:
    Q1 from the rows of Q0, Q2 from its columns, Q3 from the rows of Q2.
    `control` encodes over CONTROL_FIELDS."""
    k = ods.shape[0]
    bits = protocol_field(k) if bits is None else bits
    eds = torch.empty((2 * k, 2 * k, ods.shape[-1]), dtype=torch.uint8, device=ods.device)
    eds[:k, :k] = ods
    eds[:k, k:] = extend_axis(ods.transpose(0, 1), bits, control).transpose(0, 1)
    eds[k:, :k] = extend_axis(ods, bits, control)
    eds[k:, k:] = extend_axis(eds[k:, :k].transpose(0, 1), bits, control).transpose(0, 1)
    return eds
