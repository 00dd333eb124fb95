"""Erasure decoding of an extended square in plain torch: the reference
for a repaired square, with either code of reference/leopard (the
protocol's, or the control's).

An axis of 2k symbols is a codeword c = G d of its k data symbols, where
G (2k x k) stacks the identity over the encoder's parity map, obtained by
encoding unit vectors. For a pattern of present positions S, the first k
of them U give d = G_U^-1 c_U, so every position is D c_U with D =
G G_U^-1, inverted here by Gauss-Jordan over the field. Every axis of
one pattern takes the same D. The square is swept rows then columns, an
axis with at least k present shares decoded whole, until every share is
present (rsmt2d's crossword, without the roots: the reference judges
bytes).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference import leopard


def _mul(f: leopard.Field, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise product of label arrays (broadcasting)."""
    log, exp = leopard.tables(f)
    a, b = np.broadcast_arrays(np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64))
    out = exp[(log[a] + log[b]) % f.modulus]
    return np.where((a == 0) | (b == 0), 0, out)


def _inverse(f: leopard.Field, m: np.ndarray) -> np.ndarray:
    """The inverse of a square label matrix over the field (Gauss-Jordan);
    ValueError where it is singular."""
    n = m.shape[0]
    aug = np.concatenate([m.astype(np.int64), np.eye(n, dtype=np.int64)], axis=1)
    for col in range(n):
        pivots = np.flatnonzero(aug[col:, col])
        if not pivots.size:
            raise ValueError("singular matrix")
        p = col + int(pivots[0])
        aug[[col, p]] = aug[[p, col]]
        aug[col] = _mul(f, leopard.inv(f, int(aug[col, col])), aug[col])
        factors = aug[:, col].copy()
        factors[col] = 0
        aug ^= _mul(f, factors[:, None], aug[col][None, :])
    return aug[:, n:]


@functools.lru_cache(maxsize=4)
def generator(f: leopard.Field, k: int) -> np.ndarray:
    """G (2k x k): data over parity, each column the codeword of a unit
    vector."""
    unit = torch.eye(k, dtype=torch.int64)
    return torch.cat([unit, leopard.encode(f, unit)]).numpy()


@functools.lru_cache(maxsize=16)
def decode_matrix(f: leopard.Field, k: int, present: tuple[int, ...]) -> np.ndarray:
    """D (2k x k): every position of an axis from its first k present ones."""
    g = generator(f, k)
    inv = _inverse(f, g[list(present[:k])])
    out = np.zeros((2 * k, k), dtype=np.int64)
    for j in range(k):
        out ^= _mul(f, g[:, j:j + 1], inv[j][None, :])
    return out


def _apply(f: leopard.Field, matrix: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(m, n) labels times (n, ...) int64 symbols -> (m, ...) on x's device."""
    t = leopard._device_tables(f, x.device)
    m = matrix.shape[0]
    logs = np.where(matrix != 0, t.log[matrix], t.zero_log)
    logs = torch.from_numpy(logs).to(x.device).view(m, matrix.shape[1], *([1] * (x.dim() - 1)))
    out = torch.zeros((m, *x.shape[1:]), dtype=torch.int64, device=x.device)
    for j in range(matrix.shape[1]):
        out ^= t.expz[logs[:, j] + t.logz[x[j]]]
    return out


def _decode_axes(f: leopard.Field, bits: int, k: int, present: tuple[int, ...],
                 axes: torch.Tensor) -> torch.Tensor:
    """(n, 2k, 512) uint8 axes sharing one pattern -> the same, decoded."""
    d = decode_matrix(f, k, present)
    sym = leopard._to_symbols(axes[:, list(present[:k])], bits).transpose(0, 1)  # (k, n, symbols)
    return leopard._to_bytes(_apply(f, d, sym).transpose(0, 1), bits)


def repair(symbols: torch.Tensor, present: torch.Tensor, bits: int | None = None,
           control: bool = False) -> torch.Tensor:
    """(2k, 2k, 512) uint8 square and (2k, 2k) bool mask on any device ->
    the full square, every absent share decoded (the protocol's code, or
    the control's). ValueError where the pattern cannot be solved."""
    sq, have = symbols.clone(), present.clone()
    two_k = sq.shape[0]
    k = two_k // 2
    bits = leopard.protocol_field(k) if bits is None else bits
    f = (leopard.CONTROL_FIELDS if control else leopard.FIELDS)[bits]
    while not bool(have.all()):
        progress = False
        for axis in (0, 1):
            view, mask = (sq, have) if axis == 0 else (sq.transpose(0, 1), have.transpose(0, 1))
            groups: dict[tuple[int, ...], list[int]] = {}
            for i, row in enumerate(mask.cpu().numpy()):
                if k <= row.sum() < two_k:
                    groups.setdefault(tuple(np.flatnonzero(row).tolist()), []).append(i)
            for pattern, lines in groups.items():
                view[lines] = _decode_axes(f, bits, k, pattern, view[lines])
                mask[lines] = True
                progress = True
        if not progress:
            raise ValueError(f"unsolvable: {int((~have).sum())} shares missing, no axis has {k}")
    return sq
