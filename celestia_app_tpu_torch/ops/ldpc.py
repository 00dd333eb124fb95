"""The sparse GF(2) LDGM code of the Coded Merkle Tree scheme: the port of
celestia_app_tpu/ops/ldpc.py.

- **Construction** (host, numpy, copied): systematic LDGM, coded =
  [data || parity], parity p the XOR of ``degree`` distinct data symbols. The
  neighbour table is a pure function of (n_data, degree, tag), built from a
  splitmix64 stream seeded by sha256(tag), so every node derives the same
  code from the scheme parameters alone. uint64 arithmetic stays in numpy:
  torch has no uint64 add or shift on the CPU.
- **Encode** on the card: for each degree slot, gather the neighbour symbols
  and XOR them, over an int64 view of the symbols. This is the reference's
  host engine (:122), not its dense GF(2) product (:133), which at k = 128 is
  a 16,384^2 generator and 10^12 multiply-adds to XOR 8 neighbours.
- **Peel** on the card: per sweep, gather each equation's members from the
  (n_parity, d + 1) members table, count its unknowns and XOR its known
  members; an equation with one unknown resolves it, and when several target
  one symbol the lowest equation wins (a scatter-reduce ``amin``, then one
  gather per target). One progress flag per sweep comes back to the host.
  The bytes, ``known`` and sweep count equal `peel_host`'s, inconsistent
  (fraud) inputs included.

Entry points take ``device=None`` (the card; RuntimeError without one) or an
explicit device (the tests pass ``"cpu"``).
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod

# Regular degree of every parity equation (and of every data symbol). Rate
# 1/2: n_parity == n_data. Degree 8 peels a 1/4-erased layer from n = 16
# through n = 16,384 (reference :45-53).
DEGREE = 8


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: u64 counters -> u64 keys (wrapping
    u64 arithmetic, no RNG state)."""
    z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@functools.lru_cache(maxsize=64)
def parity_indices(n_data: int, degree: int = DEGREE, tag: bytes = b"cmt") -> np.ndarray:
    """(n_data, d) int32 neighbour table: parity p = XOR of data[idx[p]].

    d = min(degree, n_data). Column j is a pseudorandom permutation of
    [0, n_data) seeded from sha256(tag || j || n_data); collisions within a
    row are probed away by +1, so every equation has d distinct members."""
    d = min(degree, n_data)
    cols = []
    for j in range(d):
        seed = int.from_bytes(
            hashlib.sha256(tag + b"/" + j.to_bytes(4, "big") + n_data.to_bytes(8, "big")).digest()[:8],
            "big",
        )
        with np.errstate(over="ignore"):
            keys = _splitmix64(np.uint64(seed) + np.arange(n_data, dtype=np.uint64))
        cols.append(np.argsort(keys, kind="stable").astype(np.int32))
    idx = np.stack(cols, axis=1)  # (n_data, d)
    for j in range(1, d):
        while True:
            dup = (idx[:, :j] == idx[:, j:j + 1]).any(axis=1)
            if not dup.any():
                break
            idx[dup, j] = (idx[dup, j] + 1) % n_data
    idx.setflags(write=False)
    return idx


@functools.lru_cache(maxsize=64)
def membership(n_data: int, degree: int = DEGREE, tag: bytes = b"cmt") -> np.ndarray:
    """(n_parity, n_coded) u8 0/1 membership matrix of every parity equation
    over the coded symbols: the neighbours plus the parity symbol itself."""
    idx = parity_indices(n_data, degree, tag)
    n_parity, d = idx.shape
    m = np.zeros((n_parity, 2 * n_data), dtype=np.uint8)
    m[np.repeat(np.arange(n_parity), d), idx.ravel()] = 1
    m[np.arange(n_parity), n_data + np.arange(n_parity)] = 1
    m.setflags(write=False)
    return m


def members_table(n_data: int, degree: int = DEGREE, tag: bytes = b"cmt") -> np.ndarray:
    """(n_parity, d + 1) int32 coded indices of every equation's members: the
    d data neighbours, then the parity symbol."""
    idx = parity_indices(n_data, degree, tag)
    return np.concatenate([idx, (n_data + np.arange(n_data, dtype=np.int32))[:, None]], axis=1)


@functools.lru_cache(maxsize=64)
def _device_table(table_key: tuple, device: torch.device) -> torch.Tensor:
    """An int64 index table on `device`, uploaded once per (table, device)."""
    kind, *args = table_key
    table = parity_indices(*args) if kind == "idx" else members_table(*args)
    return torch.from_numpy(table.astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# symbols as words
# ---------------------------------------------------------------------------


def to_device(x: np.ndarray | torch.Tensor, dev: torch.device) -> torch.Tensor:
    """(n, S) u8 symbols as a contiguous uint8 tensor on `dev`. A numpy input
    is copied (never a tensor sharing the caller's buffer)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.uint8))
    if x.dtype != torch.uint8 or x.dim() != 2:
        raise ValueError(f"symbols must be (n, S) uint8, got {tuple(x.shape)} {x.dtype}")
    x = x.to(dev).contiguous()
    return x.clone() if x.storage_offset() % 8 else x  # `words` needs aligned rows


def known_to_device(known: np.ndarray | torch.Tensor, dev: torch.device) -> torch.Tensor:
    """(n,) bool mask as a bool tensor on `dev` that the caller may mutate."""
    if not isinstance(known, torch.Tensor):
        known = torch.from_numpy(np.array(known, dtype=bool))
    return known.to(dev, torch.bool).clone()


def words(x: torch.Tensor) -> torch.Tensor:
    """(n, S) uint8 -> (n, S/8) int64 view when S is a multiple of 8 (XOR is
    bitwise, so the words give the bytes' result), else the bytes."""
    return x.view(torch.int64) if x.shape[1] % 8 == 0 and x.shape[1] else x


def from_words(w: torch.Tensor) -> torch.Tensor:
    return w.view(torch.uint8) if w.dtype == torch.int64 else w


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode_host(data: np.ndarray, n_data: int | None = None, degree: int = DEGREE,
                tag: bytes = b"cmt") -> np.ndarray:
    """(n_data, S) u8 data symbols -> (n_data, S) u8 parity symbols, numpy
    XOR-gather (the host yardstick)."""
    n = data.shape[0] if n_data is None else n_data
    idx = parity_indices(n, degree, tag)
    return np.bitwise_xor.reduce(data[idx], axis=1)


def encode(data: np.ndarray | torch.Tensor, device=None, degree: int = DEGREE,
           tag: bytes = b"cmt") -> torch.Tensor:
    """(n_data, S) u8 data -> (n_data, S) u8 parity, a tensor on `device`
    (the card unless the caller asks for the CPU): d gathers and XORs of
    int64 words."""
    dev = device_mod.resolve(device)
    x = to_device(data, dev)
    idx = _device_table(("idx", x.shape[0], degree, tag), device_mod.concrete(dev))
    w = words(x)
    out = w.index_select(0, idx[:, 0])
    for j in range(1, idx.shape[1]):
        out.bitwise_xor_(w.index_select(0, idx[:, j]))
    return from_words(out)


# ---------------------------------------------------------------------------
# peeling decode
# ---------------------------------------------------------------------------


def peel_host(symbols: np.ndarray, known: np.ndarray, degree: int = DEGREE,
              tag: bytes = b"cmt") -> tuple[np.ndarray, np.ndarray, int]:
    """Peel erasures out of one coded layer on the host (reference :210).

    ``symbols`` is (n_coded, S) u8 with any bytes at unknown positions,
    ``known`` (n_coded,) bool. Returns (symbols, known, sweeps); inputs are
    not mutated. Per sweep every equation with exactly one unknown member
    resolves it to the XOR of its known members; when several equations
    target one symbol the lowest equation index wins."""
    n_coded = symbols.shape[0]
    members = members_table(n_coded // 2, degree, tag)
    symbols = symbols.copy()
    known = known.copy()
    sweeps = 0
    while True:
        m_unk = (~known)[members]  # (n_parity, d + 1)
        resolvable = m_unk.sum(axis=1) == 1
        if not resolvable.any():
            return symbols, known, sweeps
        sweeps += 1
        masked = symbols * known[:, None]
        eqxor = np.bitwise_xor.reduce(masked[members], axis=1)
        targets = members[resolvable, np.argmax(m_unk[resolvable], axis=1)]
        eq_ids = np.flatnonzero(resolvable)
        best = np.full(n_coded, len(members), dtype=np.int64)
        np.minimum.at(best, targets, eq_ids)
        chosen = best[targets] == eq_ids
        symbols[targets[chosen]] = eqxor[resolvable][chosen]
        known[targets[chosen]] = True


def peel_members(w: torch.Tensor, known: torch.Tensor, members: torch.Tensor) -> int:
    """Peel in place on the tensors' device: ``w`` (n, W) symbol words,
    ``known`` (n,) bool, ``members`` (n_eq, r) int64 member table whose rows
    XOR to zero on a codeword. Returns the sweeps that resolved a symbol.
    Each sweep reads one progress flag on the host (`peel_members.syncs`)."""
    n_eq = members.shape[0]
    eq_ids = torch.arange(n_eq, device=w.device)
    sweeps = 0
    while True:
        m_unk = ~known[members]  # (n_eq, r)
        resolvable = m_unk.sum(dim=1) == 1
        peel_members.syncs += 1
        if not bool(resolvable.any()):
            return sweeps
        sweeps += 1
        masked = torch.where(known[:, None], w, torch.zeros((), dtype=w.dtype, device=w.device))
        eqxor = masked.index_select(0, members[:, 0])
        for j in range(1, members.shape[1]):
            eqxor.bitwise_xor_(masked.index_select(0, members[:, j]))
        # the single unknown member of a resolvable equation (the first
        # unknown of any other row, which the sentinel below discards)
        target = members.gather(1, m_unk.to(torch.uint8).argmax(dim=1, keepdim=True)).squeeze(1)
        # lowest resolvable equation per target; n_eq where none
        best = torch.full((w.shape[0],), n_eq, dtype=torch.int64, device=w.device)
        best.scatter_reduce_(0, target, torch.where(resolvable, eq_ids, n_eq), "amin", include_self=True)
        newly = best < n_eq
        w.copy_(torch.where(newly[:, None], eqxor.index_select(0, best.clamp(max=n_eq - 1)), w))
        known |= newly


peel_members.syncs = 0


def peel(symbols: np.ndarray | torch.Tensor, known: np.ndarray | torch.Tensor, device=None,
         degree: int = DEGREE, tag: bytes = b"cmt") -> tuple[np.ndarray, np.ndarray, int]:
    """`peel_host` on `device` (the card unless the caller asks for the
    CPU): the same bytes, ``known`` and sweeps, brought back to the host."""
    dev = device_mod.resolve(device)
    x = to_device(symbols, dev).clone()
    kn = known_to_device(known, dev)
    members = _device_table(("members", x.shape[0] // 2, degree, tag), device_mod.concrete(dev))
    sweeps = peel_members(words(x), kn, members)
    return x.cpu().numpy(), kn.cpu().numpy(), sweeps


def check_equations(symbols: np.ndarray, known: np.ndarray, degree: int = DEGREE,
                    tag: bytes = b"cmt") -> np.ndarray:
    """Ascending ids of the violated equations among those with every member
    known: a violation over verified members is an incorrect-coding fraud."""
    members = members_table(symbols.shape[0] // 2, degree, tag)
    full = known[members].all(axis=1)
    eqxor = np.bitwise_xor.reduce(symbols[members], axis=1)
    return np.flatnonzero(full & eqxor.any(axis=1)).astype(np.int64)
