"""The polar code of the Polar Coded Merkle Tree scheme: the port of
celestia_app_tpu/ops/polar.py.

- **Construction** (host, numpy, copied): the information set is the n_data
  most reliable synthetic channels under a Q32 fixed-point Bhattacharyya
  recursion for BEC(1/2) (wrapping uint64, which torch lacks on the CPU),
  ties broken toward higher Hamming weight, then by a sha256-keyed order.
  The pruned factor graph of the transform (every stage value that survives
  known-zero simplification, equal-value chains collapsed into one committed
  class) and its degree-3 XOR checks follow from (n, n_data) alone, so every
  node derives them from the header. `geometry` is cached per n_data.
- **Encode** on the card: the systematic double transform. Scatter the data
  onto the information set A, run the m butterfly stages as reshape-XORs,
  re-mask to A, and run them again, gathering each stage's committed
  representatives on the way: the reference's device path above
  POLAR_MATMUL_MAX_N (:318-373), at every n. No product rounds a parity
  (a generator row sums up to n bits, beyond fp16 and bf16's exact range).
- **Peel** on the card: the LDPC sweep of `ldpc.peel_members` over the
  (n_checks, 3) check table, values at unknown positions zeroed first as the
  reference does (:497-498).

Entry points take ``device=None`` (the card; RuntimeError without one) or an
explicit device (the tests pass ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.ops import ldpc

FROZEN_TAG = b"pcmt/frozen"

_Q32_CAP = np.uint64((1 << 32) - 1)


def reliability(n: int) -> np.ndarray:
    """(n,) u64 Q32 Bhattacharyya parameters of the n synthetic channels for
    BEC(1/2): z(-) = 2z - z^2, z(+) = z^2, natural bit order. Lower is more
    reliable. Wrapping u64 arithmetic, no float."""
    z = np.array([1 << 31], dtype=np.uint64)
    m = n.bit_length() - 1
    with np.errstate(over="ignore"):
        for _ in range(m):
            z2 = (z * z) >> np.uint64(32)
            minus = np.minimum(np.uint64(2) * z - z2, _Q32_CAP)
            z = np.concatenate([minus, z2])
    return z


def _popcounts(n: int) -> np.ndarray:
    v = np.arange(n, dtype=np.uint64)
    pc = np.zeros(n, dtype=np.int64)
    for s in range(max(1, n.bit_length() - 1)):
        pc += ((v >> np.uint64(s)) & np.uint64(1)).astype(np.int64)
    return pc


def _tie_keys(n: int) -> np.ndarray:
    """sha256-derived u64 tie-break keys."""
    keys = np.empty(n, dtype=np.uint64)
    nb = n.to_bytes(8, "big")
    for i in range(n):
        keys[i] = int.from_bytes(hashlib.sha256(FROZEN_TAG + nb + i.to_bytes(8, "big")).digest()[:8], "big")
    return keys


def info_set(n: int, n_data: int) -> np.ndarray:
    """The information set A: the n_data channels picked by (reliability asc,
    Hamming weight desc, sha256 key asc, index asc), sorted ascending. It is
    up-closed under bitwise domination, which makes the two-transform encode
    systematic; a violation raises."""
    z = reliability(n)
    pc = _popcounts(n)
    keys = _tie_keys(n)
    order = np.lexsort((np.arange(n), keys, -pc, z))
    a = np.sort(order[:n_data]).astype(np.int64)
    in_a = np.zeros(n, dtype=bool)
    in_a[a] = True
    for s in range(n.bit_length() - 1):
        up = a | np.int64(1 << s)
        if not in_a[up].all():
            raise AssertionError(f"info set not up-closed at n={n}, n_data={n_data}")
    return a


@dataclasses.dataclass(frozen=True)
class PolarGeometry:
    """The pruned factor graph of one (n_data -> n) polar layer (node ids
    s*n + i; class representative = minimum node id; checks deduplicated and
    lexicographically ordered)."""

    n: int
    m: int
    n_data: int
    A: np.ndarray  # (n_data,) i64 information set, ascending
    C: int  # committed class count
    reps: np.ndarray  # (C, 2) i32 (stage, position) representative
    checks: np.ndarray  # (n_checks, 3) i32 committed-class triples
    data_class: np.ndarray  # (n_data,) i32 committed index of data t


def _compress(p: np.ndarray) -> np.ndarray:
    while True:
        p2 = p[p]
        if np.array_equal(p2, p):
            return p2
        p = p2


@functools.lru_cache(maxsize=32)
def geometry(n_data: int) -> PolarGeometry:
    """The pruned factor graph for an n_data-symbol layer (n = the smallest
    power of two >= 2 n_data). Simplification runs set-at-a-time to a
    fixpoint: map check members to class roots, drop known-zero members,
    cancel duplicate members; degree 0 drops the check, degree 1 forces its
    member zero, degree 2 merges the pair. The inferences are monotone, so
    the fixpoint is unique (reference :162)."""
    if n_data < 1:
        raise ValueError(f"n_data must be >= 1, got {n_data}")
    n = 1
    while n < 2 * n_data:
        n *= 2
    m = n.bit_length() - 1
    a = info_set(n, n_data)
    nn = (m + 1) * n
    inf = nn  # sentinel for a cancelled or absent member

    ii = np.arange(n, dtype=np.int64)
    p = np.arange(nn, dtype=np.int64)
    for s in range(m):
        sel = ii[(ii >> s) & 1 == 1]
        p[(s + 1) * n + sel] = s * n + sel  # equal-value chain link
    p = _compress(p)

    zero = np.zeros(nn, dtype=bool)
    frozen = np.ones(n, dtype=bool)
    frozen[a] = False
    zero[p[ii[frozen]]] = True

    row_parts = []
    for s in range(m):
        sel = ii[(ii >> s) & 1 == 0]
        row_parts.append(np.stack([(s + 1) * n + sel, s * n + sel, s * n + (sel | (1 << s))], axis=1))
    rows = np.concatenate(row_parts, axis=0)

    while True:
        changed = False
        p = _compress(p)
        safe = np.minimum(rows, nn - 1)
        r = np.where(rows < inf, p[safe], inf)
        zr = (rows < inf) & zero[np.minimum(r, nn - 1)]
        r = np.where(zr, inf, r)
        r.sort(axis=1)
        eq01 = (r[:, 0] == r[:, 1]) & (r[:, 0] < inf)
        eq12 = (r[:, 1] == r[:, 2]) & (r[:, 1] < inf)
        all3 = eq01 & eq12
        out = r.copy()
        pair01 = eq01 & ~all3
        out[pair01, 0] = r[pair01, 2]
        out[pair01 | eq12 | all3, 2] = inf
        out[pair01 | (eq12 & ~all3) | all3, 1] = inf
        out.sort(axis=1)
        r = out
        deg = (r < inf).sum(axis=1)
        ones = r[deg == 1, 0]
        if ones.size:
            if not zero[ones].all():
                changed = True
            zero[ones] = True
        two = r[deg == 2, :2]
        if len(two):
            lo = two.min(axis=1)
            hi = two.max(axis=1)
            before = p[hi].copy()
            np.minimum.at(p, hi, lo)
            if not np.array_equal(before, p[hi]):
                changed = True
            # zero flows across the merge in both directions
            zmerge = zero[lo] | zero[hi]
            zero[lo] |= zmerge
            zero[hi] |= zmerge
        keep = deg >= 2
        if not keep.all():
            changed = True
        rows = r[keep]
        if not changed:
            break

    p = _compress(p)
    zero_roots = np.zeros(nn, dtype=bool)
    np.logical_or.at(zero_roots, p, zero)
    zero = zero_roots

    deg = (rows < inf).sum(axis=1)
    if (deg != 3).any():
        raise AssertionError("unconsumed sub-degree-3 check at fixpoint")
    final = p[rows]
    if zero[final].any():
        raise AssertionError("zero member survived simplification")
    final.sort(axis=1)
    final = np.unique(final, axis=0)

    x_roots = p[m * n + ii]
    if zero[x_roots].any():
        raise AssertionError("coded position forced zero by frozen set")
    committed = np.unique(np.concatenate([x_roots, final.ravel()]))
    cidx = np.full(nn, -1, dtype=np.int64)
    cidx[committed] = np.arange(len(committed))
    checks = cidx[final].astype(np.int32)
    data_class = cidx[p[m * n + a]].astype(np.int32)
    if len(np.unique(data_class)) != n_data:
        raise AssertionError("data positions share a committed class")
    reps = np.stack([committed // n, committed % n], axis=1).astype(np.int32)
    for arr in (a, reps, checks, data_class):
        arr.setflags(write=False)
    return PolarGeometry(n=n, m=m, n_data=n_data, A=a, C=len(committed), reps=reps, checks=checks,
                         data_class=data_class)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _butterfly_stages(v: np.ndarray, m: int) -> list[np.ndarray]:
    """All m+1 stage arrays of the transform, stage 0 = input."""
    out = v.copy()
    stages = [out.copy()]
    for s in range(m):
        w = out.reshape(-1, 2, 1 << s, out.shape[1])
        w[:, 0] ^= w[:, 1]
        stages.append(out.copy())
    return stages


def encode_host(data: np.ndarray) -> np.ndarray:
    """(n_data, S) u8 data -> (C, S) u8 committed class values, numpy XOR
    butterflies (the host yardstick)."""
    g = geometry(data.shape[0])
    s_bytes = data.shape[1]
    t = np.zeros((g.n, s_bytes), dtype=np.uint8)
    t[g.A] = data
    w = _butterfly_stages(t, g.m)[-1]
    u = np.zeros_like(w)
    u[g.A] = w[g.A]
    stages = _butterfly_stages(u, g.m)
    if not np.array_equal(stages[-1][g.A], data):
        raise AssertionError("systematic property failed")  # impossible
    vals = np.empty((g.C, s_bytes), dtype=np.uint8)
    for s in range(g.m + 1):
        sel = g.reps[:, 0] == s
        if sel.any():
            vals[sel] = stages[s][g.reps[sel, 1]]
    return vals


@functools.lru_cache(maxsize=32)
def _device_plan(n_data: int, device: torch.device):
    """(A, [(classes, positions) or None per stage], checks) as int64
    tensors on `device`, uploaded once per (n_data, device)."""
    g = geometry(n_data)

    def up(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.int64)).to(device)

    stages = []
    for s in range(g.m + 1):
        sel = np.flatnonzero(g.reps[:, 0] == s)
        stages.append((up(sel), up(g.reps[sel, 1])) if len(sel) else None)
    return up(g.A), stages, up(g.checks.reshape(-1, 3))


def _butterfly_(x: torch.Tensor, s: int) -> None:
    """Stage s of the transform in place: v[i] ^= v[i | 2^s] where bit s of
    i is clear."""
    w = x.view(-1, 2, 1 << s, x.shape[1])
    w[:, 0].bitwise_xor_(w[:, 1])


def encode(data: np.ndarray | torch.Tensor, device=None) -> torch.Tensor:
    """(n_data, S) u8 data -> (C, S) u8 committed class values, a tensor on
    `device` (the card unless the caller asks for the CPU)."""
    dev = device_mod.resolve(device)
    x = ldpc.words(ldpc.to_device(data, dev))
    g = geometry(x.shape[0])
    a, stages, _ = _device_plan(g.n_data, device_mod.concrete(dev))
    t = torch.zeros((g.n, x.shape[1]), dtype=x.dtype, device=dev)
    t.index_copy_(0, a, x)
    for s in range(g.m):
        _butterfly_(t, s)
    u = torch.zeros_like(t)
    u.index_copy_(0, a, t.index_select(0, a))
    vals = torch.empty((g.C, x.shape[1]), dtype=x.dtype, device=dev)
    for s in range(g.m + 1):
        if stages[s] is not None:
            classes, positions = stages[s]
            vals.index_copy_(0, classes, u.index_select(0, positions))
        if s < g.m:
            _butterfly_(u, s)
    return ldpc.from_words(vals)


# ---------------------------------------------------------------------------
# peeling (successive-cancellation) decode
# ---------------------------------------------------------------------------


def peel_host(n_data: int, vals: np.ndarray, known: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Peel erasures out of one committed layer on the host (reference :405).

    ``vals`` is (C, S) u8, ``known`` (C,) bool; unknown positions are zeroed.
    Returns (vals, known, sweeps). Per sweep every check with exactly one
    unknown member resolves it to the XOR of the other two; contended
    targets go to the lowest check index."""
    g = geometry(n_data)
    checks = g.checks
    known = np.asarray(known, dtype=bool).copy()
    vals = np.where(known[:, None], np.ascontiguousarray(vals, dtype=np.uint8), 0)
    n_checks = len(checks)
    sweeps = 0
    while n_checks:
        kn = known[checks]  # (nc, 3)
        resolvable = kn.sum(axis=1) == 2
        if not resolvable.any():
            break
        sweeps += 1
        masked = vals * known[:, None]
        eqxor = masked[checks[:, 0]] ^ masked[checks[:, 1]] ^ masked[checks[:, 2]]
        tgt = checks[np.arange(n_checks), np.argmin(kn, axis=1)]
        eq_ids = np.flatnonzero(resolvable)
        best = np.full(g.C, n_checks, dtype=np.int64)
        np.minimum.at(best, tgt[resolvable], eq_ids)
        chosen = best[tgt[resolvable]] == eq_ids
        vals[tgt[resolvable][chosen]] = eqxor[resolvable][chosen]
        known[tgt[resolvable][chosen]] = True
    return vals, known, sweeps


def peel(n_data: int, vals: np.ndarray | torch.Tensor, known: np.ndarray | torch.Tensor,
         device=None) -> tuple[np.ndarray, np.ndarray, int]:
    """`peel_host` on `device` (the card unless the caller asks for the
    CPU): the same bytes, ``known`` and sweeps, brought back to the host."""
    dev = device_mod.resolve(device)
    kn = ldpc.known_to_device(known, dev)
    x = ldpc.to_device(vals, dev)
    x = torch.where(kn[:, None], x, torch.zeros((), dtype=torch.uint8, device=dev))
    _, _, checks = _device_plan(n_data, device_mod.concrete(dev))
    sweeps = ldpc.peel_members(ldpc.words(x), kn, checks) if len(checks) else 0
    return x.cpu().numpy(), kn.cpu().numpy(), sweeps


def check_equations(n_data: int, vals: np.ndarray, known: np.ndarray) -> np.ndarray:
    """Ascending ids of the violated checks among those with every member
    known: a violation over verified members is an incorrect-coding fraud."""
    g = geometry(n_data)
    if not len(g.checks):
        return np.zeros(0, dtype=np.int64)
    known = np.asarray(known, dtype=bool)
    full = known[g.checks].all(axis=1)
    vals = np.ascontiguousarray(vals, dtype=np.uint8)
    eqxor = vals[g.checks[:, 0]] ^ vals[g.checks[:, 1]] ^ vals[g.checks[:, 2]]
    return np.flatnonzero(full & eqxor.any(axis=1)).astype(np.int64)
