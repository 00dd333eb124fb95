"""NMT axis roots and the RFC-6962 data root of an extended square, in
plain torch over any SHA-256 (`sha256.digest` on a card, `digest_hashlib`
in the tests).

The node rules are celestiaorg/nmt as celestia-app configures it
(sha256, 29-byte namespaces, IgnoreMaxNamespace):

  leaf:  min = max = ns;  v = SHA256(0x00 || ns || share)
  inner: min = min(l.min, r.min)
         max = PARITY if l.min == PARITY, l.max if r.min == PARITY,
               max(l.max, r.max) otherwise
         v = SHA256(0x01 || l.min || l.max || l.v || r.min || r.max || r.v)

A leaf of Q0 keeps its share's namespace; every other leaf takes the
parity namespace. A root serialises as min || max || v (90 bytes). The
data root is the RFC-6962 tree over row roots || column roots: leaf
SHA256(0x00 || root), inner SHA256(0x01 || l || r).
"""

from __future__ import annotations

from typing import Callable

import torch

NS = 29
PARITY = bytes([0xFF] * NS)

HashFn = Callable[[torch.Tensor], torch.Tensor]


def _less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over (..., 29) uint8 namespaces."""
    first = (a != b).to(torch.int32).argmax(dim=-1, keepdim=True)
    return (a.gather(-1, first) < b.gather(-1, first)).squeeze(-1)


def leaf_namespaces(eds: torch.Tensor) -> torch.Tensor:
    """(..., 2k, 2k, 512) -> (..., 2k, 2k, 29): own namespace in Q0, else parity."""
    two_k = eds.shape[-2]
    k = two_k // 2
    idx = torch.arange(two_k, device=eds.device)
    in_q0 = (idx[:, None] < k) & (idx[None, :] < k)
    parity = torch.tensor(list(PARITY), dtype=torch.uint8, device=eds.device)
    return torch.where(in_q0.unsqueeze(-1), eds[..., :NS], parity)


def _prefixed(prefix: int, *parts: torch.Tensor) -> torch.Tensor:
    lead = parts[0].shape[:-1]
    head = torch.full((*lead, 1), prefix, dtype=torch.uint8, device=parts[0].device)
    return torch.cat([head, *parts], dim=-1)


def _hash(hash_fn: HashFn, msgs: torch.Tensor) -> torch.Tensor:
    lead = msgs.shape[:-1]
    return hash_fn(msgs.reshape(-1, msgs.shape[-1])).reshape(*lead, 32)


LEAVES_PER_STEP = 1 << 20  # leaf messages built and hashed at once (568 MB at 542 B)


def leaf_hashes(ns: torch.Tensor, shares: torch.Tensor, hash_fn: HashFn) -> torch.Tensor:
    """(N, 29) namespaces and (N, 512) shares -> (N, 32) leaf digests."""
    out = torch.empty((ns.shape[0], 32), dtype=torch.uint8, device=shares.device)
    for lo in range(0, ns.shape[0], LEAVES_PER_STEP):
        hi = lo + LEAVES_PER_STEP
        out[lo:hi] = hash_fn(_prefixed(0, ns[lo:hi], shares[lo:hi]))
    return out


def tree_roots(mins: torch.Tensor, vs: torch.Tensor, hash_fn: HashFn) -> torch.Tensor:
    """(T, 2k, 29) leaf namespaces and (T, 2k, 32) leaf digests of T trees
    -> their (T, 90) roots, every tree reduced together."""
    maxs = mins
    parity = torch.tensor(list(PARITY), dtype=torch.uint8, device=vs.device)
    while mins.shape[1] > 1:
        lmin, rmin = mins[:, 0::2], mins[:, 1::2]
        lmax, rmax = maxs[:, 0::2], maxs[:, 1::2]
        lv, rv = vs[:, 0::2], vs[:, 1::2]
        vs = _hash(hash_fn, _prefixed(1, lmin, lmax, lv, rmin, rmax, rv))
        l_parity = (lmin == parity).all(-1, keepdim=True)
        r_parity = (rmin == parity).all(-1, keepdim=True)
        bigger = torch.where(_less(lmax, rmax).unsqueeze(-1), rmax, lmax)
        maxs = torch.where(l_parity, parity, torch.where(r_parity, lmax, bigger))
        mins = torch.where(_less(lmin, rmin).unsqueeze(-1), lmin, rmin)
    return torch.cat([mins[:, 0], maxs[:, 0], vs[:, 0]], dim=-1)


def axis_roots(eds: torch.Tensor, hash_fn: HashFn) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 2k, 2k, 512) uint8 squares -> (row roots, column roots), (B, 2k,
    90) each. Every leaf is hashed once (a cell is the same leaf in its row
    and its column tree); every square's trees reduce together."""
    b, two_k = eds.shape[0], eds.shape[1]
    ns = leaf_namespaces(eds)
    leaf_v = leaf_hashes(ns.reshape(-1, NS), eds.reshape(-1, eds.shape[-1]), hash_fn).view(b, two_k, two_k, 32)
    # each square's 2k row trees, then its 2k column trees: (B * 4k, 2k leaves, .)
    mins = torch.cat([ns, ns.transpose(1, 2)], dim=1).reshape(b * 2 * two_k, two_k, NS)
    vs = torch.cat([leaf_v, leaf_v.transpose(1, 2)], dim=1).reshape(b * 2 * two_k, two_k, 32)
    roots = tree_roots(mins, vs, hash_fn).view(b, 2 * two_k, -1)
    return roots[:, :two_k], roots[:, two_k:]


def data_root(row_roots: torch.Tensor, col_roots: torch.Tensor, hash_fn: HashFn) -> torch.Tensor:
    """RFC-6962 root over each square's rowRoots || colRoots (a power-of-two
    count, so every level bisects): (B, 2k, 90) twice -> (B, 32) uint8."""
    nodes = _hash(hash_fn, _prefixed(0, torch.cat([row_roots, col_roots], dim=1)))
    while nodes.shape[1] > 1:
        nodes = _hash(hash_fn, _prefixed(1, nodes[:, 0::2], nodes[:, 1::2]))
    return nodes[:, 0]
