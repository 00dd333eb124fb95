"""Namespaced Merkle tree reduction, batched over many trees: the port of
celestia_app_tpu/ops/nmt.py.

NMT node semantics of celestiaorg/nmt as the reference configures it
(pkg/wrapper/nmt_wrapper.go:59-61: sha256, NamespaceIDSize=29,
IgnoreMaxNamespace=true), per specs/src/specs/data_structures.md:236-263:

  leaf:  n_min = n_max = ns;  v = SHA256(0x00 || ns || data)
  inner: n_min = min(l.n_min, r.n_min)
         n_max = PARITY            if l.n_min == PARITY
               = l.n_max           elif r.n_min == PARITY   (IgnoreMaxNamespace)
               = max(l.n_max, r.n_max) otherwise
         v = SHA256(0x01 || l.n_min || l.n_max || l.v || r.n_min || r.n_max || r.v)

Every level of every tree in the batch is one batched SHA-256 launch.
Roots serialize as min || max || v (90 bytes), the axis-root format of
the DataAvailabilityHeader. `eds_axis_roots` is the repair side's entry:
the roots of any batch of EDS rows or columns in one reduction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da import namespace as ns_mod
from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.ops import sha256

NS = appconsts.NAMESPACE_SIZE  # 29


@functools.lru_cache(maxsize=None)
def _parity_ns(device: torch.device) -> torch.Tensor:
    return torch.tensor(list(ns_mod.PARITY_NS_RAW), dtype=torch.uint8, device=device)


def parity_ns(device: torch.device) -> torch.Tensor:
    """PARITY_SHARE_NAMESPACE as a (29,) uint8 tensor on `device`, built
    once per device (an upload from host memory synchronises the stream).
    Callers must not write to it."""
    return _parity_ns(device_mod.concrete(device))


def ns_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over (..., 29) u8 namespaces -> (...) bool:
    compare at the first byte where they differ (byte 0 when equal)."""
    first = (a != b).to(torch.int32).argmax(dim=-1, keepdim=True)
    return (a.gather(-1, first) < b.gather(-1, first)).squeeze(-1)


def ns_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(ns_less(a, b).unsqueeze(-1), a, b)


def ns_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(ns_less(a, b).unsqueeze(-1), b, a)


def _is_parity(ns_u8: torch.Tensor) -> torch.Tensor:
    return (ns_u8 == parity_ns(ns_u8.device)).all(dim=-1)


def leaf_nodes(
    leaf_ns: torch.Tensor, leaf_data: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash all leaves: (T, L, 29) ns + (T, L, D) data -> (min, max, v)."""
    t, l, d = leaf_data.shape
    prefix = torch.zeros((t * l, 1), dtype=torch.uint8, device=leaf_data.device)
    preimage = torch.cat(
        [prefix, leaf_ns.reshape(t * l, NS), leaf_data.reshape(t * l, d)], dim=1
    )
    v = sha256.sha256(preimage).reshape(t, l, 32)
    return leaf_ns, leaf_ns, v


def reduce_level(
    mins: torch.Tensor, maxs: torch.Tensor, vs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combine adjacent node pairs: (T, L, .) -> (T, L/2, .)."""
    l_min, r_min = mins[:, 0::2], mins[:, 1::2]
    l_max, r_max = maxs[:, 0::2], maxs[:, 1::2]
    l_v, r_v = vs[:, 0::2], vs[:, 1::2]
    t, half = l_v.shape[0], l_v.shape[1]

    prefix = torch.ones((t * half, 1), dtype=torch.uint8, device=vs.device)
    preimage = torch.cat(
        [
            prefix,
            l_min.reshape(-1, NS), l_max.reshape(-1, NS), l_v.reshape(-1, 32),
            r_min.reshape(-1, NS), r_max.reshape(-1, NS), r_v.reshape(-1, 32),
        ],
        dim=1,
    )  # (T*half, 181)
    v = sha256.sha256(preimage).reshape(t, half, 32)

    node_min = ns_min(l_min, r_min)
    node_max = torch.where(
        _is_parity(l_min).unsqueeze(-1),
        parity_ns(vs.device).expand_as(l_max),
        torch.where(_is_parity(r_min).unsqueeze(-1), l_max, ns_max(l_max, r_max)),
    )
    return node_min, node_max, v


def _check_pow2(l: int) -> None:
    if l < 1 or l & (l - 1):
        raise ValueError(f"leaf count {l} is not a power of two")


def nmt_levels(
    leaf_ns: torch.Tensor, leaf_data: torch.Tensor
) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """All tree levels, leaves first: [(T, L/2^i, .) for i in 0..log2(L)]."""
    _check_pow2(leaf_data.shape[1])
    levels = [leaf_nodes(leaf_ns, leaf_data)]
    while levels[-1][0].shape[1] > 1:
        levels.append(reduce_level(*levels[-1]))
    return levels


def nmt_roots(leaf_ns: torch.Tensor, leaf_data: torch.Tensor) -> torch.Tensor:
    """Batched NMT roots: (T, L, 29) ns + (T, L, D) leaves -> (T, 90) u8."""
    return roots_from_leaf_nodes(*leaf_nodes(leaf_ns, leaf_data))


def eds_axis_leaf_ns(slabs: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Leaf namespaces for a batch of EDS axes: (n, 2k, 512) axis slabs and
    their (n,) int64 axis indices on the slabs' device -> (n, 2k, 29). Leaf
    j of axis i keeps its share's own prefix iff idx[i] < k and j < k (it
    lies in Q0), else it is PARITY: the pkg/wrapper rule
    (da/fraud.leaf_ns). Symmetric under transpose, so it serves row slabs
    (index = row) and column slabs (index = column) alike."""
    width = slabs.shape[1]
    in_q0 = (idx < k)[:, None, None] & (torch.arange(width, device=slabs.device) < k)[None, :, None]
    return torch.where(in_q0, slabs[..., :NS], parity_ns(slabs.device))


def eds_axis_roots(slabs, indices, k: int, device=None, mesh=None) -> np.ndarray:
    """NMT roots of a batch of EDS axes: (n, 2k, 512) uint8 slabs (numpy,
    or a tensor) and their n axis indices -> (n, 90) uint8 serialized roots
    on the host, computed on `device` (the card unless the caller asks for
    the CPU). One `nmt_roots` reduction over the whole batch: 1 + log2(2k)
    launches of K1, 9 at k = 128, for any n; no padding of the batch. The
    trees are blind: leaves are taken in order, with no namespace-order
    check, as a producer of a bad encoding commits them (da/fraud.py).

    The crossings are the transfer ledger's ``ops.roots_dispatch`` (slabs
    that are not on `device` yet, and the axis indices) and
    ``ops.roots_fetch`` (the roots).

    When the mesh plane is active for k (`mesh`, a parallel/mesh.Mesh, or
    ``None`` for the auto rule: parallel/mesh_engine), the trees are split
    over the mesh's flat device list (host slabs and indices cross under
    ``mesh.shard_batch``), each part is one reduction on its own device
    and the roots are gathered on `device` (the mesh's lead device when
    `device` is None)."""
    from celestia_app_tpu_torch.parallel import mesh_engine

    if mesh is not None and device is None:
        device = mesh.lead
    dev = device_mod.concrete(device_mod.resolve(device))
    if not isinstance(slabs, torch.Tensor):
        slabs = np.ascontiguousarray(slabs, dtype=np.uint8)
    n = slabs.shape[0]
    if slabs.dtype not in (torch.uint8, np.uint8) or slabs.ndim != 3 or \
            tuple(slabs.shape[1:]) != (2 * k, appconsts.SHARE_SIZE):
        raise ValueError(f"slabs must be (n, {2 * k}, {appconsts.SHARE_SIZE}) uint8, got "
                         f"{tuple(slabs.shape)} {slabs.dtype}")
    if len(indices) != n:
        raise ValueError(f"{len(indices)} indices for {n} axes")
    if n == 0:
        return np.zeros((0, appconsts.NMT_ROOT_SIZE), dtype=np.uint8)
    idx = np.asarray(indices, dtype=np.int64)
    parts = mesh_engine.maybe_shard_batch(slabs, k, mesh, dev)
    if parts is not None:
        idx_parts = mesh_engine.maybe_shard_batch(idx, k, mesh, dev)
        roots = [nmt_roots(eds_axis_leaf_ns(p, i, k), p) for p, i in zip(parts, idx_parts)]
        return xfer.to_host(mesh_engine.gather(roots, dev), "ops.roots_fetch")
    if not (isinstance(slabs, torch.Tensor) and slabs.device == dev):
        slabs = xfer.to_device(slabs, "ops.roots_dispatch", device=dev)
    idx = xfer.to_device(idx, "ops.roots_dispatch", device=dev)
    return xfer.to_host(nmt_roots(eds_axis_leaf_ns(slabs, idx, k), slabs), "ops.roots_fetch")


def roots_from_leaf_nodes(
    mins: torch.Tensor, maxs: torch.Tensor, vs: torch.Tensor
) -> torch.Tensor:
    """Inner-node reduction only: (T, L, .) leaf nodes -> (T, 90) roots.

    Lets a caller with shared leaves hash them once: in an EDS the leaf at
    (r, c) has the same preimage in row tree r and column tree c, and
    leaves are most of the hash work (542-byte preimages, 9 compression
    blocks, against 3 for a 181-byte inner node)."""
    _check_pow2(vs.shape[1])
    level = (mins, maxs, vs)
    while level[0].shape[1] > 1:
        level = reduce_level(*level)
    l_min, l_max, l_v = level
    return torch.cat([l_min[:, 0], l_max[:, 0], l_v[:, 0]], dim=1)
