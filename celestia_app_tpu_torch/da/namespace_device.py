"""Batched namespace search over a block's row trees, on the card.

Port of celestia_app_tpu/da/namespace_device.py. A serving node answers
many namespace queries per block; the host scan of
`da/namespace_data.get_namespace_data` compares k^2 shares per query in
Python. The level-0 ``mins`` of the prover's row trees ARE the Q0 share
namespaces, so the namespace -> share-range search is one equality of a
(queries, k^2, 29) comparison, a min and a max over the masked indices,
and a count: one plain PyTorch pass on the device (it was plain XLA, not a
Pallas kernel, in the JAX package).

The search only picks each query's contiguous hit range; the proofs are
then assembled by the same `prover.prove_shares` and absence walk as the
host scan, so every result is identical to `get_namespace_data`'s.

Unlike the JAX module there is no batch-size gate and no fallback: the
search runs where the caller says (the card by default) and a failure
there raises. The JAX module pads the query count to a power of two to
bound XLA compiles; nothing is compiled per shape here, so nothing is
padded.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da.namespace_data import (
    NamespaceData,
    absence_data,
    get_namespace_data,
    presence_data,
)

NS = appconsts.NAMESPACE_SIZE

__all__ = [
    "decode_namespace",
    "parse_namespace",
    "share_namespace",
    "leaf_namespaces",
    "get_namespace_data",
    "get_namespace_data_batched",
]


def decode_namespace(value: str) -> bytes:
    """Hex-decode a namespace request field ('' stays empty). Raises
    ValueError on non-hex input."""
    return bytes.fromhex(value)


def parse_namespace(value: str) -> bytes:
    """Strict form: hex-decode AND require exactly 29 bytes."""
    ns = decode_namespace(value)
    if len(ns) != NS:
        raise ValueError(f"namespace must be {NS} bytes, got {len(ns)}")
    return ns


def share_namespace(share) -> bytes:
    """The 29-byte namespace prefix of one share (bytes or an array cell)."""
    if isinstance(share, (bytes, bytearray, memoryview)):
        return bytes(share[:NS])
    return np.asarray(share).tobytes()[:NS]


def leaf_namespaces(prover) -> np.ndarray:
    """(k^2, 29) uint8: every Q0 share's namespace in row-major order, read
    off the prover's level-0 ``mins`` (a leaf's min IS its namespace)."""
    k = prover.k
    return prover.levels[0][0][:k, :k].reshape(k * k, NS)


def _query_matrix(namespaces: list[bytes]) -> np.ndarray:
    for ns in namespaces:
        if len(ns) != NS:
            raise ValueError(f"namespace must be {NS} bytes")
    return np.frombuffer(b"".join(namespaces), dtype=np.uint8).reshape(len(namespaces), NS)


def search(leaf_ns: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(n, 29) leaf namespaces x (Q, 29) queries -> (3, Q) int64: per query
    the first hit, one past the last hit (row-major), and the hit count. A
    query with no hit has start n, end 0 and count 0."""
    n = leaf_ns.shape[0]
    eq = (qs[:, None, :] == leaf_ns[None, :, :]).all(dim=-1)  # (Q, n)
    idx = torch.arange(n, device=leaf_ns.device)
    starts = torch.where(eq, idx, n).amin(dim=1)
    ends = torch.where(eq, idx + 1, 0).amax(dim=1)
    return torch.stack([starts, ends, eq.sum(dim=1)])


def get_namespace_data_batched(prover, namespaces, device=None) -> list[NamespaceData]:
    """Resolve many namespace queries against one block: one search pass on
    `device` (the card unless the caller asks for the CPU), then the host
    proof assembly. One `NamespaceData` per query, in request order, each
    identical to ``get_namespace_data(prover, ns)``."""
    dev = device_mod.resolve(device)
    namespaces = list(namespaces)
    if not namespaces:
        return []
    qs = torch.from_numpy(_query_matrix(namespaces).copy()).to(dev)
    leaf_ns = torch.from_numpy(leaf_namespaces(prover).copy()).to(dev)
    starts, ends, counts = search(leaf_ns, qs).cpu().tolist()
    out: list[NamespaceData] = []
    for namespace, start, end, count in zip(namespaces, starts, ends, counts):
        if count == 0:
            out.append(absence_data(prover, namespace))
            continue
        if end - start != count:
            raise AssertionError("namespace shares are not contiguous: square is not sorted")
        out.append(presence_data(prover, namespace, start, end))
    return out
