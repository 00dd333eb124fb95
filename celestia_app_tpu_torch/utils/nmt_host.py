"""Host-side Namespaced Merkle Tree (hashlib) with namespace range proofs.

Copied from celestia_app_tpu/utils/nmt_host.py. Reference parity:
celestiaorg/nmt as configured by pkg/wrapper/nmt_wrapper.go (sha256,
29-byte namespaces, IgnoreMaxNamespace=true); node semantics per
specs/src/specs/data_structures.md:236-263, the same as ops/nmt.py. Split
point for n leaves matches RFC-6962 (largest power of two < n).

Proofs from the device levels (da/proof_device.py) are checked against
`NmtRangeProof.verify` here, and `NmtTree` is the host path of
da/proof.py and da/commitment.py.
"""

from __future__ import annotations

import dataclasses
import hashlib

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.da import namespace as ns_mod

NS = appconsts.NAMESPACE_SIZE
PARITY = ns_mod.PARITY_NS_RAW

Node = tuple[bytes, bytes, bytes]  # (min_ns, max_ns, digest)


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def leaf_node(ns: bytes, data: bytes) -> Node:
    if len(ns) != NS:
        raise ValueError(f"namespace must be {NS} bytes, got {len(ns)}")
    return (ns, ns, _sha(b"\x00" + ns + data))


def inner_node(left: Node, right: Node) -> Node:
    n_min = min(left[0], right[0])
    if left[0] == PARITY:
        n_max = PARITY
    elif right[0] == PARITY:
        n_max = left[1]  # IgnoreMaxNamespace: parity children don't raise max
    else:
        n_max = max(left[1], right[1])
    v = _sha(b"\x01" + left[0] + left[1] + left[2] + right[0] + right[1] + right[2])
    return (n_min, n_max, v)


def serialize(node: Node) -> bytes:
    return node[0] + node[1] + node[2]  # 90 bytes


def deserialize(raw: bytes) -> Node:
    if len(raw) != appconsts.NMT_ROOT_SIZE:
        raise ValueError(f"serialized node must be {appconsts.NMT_ROOT_SIZE} bytes, got {len(raw)}")
    return (raw[:NS], raw[NS : 2 * NS], raw[2 * NS :])


def split_point(n: int) -> int:
    k = 1
    while k * 2 < n:
        k *= 2
    return k


class NmtTree:
    """An NMT over (namespace, data) leaves pushed in namespace order."""

    def __init__(self) -> None:
        self.leaves: list[tuple[bytes, bytes]] = []

    def push(self, ns: bytes, data: bytes) -> None:
        if self.leaves and ns < self.leaves[-1][0]:
            raise ValueError(
                f"namespace out of order: {ns.hex()} < {self.leaves[-1][0].hex()}"
            )
        self.leaves.append((ns, data))

    def _subtree(self, start: int, end: int) -> Node:
        if end - start == 1:
            return leaf_node(*self.leaves[start])
        k = split_point(end - start)
        return inner_node(self._subtree(start, start + k), self._subtree(start + k, end))

    def root(self) -> Node:
        if not self.leaves:
            zero = b"\x00" * NS
            return (zero, zero, _sha(b""))
        return self._subtree(0, len(self.leaves))

    def prove_range(self, p_start: int, p_end: int) -> "NmtRangeProof":
        """Prove leaves [p_start, p_end) (celestiaorg/nmt ProveRange): the
        nodes are the maximal out-of-range subtree roots, left to right."""
        if not (0 <= p_start < p_end <= len(self.leaves)):
            raise ValueError(f"invalid range [{p_start}, {p_end})")
        nodes: list[Node] = []

        def walk(start: int, end: int) -> None:
            if end <= p_start or start >= p_end:
                nodes.append(self._subtree(start, end))
                return
            if end - start == 1:
                return  # in-range leaf: the verifier recomputes it
            k = split_point(end - start)
            walk(start, start + k)
            walk(start + k, end)

        walk(0, len(self.leaves))
        return NmtRangeProof(
            start=p_start, end=p_end, total=len(self.leaves),
            nodes=[serialize(n) for n in nodes],
        )


@dataclasses.dataclass
class NmtRangeProof:
    """Range proof over an NMT: out-of-range subtree roots (90-byte
    serialized nodes), left to right."""

    start: int
    end: int
    total: int
    nodes: list[bytes]

    def verify(self, root: bytes, leaves: list[tuple[bytes, bytes]]) -> bool:
        """Check `leaves` = [(ns, data)] occupy [start, end) under `root` (90 B)."""
        if len(leaves) != self.end - self.start or self.total < self.end:
            return False
        node_iter = iter(self.nodes)
        leaf_iter = iter(leaves)

        def rebuild(start: int, end: int) -> Node:
            if end <= self.start or start >= self.end:
                return deserialize(next(node_iter))
            if end - start == 1:
                return leaf_node(*next(leaf_iter))
            k = split_point(end - start)
            left = rebuild(start, start + k)
            right = rebuild(start + k, end)
            return inner_node(left, right)

        try:
            got = rebuild(0, self.total)
            if next(node_iter, None) is not None:
                return False
        except (StopIteration, ValueError):
            return False
        return serialize(got) == root
