"""Polar Coded Merkle Tree, the third DA commitment scheme (wire id 2,
arXiv:2201.07287, frozen set per arXiv:2301.08295): the port of
celestia_app_tpu/da/pcmt.py.

Each tree layer is coded with the polar code of ops/polar.py, and every
committed class of its pruned factor graph is hashed. The hashes are padded
to Q = 64 per batch and each batch is folded by a depth-6 binary Merkle
subtree whose root (32 bytes) is one data symbol of the next layer, which is
polar-coded in turn, until a layer commits at most ROOT_MAX classes: its hash
list is the block commitment, and one sha256 over the parameterised list is
the data root (FORMATS §16.5).

On the card every layer hash and every subtree level is one launch of kernel
K1; the layers, hash lists and subtrees stay on the device until one copy
brings them all to the host at the end. Repair peels on the card
(`polar.peel`); proofs and fraud proofs are host index arithmetic and
hashlib.

Sampling threshold: CATCH_BP declares 1/4, the erasure fraction the pruned
graph's peeling decoder recovers at every deployed size (reference :27-38);
empirical, not combinatorial.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib

import numpy as np
import torch

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da import codec as codec_mod
from celestia_app_tpu_torch.da.cmt import _b64, _hash_symbols, _to_host, ods_symbols
from celestia_app_tpu_torch.da.shares import uvarint
from celestia_app_tpu_torch.ops import ldpc, polar

# hash-batch width: Q hashes of layer j fold (through a depth-LOG2Q binary
# subtree) into one 32-byte data symbol of layer j+1
Q = 64
LOG2Q = 6
HASH_BYTES = 32
# stop coding when a layer commits <= ROOT_MAX classes
ROOT_MAX = 512
DOMAIN = b"PCMT\x01"


class PcmtBadEncodingError(codec_mod.BadEncodingDetected):
    """A degree-3 check over commitment-verified classes is violated: the
    producer committed an invalid codeword at (layer, equation)."""

    def __init__(self, layer: int, equation: int):
        super().__init__((layer, equation), f"bad PCMT encoding: layer {layer} equation {equation}")
        self.layer = layer
        self.equation = equation


def layer_plan(k: int) -> list[tuple[int, int]]:
    """[(n_data, sym_bytes)] per layer, base first: a pure function of k."""
    plan = [(k * k, appconsts.SHARE_SIZE)]
    while polar.geometry(plan[-1][0]).C > ROOT_MAX:
        plan.append((-(-polar.geometry(plan[-1][0]).C // Q), HASH_BYTES))
    return plan


def _layer_c(plan: list[tuple[int, int]], layer: int) -> int:
    return polar.geometry(plan[layer][0]).C


@dataclasses.dataclass(frozen=True)
class PcmtCommitments:
    """What a light client holds: the parameters and the top layer's hash
    list. ``hash()`` is the header's data root."""

    k: int
    root_hashes: tuple[bytes, ...]

    def hash(self) -> bytes:
        out = bytearray(DOMAIN)
        out += uvarint(self.k) + uvarint(Q) + uvarint(ROOT_MAX)
        out += uvarint(len(self.root_hashes))
        for h in self.root_hashes:
            out += h
        return hashlib.sha256(bytes(out)).digest()

    @property
    def plan(self) -> list[tuple[int, int]]:
        return layer_plan(self.k)

    @property
    def n_base(self) -> int:
        """Base-layer committed class count: the sample space size."""
        return polar.geometry(self.k * self.k).C

    def validate_basic(self) -> None:
        plan = self.plan
        want = _layer_c(plan, len(plan) - 1)
        if len(self.root_hashes) != want:
            raise codec_mod.CodecError(f"root hash count {len(self.root_hashes)} != {want} for k={self.k}")
        for h in self.root_hashes:
            if len(h) != HASH_BYTES:
                raise codec_mod.CodecError("root hash has size != 32")


class PcmtEntry:
    """One encoded block on the host: every layer's committed class values,
    hash lists and batch subtrees. Has the codec entry surface."""

    scheme = codec_mod.PCMT_NAME

    def __init__(self, commitments: PcmtCommitments, layers: list[np.ndarray],
                 hash_lists: list[np.ndarray], subtrees: list[list[np.ndarray]], ods: np.ndarray):
        self.commitments = commitments
        self.layers = layers  # [(C_j, S_j) u8 committed values]
        self.hash_lists = hash_lists  # [(C_j, 32) u8]
        # per non-top layer: LOG2Q + 1 levels, level 0 the zero-padded leaf
        # hashes (Q * D_{j+1}, 32), the last the batch roots
        self.subtrees = subtrees
        self._ods = np.ascontiguousarray(ods, dtype=np.uint8)
        self.data_root = commitments.hash()
        self.eds = None

    @property
    def dah(self) -> PcmtCommitments:
        return self.commitments

    @property
    def k(self) -> int:
        return self.commitments.k

    def ods(self) -> np.ndarray:
        k = self.commitments.k
        return self._ods.reshape(k, k, appconsts.SHARE_SIZE)

    def warm(self, device=None) -> None:
        """Nothing to build: hash lists and subtrees come with the encode."""


def _subtree_levels(hashes: torch.Tensor, n_batches: int) -> list[torch.Tensor]:
    """A layer's hash list folded into n_batches Q-wide binary Merkle
    subtrees on its device, one K1 launch per level: level 0 the zero-padded
    leaves, the last the (n_batches, 32) batch roots."""
    padded = torch.zeros((n_batches * Q, HASH_BYTES), dtype=torch.uint8, device=hashes.device)
    padded[: len(hashes)] = hashes
    levels = [padded]
    for _ in range(LOG2Q):
        levels.append(_hash_symbols(levels[-1].reshape(-1, 2 * HASH_BYTES)))
    return levels


def build_from_base(ods: np.ndarray, base_vals: np.ndarray | torch.Tensor, device=None) -> PcmtEntry:
    """Hash and aggregate from given base committed values up to the root
    hash list, on `device`; one copy back at the end. Split out so that a
    malicious producer can grow a self-consistent tree over a corrupt base."""
    dev = device_mod.resolve(device)
    k = ods.shape[0]
    plan = layer_plan(k)
    vals = ldpc.to_device(base_vals, dev)
    layers, hash_lists, subtrees = [vals], [], []
    for j in range(len(plan)):
        hash_lists.append(_hash_symbols(vals))
        if j + 1 < len(plan):
            subtrees.append(_subtree_levels(hash_lists[-1], plan[j + 1][0]))
            vals = polar.encode(subtrees[-1][-1], dev)
            layers.append(vals)
    host = _to_host(layers + hash_lists + [lvl for levels in subtrees for lvl in levels])
    n = len(plan)
    layers_h, hashes_h, flat_levels = host[:n], host[n:2 * n], host[2 * n:]
    subtrees_h = [flat_levels[j * (LOG2Q + 1):(j + 1) * (LOG2Q + 1)] for j in range(n - 1)]
    commitments = PcmtCommitments(k=k, root_hashes=tuple(bytes(h) for h in hashes_h[-1]))
    return PcmtEntry(commitments, layers_h, hashes_h, subtrees_h, ods)


def build_layers(ods: np.ndarray, device=None) -> PcmtEntry:
    """The encode pipeline, (k, k, 512) u8 host ODS -> PcmtEntry, on
    `device` (the card unless the caller asks for the CPU): one upload, one
    polar encode per layer, one K1 launch per layer hash and per subtree
    level, one download."""
    return build_from_base(ods, polar.encode(ods_symbols(ods), device), device)


# ---------------------------------------------------------------------------
# sample proofs
# ---------------------------------------------------------------------------


def open_sample(entry: PcmtEntry, layer: int, index: int) -> dict:
    """Committed class (layer, index) with its layered inclusion proof:
    LOG2Q subtree siblings per step; the recomputed batch root is the parent
    layer's data symbol, whose class comes from the parent geometry."""
    plan = entry.commitments.plan
    if not 0 <= layer < len(plan):
        raise codec_mod.CodecError(f"no PCMT layer {layer}")
    if not 0 <= index < _layer_c(plan, layer):
        raise codec_mod.CodecError(f"class {index} outside layer {layer} ({_layer_c(plan, layer)} classes)")
    steps: list[list[str]] = []
    pos = index
    for j in range(layer, len(plan) - 1):
        levels = entry.subtrees[j]
        idx = pos
        sibs = []
        for lvl in range(LOG2Q):
            sibs.append(bytes(levels[lvl][idx ^ 1]))
            idx >>= 1
        steps.append([_b64(s) for s in sibs])
        pos = int(polar.geometry(plan[j + 1][0]).data_class[pos // Q])
    return {"layer": layer, "index": index, "symbol": _b64(bytes(entry.layers[layer][index])),
            "steps": steps}


def verify_sample(commitments: PcmtCommitments, doc: dict):
    """((layer, index), symbol bytes) when the served doc's symbol is
    committed at that position; None on any failure."""
    try:
        layer = int(doc["layer"])
        index = int(doc["index"])
        symbol = base64.b64decode(doc["symbol"])
        steps = doc["steps"]
    except (KeyError, TypeError, ValueError):
        return None
    plan = commitments.plan
    if not 0 <= layer < len(plan):
        return None
    if not 0 <= index < _layer_c(plan, layer) or len(symbol) != plan[layer][1]:
        return None
    if not isinstance(steps, list) or len(steps) != len(plan) - 1 - layer:
        return None
    h = hashlib.sha256(symbol).digest()
    pos = index
    try:
        for j, step in zip(range(layer, len(plan) - 1), steps):
            if len(step) != LOG2Q:
                return None
            sibs = [base64.b64decode(s) for s in step]
            if any(len(s) != HASH_BYTES for s in sibs):
                return None
            idx = pos
            for sib in sibs:
                h = hashlib.sha256(sib + h if idx & 1 else h + sib).digest()
                idx >>= 1
            # h is the batch root, the parent data symbol
            pos = int(polar.geometry(plan[j + 1][0]).data_class[pos // Q])
            h = hashlib.sha256(h).digest()
    except (TypeError, ValueError):
        return None
    if h != commitments.root_hashes[pos]:
        return None
    return (layer, index), symbol


def sample_wire_bytes(commitments: PcmtCommitments, doc: dict) -> int:
    """Canonical binary size of the proof (FORMATS §16.6): varint layer,
    varint index, the symbol, LOG2Q * 32 per step."""
    layer = int(doc["layer"])
    return (len(uvarint(layer)) + len(uvarint(int(doc["index"]))) + commitments.plan[layer][1]
            + len(doc["steps"]) * LOG2Q * HASH_BYTES)


# ---------------------------------------------------------------------------
# repair (peeling) and incorrect-coding fraud proofs
# ---------------------------------------------------------------------------


def repair(commitments: PcmtCommitments, samples: dict, device=None) -> np.ndarray:
    """The ODS from verified samples {(layer, index): bytes}, peeled on
    `device` (the card unless the caller asks for the CPU).

    A violated check whose members were all served raises
    PcmtBadEncodingError; a peel that stalls before every data class raises
    ValueError (below threshold, not provably mis-coded); so does a
    recovered square whose recommitment misses the committed root."""
    plan = commitments.plan
    k = commitments.k
    d0, s0 = plan[0]
    g = polar.geometry(d0)
    base = {i: b for (layer, i), b in samples.items() if layer == 0}
    if not base:
        raise ValueError("no base-layer samples to reconstruct from")
    vals = np.zeros((g.C, s0), dtype=np.uint8)
    known = np.zeros(g.C, dtype=bool)
    for i, b in sorted(base.items()):
        vals[i] = np.frombuffer(b, dtype=np.uint8)
        known[i] = True
    vals, known, _sweeps = polar.peel(d0, vals, known, device)
    violated = polar.check_equations(d0, vals, known)
    for eq in violated:
        if all(m in base for m in equation_members(commitments, 0, int(eq))):
            raise PcmtBadEncodingError(0, int(eq))
    if violated.size:
        raise ValueError(f"PCMT layer 0 inconsistent at equations {violated[:4].tolist()} "
                         f"but members were not all served")
    if not known[g.data_class].all():
        raise ValueError(f"below peeling threshold: {int((~known[g.data_class]).sum())} of {d0} "
                         f"data classes unrecovered")
    ods = vals[g.data_class].reshape(k, k, appconsts.SHARE_SIZE)
    if build_layers(ods, device).data_root != commitments.hash():
        raise ValueError("recovered data does not reproduce the committed root: an "
                         "upper PCMT layer was mis-coded (fetch its symbols to prove)")
    return ods


def equation_members(commitments: PcmtCommitments, layer: int, equation: int) -> list[int]:
    """Committed-class indices of one check's three members at a layer (the
    order a proof carries)."""
    return [int(x) for x in polar.geometry(commitments.plan[layer][0]).checks[equation]]


@dataclasses.dataclass(frozen=True)
class PcmtSymbolWithProof:
    index: int  # committed-class index within the equation's layer
    symbol: bytes
    doc: dict  # the served sample doc (carries the layered proof)


@dataclasses.dataclass(frozen=True)
class PcmtFraudProof:
    """One violated degree-3 check: its three members, each with its
    inclusion proof."""

    layer: int
    equation: int
    members: tuple[PcmtSymbolWithProof, ...]


def generate_fraud(entry: PcmtEntry, layer: int, equation: int) -> PcmtFraudProof:
    """Full-node side: the proof assembled from an entry it holds."""
    return PcmtFraudProof(
        layer=layer, equation=equation,
        members=tuple(PcmtSymbolWithProof(index=m, symbol=bytes(entry.layers[layer][m]),
                                          doc=open_sample(entry, layer, m))
                      for m in equation_members(entry.commitments, layer, equation)),
    )


def verify_fraud(commitments: PcmtCommitments, proof: PcmtFraudProof) -> bool:
    """True iff every member verifies against the commitments at the
    positions the recomputed check demands and the three XOR to non-zero.
    False for malformed proofs and honest blocks."""
    try:
        plan = commitments.plan
        if not 0 <= proof.layer < len(plan):
            return False
        if not 0 <= proof.equation < len(polar.geometry(plan[proof.layer][0]).checks):
            return False
        if [m.index for m in proof.members] != equation_members(commitments, proof.layer, proof.equation):
            return False
        syms: list[bytes] = []
        for m in proof.members:
            got = verify_sample(commitments, m.doc)
            if got is None:
                return False
            (layer, index), symbol = got
            if layer != proof.layer or index != m.index or symbol != m.symbol:
                return False
            syms.append(symbol)
        acc = np.frombuffer(syms[0], dtype=np.uint8) ^ np.frombuffer(syms[1], dtype=np.uint8)
        return not np.array_equal(acc, np.frombuffer(syms[2], dtype=np.uint8))
    except (KeyError, TypeError, ValueError, IndexError, AttributeError):
        # AttributeError: a proof routed against another scheme's commitments
        return False


# ---------------------------------------------------------------------------
# the Codec implementation
# ---------------------------------------------------------------------------


class PcmtCodec(codec_mod.Codec):
    scheme_id = codec_mod.SCHEME_PCMT
    name = codec_mod.PCMT_NAME
    CATCH_BP = 2500  # declared sampling threshold (module docstring)

    def compute_entry(self, ods: np.ndarray, device=None) -> PcmtEntry:
        from celestia_app_tpu_torch.da import edscache

        return edscache.compute_entry(ods, device, scheme=self.name)

    def _encode_impl(self, ods: np.ndarray, device=None) -> PcmtEntry:
        return build_layers(ods, device)

    def commitments_doc(self, entry) -> dict:
        c = entry.dah
        return {"scheme": self.name, "k": c.k, "q": Q, "root_max": ROOT_MAX,
                "root_hashes": [h.hex() for h in c.root_hashes], "data_root": entry.data_root.hex()}

    def commitments_from_doc(self, doc: dict, data_root_hex: str, square_size: int) -> PcmtCommitments:
        try:
            if int(doc["q"]) != Q or int(doc["root_max"]) != ROOT_MAX:
                raise codec_mod.CodecError("served PCMT parameters differ from this build's")
            c = PcmtCommitments(k=int(doc["k"]), root_hashes=tuple(bytes.fromhex(h) for h in doc["root_hashes"]))
        except (KeyError, TypeError, ValueError) as e:
            raise codec_mod.CodecError(f"malformed PCMT commitments doc: {e}") from None
        c.validate_basic()
        if c.k != square_size:
            raise codec_mod.CodecError("served PCMT k contradicts the header square size")
        if c.hash().hex() != data_root_hex:
            raise codec_mod.CodecError("served PCMT commitments do not bind to the data root")
        return c

    def sample_space(self, commitments) -> list[tuple[int, int]]:
        # base layer only: each proof carries one class of every upper layer
        return [(0, i) for i in range(commitments.n_base)]

    def open_sample(self, entry, cell: tuple[int, int], device=None) -> dict:
        return open_sample(entry, cell[0], cell[1])

    def verify_sample(self, commitments, doc: dict):
        return verify_sample(commitments, doc)

    def sample_wire_bytes(self, doc: dict, commitments=None) -> int:
        if commitments is None:
            raise codec_mod.CodecError("pcmt wire size needs commitments")
        return sample_wire_bytes(commitments, doc)

    def hashes_per_sample_verify(self, commitments) -> int:
        # the symbol hash, then LOG2Q subtree nodes and one parent-symbol
        # hash per layer step
        return 1 + (len(commitments.plan) - 1) * (LOG2Q + 1)

    def repair(self, commitments, samples: dict, device=None) -> np.ndarray:
        return repair(commitments, samples, device)

    def build_fraud_proof(self, entry, location) -> PcmtFraudProof:
        layer, equation = location
        return generate_fraud(entry, layer, equation)

    def verify_fraud_proof(self, commitments, proof, device=None) -> bool:
        return verify_fraud(commitments, proof)

    def fraud_proof_type(self) -> type:
        return PcmtFraudProof

    def commitments_type(self) -> type:
        return PcmtCommitments

    def fraud_cells(self, commitments, location) -> list[tuple]:
        layer, equation = location
        return [(layer, m) for m in equation_members(commitments, layer, equation)]

    def fraud_proof_from_members(self, commitments, location, members: list[tuple]) -> PcmtFraudProof:
        layer, equation = location
        return PcmtFraudProof(layer=layer, equation=equation, members=tuple(
            PcmtSymbolWithProof(index=cell[1], symbol=payload, doc=doc) for cell, payload, doc in members))


codec_mod.register(PcmtCodec())
