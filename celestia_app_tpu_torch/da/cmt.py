"""Coded Merkle Tree, the second DA commitment scheme (wire id 1,
arXiv:1910.01247): the port of celestia_app_tpu/da/cmt.py.

The k*k ODS shares are coded with the rate-1/2 LDGM code of ops/ldpc.py, the
2k^2 coded symbols are hashed, every Q = 8 hashes form one data symbol of the
next layer, which is coded the same way, until a coded layer has at most
ROOT_MAX symbols: its hash list is the block commitment, and one sha256 over
the parameterised list is the data root (FORMATS §16.2).

On the card the layers stay on the device from the ODS upload through the
encodes and the hashing (every `_hash_symbols` is one launch of kernel K1)
and come back to the host in one copy at the end; the entry holds numpy, as
the reference's does, because sample proofs index it on the host. Repair
peels on the card (`ldpc.peel`); proofs and fraud proofs are host index
arithmetic and hashlib.

Sampling threshold: CATCH_BP declares 1/4, the erasure fraction the degree-8
code peels at every deployed size (reference :27-37); it is empirical, not
combinatorial.
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
from celestia_app_tpu_torch.da.shares import uvarint
from celestia_app_tpu_torch.ops import ldpc
from celestia_app_tpu_torch.ops import sha256 as sha256_mod

# hash-batch width: Q hashes of layer j form one data symbol of layer j+1
Q = 8
HASH_BYTES = 32
# stop coding when a layer has <= ROOT_MAX coded symbols; its hash list is
# the published commitment
ROOT_MAX = 512
DOMAIN = b"CMT\x01"


class CmtBadEncodingError(codec_mod.BadEncodingDetected):
    """A parity equation over commitment-verified symbols is violated: the
    producer committed an invalid codeword at (layer, equation)."""

    def __init__(self, layer: int, equation: int):
        super().__init__((layer, equation), f"bad CMT encoding: layer {layer} equation {equation}")
        self.layer = layer
        self.equation = equation


def layer_plan(k: int) -> list[tuple[int, int]]:
    """[(n_data, sym_bytes)] per layer, base first: a pure function of k."""
    plan = [(k * k, appconsts.SHARE_SIZE)]
    while 2 * plan[-1][0] > ROOT_MAX:
        plan.append(((2 * plan[-1][0]) // Q, Q * HASH_BYTES))
    return plan


@dataclasses.dataclass(frozen=True)
class CmtCommitments:
    """What a light client holds: the parameters and the top layer's hash
    list. ``hash()`` is the header's data root."""

    k: int
    root_hashes: tuple[bytes, ...]

    def hash(self) -> bytes:
        out = bytearray(DOMAIN)
        out += uvarint(self.k) + uvarint(Q) + uvarint(ldpc.DEGREE)
        out += uvarint(ROOT_MAX) + uvarint(len(self.root_hashes))
        for h in self.root_hashes:
            out += h
        return hashlib.sha256(bytes(out)).digest()

    @property
    def plan(self) -> list[tuple[int, int]]:
        return layer_plan(self.k)

    @property
    def n_base(self) -> int:
        return 2 * self.k * self.k

    def validate_basic(self) -> None:
        plan = self.plan
        if len(self.root_hashes) != 2 * plan[-1][0]:
            raise codec_mod.CodecError(
                f"root hash count {len(self.root_hashes)} != {2 * plan[-1][0]} for k={self.k}")
        for h in self.root_hashes:
            if len(h) != HASH_BYTES:
                raise codec_mod.CodecError("root hash has size != 32")


def _hash_symbols(symbols: torch.Tensor) -> torch.Tensor:
    """(n, S) u8 -> (n, 32) u8 sha256 digests on the tensor's device: one
    launch of kernel K1 on the card."""
    return sha256_mod.sha256(symbols.contiguous())


def ods_symbols(ods: np.ndarray) -> np.ndarray:
    """(k, k, 512) u8 host ODS -> its (k*k, 512) shares, row-major."""
    k = ods.shape[0]
    return np.asarray(ods, dtype=np.uint8).reshape(k * k, appconsts.SHARE_SIZE)


def _to_host(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """The tensors as numpy arrays, through one device-to-host copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


class CmtEntry:
    """One encoded block: every layer's coded symbols and hash lists, on the
    host. Has the codec entry surface: ``scheme``, ``data_root``, ``dah``
    (the commitments), ``k`` and ``warm``."""

    scheme = codec_mod.CMT_NAME

    def __init__(self, commitments: CmtCommitments, layers: list[np.ndarray],
                 hash_lists: list[np.ndarray]):
        self.commitments = commitments
        self.layers = layers  # [(n_coded_j, S_j) u8]
        self.hash_lists = hash_lists  # [(n_coded_j, 32) u8]
        self.data_root = commitments.hash()
        self.eds = None  # no extended square in this scheme

    @property
    def dah(self) -> CmtCommitments:
        return self.commitments

    @property
    def k(self) -> int:
        return self.commitments.k

    def ods(self) -> np.ndarray:
        k = self.commitments.k
        return self.layers[0][: k * k].reshape(k, k, appconsts.SHARE_SIZE)

    def warm(self, device=None) -> None:
        """Nothing to build: the proof machinery is the hash lists."""


def build_from_base(k: int, base: torch.Tensor, device=None) -> CmtEntry:
    """The tree over a given coded base layer ((2k^2, 512) u8): hash it, and
    code and hash each upper layer, on `device`; one copy back at the end.
    Split out so that a malicious producer can commit a corrupt base."""
    dev = device_mod.resolve(device)
    plan = layer_plan(k)
    coded = ldpc.to_device(base, dev)
    layers, hash_lists = [coded], [_hash_symbols(coded)]
    for _ in plan[1:]:
        data = hash_lists[-1].reshape(-1, Q * HASH_BYTES)
        coded = torch.cat([data, ldpc.encode(data, dev)])
        layers.append(coded)
        hash_lists.append(_hash_symbols(coded))
    host = _to_host(layers + hash_lists)
    layers_h, hashes_h = host[:len(plan)], host[len(plan):]
    commitments = CmtCommitments(k=k, root_hashes=tuple(bytes(h) for h in hashes_h[-1]))
    return CmtEntry(commitments, layers_h, hashes_h)


def build_layers(ods: np.ndarray, device=None) -> CmtEntry:
    """The encode pipeline, (k, k, 512) u8 host ODS -> CmtEntry, on `device`
    (the card unless the caller asks for the CPU): one upload, one LDGM
    encode and one K1 launch per layer, one download."""
    dev = device_mod.resolve(device)
    data = ldpc.to_device(ods_symbols(ods), dev)
    return build_from_base(ods.shape[0], torch.cat([data, ldpc.encode(data, dev)]), dev)


# ---------------------------------------------------------------------------
# sample proofs
# ---------------------------------------------------------------------------


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def open_sample(entry: CmtEntry, layer: int, index: int) -> dict:
    """Coded symbol (layer, index) with its layered inclusion proof: Q - 1
    sibling hashes per step up to the root hash list."""
    plan = entry.commitments.plan
    if not 0 <= layer < len(plan):
        raise codec_mod.CodecError(f"no CMT layer {layer}")
    n_coded = 2 * plan[layer][0]
    if not 0 <= index < n_coded:
        raise codec_mod.CodecError(f"symbol {index} outside layer {layer} ({n_coded} symbols)")
    steps: list[list[str]] = []
    pos = index
    for j in range(layer, len(plan) - 1):
        base, off = (pos // Q) * Q, pos % Q
        steps.append([_b64(bytes(entry.hash_lists[j][base + t])) for t in range(Q) if t != off])
        pos //= Q
    return {"layer": layer, "index": index, "symbol": _b64(bytes(entry.layers[layer][index])),
            "steps": steps}


def verify_sample(commitments: CmtCommitments, doc: dict):
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
    n_coded = 2 * plan[layer][0]
    if not 0 <= index < n_coded or len(symbol) != plan[layer][1]:
        return None
    if not isinstance(steps, list) or len(steps) != len(plan) - 1 - layer:
        return None
    h = hashlib.sha256(symbol).digest()
    pos = index
    try:
        for step in steps:
            if len(step) != Q - 1:
                return None
            sibs = [base64.b64decode(s) for s in step]
            if any(len(s) != HASH_BYTES for s in sibs):
                return None
            off = pos % Q
            h = hashlib.sha256(b"".join(sibs[:off]) + h + b"".join(sibs[off:])).digest()
            pos //= Q
    except (TypeError, ValueError):
        return None
    if h != commitments.root_hashes[pos]:
        return None
    return (layer, index), symbol


def sample_wire_bytes(commitments: CmtCommitments, doc: dict) -> int:
    """Canonical binary size of the proof (FORMATS §16.3): varint layer,
    varint index, the symbol, (Q - 1) * 32 per step."""
    layer = int(doc["layer"])
    return (len(uvarint(layer)) + len(uvarint(int(doc["index"]))) + commitments.plan[layer][1]
            + len(doc["steps"]) * (Q - 1) * HASH_BYTES)


# ---------------------------------------------------------------------------
# repair (peeling) and incorrect-coding fraud proofs
# ---------------------------------------------------------------------------


def repair(commitments: CmtCommitments, samples: dict, device=None) -> np.ndarray:
    """The ODS from verified samples {(layer, index): bytes}, peeled on
    `device` (the card unless the caller asks for the CPU).

    A violated equation whose members were all served raises
    CmtBadEncodingError; a peel that stalls before every data symbol raises
    ValueError (below threshold, not provably mis-coded); so does a
    recovered square whose recommitment misses the committed root (an upper
    layer was mis-coded)."""
    plan = commitments.plan
    k = commitments.k
    n_data0, sym0 = plan[0]
    n0 = 2 * n_data0
    base = {i: b for (layer, i), b in samples.items() if layer == 0}
    if not base:
        raise ValueError("no base-layer samples to reconstruct from")
    symbols = np.zeros((n0, sym0), dtype=np.uint8)
    known = np.zeros(n0, dtype=bool)
    for i, b in sorted(base.items()):
        symbols[i] = np.frombuffer(b, dtype=np.uint8)
        known[i] = True
    symbols, known, _sweeps = ldpc.peel(symbols, known, device)
    violated = ldpc.check_equations(symbols, known)
    for eq in violated:
        if all(m in base for m in equation_members(commitments, 0, int(eq))):
            raise CmtBadEncodingError(0, int(eq))
    if violated.size:
        # inconsistent, but some member was only peeled, never served
        raise ValueError(f"CMT layer 0 inconsistent at equations {violated[:4].tolist()} "
                         f"but members were not all served")
    if not known[:n_data0].all():
        raise ValueError(f"below peeling threshold: {int((~known[:n_data0]).sum())} "
                         f"of {n_data0} data symbols unrecovered")
    ods = symbols[:n_data0].reshape(k, k, appconsts.SHARE_SIZE)
    if build_layers(ods, device).data_root != commitments.hash():
        raise ValueError("recovered data does not reproduce the committed root: an "
                         "upper CMT layer was mis-coded (fetch its symbols to prove)")
    return ods


def equation_members(commitments: CmtCommitments, layer: int, equation: int) -> list[int]:
    """Coded indices of one equation's members at a layer: the d data
    neighbours, then the parity symbol (the order a proof carries)."""
    n_data = commitments.plan[layer][0]
    return [int(m) for m in ldpc.parity_indices(n_data)[equation]] + [n_data + equation]


@dataclasses.dataclass(frozen=True)
class CmtSymbolWithProof:
    index: int  # coded index within the equation's layer
    symbol: bytes
    doc: dict  # the served sample doc (carries the layered proof)


@dataclasses.dataclass(frozen=True)
class CmtFraudProof:
    """One violated parity equation: its d + 1 members, each with its
    inclusion proof."""

    layer: int
    equation: int
    members: tuple[CmtSymbolWithProof, ...]


def generate_fraud(entry: CmtEntry, layer: int, equation: int) -> CmtFraudProof:
    """Full-node side: the proof assembled from an entry it holds."""
    return CmtFraudProof(
        layer=layer, equation=equation,
        members=tuple(CmtSymbolWithProof(index=m, symbol=bytes(entry.layers[layer][m]),
                                         doc=open_sample(entry, layer, m))
                      for m in equation_members(entry.commitments, layer, equation)),
    )


def verify_fraud(commitments: CmtCommitments, proof: CmtFraudProof) -> bool:
    """True iff every member verifies against the commitments at the
    positions the recomputed equation demands and the data members' XOR
    differs from the parity member. False for malformed proofs and honest
    blocks."""
    try:
        plan = commitments.plan
        if not 0 <= proof.layer < len(plan):
            return False
        if not 0 <= proof.equation < plan[proof.layer][0]:
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
        acc = np.zeros(plan[proof.layer][1], dtype=np.uint8)
        for s in syms[:-1]:
            acc ^= np.frombuffer(s, dtype=np.uint8)
        return not np.array_equal(acc, np.frombuffer(syms[-1], dtype=np.uint8))
    except (KeyError, TypeError, ValueError, IndexError, AttributeError):
        # AttributeError: a proof routed against another scheme's commitments
        return False


# ---------------------------------------------------------------------------
# the Codec implementation
# ---------------------------------------------------------------------------


class CmtCodec(codec_mod.Codec):
    scheme_id = codec_mod.SCHEME_CMT
    name = codec_mod.CMT_NAME
    CATCH_BP = 2500  # declared sampling threshold (module docstring)

    def compute_entry(self, ods: np.ndarray, device=None) -> CmtEntry:
        from celestia_app_tpu_torch.da import edscache

        return edscache.compute_entry(ods, device, scheme=self.name)

    def _encode_impl(self, ods: np.ndarray, device=None) -> CmtEntry:
        return build_layers(ods, device)

    def commitments_doc(self, entry) -> dict:
        c = entry.dah
        return {"scheme": self.name, "k": c.k, "q": Q, "degree": ldpc.DEGREE, "root_max": ROOT_MAX,
                "root_hashes": [h.hex() for h in c.root_hashes], "data_root": entry.data_root.hex()}

    def commitments_from_doc(self, doc: dict, data_root_hex: str, square_size: int) -> CmtCommitments:
        try:
            if int(doc["q"]) != Q or int(doc["degree"]) != ldpc.DEGREE or int(doc["root_max"]) != ROOT_MAX:
                raise codec_mod.CodecError("served CMT parameters differ from this build's")
            c = CmtCommitments(k=int(doc["k"]), root_hashes=tuple(bytes.fromhex(h) for h in doc["root_hashes"]))
        except (KeyError, TypeError, ValueError) as e:
            raise codec_mod.CodecError(f"malformed CMT commitments doc: {e}") from None
        c.validate_basic()
        if c.k != square_size:
            raise codec_mod.CodecError("served CMT k contradicts the header square size")
        if c.hash().hex() != data_root_hex:
            raise codec_mod.CodecError("served CMT commitments do not bind to the data root")
        return c

    def sample_space(self, commitments) -> list[tuple[int, int]]:
        # base layer only: each proof carries one symbol of every upper layer
        return [(0, i) for i in range(commitments.n_base)]

    def open_sample(self, entry, cell: tuple[int, int], device=None) -> dict:
        return open_sample(entry, cell[0], cell[1])

    def verify_sample(self, commitments, doc: dict):
        return verify_sample(commitments, doc)

    def sample_wire_bytes(self, doc: dict, commitments=None) -> int:
        if commitments is None:
            raise codec_mod.CodecError("cmt wire size needs commitments")
        return sample_wire_bytes(commitments, doc)

    def hashes_per_sample_verify(self, commitments) -> int:
        return len(commitments.plan)  # the symbol hash, then one per step

    def repair(self, commitments, samples: dict, device=None) -> np.ndarray:
        return repair(commitments, samples, device)

    def build_fraud_proof(self, entry, location) -> CmtFraudProof:
        layer, equation = location
        return generate_fraud(entry, layer, equation)

    def verify_fraud_proof(self, commitments, proof, device=None) -> bool:
        return verify_fraud(commitments, proof)

    def fraud_proof_type(self) -> type:
        return CmtFraudProof

    def commitments_type(self) -> type:
        return CmtCommitments

    def fraud_cells(self, commitments, location) -> list[tuple]:
        layer, equation = location
        return [(layer, m) for m in equation_members(commitments, layer, equation)]

    def fraud_proof_from_members(self, commitments, location, members: list[tuple]) -> CmtFraudProof:
        layer, equation = location
        return CmtFraudProof(layer=layer, equation=equation, members=tuple(
            CmtSymbolWithProof(index=cell[1], symbol=payload, doc=doc) for cell, payload, doc in members))


codec_mod.register(CmtCodec())
