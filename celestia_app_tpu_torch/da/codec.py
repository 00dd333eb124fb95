"""The codec plane: DA commitment schemes behind one interface. The port
of celestia_app_tpu/da/codec.py.

- ``Codec`` is what a scheme implements: encode an ODS into an entry with
  commitments and a 32-byte data root; open and verify sample proofs;
  repair from a subset of symbols; build and verify incorrect-coding fraud
  proofs; and the scheme's own confidence arithmetic (the per-sample catch
  probability differs per construction).
- The registry binds names to wire ids (FORMATS §16.1): id 0 is the 2D-RS
  + NMT default (da/codec_rs2d.py), id 1 the Coded Merkle Tree
  (da/cmt.py, LDGM-coded layers) and id 2 the Polar Coded Merkle Tree
  (da/pcmt.py, polar-coded layers). All three encode on the card through
  kernel K1 (and K2 for the default); a header's ``da_scheme`` picks one.
"""

from __future__ import annotations

import math

# Wire scheme ids (FORMATS §16.1): headers encode the id (absent/0 =
# rs2d-nmt for back-compat), JSON surfaces carry the name.
SCHEME_RS2D = 0
SCHEME_CMT = 1
SCHEME_PCMT = 2

RS2D_NAME = "rs2d-nmt"
CMT_NAME = "cmt-ldpc"
PCMT_NAME = "pcmt-polar"


class CodecError(ValueError):
    """Malformed scheme input (unknown scheme, bad proof shape, ...)."""


class BadEncodingDetected(Exception):
    """Base of every scheme's incorrect-coding detection: repair() found
    that the commitments provably commit an invalid codeword. ``location``
    is the scheme's fraud coordinate (("row", 1) for rs2d-nmt, (layer,
    equation) for cmt-ldpc and pcmt-polar), what ``build_fraud_proof`` and
    ``fraud_cells`` consume."""

    def __init__(self, location: tuple, msg: str):
        super().__init__(msg)
        self.location = location


class Codec:
    """One DA commitment scheme. Stateless: entries carry the per-block
    payload; the codec owns the algorithms and parameters.

    An entry (from ``compute_entry``) has ``.data_root`` (32 bytes),
    ``.dah`` (the commitments, with ``.hash() == data_root``), ``.k`` (ODS
    width) and ``.warm(device)``."""

    scheme_id: int
    name: str

    # basis points of the per-sample withholding catch probability: the
    # fraction of the scheme's sampleable units an adversary must withhold
    # before data becomes unrecoverable (10000 = certainty)
    CATCH_BP: int

    # -- encode / commit -------------------------------------------------

    def compute_entry(self, ods, device=None):
        """(k, k, 512) u8 ODS -> scheme entry (commitments, payload, data
        root), computed on `device` (the card unless the caller asks for
        the CPU)."""
        raise NotImplementedError

    def _encode_impl(self, ods, device=None):
        """Raw encode hook that `da/edscache.compute_entry` resolves through
        the registry for the non-default schemes; callers use
        ``compute_entry``."""
        raise NotImplementedError

    def min_entry(self, device=None):
        """Entry of the minimum (empty-block) square: one tail-padding
        share, the scheme's genesis and empty-block data root."""
        import numpy as np

        from celestia_app_tpu_torch.da import shares as shares_mod

        share = np.frombuffer(shares_mod.tail_padding_share(), dtype=np.uint8)
        return self.compute_entry(share.reshape(1, 1, -1), device)

    # -- commitments on the wire ----------------------------------------

    def commitments_doc(self, entry) -> dict:
        """The scheme-specific half of the /das/header JSON payload."""
        raise NotImplementedError

    def commitments_from_doc(self, doc: dict, data_root_hex: str, square_size: int):
        """Parse and verify a served commitments doc against the certified
        data root and header square size; raises CodecError if it does not
        bind. Returns the commitments object."""
        raise NotImplementedError

    # -- sampling --------------------------------------------------------

    def sample_space(self, commitments) -> list[tuple[int, int]]:
        """Every sampleable cell as a wire (a, b) pair; light clients draw
        uniformly from this space."""
        raise NotImplementedError

    def open_sample(self, entry, cell: tuple[int, int], device=None) -> dict:
        """Serve one cell: the sample JSON doc (FORMATS §7.2 / §16.3)."""
        raise NotImplementedError

    def verify_sample(self, commitments, doc: dict):
        """Verify one served sample doc against trusted commitments.
        Returns (cell, payload_bytes) on success, None on any failure."""
        raise NotImplementedError

    def sample_wire_bytes(self, doc: dict, commitments=None) -> int:
        """Exact canonical binary size of one sample proof (FORMATS
        §16.3), not the JSON/base64 transport size."""
        raise NotImplementedError

    def hashes_per_sample_verify(self, commitments) -> int:
        """SHA-256 compression invocations a verifier pays per sample."""
        raise NotImplementedError

    # -- repair / fraud --------------------------------------------------

    def repair(self, commitments, samples: dict, device=None):
        """Reconstruct the full ODS from verified samples ({cell: payload
        bytes}). Raises the scheme's bad-encoding error (carrying the fraud
        location) when the commitments provably commit an invalid codeword,
        ValueError when simply short of the repair threshold. Returns the
        (k, k, 512) ODS."""
        raise NotImplementedError

    def build_fraud_proof(self, entry, location):
        """Producer or full-node side: the compact incorrect-coding proof
        for a bad location that a repair attempt surfaced."""
        raise NotImplementedError

    def verify_fraud_proof(self, commitments, proof, device=None) -> bool:
        """Light-node side: True iff the proof demonstrates that the
        commitments commit an invalid codeword."""
        raise NotImplementedError

    def fraud_proof_type(self) -> type:
        """The scheme's fraud-proof class."""
        raise NotImplementedError

    def commitments_type(self) -> type:
        """The scheme's commitments class (what ``commitments_from_doc``
        returns); a scheme with a fraud-proof class declares it too."""
        raise NotImplementedError

    def fraud_cells(self, commitments, location) -> list[tuple]:
        """The sample cells a light node must hold, served and verified, to
        assemble the fraud proof for ``location`` (schemes whose proofs are
        not assembled from served cells need not implement it)."""
        raise NotImplementedError

    def fraud_proof_from_members(self, commitments, location, members: list[tuple]):
        """The proof assembled from served members: one (cell, payload,
        sample doc) triple per ``fraud_cells`` cell, in order."""
        raise NotImplementedError

    # -- confidence arithmetic (per scheme; light-client math) -----------

    def catch_probability(self) -> float:
        """Per-sample probability that a borderline withholding attack
        loses the sample (the scheme's availability threshold)."""
        return self.CATCH_BP / 10000.0

    def confidence(self, samples: int) -> float:
        """1 - (1 - catch)^s: availability confidence after s verified
        samples."""
        return 1.0 - (1.0 - self.catch_probability()) ** samples

    def samples_for_confidence(self, target: float = 0.99) -> int:
        """Smallest s with confidence(s) >= target."""
        if not 0.0 < target < 1.0:
            raise CodecError(f"confidence target {target} not in (0, 1)")
        miss = 1.0 - self.catch_probability()
        return max(1, math.ceil(math.log(1.0 - target) / math.log(miss)))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Codec] = {}
_BY_ID: dict[int, Codec] = {}


def register(codec: Codec) -> Codec:
    """Bind a codec under its name and wire id (re-registering a name
    replaces it)."""
    _REGISTRY[codec.name] = codec
    _BY_ID[codec.scheme_id] = codec
    return codec


def _ensure_builtin() -> None:
    # lazy: the scheme modules import da/edscache and ops/, which need not
    # load with this module
    if RS2D_NAME not in _REGISTRY:
        from celestia_app_tpu_torch.da import codec_rs2d  # noqa: F401
    if CMT_NAME not in _REGISTRY:
        from celestia_app_tpu_torch.da import cmt  # noqa: F401
    if PCMT_NAME not in _REGISTRY:
        from celestia_app_tpu_torch.da import pcmt  # noqa: F401


def _registered_desc() -> str:
    """'id=name' listing for unknown-scheme errors: whoever asks for a
    scheme the port does not carry sees what it does carry."""
    return ", ".join(f"{i}={_BY_ID[i].name}" for i in sorted(_BY_ID))


def get(name: str) -> Codec:
    """Codec by scheme name; raises CodecError for unknown schemes."""
    _ensure_builtin()
    codec = _REGISTRY.get(name)
    if codec is None:
        raise CodecError(f"unknown DA scheme {name!r} (registered: {_registered_desc()})")
    return codec


def by_id(scheme_id: int) -> Codec:
    """Codec by wire id (header da_scheme field; absent = 0 = rs2d)."""
    _ensure_builtin()
    codec = _BY_ID.get(scheme_id)
    if codec is None:
        raise CodecError(f"unknown DA scheme id {scheme_id} (registered: {_registered_desc()})")
    return codec


def default() -> Codec:
    return get(RS2D_NAME)


def names() -> list[str]:
    _ensure_builtin()
    return sorted(_REGISTRY)


def registered_ids() -> list[int]:
    """Sorted wire ids of every registered scheme."""
    _ensure_builtin()
    return sorted(_BY_ID)
