"""The default DA scheme behind the codec interface, 2D-RS + NMT: the port
of celestia_app_tpu/da/codec_rs2d.py.

A thin adapter: the algorithms stay where they live (da/edscache.py for
the encode, da/proof_device.py for the provers, da/repair.py for the
sweep engine, da/fraud.py for BEFPs); the codec gives them the face that
the DAS plane and the light client use.

Sampling threshold: to make any original share unrecoverable a withholder
must hide more than (k+1)^2 of the (2k)^2 extended cells, over a quarter,
so CATCH_BP is 2500, a combinatorial bound.
"""

from __future__ import annotations

import base64

import numpy as np

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.da import codec as codec_mod
from celestia_app_tpu_torch.da import edscache, fraud, sampling
from celestia_app_tpu_torch.da import repair as repair_mod
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
from celestia_app_tpu_torch.da.shares import uvarint
from celestia_app_tpu_torch.utils import nmt_host

NMT_ROOT = appconsts.NMT_ROOT_SIZE  # 90


class Rs2dBadEncoding(codec_mod.BadEncodingDetected):
    """Normalized bad-encoding location (axis, index): a re-raise wrapper,
    so codec callers need not import da/repair's exception."""

    def __init__(self, axis: str, index: int):
        super().__init__((axis, index), f"bad {axis} {index}")
        self.axis = axis
        self.index = index


class Rs2dNmtCodec(codec_mod.Codec):
    scheme_id = codec_mod.SCHEME_RS2D
    name = codec_mod.RS2D_NAME
    CATCH_BP = 2500

    # -- encode ----------------------------------------------------------

    def compute_entry(self, ods: np.ndarray, device=None) -> edscache.EdsCacheEntry:
        return edscache.compute_entry(ods, device)

    # -- commitments on the wire (the /das/header doc, FORMATS §7) -------

    def commitments_doc(self, entry) -> dict:
        dah = entry.dah
        return {
            "scheme": self.name,
            "square_width": len(dah.row_roots),
            "row_roots": [r.hex() for r in dah.row_roots],
            "col_roots": [c.hex() for c in dah.col_roots],
            "data_root": entry.data_root.hex(),
        }

    def commitments_from_doc(self, doc: dict, data_root_hex: str,
                             square_size: int) -> DataAvailabilityHeader:
        try:
            dah = DataAvailabilityHeader(
                row_roots=tuple(bytes.fromhex(x) for x in doc["row_roots"]),
                col_roots=tuple(bytes.fromhex(x) for x in doc["col_roots"]),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise codec_mod.CodecError(f"malformed DAH doc: {e}") from None
        try:
            dah.validate_basic()
        except ValueError as e:
            raise codec_mod.CodecError(str(e)) from None
        if dah.hash().hex() != data_root_hex:
            raise codec_mod.CodecError("served DAH does not bind to the certified root")
        if len(dah.row_roots) != 2 * square_size:
            raise codec_mod.CodecError("served DAH width contradicts the header")
        return dah

    # -- sampling --------------------------------------------------------

    def sample_space(self, commitments) -> list[tuple[int, int]]:
        width = len(commitments.row_roots)
        return [(r, c) for r in range(width) for c in range(width)]

    def open_sample(self, entry, cell: tuple[int, int], device=None) -> dict:
        """One cell with its proof from the entry's row prover, built on
        `device` at first use (the card unless the caller asks for the CPU)."""
        row, col = cell
        share, proof = entry.get_prover(device).prove_cell(row, col)
        return {
            "row": row,
            "col": col,
            "share": base64.b64encode(share).decode(),
            "proof": {
                "start": proof.start,
                "end": proof.end,
                "total": proof.total,
                "nodes": [base64.b64encode(n).decode() for n in proof.nodes],
            },
        }

    def verify_sample(self, commitments, doc: dict):
        try:
            row, col = int(doc["row"]), int(doc["col"])
            share = base64.b64decode(doc["share"])
            proof = nmt_host.NmtRangeProof(
                start=int(doc["proof"]["start"]),
                end=int(doc["proof"]["end"]),
                total=int(doc["proof"]["total"]),
                nodes=[base64.b64decode(n) for n in doc["proof"]["nodes"]],
            )
        except (KeyError, TypeError, ValueError):
            return None
        if not sampling.verify_sample(commitments, row, col, share, proof):
            return None
        return (row, col), share

    def sample_wire_bytes(self, doc: dict, commitments=None) -> int:
        return (len(uvarint(int(doc["row"])))
                + len(uvarint(int(doc["col"])))
                + len(base64.b64decode(doc["share"]))
                + len(uvarint(int(doc["proof"]["start"])))
                + len(uvarint(int(doc["proof"]["end"])))
                + len(uvarint(int(doc["proof"]["total"])))
                + len(doc["proof"]["nodes"]) * NMT_ROOT)

    def hashes_per_sample_verify(self, commitments) -> int:
        # one leaf hash + one inner hash per proof node up the 2k tree
        width = len(commitments.row_roots)
        return 1 + (width - 1).bit_length()

    # -- repair / fraud --------------------------------------------------

    def repair(self, commitments, samples: dict, device=None) -> np.ndarray:
        """The ODS from verified samples, through the batched `repair_eds`
        on `device` (the card unless the caller asks for the CPU)."""
        width = len(commitments.row_roots)
        k = width // 2
        symbols = np.zeros((width, width, appconsts.SHARE_SIZE), dtype=np.uint8)
        present = np.zeros((width, width), dtype=bool)
        for (r, c), share in sorted(samples.items()):
            symbols[r, c] = np.frombuffer(share, dtype=np.uint8)
            present[r, c] = True
        try:
            repaired = repair_mod.repair_eds(symbols, present, list(commitments.row_roots),
                                             list(commitments.col_roots), device=device)
        except repair_mod.BadEncodingError as e:
            raise Rs2dBadEncoding(e.axis, e.index) from e
        return repaired[:k, :k]

    def build_fraud_proof(self, entry, location) -> fraud.BadEncodingProof:
        axis, index = location
        return fraud.generate_befp(entry.eds, axis, index)

    def verify_fraud_proof(self, commitments, proof, device=None) -> bool:
        return fraud.verify_befp(commitments, proof, device)

    def fraud_proof_type(self) -> type:
        return fraud.BadEncodingProof

    def commitments_type(self) -> type:
        return DataAvailabilityHeader


codec_mod.register(Rs2dNmtCodec())
