"""Light client: verify a chain of headers from commit certificates alone.

Copied from celestia_app_tpu/chain/light.py.

Reference parity: celestia-core's `light` package (Tendermint light client
— SURVEY §1 L1). A light client holds a trusted (height, validator set)
and accepts new headers without executing any transactions:

- **sequential / same-valset**: the certificate must carry >2/3 of the
  TRUSTED set's power over the new header's hash.
- **valset change (skipping trust, Tendermint's 1/3 rule)**: the caller
  supplies the candidate new set; it must hash to the new header's
  `validators_hash` commitment, every pubkey must derive its operator
  address (addresses ARE pubkey hashes, chain/crypto.py), the certificate
  must carry >2/3 of the NEW set — and, to prevent long-range forks,
  >1/3 of the TRUSTED set's power must also have signed.

Headers commit to their (operator, power) set via `validators_hash`
(chain/block.validators_hash_of); every full node's ProcessProposal
recomputes and enforces it, so the commitment a light client sees is the
one consensus agreed on. The IBC verifying client (chain/ibc.py) is the
packet-plane consumer of the same certificate verification; this module
adds header-chain FOLLOWING with valset transitions.
"""

from __future__ import annotations

import dataclasses

from celestia_app_tpu_torch.chain.block import Header, validators_hash_of
from celestia_app_tpu_torch.chain.consensus import CommitCertificate
from celestia_app_tpu_torch.chain.crypto import PublicKey


class LightClientError(ValueError):
    pass


@dataclasses.dataclass
class TrustedState:
    height: int
    header_hash: bytes
    validators: dict[bytes, bytes]  # operator address -> 33-byte pubkey
    powers: dict[bytes, int]


class LightClient:
    """Follows headers by certificate verification only."""

    def __init__(self, chain_id: str, trusted: TrustedState,
                 check_set: bool = True):
        """`check_set=False` skips re-validating the trusted set's
        pubkey/address derivations — for callers restoring a set THEY
        validated and persisted (the IBC client keeper's per-update
        reconstruction), not for fresh external input."""
        self.chain_id = chain_id
        self.trusted = trusted
        # data roots condemned by verified bad-encoding fraud proofs:
        # headers carrying them are refused even with a valid certificate
        # (>2/3 of validators signing a non-codeword IS the fraud-proof
        # threat model — specs fraud_proofs.md)
        self.condemned_roots: set[bytes] = set()
        if check_set:
            self._check_set(trusted.validators, trusted.powers)

    def submit_fraud_proof(self, commitments, proof, device=None) -> bool:
        """A gossiped incorrect-coding fraud proof against a block's DA
        commitments. The proof's TYPE selects the codec through the
        registry (each codec declares its ``fraud_proof_type`` —
        da/codec.py), so a new scheme's proofs are dispatchable by
        registration alone. If it VERIFIES — the committed roots carry
        an invalid codeword — the data root (``commitments.hash()``,
        whichever scheme) is condemned and any header carrying it will
        be refused. Returns whether the proof checked out.

        The check runs on `device` (the card unless the caller asks for
        the CPU). Only the proof's own faults make a False verdict: a
        proof against another scheme's commitments, or one that does not
        parse against them (ValueError, TypeError, KeyError,
        CodecError), is counted in ``light.malformed_fraud_proofs``. An
        error of the device work (a RuntimeError from the card, a kernel
        wrapper's ``cuda_build.KernelError``) is no verdict and
        propagates."""
        from celestia_app_tpu_torch import cuda_build
        from celestia_app_tpu_torch.da import codec as dacodec

        codec = None
        for sid in dacodec.registered_ids():
            candidate = dacodec.by_id(sid)
            try:
                proof_type = candidate.fraud_proof_type()
            except NotImplementedError:
                continue
            if isinstance(proof, proof_type):
                codec = candidate
                break
        if codec is None:
            return False
        from celestia_app_tpu_torch.utils import telemetry

        if not isinstance(commitments, codec.commitments_type()):
            # untrusted input end to end: a proof of another scheme than
            # the commitments' (e.g. a BEFP against CmtCommitments) is
            # refused, never escapes — this API promises a bool verdict
            telemetry.incr("light.malformed_fraud_proofs")
            return False
        try:
            ok = codec.verify_fraud_proof(commitments, proof, device)
        except cuda_build.KernelError:
            raise
        except (ValueError, TypeError, KeyError, dacodec.CodecError):
            # a proof whose members do not parse against the commitments
            telemetry.incr("light.malformed_fraud_proofs")
            return False
        if not ok:
            return False
        self.condemned_roots.add(commitments.hash())
        return True

    @staticmethod
    def _check_set(validators: dict[bytes, bytes],
                   powers: dict[bytes, int]) -> None:
        for op, pub in validators.items():
            if PublicKey(pub).address() != op:
                raise LightClientError(
                    f"pubkey does not derive operator {op.hex()[:12]}"
                )
        if set(validators) != set(powers):
            raise LightClientError("validator/power key sets differ")

    def _signed_power(self, cert: CommitCertificate,
                      validators: dict[bytes, bytes],
                      powers: dict[bytes, int]) -> int:
        # the ONE vote-counting implementation (CommitCertificate)
        return cert.signed_power(self.chain_id, validators, powers)

    def update(
        self,
        header: Header,
        cert: CommitCertificate,
        new_validators: dict[bytes, bytes] | None = None,
        new_powers: dict[bytes, int] | None = None,
    ) -> TrustedState:
        """Advance trust to `header`. Raises LightClientError on any
        verification failure; on success the new state is adopted AND
        returned."""
        if header.chain_id != self.chain_id:
            raise LightClientError("wrong chain id")
        if header.height <= self.trusted.height:
            raise LightClientError(
                f"non-monotonic header: {header.height} <= {self.trusted.height}"
            )
        if cert.height != header.height or cert.block_hash != header.hash():
            raise LightClientError("certificate does not cover this header")
        if header.data_hash in self.condemned_roots:
            raise LightClientError(
                "header carries a data root condemned by a fraud proof"
            )
        # sequential hash-linkage: an adjacent header must chain to the
        # trusted one (skipping updates have no such check — the overlap
        # rule carries trust across the gap)
        if (header.height == self.trusted.height + 1
                and self.trusted.header_hash
                and header.last_block_hash != self.trusted.header_hash):
            raise LightClientError(
                "adjacent header does not chain to the trusted header"
            )

        if new_validators is None:
            # same-valset path: the header must still commit to the
            # trusted set, and >2/3 of it must have signed
            want = validators_hash_of(
                [(op, p) for op, p in self.trusted.powers.items()]
            )
            if header.validators_hash != want:
                raise LightClientError(
                    "validator set changed: supply the new set"
                )
            total = sum(self.trusted.powers.values())
            if self._signed_power(
                cert, self.trusted.validators, self.trusted.powers
            ) * 3 <= total * 2:
                raise LightClientError("certificate below 2/3 of trusted power")
            vals, powers = self.trusted.validators, self.trusted.powers
        else:
            if new_powers is None:
                raise LightClientError("new validator set needs powers")
            self._check_set(new_validators, new_powers)
            # the candidate set must BE the one the header commits to
            want = validators_hash_of(list(new_powers.items()))
            if header.validators_hash != want:
                raise LightClientError(
                    "candidate set does not match the header's commitment"
                )
            new_total = sum(new_powers.values())
            if self._signed_power(
                cert, new_validators, new_powers
            ) * 3 <= new_total * 2:
                raise LightClientError("certificate below 2/3 of new power")
            # Tendermint skipping-trust overlap: >1/3 of the TRUSTED set
            # must also have signed, or a long-gone valset could fork us
            old_total = sum(self.trusted.powers.values())
            if self._signed_power(
                cert, self.trusted.validators, self.trusted.powers
            ) * 3 <= old_total:
                raise LightClientError(
                    "certificate below 1/3 of trusted power (no overlap)"
                )
            vals, powers = new_validators, new_powers

        self.trusted = TrustedState(
            height=header.height,
            header_hash=header.hash(),
            validators=dict(vals),
            powers=dict(powers),
        )
        return self.trusted
