"""Multi-node consensus coordination: votes, gossip, WAL replay, state sync.

The reference delegates this plane to celestia-core (Tendermint: p2p gossip
of txs/proposals/votes, the write-ahead log replayed on crash recovery
(app/app.go:435 LoadLatestVersion + WAL), and state-sync snapshots serving
fast bootstrap (default_overrides.go:294-297)). This module coordinates
N validator instances of THIS framework the same way, with an in-process
message bus standing in for TCP gossip (the single-container analog of
test/util/testnode's real-node network):

- **Proposals + votes**: the height's proposer (round-robin by voting
  power order) runs PrepareProposal; every validator independently replays
  it through ProcessProposal and casts a SIGNED prevote for the block hash
  (or nil on rejection). ≥2/3 of voting power on the same hash forms a
  commit certificate; every node then finalizes + commits the identical
  block and must land on the identical app hash (divergence raises).
- **Commit certificates** are persisted with each height and verifiable
  offline: height, block hash, and the validators' signatures over the
  canonical vote bytes.
- **WAL**: each node appends {proposal, votes} to a height-keyed JSON WAL
  BEFORE applying the block; a node that crashed between WAL write and
  commit replays the WAL entry on restart and converges without re-running
  consensus (Tendermint's replay semantics).
- **State sync**: a fresh node bootstraps from a peer by fetching snapshot
  CHUNKS (the peer's committed store in deterministic key-ranged pieces),
  verifying the reassembled store's app hash against the trusted header's
  app_hash before adopting it — a wrong/altered chunk set is rejected.

Port of celestia_app_tpu/chain/consensus.py. A validator runs its App on
`device` (``ValidatorNode(device=...)``): the card unless the caller asks
for the CPU, and a RuntimeError where there is no card, as `App` does.
There is no ``engine``, no ``auto`` and no ``mesh``. Every height's
ProcessProposal, the batched admission of `add_txs` and the WAL replay's
prevalidation run there; votes, certificates, proposals and evidence are
signed and checked on the host, as in the reference. ``app_version``
sets the genesis app version (the reference starts every chain at 1).
The two consensus fault points carry the validator's name beside the
height, so a fault can be armed on one validator, and an armed "error"
raises OSError there (the reference acts on "crash" alone). Every byte
format (the WAL record, priv_validator_state.json, snapshot manifests
and chunks, the JSON of votes, certificates, proposals and evidence) is
the reference's, so either package reads what the other wrote.
`SNAPSHOT_CHUNK_KEYS` is a plain module constant: the port reads no
environment.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

from celestia_app_tpu_torch import faults
from celestia_app_tpu_torch import obs
from celestia_app_tpu_torch.chain.app import App
from celestia_app_tpu_torch.chain.block import Block, Header
from celestia_app_tpu_torch.chain.crypto import PrivateKey, PublicKey
from celestia_app_tpu_torch.chain.state import Context, InfiniteGasMeter
from celestia_app_tpu_torch.utils import telemetry


@dataclasses.dataclass(frozen=True)
class Vote:
    height: int
    block_hash: bytes | None  # None = nil vote (proposal rejected)
    validator: bytes  # 20-byte operator address
    signature: bytes
    phase: str = "precommit"  # "prevote" | "precommit" (Tendermint steps)
    round: int = 0

    @staticmethod
    def sign_bytes(
        chain_id: str, height: int, block_hash: bytes | None,
        phase: str = "precommit", round_: int = 0,
    ) -> bytes:
        """The signed vote document. It commits to (chain_id, height,
        ROUND, block hash, phase) — Tendermint's CanonicalVote fields
        (celestia-core types/vote.go) — so a relayed old-round vote can
        never be replayed into a newer round, per-round attribution is
        exact, and same-round duplicate votes (either phase) are the
        slashable double-sign."""
        doc = {
            "chain_id": chain_id,
            "height": height,
            "round": round_,
            "block_hash": block_hash.hex() if block_hash else None,
            "type": phase,
        }
        return json.dumps(doc, sort_keys=True).encode()


@dataclasses.dataclass(frozen=True)
class CommitCertificate:
    height: int
    block_hash: bytes
    votes: tuple[Vote, ...]
    # The commit round (Tendermint Commit.Round): every counted precommit
    # must be FROM this round. Cross-round aggregation would void the
    # textbook safety proof once unlock-on-higher-polka lets an honest
    # validator legally precommit different hashes in different rounds.
    round: int = 0

    def signed_power(self, chain_id: str, validators: dict[bytes, bytes],
                     powers: dict[bytes, int]) -> int:
        """THE vote-counting core: total power of distinct validators whose
        precommit signature over THIS (height, round, block_hash) verifies
        against `validators` (operator address -> 33-byte pubkey; the pubkey
        must derive the address). Shared by certificate verification, the
        light client's 2/3 and 1/3-overlap checks (chain/light.py), and the
        IBC verifying client — one hardening fix reaches every consumer."""
        signed = 0
        seen: set[bytes] = set()
        doc = Vote.sign_bytes(chain_id, self.height, self.block_hash,
                              round_=self.round)
        for v in self.votes:
            if (v.validator in seen or v.block_hash != self.block_hash
                    or v.height != self.height or v.phase != "precommit"
                    or v.round != self.round):
                continue
            pub = validators.get(v.validator)
            if pub is None or PublicKey(pub).address() != v.validator:
                continue
            if not PublicKey(pub).verify(v.signature, doc):
                continue
            seen.add(v.validator)
            signed += powers.get(v.validator, 0)
        return signed

    def verify(self, chain_id: str, validators: dict[bytes, bytes],
               total_power: int, powers: dict[bytes, int]) -> bool:
        """Check ≥2/3 of `total_power` signed this block hash.

        STRICTLY more than 2/3 (Tendermint): at exactly 2/3, two
        conflicting certificates could overlap in only 1/3 of power —
        all of it byzantine — losing the accountability guarantee."""
        return self.signed_power(chain_id, validators, powers) * 3 > total_power * 2


# ---------------------------------------------------------------------------
# JSON codecs for consensus types: one definition shared by the WAL record,
# the socket wire (service/validator_server.py), and state-sync manifests —
# divergent encodings would let a replayed WAL disagree with live peers.
# ---------------------------------------------------------------------------


def header_to_json(h: Header) -> dict:
    doc = {
        "chain_id": h.chain_id,
        "height": h.height,
        "time_unix": h.time_unix,
        "data_hash": h.data_hash.hex(),
        "square_size": h.square_size,
        "app_hash": h.app_hash.hex(),
        "proposer": h.proposer.hex(),
        "app_version": h.app_version,
        "last_block_hash": h.last_block_hash.hex(),
        "validators_hash": h.validators_hash.hex(),
    }
    if h.da_scheme:
        # emitted only for non-default schemes: default-scheme docs stay
        # byte-identical to pre-codec-plane ones (WAL/socket/snapshot
        # encodings are shared — FORMATS §16.1)
        doc["da_scheme"] = h.da_scheme
    return doc


def header_from_json(d: dict) -> Header:
    return Header(
        chain_id=d["chain_id"],
        height=d["height"],
        time_unix=d["time_unix"],
        data_hash=bytes.fromhex(d["data_hash"]),
        square_size=d["square_size"],
        app_hash=bytes.fromhex(d["app_hash"]),
        proposer=bytes.fromhex(d["proposer"]),
        app_version=d["app_version"],
        last_block_hash=bytes.fromhex(d["last_block_hash"]),
        # STRICT: a header doc without the validators_hash commitment is
        # from a pre-commitment encoding whose block hash no longer matches
        # this code — failing loudly here beats silently re-hashing it to a
        # value none of its stored votes cover
        validators_hash=bytes.fromhex(d["validators_hash"]),
        # absent ⇒ 0 = 2D-RS+NMT (the codec plane's back-compat rule)
        da_scheme=d.get("da_scheme", 0),
    )


def block_to_json(b: Block) -> dict:
    import base64

    return {
        "header": header_to_json(b.header),
        "txs": [base64.b64encode(tx).decode() for tx in b.txs],
    }


def block_from_json(d: dict) -> Block:
    import base64

    return Block(
        header=header_from_json(d["header"]),
        txs=[base64.b64decode(t) for t in d["txs"]],
    )


def vote_to_json(v: Vote) -> dict:
    return {
        "height": v.height,
        "block_hash": v.block_hash.hex() if v.block_hash else None,
        "validator": v.validator.hex(),
        "signature": v.signature.hex(),
        "phase": v.phase,
        "round": v.round,
    }


def vote_from_json(d: dict) -> Vote:
    return Vote(
        d["height"],
        bytes.fromhex(d["block_hash"]) if d["block_hash"] else None,
        bytes.fromhex(d["validator"]),
        bytes.fromhex(d["signature"]),
        d.get("phase", "precommit"),
        int(d.get("round", 0)),
    )


def cert_to_json(c: CommitCertificate) -> dict:
    return {
        "height": c.height,
        "block_hash": c.block_hash.hex(),
        "votes": [vote_to_json(v) for v in c.votes],
        "round": c.round,
    }


def cert_from_json(d: dict) -> CommitCertificate:
    return CommitCertificate(
        d["height"],
        bytes.fromhex(d["block_hash"]),
        tuple(vote_from_json(v) for v in d["votes"]),
        int(d.get("round", 0)),
    )


def evidence_to_json(ev: "DuplicateVoteEvidence") -> dict:
    return {
        "height": ev.height,
        "votes": [vote_to_json(v) for v in (ev.vote_a, ev.vote_b)],
    }


def evidence_from_json(d: dict) -> "DuplicateVoteEvidence":
    # pre-round-4 WAL evidence votes carried height only on the OUTER dict
    a, b = (
        vote_from_json({"height": d["height"], **v}) for v in d["votes"]
    )
    return DuplicateVoteEvidence(d["height"], a, b)


@dataclasses.dataclass(frozen=True)
class Proposal:
    """Signed proposal envelope for the autonomous (gossip) consensus mode.

    Tendermint proposals carry the block plus the consensus-critical
    commit-info the whole network must apply IDENTICALLY: the commit
    certificate for height-1 (LastCommitInfo — what liveness accounting
    reads) and the equivocation evidence for this height. In the
    orchestrated socket mode one coordinator picks those for everyone; in
    autonomous mode every node assembles its own certificate from gossip,
    so cert contents differ per node — the proposer's choice, committed to
    by this envelope's signature, is what keeps app hashes equal.

    The signature covers (chain_id, height, round, block hash, and a
    digest of last_cert+evidence), so a relaying peer cannot swap the
    commit-info under a real proposal.
    """

    height: int
    round: int
    block: Block
    proposer: bytes  # 20-byte operator address
    signature: bytes
    last_cert: CommitCertificate | None  # None only at height 1
    evidence: tuple["DuplicateVoteEvidence", ...] = ()

    @staticmethod
    def commit_info_digest(
        last_cert: CommitCertificate | None,
        evidence: tuple["DuplicateVoteEvidence", ...],
    ) -> bytes:
        doc = {
            "last_cert": cert_to_json(last_cert) if last_cert else None,
            "evidence": [evidence_to_json(e) for e in evidence],
        }
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()
        ).digest()

    @staticmethod
    def sign_bytes(
        chain_id: str, height: int, round_: int, block_hash: bytes,
        info_digest: bytes,
    ) -> bytes:
        doc = {
            "chain_id": chain_id,
            "height": height,
            "round": round_,
            "block_hash": block_hash.hex(),
            "commit_info": info_digest.hex(),
            "type": "proposal",
        }
        return json.dumps(doc, sort_keys=True).encode()

    def verify(self, chain_id: str, pubkey: bytes) -> bool:
        doc = Proposal.sign_bytes(
            chain_id, self.height, self.round, self.block.header.hash(),
            Proposal.commit_info_digest(self.last_cert, self.evidence),
        )
        pk = PublicKey(pubkey)
        return pk.address() == self.proposer and pk.verify(
            self.signature, doc
        )


def proposal_to_json(p: Proposal) -> dict:
    return {
        "height": p.height,
        "round": p.round,
        "block": block_to_json(p.block),
        "proposer": p.proposer.hex(),
        "signature": p.signature.hex(),
        "last_cert": cert_to_json(p.last_cert) if p.last_cert else None,
        "evidence": [evidence_to_json(e) for e in p.evidence],
    }


def proposal_from_json(d: dict) -> Proposal:
    return Proposal(
        height=d["height"],
        round=d["round"],
        block=block_from_json(d["block"]),
        proposer=bytes.fromhex(d["proposer"]),
        signature=bytes.fromhex(d["signature"]),
        last_cert=cert_from_json(d["last_cert"]) if d["last_cert"] else None,
        evidence=tuple(evidence_from_json(e) for e in d["evidence"]),
    )


class ValidatorNode:
    """One validator: an App + key + mempool + WAL."""

    def __init__(self, name: str, priv: PrivateKey, genesis: dict,
                 chain_id: str, data_dir: str | None = None,
                 v2_upgrade_height: int | None = None,
                 upgrade_height_delay: int | None = None,
                 device=None,
                 da_scheme: str = "rs2d-nmt",
                 pack_keep: int | None = None,
                 max_square_size: int | None = None,
                 app_version: int = 1,
                 mesh=None):
        self.name = name
        self.priv = priv
        self.address = priv.public_key().address()
        # the App's block plane runs on `device` (the card unless the
        # caller asks for the CPU; pack_keep builds the proof packs there).
        # max_square_size is the consensus-critical k=256/512 admission
        # override (chain/app.py); app_version the genesis version (the
        # reference starts every validator's chain at 1), which every
        # validator of a chain must share; mesh the App's mesh plane
        # (parallel/mesh.Mesh, None for the auto rule).
        self.app = App(chain_id=chain_id, device=device, data_dir=data_dir,
                       app_version=app_version,
                       v2_upgrade_height=v2_upgrade_height,
                       upgrade_height_delay=upgrade_height_delay,
                       da_scheme=da_scheme, pack_keep=pack_keep,
                       max_square_size=max_square_size, mesh=mesh)
        self.app.init_chain(genesis)
        # THE mempool: the shared CAT pool (celestia_app_tpu/mempool) —
        # the pre-CAT validator list grew unboundedly (no cap, no TTL) and
        # leaked per-tx metadata (_tx_meta) for any tx that never
        # committed; pool entries now carry their own metadata, so
        # lifetime follows membership by construction
        from celestia_app_tpu_torch.mempool.pool import CATPool

        self.pool = CATPool()
        self.committed: dict[bytes, tuple[int, object]] = {}
        self.wal_dir = os.path.join(data_dir, "wal") if data_dir else None
        if self.wal_dir:
            os.makedirs(self.wal_dir, exist_ok=True)
        self.certificates: dict[int, CommitCertificate] = {}
        # lock-on-polka state (Tendermint lockedValue/lockedRound)
        self.locked_block: Block | None = None
        self.locked_round: int = -1
        # consensus pubkeys ride the genesis doc (Tendermint genesis
        # validators carry pub_key the same way) so a rebooted node can
        # verify WAL'd certificate votes without any peer alive
        self.validator_pubkeys: dict[bytes, bytes] = {
            bytes.fromhex(v["operator"]): bytes.fromhex(v["pubkey"])
            for v in genesis.get("validators", [])
            if "pubkey" in v
        }
        self._load_sign_state()

    # -- mempool (gossiped) ---------------------------------------------

    @property
    def mempool(self):
        """List-of-raw-bytes view over the CAT pool (the pre-CAT shape
        tests and status surfaces read)."""
        from celestia_app_tpu_torch.mempool.pool import RawTxView

        return RawTxView(self.pool)

    @mempool.setter
    def mempool(self, items) -> None:
        """Compat for fixtures that assign a replacement list; re-admitted
        WITHOUT CheckTx (the caller vouches)."""
        self.pool.clear()
        for raw in items:
            self.pool.add(raw, height=self.app.height)

    def add_tx(self, raw: bytes):
        """CheckTx + CAT admission; returns the TxResult so transports
        (in-process bus, HTTP validator service, gRPC) share ONE admission
        path — the pool's byte gate (default_overrides.go:271-273),
        hash dedup (a duplicate submission returns the ORIGINAL result),
        and cap eviction included."""
        # mempool TTL stamp: the POOL's injected clock supplies it
        # (node-local state, never hashed) — SystemClock in production,
        # the scenario plane's VirtualClock under simulation
        return self.pool.add(raw, height=self.app.height,
                             check_fn=self.app.check_tx)

    def add_txs(self, raws) -> list:
        """Batched admission (admission plane phase 1 + per-tx CheckTx):
        an ingest burst pays ONE signature dispatch and ONE blob-
        commitment dispatch, not one of each per tx."""
        from celestia_app_tpu_torch.chain import admission

        # TTL stamp comes from the pool's injected clock (see add_tx)
        return self.pool.add_batch(
            raws, height=self.app.height,
            check_fn=self.app.check_tx,
            prevalidate_fn=lambda rs: admission.prevalidate(
                self.app, rs, check_state=True, device=self.app.device),
        )

    def prevalidate_txs(self, raws) -> int:
        """Admission plane phase 1 ALONE: batch-verify the signatures of
        not-yet-pooled txs into the verified-sig cache (and batch their
        blobs' share commitments into the verified-commitment cache —
        the traffic plane's half). Stateless and never raises, so the
        reactor runs it OUTSIDE the service lock —
        the first qualifying batch pays the kernels' build, which
        must not stall the consensus loop (a racing commit at worst
        costs a cache miss, never a wrong verdict)."""
        from celestia_app_tpu_torch.chain import admission
        from celestia_app_tpu_torch.mempool.pool import tx_hash

        fresh = [raw for raw in raws if not self.pool.has(tx_hash(raw))]
        if not fresh:
            return 0
        return admission.prevalidate(self.app, fresh, check_state=True,
                                     device=self.app.device)

    def reap_mempool(self) -> list[bytes]:
        """Priority order: gas price desc, per-sender arrival order kept —
        the order FilterTxs receives candidates in (mempool v1 semantics;
        see mempool.pool.priority_order for the nonce-safety rationale)."""
        return self.pool.reap(self.app.height)

    def prewarm_proposals(self, n_blocks: int) -> int:
        """Mesh-plane produce prefetch (reactor ``produce_batch`` knob):
        speculatively plan the next ``n_blocks`` proposal squares from
        the current reap and batch-extend them in one dispatch
        (chain/producer.py), seeding the app's EDS cache with
        device-resident entries so the upcoming propose (and, while the
        pool holds, the following heights this node proposes) hit a warm
        entry instead of dispatching per block. Purely a cache warm:
        proposal bytes are unchanged whether or not it ran. Returns how
        many entries were inserted."""
        from celestia_app_tpu_torch.chain import producer

        plans = producer.plan_block_squares(
            self.app, self.reap_mempool(), n_blocks)
        return producer.warm_block_batch(self.app, plans)

    # -- consensus steps -------------------------------------------------
    # Two-phase Tendermint vote flow with lock-on-polka: prevote after
    # ProcessProposal, lock when >2/3 prevote one hash (a "polka"),
    # precommit only the locked/polka block. A validator locked at an
    # earlier round prevotes nil on any different block, so two conflicting
    # certificates at one height would need >1/3 byzantine power — the
    # safety argument LocalNetwork's tests pin.

    def propose(self, t: float):
        # a locked proposer must re-propose its locked block (Tendermint
        # validValue/lockedValue rule), not build a fresh one
        if self.locked_block is not None:
            return self.locked_block
        prop = self.app.prepare_proposal(
            self.reap_mempool(), proposer=self.address, t=t
        )
        return prop.block

    def _sign_state_path(self) -> str | None:
        if self.wal_dir is None:
            return None
        return os.path.join(os.path.dirname(self.wal_dir),
                            "priv_validator_state.json")

    def _load_sign_state(self) -> None:
        """Tendermint's priv_validator_state.json: the last non-nil vote
        hash signed per (height, round, phase), persisted BEFORE each
        signature so a crashed-and-restarted validator can never be
        tricked (or race itself) into signing a second, different non-nil
        vote at a (height, round) it already voted — now that votes sign
        their round, a same-round duplicate in EITHER phase is the
        slashable double-sign (celestia-core privval/file.go
        checkVotesOnlyDifferByTimestamp analog)."""
        self._signed_hashes: dict[tuple[int, int, str], str] = {}
        # Tendermint's monotonic watermark: the highest (round, step)
        # signed per height. A non-nil signature for an EARLIER slot is
        # refused (nil instead) — a lying coordinator replaying an old
        # round's genuine polka after we moved on (locks are in-memory;
        # a restart loses them) could otherwise harvest conflicting
        # cross-round precommits into two certificates at one height.
        self._sign_watermark: dict[int, tuple[int, int]] = {}
        path = self._sign_state_path()
        if path is None or not os.path.exists(path):
            return
        with open(path) as f:
            doc = json.load(f)
        for k, v in doc.get("signed", {}).items():
            parts = k.split(":")
            if len(parts) == 3:  # "height:round:phase"
                self._signed_hashes[(int(parts[0]), int(parts[1]),
                                     parts[2])] = v
            elif len(parts) == 2:  # legacy round-blind "height:phase"
                self._signed_hashes[(int(parts[0]), 0, parts[1])] = v
        for h, rr in doc.get("watermark", {}).items():
            self._sign_watermark[int(h)] = (int(rr[0]), int(rr[1]))

    def _persist_sign_state(self) -> None:
        path = self._sign_state_path()
        if path is None:
            return
        doc = {
            "signed": {
                f"{h}:{r}:{p}": v
                for (h, r, p), v in self._signed_hashes.items()
            },
            "watermark": {
                str(h): list(rr)
                for h, rr in self._sign_watermark.items()
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _signed(self, height: int, bh: bytes | None, phase: str,
                round_: int = 0) -> Vote:
        """Sign a vote — through the durable double-sign guard (Tendermint
        privval FilePV semantics), refusing with a signed NIL instead
        (safe: nil votes can never form evidence or a certificate). Two
        durable rules:

        1. same-slot: a second non-nil vote at a (height, round, phase)
           we already signed must carry the SAME hash — a same-round
           duplicate is the slashable double-sign;
        2. monotonic: a non-nil vote for a slot EARLIER than the highest
           (round, step) signed at this height is refused — without it a
           lying coordinator (or a crash that dropped the in-memory
           lock) could walk us back to an old round's genuine polka and
           collect the conflicting old-round precommit that forges a
           second certificate at the height.

        Signing different hashes in LATER rounds stays legal (required
        for liveness: re-prevoting a fresh proposal after a failed
        round, re-precommitting after unlock-on-higher-polka). Entries
        are pruned once the chain moves past them.

        Nil signatures are recorded per slot too (the "" sentinel), so a
        later NON-nil vote at a slot we already signed nil is refused —
        Tendermint FilePV's same-HRS rule: two different votes at one
        (height, round, step), nil vs block, are a conflict an external
        privval judge would flag (ADVICE r5 #3). Re-signing nil at a
        nil slot stays legal (nil is also the refusal output)."""
        slot = (round_, 0 if phase == "prevote" else 1)
        wm = self._sign_watermark.get(height)
        changed = False
        key = (height, round_, phase)
        if bh is not None:
            if wm is not None and slot < wm:
                bh = None  # slot regression: refuse
            else:
                prior = self._signed_hashes.get(key)
                if prior is not None and prior != bh.hex():
                    # covers both a DIFFERENT non-nil (the classic
                    # double-sign) and a recorded nil ("" sentinel)
                    bh = None  # refuse; vote nil
                elif prior is None:
                    self._signed_hashes[key] = bh.hex()
                    changed = True
        if bh is None and key not in self._signed_hashes:
            self._signed_hashes[key] = ""  # nil signed at this slot
            changed = True
        if wm is None or slot > wm:
            # every signature advances the watermark — nil ones too
            # (Tendermint persists every signed vote): a nil precommit at
            # round r must block a later non-nil signature for round < r
            self._sign_watermark[height] = slot
            changed = True
        if changed:  # persist REAL transitions only (idempotent re-signs
            # of a recorded slot+hash skip the fsync on the hot path)
            floor = self.app.height - 2
            for k in [k for k in self._signed_hashes if k[0] < floor]:
                del self._signed_hashes[k]
            for h in [h for h in self._sign_watermark if h < floor]:
                del self._sign_watermark[h]
            self._persist_sign_state()
        sig = self.priv.sign(
            Vote.sign_bytes(self.app.chain_id, height, bh, phase, round_)
        )
        return Vote(height, bh, self.address, sig, phase, round_)

    def prevote_on(self, block: Block, round_: int = 0) -> Vote:
        """Prevote step: nil unless the proposal validates AND does not
        conflict with an existing lock."""
        h = block.header.height
        bh = block.header.hash()
        if self.locked_block is not None:
            if self.locked_block.header.hash() == bh:
                return self._signed(h, bh, "prevote", round_)  # validated
            return self._signed(h, None, "prevote", round_)  # locked: nil
        ok = self.app.process_proposal(block)
        return self._signed(h, bh if ok else None, "prevote", round_)

    def lock_permits(self, block_hash: bytes, round_: int) -> bool:
        """THE lock discipline, shared by the autonomous reactor and the
        orchestrated server (one definition — divergent copies would give
        the two modes different consensus safety rules): a locked
        validator may precommit `block_hash` at `round_` iff it is
        unlocked, the hash IS its lock, or the polka is from a LATER
        round than its lock (Tendermint unlock-on-higher-polka, sound
        now that votes sign their round)."""
        return (self.locked_block is None
                or self.locked_block.header.hash() == block_hash
                or round_ > self.locked_round)

    def on_polka(self, block: Block, round_: int) -> None:
        """>2/3 prevoted this block: lock on it (lock-on-polka). A polka
        at a LATER round than the current lock replaces it — Tendermint's
        unlock-on-higher-polka, sound now that votes sign their round."""
        if self.locked_block is not None and round_ < self.locked_round:
            return  # never regress to an older lock
        self.locked_block = block
        self.locked_round = round_

    def precommit_on(self, block: Block | None, round_: int = 0) -> Vote:
        """Precommit the polka block, or nil when no polka was observed."""
        if block is None:
            height = self.app.height + 1
            return self._signed(height, None, "precommit", round_)
        bh = block.header.hash()
        return self._signed(block.header.height, bh, "precommit", round_)

    def clear_lock(self) -> None:
        self.locked_block = None
        self.locked_round = -1

    def vote_on(self, block: Block, round_: int = 0) -> Vote:
        """One-shot validate+precommit (single-phase fixtures and tests);
        the network path uses prevote_on/precommit_on."""
        ok = self.app.process_proposal(block)
        bh = block.header.hash() if ok else None
        return self._signed(block.header.height, bh, "precommit", round_)

    def known_pubkeys(self) -> dict[bytes, bytes]:
        """operator -> consensus pubkey from BOTH trust roots: the genesis
        doc and on-chain registrations (MsgCreateValidator.pubkey via
        staking.consensus_pubkeys) — the full set whose votes this node
        can verify. Runtime-created validators exist only in the latter;
        a genesis entry wins any conflict (it is the older commitment,
        and create_validator refuses existing operators anyway)."""
        ctx = Context(
            self.app.store, InfiniteGasMeter(), self.app.height, 0,
            self.app.chain_id, self.app.app_version,
        )
        out = dict(self.app.staking.consensus_pubkeys(ctx))
        out.update(self.validator_pubkeys)
        return out

    def verify_certificate(self, cert: CommitCertificate,
                           pubkeys: dict[bytes, bytes] | None = None) -> bool:
        """Check a certificate against THIS node's own trust roots — the
        genesis + on-chain-registered pubkeys and the staking-state powers
        — before applying a block a remote orchestrator hands over (the
        socket commit path must not trust the coordinator). `pubkeys`
        optionally supplies a precomputed known_pubkeys() map so hot
        callers avoid repeated staking-store scans."""
        if pubkeys is None:
            pubkeys = self.known_pubkeys()
        if not pubkeys:
            return False
        ctx = Context(
            self.app.store, InfiniteGasMeter(), self.app.height, 0,
            self.app.chain_id, self.app.app_version,
        )
        powers = dict(self.app.staking.validators(ctx))
        return cert.verify(
            self.app.chain_id, pubkeys,
            sum(powers.values()), powers,
        )

    def _wal_path(self, height: int) -> str:
        return os.path.join(self.wal_dir, f"{height:020d}.json")

    def write_wal(
        self, block: Block, cert: CommitCertificate,
        evidence: tuple["DuplicateVoteEvidence", ...] = (),
        present: set[bytes] | None = None,
        record_present: bool = False,
    ) -> None:
        """Append-before-apply: the crash-recovery record. Evidence applied
        with the block is PART of the record — replay must re-apply it or
        the replayed app hash diverges from live peers. When
        `record_present` is set (autonomous mode), the presence set that
        liveness accounting actually used is recorded explicitly, because
        it came from the PROPOSAL's last-commit certificate, not from the
        locally-assembled `cert` this record stores — replay from the cert
        alone would diverge."""
        if self.wal_dir is None:
            return

        with obs.span(
            "wal.append", traces=self.app.traces,
            trace_id=obs.trace_id_for(self.app.chain_id,
                                      block.header.height),
            height=block.header.height,
        ):
            doc = {
                "evidence": [evidence_to_json(ev) for ev in evidence],
                "height": block.header.height,
                **block_to_json(block),
                "votes": [vote_to_json(v) for v in cert.votes],
                # the commit round: replay must rebuild the certificate
                # with it, or a round>0 cert's round-scoped votes count
                # as zero power (and the presence set reads empty) after
                # restart
                "cert_round": cert.round,
            }
            if record_present:
                doc["present"] = (
                    None if present is None
                    else sorted(a.hex() for a in present)
                )
            tmp = self._wal_path(block.header.height) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            # crash point 1 of the commit matrix: the record is fsync'd
            # as a tmp but NOT renamed — after restart there is no
            # durable WAL entry for this height (the torn tail the replay
            # scanner skips). Recovery: commit-record catch-up from peers
            # (blocksync). An armed "error" surfaces as the OSError a
            # failed write would.
            if faults.fire("consensus.wal_append", height=block.header.height,
                           node=self.name) == "error":
                raise OSError("injected fault: consensus.wal_append")
            os.replace(tmp, self._wal_path(block.header.height))

    def _present_set_from_cert(
        self, cert: CommitCertificate | None
    ) -> set[bytes] | None:
        """LastCommitInfo presence reconstruction: a validator counts as
        present only with a precommit FOR the committed block at the
        certificate's height — a vote for a different block / stale height
        / junk signature is an absence, so misbehaving validators cannot
        suppress their own liveness window. Each vote's signature is
        checked against the genesis-known validator pubkeys (mirroring
        cert.verify), so a cert padded with forged presence-votes for
        offline validators cannot suppress their downtime accounting; a
        validator with no genesis pubkey (legacy fixture genesis) falls
        back to unverified matching. None cert (height 1 in autonomous
        mode: no last commit exists) -> None, meaning everyone present.

        Computed BEFORE evidence is applied (and recorded in the WAL when
        the source cert differs from the stored one), while the absent
        set it induces is derived from the POST-evidence validator set
        (_set_absent). Verification keys are known_pubkeys() — genesis
        plus on-chain registrations — so runtime-created validators'
        presence votes are signature-checked too, not fallback-matched;
        both live apply and WAL replay read the same pre-block state, so
        the computation stays deterministic across them."""
        if cert is None:
            return None
        known = self.known_pubkeys()
        doc = Vote.sign_bytes(self.app.chain_id, cert.height,
                              cert.block_hash, round_=cert.round)
        voted = set()
        for v in cert.votes:
            if (v.block_hash != cert.block_hash or v.height != cert.height
                    or v.round != cert.round):
                continue
            pub = known.get(v.validator)
            if pub is not None and not PublicKey(pub).verify(v.signature, doc):
                continue
            voted.add(v.validator)
        return voted

    def _set_absent(self, present: set[bytes] | None) -> None:
        ctx = Context(
            self.app.store, InfiniteGasMeter(), self.app.height, 0,
            self.app.chain_id, self.app.app_version,
        )
        if present is None:
            self.app.absent_validators = set()
            return
        self.app.absent_validators = {
            op for op, _p in self.app.staking.validators(ctx)
            if op not in present
        }

    def _mark_absent_from_votes(self, cert: CommitCertificate) -> None:
        self._set_absent(self._present_set_from_cert(cert))

    def _apply_evidence(
        self, evidence: tuple["DuplicateVoteEvidence", ...]
    ) -> None:
        for ev in evidence:
            ctx = Context(
                self.app.store, InfiniteGasMeter(), self.app.height, 0,
                self.app.chain_id, self.app.app_version,
            )
            self.app.slashing.handle_equivocation(
                ctx, ev.vote_a.validator, infraction_height=ev.height
            )

    # sentinel: "derive the presence set from the commit certificate itself"
    # (the orchestrated modes, where one coordinator hands every node the
    # same cert). Autonomous mode passes the proposal's last_cert instead.
    _ABSENT_FROM_CERT = object()

    def apply(
        self, block: Block, cert: CommitCertificate,
        evidence: tuple["DuplicateVoteEvidence", ...] = (),
        absent_cert=_ABSENT_FROM_CERT,
    ) -> bytes:
        """Finalize + commit a certified block (evidence first — the
        x/evidence BeginBlock position); returns the app hash. Evidence is
        in the WAL record, so crash replay re-applies it identically.

        LastCommitInfo analog: validators whose precommit is absent from
        the presence source are marked absent, consumed by THIS block's
        BeginBlock liveness accounting. The presence source is the commit
        certificate itself in the orchestrated modes (every node receives
        the identical cert), or — in autonomous mode, where each node
        assembles its OWN cert from gossip — the height-1 certificate the
        PROPOSER embedded in the signed proposal (`absent_cert`), which is
        the one choice all nodes share (Tendermint's LastCommitInfo-in-
        block wiring). The WAL records the presence set whenever it did
        not come from `cert`."""
        with obs.span(
            "apply", traces=self.app.traces,
            trace_id=obs.trace_id_for(self.app.chain_id,
                                      block.header.height),
            height=block.header.height, node=self.name,
        ):
            from_proposal = \
                absent_cert is not ValidatorNode._ABSENT_FROM_CERT
            src = cert if not from_proposal else absent_cert
            present = self._present_set_from_cert(src)
            self.write_wal(block, cert, evidence, present=present,
                           record_present=from_proposal)
            # crash point 2 of the commit matrix: the WAL record IS
            # durable but no state has been touched. Recovery:
            # replay_wal() re-applies the recorded block on restart
            # (Tendermint's replay semantics). An armed "error" stops this
            # validator here, as a crash would, without ending the process.
            if faults.fire("consensus.post_wal_pre_apply",
                           height=block.header.height,
                           node=self.name) == "error":
                raise OSError("injected fault: consensus.post_wal_pre_apply")
            self._apply_evidence(evidence)
            # ordering invariant shared with replay_wal: evidence FIRST,
            # then absences — both paths must compute the absent set
            # against the same post-evidence validator set or replayed
            # nodes diverge
            self._set_absent(present)
            results = self.app.finalize_block(block)
            app_hash = self.app.commit(block)
            self.certificates[block.header.height] = cert
            self._record_committed(block, results)
            self.pool.remove_committed(block.txs)
            # post-commit recheck (RecheckTx): survivors re-run CheckTx
            # against the fresh check state so nonce-stale txs (their
            # sender's sequence advanced in THIS block via a different
            # tx) drop instead of wasting the next proposal slot
            self.pool.recheck(self.app.check_tx)
            return app_hash

    def _record_committed(self, block: Block, results) -> None:
        """Tx-hash -> (height, result) index backing the gRPC GetTx /
        ConfirmTx surface a validator process serves — the ONE recorder
        shared with Node (height-windowed; node.record_committed)."""
        from celestia_app_tpu_torch.chain.node import record_committed

        record_committed(self.committed, block, results)

    # GrpcTxServer and NodeService speak to anything exposing
    # broadcast_tx/app/committed; a validator process IS that node
    # (one binary per validator)
    def broadcast_tx(self, raw: bytes):
        return self.add_tx(raw)

    def produce_block(self, t: float | None = None):
        """Blocked on purpose: a validator's blocks come from consensus
        (the socket round schedule), never from a local convenience route
        — NodeService's /produce_block surfaces this as a 400 policy
        refusal (QueryError), not a server error."""
        from celestia_app_tpu_torch.chain.query import QueryError

        raise QueryError(
            "validator blocks are produced by consensus, not on demand"
        )

    def replay_wal(self) -> int:
        """Crash recovery: apply WAL entries above the committed height
        (Tendermint replay). Returns how many blocks were replayed."""
        if self.wal_dir is None:
            return 0

        replayed = 0
        for name in sorted(os.listdir(self.wal_dir)):
            if not name.endswith(".json"):
                continue
            height = int(name.split(".")[0])
            if height <= self.app.height:
                continue
            with open(os.path.join(self.wal_dir, name)) as f:
                doc = json.load(f)
            block = block_from_json(doc)
            votes = tuple(vote_from_json(v) for v in doc["votes"])
            cert = CommitCertificate(height, block.header.hash(), votes,
                                     int(doc.get("cert_round", 0)))
            evidence = tuple(
                evidence_from_json(e) for e in doc.get("evidence", [])
            )
            self._apply_evidence(evidence)
            # reconstruct the LastCommitInfo absences exactly as the live
            # run applied them (same evidence-then-absences order as
            # apply()): from the WAL's explicit presence record when one
            # was written (autonomous mode), else from the stored cert
            if "present" in doc:
                present = (
                    None if doc["present"] is None
                    else {bytes.fromhex(a) for a in doc["present"]}
                )
                self._set_absent(present)
            else:
                self._mark_absent_from_votes(cert)
            # admission plane: one batched dispatch verifies the whole
            # replayed block's signatures (replay skips process_proposal,
            # where the live path prevalidates); the delivery ante below
            # hits the verified-sig cache instead of re-verifying per tx.
            # commitments=False: delivery under a commit certificate
            # validates no blob commitments, so the commitment batch
            # would be pure wasted hashing on the recovery path
            from celestia_app_tpu_torch.chain import admission

            admission.prevalidate(self.app, block.txs, commitments=False,
                                  device=self.app.device)
            results = self.app.finalize_block(block)
            self.app.commit(block)
            self.certificates[height] = cert
            self._record_committed(block, results)
            replayed += 1
        return replayed

    # -- state sync (serving side) ---------------------------------------

    def snapshot_chunks(self) -> tuple[dict, list[bytes]]:
        return snapshot_app_chunks(self.app)


# keys per state-sync snapshot chunk (chunking is a serving-local choice:
# the manifest commits to whatever chunking the server used, and the
# joiner verifies against THAT manifest). Tests shrink it to force
# multi-chunk restores out of small states.
SNAPSHOT_CHUNK_KEYS = 64


def capture_app_snapshot(app: App) -> dict:
    """The part that must run under the node's writer lock: copy the
    committed store + chain identity at one instant. Cheap (dict copy);
    the expensive chunk encoding happens in encode_app_snapshot, safely
    outside the lock."""
    capture = {
        "items": app.store.snapshot(),  # already a fresh copy (state.py)
        "height": app.height,
        "app_hash": app.last_app_hash.hex(),
        "app_version": app.app_version,
        "chain_id": app.chain_id,
        "genesis_time": app.genesis_time,
        "last_block_hash": app.last_block_hash.hex(),
    }
    codec = getattr(app, "codec", None)
    if codec is not None and codec.scheme_id:
        # codec plane: a joiner must refuse a snapshot from a chain run
        # under a different DA scheme (its stored blocks would neither
        # replay nor serve samples here). Stamped only for non-default
        # schemes so default-scheme manifests — and their content
        # digests, which key restore resume dirs — stay byte-identical
        # to pre-plane ones (FORMATS §16.1 back-compat rule).
        capture["da_scheme"] = codec.name
    return capture


def encode_app_snapshot(capture: dict) -> tuple[dict, list[bytes]]:
    """Pure: deterministic key-ranged chunks + manifest from a capture."""
    items = sorted(capture["items"].items())
    chunks: list[bytes] = []
    for i in range(0, max(len(items), 1), SNAPSHOT_CHUNK_KEYS):
        part = items[i : i + SNAPSHOT_CHUNK_KEYS]
        chunks.append(
            json.dumps(
                [[k.hex(), v.hex()] for k, v in part], sort_keys=True
            ).encode()
        )
    manifest = {
        **{k: v for k, v in capture.items() if k != "items"},
        "n_chunks": len(chunks),
        "chunk_hashes": [hashlib.sha256(c).hexdigest() for c in chunks],
    }
    return manifest, chunks


def snapshot_app_chunks(app: App) -> tuple[dict, list[bytes]]:
    """(manifest, chunks): the committed store split into deterministic
    key-ranged chunks (state-sync serving, default_overrides.go:294).
    One-shot convenience; lock-conscious callers split into
    capture_app_snapshot (under lock) + encode_app_snapshot (outside)."""
    return encode_app_snapshot(capture_app_snapshot(app))


def state_sync_bootstrap(node_or_app, manifest: dict, chunks: list[bytes]) -> None:
    """Adopt a snapshot AFTER verification: every chunk must match the
    manifest hash, and the reassembled store's app hash must equal the
    trusted header's app_hash — altered chunks are rejected wholesale.
    Accepts a ValidatorNode or a bare App."""
    app = getattr(node_or_app, "app", node_or_app)
    codec = getattr(app, "codec", None)
    local_scheme = codec.name if codec is not None else "rs2d-nmt"
    if manifest.get("da_scheme", "rs2d-nmt") != local_scheme:
        # codec plane: adopting another scheme's state would leave this
        # node unable to replay or serve the chain it just joined
        raise ValueError(
            f"snapshot is from a {manifest.get('da_scheme')!r}-scheme "
            f"chain; this node runs {local_scheme!r}")
    if len(chunks) != manifest["n_chunks"]:
        raise ValueError("chunk count mismatch")
    for i, c in enumerate(chunks):
        if hashlib.sha256(c).hexdigest() != manifest["chunk_hashes"][i]:
            raise ValueError(f"chunk {i} hash mismatch")
    data: dict[bytes, bytes] = {}
    for c in chunks:
        for k_hex, v_hex in json.loads(c):
            data[bytes.fromhex(k_hex)] = bytes.fromhex(v_hex)
    from celestia_app_tpu_torch.chain.state import KVStore

    probe = KVStore(data)
    if probe.app_hash().hex() != manifest["app_hash"]:
        raise ValueError("snapshot app hash does not match trusted header")
    app.store.restore(data)
    app.height = manifest["height"]
    app.app_version = manifest["app_version"]
    app.last_app_hash = bytes.fromhex(manifest["app_hash"])
    app.last_block_hash = bytes.fromhex(manifest["last_block_hash"])
    app.genesis_time = manifest["genesis_time"]
    app._check_state = None


@dataclasses.dataclass(frozen=True)
class DuplicateVoteEvidence:
    """Two signed votes by the same validator for DIFFERENT blocks at one
    height — the Tendermint double-sign evidence type. Verifiable offline
    (both signatures check out against the validator's key), and submitted
    to x/evidence → tombstone + slash (sdk_modules.handle_equivocation)."""

    height: int
    vote_a: Vote
    vote_b: Vote

    def verify(self, chain_id: str, pubkey: bytes) -> bool:
        a, b = self.vote_a, self.vote_b
        if a.validator != b.validator:
            return False
        if a.height != self.height or b.height != self.height:
            return False  # both votes must be AT the evidence height
        if a.block_hash is None or b.block_hash is None:
            # nil votes are never equivocation — the sign guard's refusal
            # path EMITS signed nils at slots where a non-nil already
            # exists, so a (non-nil, nil) pair is an honest validator
            # protecting itself, not a double-sign
            return False
        if a.block_hash == b.block_hash:
            return False  # same block: not equivocation
        if a.phase != b.phase:
            # prevote(A)+precommit(B) is a legal Tendermint history
            # (unlock via a later polka); only duplicate votes in the
            # SAME step are slashable
            return False
        if a.round != b.round:
            # different rounds: legal protocol behavior in BOTH phases —
            # re-prevoting a fresh proposal after a failed round, or
            # re-precommitting after unlock-on-higher-polka. Without this
            # check a byzantine proposer could package two honest
            # cross-round votes as "evidence" and have the network slash
            # an honest validator (round-4 advisor finding).
            return False
        pub = PublicKey(pubkey)
        if pub.address() != a.validator:
            return False
        return pub.verify(
            a.signature,
            Vote.sign_bytes(chain_id, a.height, a.block_hash, a.phase,
                            a.round),
        ) and pub.verify(
            b.signature,
            Vote.sign_bytes(chain_id, b.height, b.block_hash, b.phase,
                            b.round),
        )


def detect_equivocation(
    chain_id: str, votes_by_round: list[list[Vote]],
    validators: dict[bytes, bytes],
) -> list[DuplicateVoteEvidence]:
    """Scan one height's votes for validators that signed two different
    block hashes at the same (round, phase); returns verified evidence
    only."""
    # SAME (round, phase) only. Votes sign their round, so an honest
    # validator produces at most one non-nil vote per (height, round,
    # phase) — prevoting different blocks in different ROUNDS (failed
    # round rotates the proposal) and precommitting different blocks in
    # different rounds (unlock-on-higher-polka) are both legal protocol
    # histories. A same-round duplicate in EITHER phase is the classic
    # slashable double-sign (celestia-core types/evidence.go).
    seen: dict[tuple[bytes, int, int, str], Vote] = {}
    out: list[DuplicateVoteEvidence] = []
    accused: set[bytes] = set()
    for votes in votes_by_round:
        for v in votes:
            if v.block_hash is None or v.validator in accused:
                continue
            if v.phase not in ("prevote", "precommit"):
                continue
            key = (v.validator, v.height, v.round, v.phase)
            prior = seen.get(key)
            if prior is None:
                seen[key] = v
            elif prior.block_hash != v.block_hash:
                ev = DuplicateVoteEvidence(v.height, prior, v)
                pub = validators.get(v.validator)
                if pub is not None and ev.verify(chain_id, pub):
                    out.append(ev)
                    accused.add(v.validator)
    return out


class LocalNetwork:
    """N validators + an in-process gossip bus (tx fan-out, proposal/vote
    exchange). Proposer rotation is deterministic round-robin over the
    address-sorted validator set. Votes from failed rounds are retained
    per height and scanned for equivocation; verified double-sign evidence
    is submitted to every node's x/evidence handler (tombstone + slash)."""

    def __init__(self, nodes: list[ValidatorNode]):
        if not nodes:
            raise ValueError("need at least one validator")
        self.nodes = sorted(nodes, key=lambda n: n.address)
        self.chain_id = nodes[0].app.chain_id
        # every member learns every member's consensus pubkey (gossiped at
        # handshake in real p2p); genesis-carried keys take precedence
        peer_keys = {n.address: n.priv.public_key().compressed for n in nodes}
        for n in self.nodes:
            n.validator_pubkeys = {**peer_keys, **n.validator_pubkeys}
        self._round = 0  # advances on failed rounds so the proposer rotates
        # signature-verified votes retained for the evidence window, so a
        # conflicting vote surfacing a few heights late still pairs up
        # (Tendermint's evidence max-age analog)
        self._vote_pool: list[Vote] = []

    EVIDENCE_MAX_AGE = 10  # heights a vote stays eligible for evidence

    def _powers(self, app: App) -> dict[bytes, int]:
        ctx = Context(app.store, InfiniteGasMeter(), app.height, 0,
                      app.chain_id, app.app_version)
        return dict(app.staking.validators(ctx))

    def broadcast_tx(self, raw: bytes, via: int = 0) -> bool:
        """Gossip: every node runs CheckTx on the tx independently (the
        Tendermint model — mempools can disagree). The caller's verdict is
        the verdict of the node it submitted through (`via`), exactly as a
        client sees only its own node's CheckTx; `broadcast_tx_all` exposes
        the full per-node picture for tests and the devnet monitor."""
        return self.broadcast_tx_all(raw)[via]

    def broadcast_tx_all(self, raw: bytes) -> list[bool]:
        return [n.add_tx(raw).code == 0 for n in self.nodes]

    def proposer_for(self, height: int, round_: int = 0) -> ValidatorNode:
        return self.nodes[(height + round_) % len(self.nodes)]

    def produce_height(
        self, t: float, vote_filter=None,
    ) -> tuple[Block | None, CommitCertificate | None]:
        """One consensus round, two vote phases (Tendermint):

        propose → prevote → [polka? lock] → precommit → [>2/3? commit].

        A "polka" (>2/3 prevote power on one hash) locks every validator
        that observed it onto the block; locked validators prevote nil on
        any OTHER block in later rounds and a locked proposer re-proposes
        its lock — so a split round is SAFE (no second certificate can
        form at the height), not merely rotated. Round timeouts are
        schedule-driven here: a round that fails any quorum advances
        `_round`, rotating the proposer exactly as Tendermint's timeout
        cascade does, and locks persist across rounds.

        `vote_filter(phase, votes) -> votes` (tests only) models partitions
        and message loss by dropping votes in flight."""
        height = self.nodes[0].app.height + 1
        proposer = self.proposer_for(height, self._round)
        try:
            block = proposer.propose(t)
        except Exception:
            # proposer crash = propose-timeout: nil round, rotate
            telemetry.incr("consensus.propose_errors")
            self._round += 1
            return None, None
        bh = block.header.hash()
        powers = self._powers(self.nodes[0].app)
        total = sum(powers.values())
        validators = {
            n.address: n.priv.public_key().compressed for n in self.nodes
        }

        # -- prevote phase ----------------------------------------------
        own_prevotes = [n.prevote_on(block, self._round) for n in self.nodes]
        prevotes = list(own_prevotes)
        if vote_filter is not None:
            prevotes = list(vote_filter("prevote", prevotes))
        # prevotes enter the evidence pool too: votes sign their round, so
        # detect_equivocation pairs only same-round duplicates — a legal
        # round-0-A/round-1-B prevote history can no longer be mistaken
        # for equivocation
        self._vote_pool.extend(
            v for v in prevotes if v.block_hash is not None
        )
        prevote_power = sum(
            powers.get(v.validator, 0)
            for v in prevotes
            if v.block_hash == bh and v.height == height
        )
        polka = prevote_power * 3 > total * 2

        # -- precommit phase --------------------------------------------
        # a polka locks only validators whose OWN prevote accepted the
        # block — one that judged it invalid precommits nil regardless of
        # what >2/3 of the others claim (Tendermint validity gate)
        precommits = []
        for n, pv in zip(self.nodes, own_prevotes):
            if polka and pv.block_hash == bh:
                n.on_polka(block, self._round)
                precommits.append(n.precommit_on(block, self._round))
            else:
                precommits.append(n.precommit_on(None, self._round))
        if vote_filter is not None:
            precommits = list(vote_filter("precommit", precommits))
        self._vote_pool.extend(
            v for v in precommits if v.block_hash is not None
        )
        self._prune_vote_pool(height)

        cert = CommitCertificate(height, bh, tuple(precommits), self._round)
        if not cert.verify(self.chain_id, validators, total, powers):
            self._round += 1
            return None, None
        self._round = 0
        # evidence rides the committed block (the x/evidence position):
        # deterministic across nodes and recorded in every WAL entry
        evidence = tuple(
            detect_equivocation(self.chain_id, [self._vote_pool], validators)
        )
        if evidence:
            punished = {ev.vote_a.validator for ev in evidence}
            self._vote_pool = [
                v for v in self._vote_pool if v.validator not in punished
            ]
        hashes = {n.apply(block, cert, evidence) for n in self.nodes}
        if len(hashes) != 1:
            raise AssertionError(
                f"state divergence after height {height}: {sorted(h.hex() for h in hashes)}"
            )
        for n in self.nodes:
            n.clear_lock()
        return block, cert

    def _prune_vote_pool(self, current_height: int) -> None:
        floor = current_height - self.EVIDENCE_MAX_AGE
        self._vote_pool = [v for v in self._vote_pool if v.height > floor]

    def inject_vote(self, vote: Vote) -> None:
        """Gossip entry for an externally-received vote. The signature is
        verified AT THE DOOR against the known validator set — a forged
        vote must never enter the pool, where it could poison the
        first-seen slot and mask real equivocation."""
        by_addr = {n.address: n.priv.public_key().compressed for n in self.nodes}
        pub = by_addr.get(vote.validator)
        if pub is None or vote.block_hash is None:
            raise ValueError("vote from unknown validator or nil vote")
        if not PublicKey(pub).verify(
            vote.signature,
            Vote.sign_bytes(self.chain_id, vote.height, vote.block_hash,
                            vote.phase, vote.round),
        ):
            raise ValueError("vote signature verification failed")
        self._vote_pool.append(vote)
