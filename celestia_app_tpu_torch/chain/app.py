"""The application: celestia-app's ABCI surface on the card.

Port of celestia_app_tpu/chain/app.py. Reference parity (SURVEY.md §3 call stacks):
- CheckTx           app/check_tx.go:16-54   — unwrap BlobTx, ValidateBlobTx,
                    strip blobs, run ante chain in check mode
- PrepareProposal   app/prepare_proposal.go:22-91 — ante-filter txs, build the
                    square, extend + DAH on device, return txs/size/data root
- ProcessProposal   app/process_proposal.go:24-158 — re-validate every tx,
                    deterministically reconstruct the square, recompute the
                    data root, byte-compare vs the header; ANY failure/panic
                    votes reject (liveness-first, :29-35)
- FinalizeBlock     BeginBlock (mint) -> DeliverTx each -> EndBlock (signal
                    upgrade flip, height-based v1->v2) -> Commit (app hash)
- multi-version behavior: one App serves versions 1..3 with per-version msg
  acceptance (ante.MSG_VERSIONS) and store migrations on upgrade
  (app/app.go:458-508 analog).

The block plane runs on `device`, resolved like every other entry point of
the port: ``cuda`` by default, a RuntimeError where there is no card, and
``device="cpu"`` (the tests) takes every kernel's plain version. The
extension, the NMT roots and the data root are one `da/eds.pipeline` pass
through `da/edscache` (kernels K2 and K1), the block's blob commitments one
`da/commitment_device` batch (K1), and its signatures one
`ops/secp256k1.verify_batch` dispatch. There is no host fallback: a kernel
that fails raises, and in ProcessProposal that raise is a reject vote
(consensus semantics) whose cause is recorded: the counter
``process_proposal.rejects{type=…,reason=…}``, the ``reject`` attribute of
the ``process_proposal`` span, and `App.last_reject`.

The reference's ``engine`` argument (device | host | auto | mesh) becomes
``device`` and ``mesh``: ``device="cpu"`` plays the part of its host
engine; there is no silent degrade. ``mesh`` (a parallel/mesh.Mesh) is its
``engine="mesh"``: every square the mesh can shard goes through the
sharded pipeline (parallel/sharded_eds.py), per block and in the batched
produce path; ``mesh=None`` is its auto rule (squares of k >= 512 on a
card take a mesh of the visible cards when there are two or more).
A disk-backed App with ``pack_keep`` set builds the static proof packs and
blob packs (das/packs.py, das/blob_packs.py) at warm time, on its device.
"""

from __future__ import annotations

import dataclasses
import os
import time as time_mod

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch import obs
from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.chain import admission as admission_mod
from celestia_app_tpu_torch.chain import ante as ante_mod
from celestia_app_tpu_torch.chain import blobstream as blobstream_mod
from celestia_app_tpu_torch.chain import gov as gov_mod
from celestia_app_tpu_torch.chain import ibc as ibc_mod
from celestia_app_tpu_torch.chain import sdk_modules
from celestia_app_tpu_torch.chain import modules
from celestia_app_tpu_torch.chain import storage
from celestia_app_tpu_torch.utils import telemetry
from celestia_app_tpu_torch.chain.block import Block, Header, TxResult
from celestia_app_tpu_torch.chain.blob_validation import (
    BlobTxError,
    resolve_commitments,
    validate_blob_tx,
)
from celestia_app_tpu_torch.chain.state import (
    Context,
    GasMeter,
    InfiniteGasMeter,
    KVStore,
    OutOfGas,
    put_json,
)
from celestia_app_tpu_torch.chain.tx import (
    MsgPayForBlobs,
    MsgRegisterEVMAddress,
    MsgSend,
    MsgSignalVersion,
    MsgTryUpgrade,
    MsgDelegate,
    MsgUndelegate,
    MsgBeginRedelegate,
    MsgCreateValidator,
    MsgSubmitProposal,
    MsgDeposit,
    MsgVote,
    MsgTransfer,
    MsgExec,
    MsgRecvPacket,
    MsgAcknowledgePacket,
    MsgTimeoutPacket,
    MsgUpdateClient,
    decode_tx,
)
from celestia_app_tpu_torch.da import blob as blob_mod
from celestia_app_tpu_torch.da import codec as dacodec
from celestia_app_tpu_torch.da import dah as dah_mod
from celestia_app_tpu_torch.da import edscache as edscache_mod
from celestia_app_tpu_torch.da import square as square_mod
from celestia_app_tpu_torch.da.square import PfbEntry


def reject_reason(exc: BaseException) -> str:
    """The stable head of a reject's message, the label of the
    ``process_proposal.rejects`` counter: the text before the first colon
    (``"square size mismatch: computed 4, header 8"`` -> ``"square size
    mismatch"``), at most 64 characters."""
    return str(exc).split(":", 1)[0].strip()[:64] or type(exc).__name__


@dataclasses.dataclass
class ProposalResult:
    block: Block
    square: square_mod.Square
    # the scheme's commitments object: a DataAvailabilityHeader under
    # the default codec, a da/cmt.CmtCommitments under cmt-ldpc
    dah: object


class App:
    def __init__(
        self,
        chain_id: str = "celestia-tpu-1",
        app_version: int = 1,
        device=None,  # the card unless the caller asks for the CPU
        min_gas_price: float = appconsts.DEFAULT_MIN_GAS_PRICE,
        v2_upgrade_height: int | None = None,
        upgrade_height_delay: int | None = None,
        data_dir: str | None = None,
        invariant_check_period: int = 0,  # crisis: 0 = only at genesis/on demand
        da_scheme: str = "rs2d-nmt",  # DA commitment scheme (da/codec.py)
        # serving plane (das/packs.py): keep-newest-N proof packs under
        # <home>/packs (0 keeps every pack; None disables packs)
        pack_keep: int | None = None,
        # mesh plane: raise the versioned hard cap on the square size so
        # k=256/512 squares are admitted end to end (the gov param still
        # gates below it). CONSENSUS-CRITICAL like upgrade_height_delay:
        # every validator must carry the same value (home config key
        # `max_square_size`, never an env var). None = reference cap.
        max_square_size: int | None = None,
        # durable storage engine of data_dir (chain/storage.py): "files";
        # the reference's CELESTIA_CHAINDB
        chaindb_backend: str = "files",
        # the mesh plane (parallel/mesh.Mesh): the reference's
        # engine="mesh"; None is its auto rule
        mesh=None,
    ):
        self.device = device_mod.resolve(device)
        self.mesh = mesh
        self.invariant_check_period = invariant_check_period
        self.traces = telemetry.TraceTables()  # per-node trace tables (§5.1)
        self.absent_validators: set[bytes] = set()
        self.chain_id = chain_id
        self.app_version = app_version
        # the codec plane: which construction data_hash commits under —
        # a consensus parameter (every validator of a chain must run the
        # same scheme; ProcessProposal rejects mismatched headers)
        self.codec = dacodec.get(da_scheme)
        # node-local (operator-set) min gas price; served by the gRPC node
        # Config route the reference's QueryMinimumGasPrice reads first
        self.min_gas_price = min_gas_price
        self.max_square_size = max_square_size
        if max_square_size is not None and max_square_size != \
                appconsts.square_size_upper_bound(app_version):
            if max_square_size < 1 \
                    or (max_square_size & (max_square_size - 1)) or \
                    max_square_size > appconsts.MAX_EXTENDED_SQUARE_WIDTH // 2:
                raise ValueError(
                    f"max_square_size must be a power of two <= "
                    f"{appconsts.MAX_EXTENDED_SQUARE_WIDTH // 2}, "
                    f"got {max_square_size}")
            # loud, same policy as upgrade_height_delay: the square-size
            # cap feeds ProcessProposal's accept/reject — divergent caps
            # fork the network at the first big block
            obs.get_logger("chain.app").warning(
                "max_square_size override active; every validator must "
                "be provisioned identically or the network forks at the "
                "first block exceeding the reference cap",
                chain_id=chain_id, max_square_size=max_square_size,
                reference=appconsts.square_size_upper_bound(app_version),
            )
        self.v2_upgrade_height = v2_upgrade_height
        self.store = KVStore()
        # durable storage: commits + blocks persist under data_dir; a
        # restarted App resumes at the latest committed height (see load()).
        self.db = storage.ChainDB(data_dir, backend=chaindb_backend) if data_dir else None
        self.height = 0
        self.last_app_hash = self.store.app_hash()
        self.last_block_hash = b"\x00" * 32
        self.genesis_time: float | None = None
        self.last_block_time: float | None = None

        self.auth = modules.AuthKeeper()
        self.bank = modules.BankKeeper()
        self.blob = modules.BlobKeeper()
        self.mint = modules.MintKeeper()
        self.staking = modules.StakingKeeper(self.bank)
        if (upgrade_height_delay is not None and upgrade_height_delay
                != appconsts.DEFAULT_UPGRADE_HEIGHT_DELAY):
            # loud: a delay override is consensus-critical
            # — every validator in the network must carry the same one
            obs.get_logger("chain.app").warning(
                "upgrade_height_delay override active; every validator "
                "must be provisioned identically or the network forks "
                "at the x/signal flip",
                chain_id=chain_id, delay=upgrade_height_delay,
                default=appconsts.DEFAULT_UPGRADE_HEIGHT_DELAY,
            )
        self.signal = modules.SignalKeeper(
            self.staking, upgrade_height_delay=upgrade_height_delay
        )
        self.minfee = modules.MinFeeKeeper()
        self.blobstream = blobstream_mod.BlobstreamKeeper(self.staking)
        self.staking.hooks.append(self.blobstream)
        # gov param routing: every governable param goes through here;
        # x/paramfilter's blocklist is enforced inside GovKeeper
        def _require(value, kind, lo, hi):
            """Setters validate types/ranges: a passed proposal must never be
            able to write a value that breaks the state machine (the
            paramfilter guards WHICH params change; this guards to WHAT)."""
            if kind is int and (type(value) is not int):
                raise ValueError(f"param value {value!r} must be an integer")
            if kind is float and not isinstance(value, (int, float)) \
                    or isinstance(value, bool):
                raise ValueError(f"param value {value!r} must be numeric")
            if not (lo <= value <= hi):
                raise ValueError(f"param value {value!r} out of range [{lo}, {hi}]")
            return value

        def _blob_param(key, lo, hi):
            def setter(ctx, value):
                params = self.blob.params(ctx)
                params[key] = _require(value, int, lo, hi)
                self.blob.set_params(ctx, params)
            return setter

        def _gov_param(key, lo, hi):
            # periods are stored as whole seconds: ints only, so no float
            # ever reaches the gov/params app-hash preimage
            def setter(ctx, value):
                params = self.gov.params(ctx)
                params[key] = _require(value, int, lo, hi)
                self.gov.set_params(ctx, params)
            return setter

        # gov_max_square_size's validation bound is CONSENSUS-visible
        # (a param-change tx above it fails; divergent bounds would
        # diverge tx results and fork): it must be THIS CHAIN's hard
        # cap — the reference bound (128) unless the chain opted into
        # the mesh plane's max_square_size — never the plumbing-wide
        # MAX_EXTENDED_SQUARE_WIDTH, which admits sizes this chain
        # refuses to build
        gov_square_cap = (
            max_square_size if max_square_size is not None
            else appconsts.square_size_upper_bound(app_version))
        param_router = {
            "blob/gas_per_blob_byte": _blob_param("gas_per_blob_byte", 1, 1 << 20),
            "blob/gov_max_square_size": _blob_param(
                "gov_max_square_size", 1, gov_square_cap
            ),
            # gas prices are sdk.Dec-shaped floats end to end (see the
            # det-float waiver on wire/txpb.py in analyze.toml)
            "minfee/network_min_gas_price": lambda ctx, v:
                self.minfee.set_network_min_gas_price(
                    ctx, _require(v, float, 0.0, 1e12)  # lint: disable=det-float
                ),
            "blobstream/data_commitment_window": lambda ctx, v:
                self.blobstream.set_data_commitment_window(
                    ctx, _require(v, int, 100, 10_000)
                ),
            "gov/min_deposit": lambda ctx, v: _gov_min_deposit(ctx, v),
            "gov/voting_period": _gov_param("voting_period", 1, 10**9),
            "gov/max_deposit_period": _gov_param("max_deposit_period", 1, 10**9),
        }

        def _gov_min_deposit(ctx, v):
            params = self.gov.params(ctx)
            params["min_deposit"] = _require(v, int, 1, 1 << 62)
            self.gov.set_params(ctx, params)
        self.gov = gov_mod.GovKeeper(self.staking, self.bank, param_router)
        def _ica_router(ctx, msg: dict, signer: bytes) -> None:
            """Execute an allowlisted ICA msg with the interchain account as
            the effective signer (ICS-27 host execution)."""
            t = msg.get("type")
            if t == "bank/MsgSend":
                self.bank.send(ctx, signer, bytes.fromhex(msg["to"]),
                               int(msg["amount"]))
            elif t == "staking/MsgDelegate":
                self.staking.delegate(ctx, bytes.fromhex(msg["validator"]),
                                      signer, int(msg["amount"]))
            elif t == "staking/MsgUndelegate":
                self.staking.undelegate(ctx, bytes.fromhex(msg["validator"]),
                                        signer, int(msg["amount"]))
            elif t == "gov/MsgVote":
                self.gov.vote(ctx, int(msg["proposal_id"]), signer,
                              msg["option"])
            else:  # the keeper's allowlist already rejected anything else
                raise ValueError(f"unroutable ICA msg {t!r}")

        self.ibc = ibc_mod.IBCStack(self.bank, ica_router=_ica_router)

        self.distribution = sdk_modules.DistributionKeeper(self.staking, self.bank)
        self.slashing = sdk_modules.SlashingKeeper(self.staking)
        self.authz = sdk_modules.AuthzKeeper()
        self.feegrant = sdk_modules.FeeGrantKeeper()
        self.vesting = sdk_modules.VestingKeeper()
        self.crisis = sdk_modules.CrisisKeeper()
        sdk_modules.register_default_invariants(self.crisis, self)
        self.bank.vesting = self.vesting  # locked funds gate inside bank.send
        self.staking.hooks.append(self.distribution)  # F1 settlement hook

        # versioned module manager (app/module/manager.go analog): each
        # module declares its [From,To] app-version range; Begin/EndBlock
        # and migrations dispatch through it (see finalize_block/_migrate)
        from celestia_app_tpu_torch.chain.module_manager import (
            ModuleManager,
            VersionedModule,
        )

        def _slashing_liveness(ctx):
            # liveness from the last commit: validators in
            # self.absent_validators are treated as not signing (the
            # single-process analog of LastCommitInfo)
            for op, _power in self.staking.validators(ctx):
                self.slashing.handle_signature(
                    ctx, op, signed=op not in self.absent_validators
                )

        mm = ModuleManager()
        mm.register(VersionedModule(
            "mint", 1, appconsts.LATEST_VERSION,
            begin_block=lambda ctx: self.mint.begin_blocker(ctx, self.bank),
        ))
        mm.register(VersionedModule(
            "distribution", 1, appconsts.LATEST_VERSION,
            begin_block=self.distribution.allocate,
        ))
        mm.register(VersionedModule(
            "slashing", 1, appconsts.LATEST_VERSION,
            begin_block=_slashing_liveness,
        ))
        mm.register(VersionedModule(
            "staking", 1, appconsts.LATEST_VERSION,
            end_block=self.staking.end_blocker,
        ))
        mm.register(VersionedModule(
            "gov", 1, appconsts.LATEST_VERSION,
            end_block=self.gov.end_blocker,
        ))
        mm.register(VersionedModule(
            "blobstream", 1, 1,  # v1 only (app/modules.go:171)
            end_block=self.blobstream.end_blocker,
            on_exit=lambda ctx: [
                ctx.store.delete(k)
                for k, _ in list(ctx.store.iterate_prefix(b"blobstream/"))
            ],
        ))
        mm.register(VersionedModule(
            "minfee", 2, appconsts.LATEST_VERSION,  # v2+ (modules.go)
            on_enter=lambda ctx: self.minfee.set_network_min_gas_price(
                ctx, appconsts.DEFAULT_NETWORK_MIN_GAS_PRICE
            ),
        ))
        mm.register(VersionedModule("signal", 2, appconsts.LATEST_VERSION))
        # registration order IS the dispatch order (setModuleOrder analog:
        # one source of truth; use set_begin_order/set_end_order only to
        # diverge from it)
        self.module_manager = mm
        # the admission plane's verified-sig cache: a (pubkey, sig,
        # sign-doc) triple verified once — batched at CheckTx or block
        # prevalidation, or scalar in the ante — is never verified again
        # in any later phase. State-independent, so rollback/load leave it.
        self.sig_cache = admission_mod.VerifiedSigCache()
        # the traffic plane's verified-commitment cache: a blob whose
        # share commitment was computed once — batched at admission
        # prevalidation or per blob in validate_blob_tx — is never
        # recomputed at CheckTx/Prepare/Process/Finalize/replay; every
        # phase still byte-compares the cached TRUE value against the
        # tx's claim, so Byzantine mismatches reject warm or cold.
        # State-independent (pure content hash), like the sig cache.
        self.commitment_cache = admission_mod.VerifiedCommitmentCache()
        # the block plane's extend-once machinery (da/edscache.py):
        # a content-addressed LRU of (EDS, DAH, data root) keyed by the
        # ODS share bytes — prepare, process, finalize/commit, the query
        # router, and the DAS serving plane all read the same entry, so
        # extend+commit dispatches at most once per (node, height).
        # State-independent (pure function of the key): rollback/load
        # leave it, exactly like the sig cache.
        self.eds_cache = edscache_mod.EdsCache()
        # DAS planes (das/server.SampleCore) register seed_cache_entry
        # here (via add_da_seed_listener); commit hands each committed
        # entry over on the warmer's background thread, never under a
        # service/consensus lock
        self.da_seed_listeners: list = []
        self.da_warmer = edscache_mod.ProverWarmer()
        # boundary observatory (obs/xfer.py): cumulative ledger mark at
        # the previous commit — each commit's delta is the gauge
        # host_bytes_crossed_per_block (surfaced in /metrics); process-
        # wide totals, so in-process multi-node tests read it on
        # single-node fixtures
        self._xfer_mark = xfer.bytes_crossed()
        self.last_host_bytes_crossed = 0
        # serving plane (das/packs.py): disk-backed nodes precompute a
        # static proof pack per warm height under <home>/packs, pruned
        # keep-newest-N; in-memory nodes serve live assembly only.
        # pack_keep=0 keeps every pack; None disables packs entirely.
        self.pack_store = None
        if self.db is not None and pack_keep is not None:
            from celestia_app_tpu_torch.das import packs as packs_mod

            self.pack_store = packs_mod.PackStore(
                os.path.join(os.path.dirname(os.path.abspath(self.db.dir)),
                             packs_mod.PACK_DIRNAME),
                keep=pack_keep,
            )
        # read plane (das/blob_packs.py): per-namespace blob-read packs
        # under <home>/blobpacks, built at warm time beside the sample
        # packs, same keep-newest-N bound
        self.blob_pack_store = None
        if self.db is not None and pack_keep is not None:
            from celestia_app_tpu_torch.das import blob_packs as blob_packs_mod

            self.blob_pack_store = blob_packs_mod.BlobPackStore(
                os.path.join(os.path.dirname(os.path.abspath(self.db.dir)),
                             blob_packs_mod.BLOB_PACK_DIRNAME),
                keep=pack_keep,
            )
        self.ante = ante_mod.AnteHandler(
            self.auth, self.bank, self.blob, self.minfee, min_gas_price,
            feegrant=self.feegrant, ibc=self.ibc,
            sig_cache=self.sig_cache,
        )
        # committed-state snapshots for load_height rollback (app/app.go:592);
        # when a ChainDB is attached the window lives on disk instead
        self._history: dict[int, dict] = {}
        # baseapp checkState: a cache branch over committed state that
        # accumulates CheckTx effects; reset at every commit
        self._check_state = None
        # bumped on every rollback/resume so read-side caches (QueryRouter)
        # can invalidate without re-reading disk
        self.state_generation = 0
        # why the last ProcessProposal rejected ("<type>: <message>"), or
        # None after an accept; last_reject_error is the exception itself,
        # so that a caller can tell a kernel wrapper's error
        # (cuda_build.KernelError) from a verdict on the block
        self.last_reject: str | None = None
        self.last_reject_error: Exception | None = None

    # ------------------------------------------------------------------
    # pipeline selection
    # ------------------------------------------------------------------

    def enable_store_trace(self, path: str) -> None:
        """Commit-multistore tracer analog (ref app/app.go:194
        SetCommitMultiStoreTracer + cmd/root.go:243 --trace): every
        committed store write/delete appends a JSON line
        {op, key, len, height} to `path`. Line-buffered so a crash loses
        at most the current line."""
        import json as json_mod

        self._trace_f = open(path, "a", buffering=1)

        def tracer(op: str, key: bytes, vlen: int) -> None:
            executing = getattr(self, "_executing_height", None)
            self._trace_f.write(json_mod.dumps({
                "op": op, "key": key.hex(), "len": vlen,
                "height": executing if executing is not None else self.height,
            }) + "\n")

        self.store.tracer = tracer

    def close(self) -> None:
        """Release durable-storage handles (the native engine holds a
        writer flock; an App replaced in-process — reborn-validator tests,
        rollback tooling — must release it before a successor opens)."""
        if self.db is not None:
            self.db.close()
        f = getattr(self, "_trace_f", None)
        if f is not None:
            self.store.tracer = None
            self._trace_f = None
            try:
                f.close()
            except OSError:
                pass

    def _data_root(self, square: square_mod.Square):
        """(commitments, data_root) for a square — through the
        extend-once cache: the first caller for a given (scheme, ODS)
        content pays the real encode dispatch (da/edscache.compute_entry
        routed through the codec plane: the 2D-RS+NMT pipeline or the
        CMT layer build, device when possible, the bit-identical host
        path otherwise); every later phase of the lifecycle —
        ProcessProposal re-validating what PrepareProposal built, a
        proposer re-validating its own gossip, the query router, the DAS
        server — hits the same entry. The commitments object is the
        scheme's (a DataAvailabilityHeader or CmtCommitments); its
        ``hash()`` is the data root either way."""
        scheme = self.codec.name
        ods = dah_mod.shares_to_ods(square.share_bytes())
        key = edscache_mod.cache_key(ods, scheme)
        entry = self.eds_cache.get(key)
        if entry is None:
            # one span covers the fused device program: RS extension + NMT
            # axis roots + data root land in a single dispatch (da/eds.py),
            # so finer stage attribution needs /debug/profile, not spans
            with obs.span("da.extend_shares", k=square.size,
                          device=str(self.device), scheme=scheme,
                          stages="extend+nmt+root"):
                entry = self.eds_cache.put(
                    key,
                    edscache_mod.compute_entry(ods, self.device, scheme, self.mesh),
                )
        return entry.dah, entry.data_root

    # ------------------------------------------------------------------
    # genesis
    # ------------------------------------------------------------------

    def init_chain(self, genesis: dict) -> None:
        """genesis = {accounts: [{address(hex), balance, sequence?}],
        validators: [{operator(hex), power}], time_unix, params...}.
        Documents produced by export_genesis additionally carry
        ``raw_modules`` (verbatim module state: delegations, params, grants,
        attestations, ...), which replaces the fresh-validator setup and
        restores account sequences so old-chain txs cannot replay."""
        ctx = self._deliver_ctx(InfiniteGasMeter())
        # a missing genesis time must NOT fall back to the wall clock:
        # every validator initializing the same genesis doc must compute
        # identical state (the analyzer's det-wallclock rule)
        self.genesis_time = genesis.get("time_unix", 0)
        if "raw_modules" in genesis:
            # verbatim module restore FIRST — auth/ (account numbers,
            # pubkeys, sequences, the next-number counter) must be in place
            # before ensure_account runs, or fresh numbers would collide
            # with restored ones
            for khex, vhex in genesis["raw_modules"].items():
                ctx.store.set(bytes.fromhex(khex), bytes.fromhex(vhex))
            # height-anchored module state (blobstream ranges, unbonding
            # heights) stays consistent by resuming the height counter
            self.height = genesis.get("exported_height", 0)
        for acc in genesis.get("accounts", []):
            addr = bytes.fromhex(acc["address"])
            record = self.auth.ensure_account(ctx, addr)
            self.bank.mint(ctx, addr, acc["balance"])
            seq = acc.get("sequence", 0)
            if seq and record["sequence"] < seq:
                # hand-authored genesis without raw_modules can still pin
                # sequences (anti-replay); verbatim auth restore wins if both
                record["sequence"] = seq
                put_json(ctx, self.auth.PREFIX + addr, record)
        if "raw_modules" not in genesis:
            for val in genesis.get("validators", []):
                self.staking.set_validator(
                    ctx, bytes.fromhex(val["operator"]), val["power"]
                )
            if "gov_max_square_size" in genesis:
                p = self.blob.params(ctx)
                p["gov_max_square_size"] = genesis["gov_max_square_size"]
                self.blob.set_params(ctx, p)
        ctx.store.write()
        # genesis invariant assertion (crisis module's init-genesis check)
        check_ctx = self._ctx(self.store, InfiniteGasMeter(), check=False)
        self.crisis.assert_invariants(check_ctx)
        self.last_app_hash = self.store.app_hash()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def add_da_seed_listener(self, fn) -> None:
        """Register a commit-seed listener (idempotent: re-attaching the
        same bound method — a double attach_das_core — must not
        double-seed every commit). A service being replaced over a
        long-lived App must deregister its old core via
        remove_da_seed_listener (the services do, in shutdown())."""
        if fn not in self.da_seed_listeners:
            self.da_seed_listeners.append(fn)

    def remove_da_seed_listener(self, fn) -> None:
        """Deregister a commit-seed listener; absent entries are a no-op
        (shutdown paths must be idempotent)."""
        try:
            self.da_seed_listeners.remove(fn)
        except ValueError:
            pass

    def _chain_time(self) -> float:
        """Deterministic time anchor for contexts not given an explicit
        block time (check-tx, queries, simulation): the last committed
        block's header time, before any block the genesis time. A wall-
        clock read here would let two nodes disagree on check/query
        results for the same state (det-wallclock)."""
        if self.last_block_time is not None:
            return self.last_block_time
        return self.genesis_time or 0

    def _ctx(self, store, gas_meter, *, check: bool, height=None, t=None) -> Context:
        return Context(
            store,
            gas_meter,
            height if height is not None else self.height + 1,
            t if t is not None else self._chain_time(),
            self.chain_id,
            self.app_version,
            is_check_tx=check,
        )

    def _deliver_ctx(self, gas_meter, height=None, t=None) -> Context:
        return self._ctx(self.store.branch(), gas_meter, check=False, height=height, t=t)

    def max_effective_square_size(self, ctx: Context) -> int:
        """min(gov param, hard cap) — app/square_size.go:9-23. The hard
        cap is the versioned reference bound unless the mesh plane's
        consensus-critical ``max_square_size`` override raises it (the
        k=256/512 admission path; see __init__)."""
        hard = (self.max_square_size if self.max_square_size is not None
                else appconsts.square_size_upper_bound(self.app_version))
        return min(self.blob.params(ctx)["gov_max_square_size"], hard)

    # ------------------------------------------------------------------
    # CheckTx (mempool admission)
    # ------------------------------------------------------------------

    def check_tx(self, raw: bytes) -> TxResult:
        """Mempool admission against a PERSISTENT check state (baseapp's
        checkState, reset on every commit): successive txs from one account
        observe each other's sequence bumps and fee deductions, so a client
        can queue several txs between blocks (app/check_tx.go semantics)."""
        if self._check_state is None:
            self._check_state = self.store.branch()
        ctx = self._ctx(self._check_state.branch(), GasMeter(1 << 40), check=True)
        threshold = appconsts.subtree_root_threshold(self.app_version)
        try:
            btx = blob_mod.try_unmarshal_blob_tx(raw)  # single parse
            if btx is not None:
                tx, _ = validate_blob_tx(btx, threshold,
                                         cache=self.commitment_cache)
            else:
                tx = decode_tx(raw)
                if any(isinstance(m, MsgPayForBlobs) for m in tx.body.msgs):
                    raise BlobTxError("MsgPayForBlobs without blobs (ErrNoBlobs)")
            gas = GasMeter(tx.body.gas_limit)
            ctx.gas_meter = gas
            self.ante.run(ctx, tx)
            ctx.store.write()  # admitted: later CheckTx sees the state
            return TxResult(0, "", tx.body.gas_limit, gas.consumed, ctx.events)
        except (ante_mod.AnteError, BlobTxError, OutOfGas, ValueError) as e:
            return TxResult(1, str(e), 0, ctx.gas_meter.consumed, [])

    # ------------------------------------------------------------------
    # PrepareProposal (proposer)
    # ------------------------------------------------------------------

    def prepare_proposal(
        self, raw_txs: list[bytes], proposer: bytes = b"", t: float | None = None
    ) -> ProposalResult:
        _t0 = telemetry.start_timer()
        # the PROPOSER's wall clock is the protocol's source of header
        # time (Tendermint BFT-time analog); every other node consumes
        # block.header.time_unix verbatim
        t = t if t is not None else time_mod.time()  # lint: disable=det-wallclock,det-reach
        height = self.height + 1
        # root span of the block lifecycle: the trace id derives from
        # (chain_id, height), so followers and DAS light nodes stamp the
        # SAME id with no coordination (docs/DESIGN.md observability)
        with obs.span(
            "prepare_proposal", traces=self.traces,
            trace_id=obs.trace_id_for(self.chain_id, height),
            height=height, n_candidates=len(raw_txs),
        ) as sp:
            out = self._prepare_inner(raw_txs, proposer, t, height, sp)
        telemetry.measure_since("prepare_proposal", _t0)
        return out

    def _prepare_inner(self, raw_txs: list[bytes], proposer: bytes,
                       t: float, height: int, sp) -> ProposalResult:
        threshold = appconsts.subtree_root_threshold(self.app_version)

        # Split first; ante-filter ALL normal txs before ANY blob tx, exactly
        # mirroring FilterTxs (validate_txs.go:32-98). This ordering is what
        # makes ProcessProposal's replay (block order: normal then blob)
        # observe identical sequence numbers.
        normal_candidates: list[bytes] = []
        blob_candidates: list[tuple[bytes, PfbEntry]] = []
        for raw in raw_txs:
            try:
                btx = blob_mod.try_unmarshal_blob_tx(raw)  # single parse
            except ValueError:
                continue
            if btx is not None:
                try:
                    validate_blob_tx(btx, threshold,
                                     cache=self.commitment_cache)
                    blob_candidates.append((raw, PfbEntry(btx.tx, btx.blobs)))
                except (BlobTxError, ValueError):
                    continue
            else:
                try:
                    tx = decode_tx(raw)
                except ValueError:
                    continue
                if any(isinstance(m, MsgPayForBlobs) for m in tx.body.msgs):
                    continue  # PFB without blobs never enters a block
                normal_candidates.append(raw)

        def ante_filter(
            normals: list[bytes], blobs: list[tuple[bytes, PfbEntry]]
        ) -> tuple[list[bytes], list[tuple[bytes, PfbEntry]]]:
            ctx = self._ctx(
                self.store.branch(), InfiniteGasMeter(), check=False,
                height=height, t=t,
            )
            kept_n, kept_b = [], []
            for raw in normals:
                tx = decode_tx(raw)
                per_tx = ctx.branch()
                per_tx.gas_meter = GasMeter(tx.body.gas_limit)
                try:
                    self.ante.run(per_tx, tx)
                    per_tx.store.write()
                    kept_n.append(raw)
                except (ante_mod.AnteError, OutOfGas, ValueError):
                    continue
            for raw, entry in blobs:
                tx = decode_tx(entry.tx)
                per_tx = ctx.branch()
                per_tx.gas_meter = GasMeter(tx.body.gas_limit)
                try:
                    self.ante.run(per_tx, tx)
                    per_tx.store.write()
                    kept_b.append((raw, entry))
                except (ante_mod.AnteError, OutOfGas, ValueError):
                    continue
            return kept_n, kept_b

        normal_txs, kept_blobs = ante_filter(normal_candidates, blob_candidates)
        max_sq = self.max_effective_square_size(
            self._ctx(self.store.branch(), InfiniteGasMeter(), check=False)
        )
        # square.build may drop txs; admission (sequence chain) depends on the
        # final tx set, so re-filter and rebuild until a fixed point.
        with obs.span("square.build"):
            while True:
                square = square_mod.build(
                    normal_txs, [e for _, e in kept_blobs], max_sq, threshold
                )
                kept_tx_set = set(square.txs)
                kept_pfb_set = {e.tx for e in square.pfbs}
                next_normals = [r for r in normal_txs if r in kept_tx_set]
                next_blobs = [(r, e) for r, e in kept_blobs
                              if e.tx in kept_pfb_set]
                if (len(next_normals) == len(normal_txs)
                        and len(next_blobs) == len(kept_blobs)):
                    break
                normal_txs, kept_blobs = ante_filter(next_normals, next_blobs)
        kept_blob_raws = [r for r, _ in kept_blobs]
        d, root = self._data_root(square)

        header = Header(
            chain_id=self.chain_id,
            height=height,
            time_unix=t,
            data_hash=root,
            square_size=square.size,
            app_hash=self.last_app_hash,
            proposer=proposer,
            app_version=self.app_version,
            last_block_hash=self.last_block_hash,
            validators_hash=self._validators_hash(),
            da_scheme=self.codec.scheme_id,
        )
        block = Block(header=header, txs=tuple(square.txs + kept_blob_raws))
        sp.set(n_txs=len(block.txs), square_size=square.size)
        return ProposalResult(block=block, square=square, dah=d)

    def _validators_hash(self) -> bytes:
        """Commitment to the current (operator, power) set — the header's
        ValidatorsHash analog light clients verify certificates against."""
        from celestia_app_tpu_torch.chain.block import validators_hash_of

        ctx = self._ctx(self.store.branch(), InfiniteGasMeter(), check=False)
        return validators_hash_of(self.staking.validators(ctx))

    # ------------------------------------------------------------------
    # ProcessProposal (every validator)
    # ------------------------------------------------------------------

    def process_proposal(self, block: Block) -> bool:
        """True = accept. Any validation failure or internal panic rejects
        (process_proposal.go:29-35 defer/recover)."""
        _t0 = telemetry.start_timer()
        try:
            with obs.span(
                "process_proposal", traces=self.traces,
                trace_id=obs.trace_id_for(self.chain_id,
                                          block.header.height),
                height=block.header.height, n_txs=len(block.txs),
            ) as sp:
                try:
                    self._process_proposal_inner(block)
                except Exception as e:
                    # a reject must say why: a failed kernel launch on a
                    # follower would otherwise read as a Byzantine block
                    self.last_reject = f"{type(e).__name__}: {e}"
                    self.last_reject_error = e
                    sp.set(reject=self.last_reject)
                    telemetry.incr("process_proposal.rejects", labels={
                        "type": type(e).__name__, "reason": reject_reason(e)})
                    raise
            telemetry.incr("process_proposal.accepted")
            self.last_reject = None
            self.last_reject_error = None
            return True
        except Exception:
            telemetry.incr("process_proposal.rejected")
            return False
        finally:
            telemetry.measure_since("process_proposal", _t0)

    def _process_proposal_inner(self, block: Block) -> None:
        threshold = appconsts.subtree_root_threshold(self.app_version)
        h = block.header
        if h.chain_id != self.chain_id or h.height != self.height + 1:
            raise ValueError("wrong chain or height")
        if h.app_version != self.app_version:
            raise ValueError("app version mismatch")
        if h.app_hash != self.last_app_hash:
            raise ValueError("app hash mismatch")
        if h.validators_hash != self._validators_hash():
            # the proposer must commit to the SAME valset every honest
            # validator derives from state — a forged commitment would let
            # light clients be pointed at a fake set
            raise ValueError("validators hash mismatch")
        if h.da_scheme != self.codec.scheme_id:
            # the DA scheme is a consensus parameter: a proposer running
            # a different codec would commit a data root this node can
            # neither recompute nor sample — reject before paying for
            # the (wrong-scheme) encode below
            raise ValueError(
                f"DA scheme mismatch: header {h.da_scheme}, "
                f"node runs {self.codec.scheme_id} ({self.codec.name})")

        ctx = self._ctx(
            self.store.branch(), InfiniteGasMeter(), check=False,
            height=h.height, t=h.time_unix,
        )
        # admission plane, phase 1: verify the whole block's signatures
        # in one batched dispatch; the per-tx ante runs below then hit
        # the verified-sig cache (CheckTx-admitted txs are already in it
        # and are not re-verified here at all). commitments=False: the
        # resolve_commitments pass below is THE one keyed trip through
        # the commitment cache for this block — running the prevalidate
        # half too would sha256 every blob's bytes twice
        admission_mod.prevalidate(self, block.txs, commitments=False,
                                  device=self.device)
        normal_txs: list[bytes] = []
        pfb_entries: list[PfbEntry] = []
        # Batch all blob commitments of the block in one device pass
        # (da/commitment_device.py) instead of per-blob host recomputation.
        parsed: dict[int, object] = {}
        all_blobs: list = []
        seen_blob_scan = False
        for i, raw in enumerate(block.txs):
            try:
                btx = blob_mod.try_unmarshal_blob_tx(raw)  # single parse
            except ValueError as e:
                raise ValueError(f"undecodable blob tx: {e}") from None
            if btx is not None:
                seen_blob_scan = True
                parsed[i] = btx
                all_blobs.extend(btx.blobs)
            elif seen_blob_scan:
                # cheap reject before paying the device commitment batch
                raise ValueError("normal tx after blob tx (ordering violation)")
        # traffic plane: commitments resolve through the verified-
        # commitment cache — CheckTx-admitted blobs (and the proposer's
        # own PrepareProposal pass) cost lookups here; only a cold
        # follower pays one batched compute, which then fills the cache
        # for finalize/replay/its own later proposals.
        all_commitments = resolve_commitments(all_blobs, threshold,
                                              cache=self.commitment_cache,
                                              device=self.device)
        cursor = 0
        for i, raw in enumerate(block.txs):
            if i in parsed:
                btx = parsed[i]
                n = len(btx.blobs)
                tx, _ = validate_blob_tx(
                    btx, threshold, all_commitments[cursor : cursor + n]
                )
                cursor += n
                # the full ante chain runs for blob txs too — sig, fee funds,
                # sequence (process_proposal.go:100-117); block order (normal
                # before blob) matches PrepareProposal's filter order, so the
                # sequence chain observed here is identical.
                per_tx = ctx.branch()
                per_tx.gas_meter = GasMeter(tx.body.gas_limit)
                self.ante.run(per_tx, tx)
                per_tx.store.write()
                pfb_entries.append(PfbEntry(btx.tx, btx.blobs))
            else:
                # normal-after-blob ordering is enforced by the pre-scan above
                tx = decode_tx(raw)  # v2+: undecodable tx rejects the block
                if any(isinstance(m, MsgPayForBlobs) for m in tx.body.msgs):
                    raise ValueError("PFB message in non-blob tx")
                per_tx = ctx.branch()
                per_tx.gas_meter = GasMeter(tx.body.gas_limit)
                self.ante.run(per_tx, tx)
                per_tx.store.write()
                normal_txs.append(raw)

        square = square_mod.construct(
            normal_txs, pfb_entries, self.max_effective_square_size(ctx), threshold
        )
        if square.size != h.square_size:
            raise ValueError(
                f"square size mismatch: computed {square.size}, header {h.square_size}"
            )
        _, root = self._data_root(square)
        if root != h.data_hash:
            raise ValueError("data root mismatch")

    # ------------------------------------------------------------------
    # FinalizeBlock + Commit
    # ------------------------------------------------------------------

    def finalize_block(self, block: Block) -> list[TxResult]:
        with obs.span(
            "finalize_block", traces=self.traces,
            trace_id=obs.trace_id_for(self.chain_id, block.header.height),
            height=block.header.height, n_txs=len(block.txs),
        ):
            return self._finalize_inner(block)

    def _finalize_inner(self, block: Block) -> list[TxResult]:
        h = block.header
        ctx = self._deliver_ctx(InfiniteGasMeter(), height=h.height, t=h.time_unix)

        # BeginBlock via the versioned module manager (mint first, then
        # distribution, then slashing liveness — app/modules.go order);
        # only modules whose [From,To] range covers the current app
        # version run (app/module/manager.go dispatch)
        self.module_manager.begin_block(ctx, self.app_version)
        self.absent_validators = set()

        results: list[TxResult] = []
        for raw in block.txs:
            results.append(self._deliver_tx(ctx, raw))

        # EndBlock: upgrades
        self._end_blocker(ctx, h.height)
        if self.invariant_check_period and h.height % self.invariant_check_period == 0:
            self.crisis.assert_invariants(ctx)

        # the branch flush below is where the store tracer fires;
        # self.height still holds the PREVIOUS height until commit(), so
        # tell the tracer which block these writes belong to
        self._executing_height = h.height
        try:
            ctx.store.write()
        finally:
            self._executing_height = None
        return results

    def _deliver_tx(self, block_ctx: Context, raw: bytes) -> TxResult:
        try:
            btx = blob_mod.try_unmarshal_blob_tx(raw)  # single parse
        except ValueError as e:
            return TxResult(1, f"undecodable blob tx: {e}", 0, 0, [])
        raw_tx = btx.tx if btx is not None else raw  # strip blobs
        try:
            tx = decode_tx(raw_tx)
        except ValueError as e:
            return TxResult(1, f"undecodable tx: {e}", 0, 0, [])
        gas = GasMeter(tx.body.gas_limit)
        tx_ctx = block_ctx.branch()
        tx_ctx.gas_meter = gas
        try:
            self.ante.run(tx_ctx, tx)
            for m in tx.body.msgs:
                self._dispatch(tx_ctx, m)
            tx_ctx.store.write()
            return TxResult(0, "", tx.body.gas_limit, gas.consumed, tx_ctx.events)
        except (ante_mod.AnteError, OutOfGas, ValueError, KeyError,
                TypeError, IndexError, AttributeError) as e:
            # baseapp's runTx panic recovery: ANY malformed msg payload
            # (e.g. relay JSON missing fields -> KeyError, or JSON of the
            # wrong shape -> AttributeError on .get/.items) becomes a
            # failed tx, never a deterministic crash of every validator.
            # failed txs keep their fee + sequence bump (cosmos semantics):
            # re-run just the ante effects on a fresh branch
            fee_ctx = block_ctx.branch()
            fee_ctx.gas_meter = GasMeter(tx.body.gas_limit)
            try:
                self.ante.run(fee_ctx, tx)
                fee_ctx.store.write()
            except Exception:
                # an unre-runnable ante means the failed tx keeps neither
                # fee nor sequence bump — count it, it undercharges
                telemetry.incr("app.fee_reapply_errors")
            return TxResult(1, str(e), tx.body.gas_limit, gas.consumed, [])

    def simulate_tx(self, raw: bytes) -> TxResult:
        """Dry-run a tx against current committed state and report the gas
        it consumes (the reference's /cosmos.tx.v1beta1.Service/Simulate,
        which pkg/user/tx_client.go:320-330 uses for estimateGas). The ante
        runs in simulate mode — no signature, fee, or sequence requirements
        — msgs dispatch on a DISCARDED branch, and gas metering is real."""
        try:
            btx = blob_mod.try_unmarshal_blob_tx(raw)
        except ValueError as e:
            return TxResult(1, f"undecodable blob tx: {e}", 0, 0, [])
        raw_tx = btx.tx if btx is not None else raw
        try:
            tx = decode_tx(raw_tx)
        except ValueError as e:
            return TxResult(1, f"undecodable tx: {e}", 0, 0, [])
        ctx = self._ctx(self.store.branch(), GasMeter(1 << 40), check=False)
        try:
            self.ante.run(ctx, tx, simulate=True)
            for m in tx.body.msgs:
                self._dispatch(ctx, m)
        except (ante_mod.AnteError, OutOfGas, ValueError, KeyError,
                TypeError, IndexError) as e:
            return TxResult(1, str(e), 0, ctx.gas_meter.consumed, [])
        # branch is dropped: simulation never mutates state
        return TxResult(0, "", 0, ctx.gas_meter.consumed, ctx.events)

    def _dispatch(self, ctx: Context, msg) -> None:
        if isinstance(msg, MsgSend):
            self.bank.send(ctx, msg.from_addr, msg.to_addr, msg.amount)
        elif isinstance(msg, MsgPayForBlobs):
            self.blob.pay_for_blobs(ctx, msg)
        elif isinstance(msg, MsgSignalVersion):
            self.signal.signal_version(ctx, msg.validator, msg.version)
        elif isinstance(msg, MsgTryUpgrade):
            self.signal.try_upgrade(ctx)
        elif isinstance(msg, MsgRegisterEVMAddress):
            if self.app_version != 1:
                raise ValueError("blobstream disabled after v1")
            self.blobstream.register_evm_address(ctx, msg.validator, msg.evm_address)
        elif isinstance(msg, MsgDelegate):
            self.staking.delegate(ctx, msg.validator, msg.delegator, msg.amount)
        elif isinstance(msg, MsgUndelegate):
            self.staking.undelegate(ctx, msg.validator, msg.delegator, msg.amount)
        elif isinstance(msg, MsgBeginRedelegate):
            self.staking.redelegate(
                ctx, msg.src_validator, msg.dst_validator, msg.delegator, msg.amount
            )
        elif isinstance(msg, MsgCreateValidator):
            if msg.pubkey:
                # the consensus pubkey must derive the operator address, or
                # anyone could register a key they don't hold for an
                # address they do (votes would verify against the wrong
                # identity)
                from celestia_app_tpu_torch.chain.crypto import PublicKey

                if PublicKey(msg.pubkey).address() != msg.operator:
                    raise ValueError(
                        "consensus pubkey does not derive operator address"
                    )
            self.staking.create_validator(
                ctx, msg.operator, msg.self_stake, pubkey=msg.pubkey
            )
        elif isinstance(msg, MsgSubmitProposal):
            import json as json_mod

            self.gov.submit_proposal(
                ctx,
                msg.proposer,
                json_mod.loads(msg.changes_json),
                msg.initial_deposit,
                msg.title,
            )
        elif isinstance(msg, MsgDeposit):
            self.gov.deposit(ctx, msg.proposal_id, msg.depositor, msg.amount)
        elif isinstance(msg, MsgVote):
            self.gov.vote(ctx, msg.proposal_id, msg.voter, msg.option)
        elif isinstance(msg, MsgTransfer):
            self.ibc.transfer.send_transfer(
                ctx, msg.source_channel, msg.sender, msg.receiver,
                msg.denom, msg.amount,
                timeout_height=msg.timeout_height,
            )
        elif isinstance(msg, MsgUpdateClient):
            # client-root recording as a consensus tx: replicated client
            # state is what makes the proof-gated relay txs below evaluate
            # identically on every validator
            import json as json_mod

            from celestia_app_tpu_torch.chain import consensus as consensus_mod

            header = cert = new_validators = new_powers = None
            if msg.header_json:
                header = consensus_mod.header_from_json(
                    json_mod.loads(msg.header_json)
                )
            if msg.cert_json:
                cert = consensus_mod.cert_from_json(
                    json_mod.loads(msg.cert_json)
                )
            if msg.valset_json:
                vs = json_mod.loads(msg.valset_json)
                if not isinstance(vs, dict):
                    raise ValueError("valset_json must be an object")
                ops = vs.get("operators", {})
                pows = vs.get("powers", {})
                if not isinstance(ops, dict) or not isinstance(pows, dict):
                    raise ValueError(
                        "valset operators/powers must be objects"
                    )
                new_validators = {
                    bytes.fromhex(k): bytes.fromhex(v)
                    for k, v in ops.items()
                }
                new_powers = {
                    bytes.fromhex(k): int(v) for k, v in pows.items()
                }
            self.ibc.clients.update_client(
                # empty root decodes as b"" — normalize to None so the
                # keeper's "trusting update needs a root" guard applies
                ctx, msg.client_id, msg.height, msg.root or None,
                header=header, cert=cert,
                new_validators=new_validators, new_powers=new_powers,
                # the tx signer: trusting clients only accept their
                # pinned authorized relayer on this path (ibc.py)
                tx_relayer=msg.relayer,
            )
            ctx.emit_event("ibc.update_client", client_id=msg.client_id,
                           height=msg.height)
        elif isinstance(msg, MsgRecvPacket):
            # consensus-routed relay (ibc-go MsgRecvPacket): packet
            # application is part of the block, so every validator applies
            # it identically and WAL replay reproduces it
            import json as json_mod

            packet = json_mod.loads(msg.packet_json)
            proof = json_mod.loads(msg.proof_json) if msg.proof_json else None
            ack = self.ibc.recv_packet(
                ctx, packet, proof,
                msg.proof_height if proof is not None else None,
            )
            ctx.emit_event(
                "ibc.recv_packet",
                sequence=packet.get("sequence"),
                ok="error" not in ack,
            )
        elif isinstance(msg, MsgAcknowledgePacket):
            import json as json_mod

            self.ibc.acknowledge_packet(
                ctx, json_mod.loads(msg.packet_json),
                json_mod.loads(msg.ack_json),
                json_mod.loads(msg.proof_json) if msg.proof_json else None,
                msg.proof_height if msg.proof_json else None,
            )
        elif isinstance(msg, MsgTimeoutPacket):
            import json as json_mod

            self.ibc.timeout_packet(
                ctx, json_mod.loads(msg.packet_json),
                json_mod.loads(msg.proof_json) if msg.proof_json else None,
                msg.proof_height if msg.proof_json else None,
            )
        elif isinstance(msg, MsgExec):
            # x/authz: every inner message's native signer must have granted
            # the tx signer (grantee) authorization for that msg type
            if not msg.inner:
                raise ValueError("MsgExec with no inner messages")
            for inner in msg.inner:
                if isinstance(inner, MsgExec):
                    raise ValueError("nested MsgExec is not allowed")
                if isinstance(inner, MsgPayForBlobs):
                    raise ValueError("MsgPayForBlobs cannot be nested in MsgExec")
                granter = ante_mod.msg_signer(inner)
                if granter is None:
                    raise ValueError("inner message has no signer")
                if granter != msg.grantee and not self.authz.has_authorization(
                    ctx, granter, msg.grantee, inner.TYPE
                ):
                    raise ValueError(
                        f"no authorization for {inner.TYPE} from {granter.hex()}"
                    )
                self._dispatch(ctx, inner)
        else:
            raise ValueError(f"unroutable message {type(msg).__name__}")

    def _end_blocker(self, ctx: Context, height: int) -> None:
        # staking unbonding queue matures, then gov proposals resolve, then
        # blobstream attestations (module EndBlocker order app/modules.go;
        # blobstream's [1,1] range retires it at v2, app/modules.go:171) —
        # all dispatched by the versioned module manager
        self.module_manager.end_block(ctx, self.app_version)
        # height-based v1 -> v2 (app/app.go:458-470)
        if (
            self.app_version == 1
            and self.v2_upgrade_height is not None
            and height >= self.v2_upgrade_height
        ):
            self._migrate(ctx, 2)
            return
        # signal-based v2+ (app/app.go:472-478)
        if self.app_version >= 2:
            target = self.signal.should_upgrade(ctx)
            if target is not None:
                self.signal.clear_upgrade(ctx)
                self._migrate(ctx, target)

    def _migrate(self, ctx: Context, new_version: int) -> None:
        """Store migrations on upgrade (app/app.go:484-508 analog): the
        module manager runs on_exit for modules leaving their version range
        (blobstream store teardown) and on_enter for those arriving
        (minfee param seeding)."""
        self.module_manager.migrate(ctx, self.app_version, new_version)
        self.app_version = new_version

    SNAPSHOT_KEEP = 100  # bounded rollback window (reference keeps pruned IAVL versions)

    def commit(self, block: Block) -> bytes:
        with obs.span(
            "commit", traces=self.traces,
            trace_id=obs.trace_id_for(self.chain_id, block.header.height),
            height=block.header.height,
        ):
            return self._commit_inner(block)

    def _commit_inner(self, block: Block) -> bytes:
        t0 = telemetry.start_timer()
        # root BEFORE height: lockless readers pairing (height,
        # last_app_hash) — ChainHandle.status_pair — can then never
        # observe a height whose root is still the previous block's;
        # the benign inverse (old height, new root) retries or, for the
        # trusting relayer, records a binding its own fresh proofs verify
        # against
        self.last_app_hash = self.store.app_hash()
        self.height = block.header.height
        self.last_block_hash = block.header.hash()
        self.last_block_time = block.header.time_unix
        meta = self._commit_meta()
        if self.db is not None:
            # durable commit: state + block hit disk atomically before the
            # commit is acknowledged (a killed process resumes here)
            self.db.save_block(block)  # block first: LATEST implies block exists
            self.db.save_commit(self.height, self.store, meta)
        else:
            self.store.drain_changes()  # keep the change log bounded
            self._history[self.height] = {
                "store": self.store.snapshot(),
                "app_version": self.app_version,
                "last_app_hash": self.last_app_hash,
                "last_block_hash": self.last_block_hash,
                "last_block_time": self.last_block_time,
            }
            for h in [
                h for h in self._history if h <= self.height - self.SNAPSHOT_KEEP
            ]:
                del self._history[h]
        self._check_state = None  # baseapp resetState on commit
        telemetry.measure_since("commit", t0)
        # boundary observatory: bytes that crossed the host<->device
        # boundary since the previous commit — THE gauge a zero-copy
        # block path optimizes against. Process-wide ledger totals, so
        # on a multi-node in-process net the proposer's commit
        # attributes the whole net's traffic (per-process nodes
        # attribute exactly). On device="cpu" the ledger's copies are
        # host memcpys, counted all the same.
        crossed = xfer.bytes_crossed()
        self.last_host_bytes_crossed = crossed - self._xfer_mark
        self._xfer_mark = crossed
        telemetry.gauge("xfer.host_bytes_crossed_per_block",
                        self.last_host_bytes_crossed)
        # BlockSummary trace row (celestia-core pkg/trace analog, §5.1):
        # what the e2e benchmark tooling scrapes per block. PER-NODE table
        # (self.traces): multi-node in-process networks must not interleave
        self.traces.write(
            "block_summary",
            height=self.height,
            time_unix=block.header.time_unix,
            n_txs=len(block.txs),
            block_bytes=sum(len(t) for t in block.txs),
            square_size=block.header.square_size,
            data_hash=block.header.data_hash.hex(),
            app_hash=self.last_app_hash.hex(),
            app_version=self.app_version,
        )
        # block plane: hand the committed entry to the DAS serving plane
        # and pre-build its provers on the warmer's background thread —
        # scheduling here is O(1) (slot swap + maybe a thread spawn); the
        # heavy level passes and seed fan-out run OUTSIDE whatever
        # service/consensus lock wraps this commit, so the first light-
        # client sample after commit is pure index arithmetic. A miss
        # (e.g. WAL replay, which never ran ProcessProposal) just means
        # the DAS plane warms lazily on first demand instead.
        entry = self.eds_cache.lookup_root(block.header.data_hash)
        if entry is not None:
            self.da_warmer.schedule(
                self.height, entry, self.da_seed_listeners,
                device=self.device, traces=self.traces,
                chain_id=self.chain_id, pack_store=self.pack_store,
                blob_pack_store=self.blob_pack_store,
            )
        return self.last_app_hash

    def _commit_meta(self) -> dict:
        """The identity document persisted beside every durable commit."""
        return {
            "app_version": self.app_version,
            "last_app_hash": self.last_app_hash.hex(),
            "last_block_hash": self.last_block_hash.hex(),
            "chain_id": self.chain_id,
            "genesis_time": self.genesis_time,
            "last_block_time": self.last_block_time,
        }

    def persist_identity(self) -> None:
        """Re-point the durable LATEST at the current in-memory identity and
        discard the abandoned fork above it (rollback semantics: the
        reference deletes store versions above the target)."""
        if self.db is None:
            raise ValueError("no data_dir attached")
        self.db.save_commit(
            self.height, self.store, self._commit_meta(), force_full=True
        )
        self.db.delete_above(self.height)

    def load(self, height: int | None = None) -> None:
        """Resume from the durable store (reference LoadLatestVersion /
        LoadHeight, app/app.go:427-435): restores state, chain identity,
        and app version from disk."""
        if self.db is None:
            raise ValueError("no data_dir attached")
        try:
            h, store_data, meta = self.db.load_commit(height)
        except FileNotFoundError:
            raise ValueError(
                f"no committed state for height {height} (missing or pruned)"
            ) from None
        self.store.restore(store_data)
        self.height = h
        self.app_version = meta["app_version"]
        self.last_app_hash = bytes.fromhex(meta["last_app_hash"])
        self.last_block_hash = bytes.fromhex(meta["last_block_hash"])
        self.chain_id = meta["chain_id"]
        self.genesis_time = meta["genesis_time"]
        # restore the deterministic time anchor: the meta carries it
        # (prune-proof, no block decode); metas written before the
        # anchor existed fall back to the block, then to genesis time
        self.last_block_time = meta.get("last_block_time")
        if self.last_block_time is None and h > 0:
            try:
                self.last_block_time = \
                    self.db.load_block(h).header.time_unix
            except FileNotFoundError:
                self.last_block_time = None
        self._check_state = None  # stale mempool overlay dies with the old timeline
        self.state_generation += 1

    def load_height(self, height: int) -> None:
        """Rollback to a committed height (reference LoadHeight): restores the
        store AND the version/hash identity so re-execution matches the
        original chain."""
        if self.db is not None:
            self.load(height)
            return
        snap = self._history.get(height)
        if snap is None:
            raise ValueError(f"no snapshot for height {height}")
        self.store.restore(snap["store"])
        self.height = height
        self.app_version = snap["app_version"]
        self.last_app_hash = snap["last_app_hash"]
        self.last_block_hash = snap["last_block_hash"]
        self.last_block_time = snap["last_block_time"]
        self._check_state = None
        self.state_generation += 1

    # module prefixes whose state is not derivable from balances and must be
    # carried verbatim by an export (delegations, unbonding queues, params,
    # reward indices, grants, attestations, signing info, channels, ...)
    EXPORT_PREFIXES = (
        b"auth/", b"staking/", b"dist/", b"gov/", b"blob/", b"minfee/",
        b"vesting/", b"feegrant/", b"authz/", b"slashing/", b"signal/",
        b"blobstream/", b"ibc/", b"mint/",
    )

    def export_genesis(self) -> dict:
        """ExportAppStateAndValidators (reference app/export.go): a genesis
        document that reproduces the committed state.

        Balances come from the BANK records (every funded address, including
        module pools and addresses that never signed); auth records (numbers,
        pubkeys, sequences — anti-replay), delegations, unbonding queues,
        governed params, reward indices, grants, and attestations ride
        verbatim in ``raw_modules``. On import the height counter resumes at
        exported_height so height-anchored state (blobstream windows,
        unbonding heights) stays consistent (the reference's export.go
        initial-height handling)."""
        ctx = self._ctx(self.store, InfiniteGasMeter(), check=False)
        accounts = []
        for k, _v in ctx.store.iterate_prefix(b"bank/bal/"):
            addr = k[len(b"bank/bal/"):]
            acc = self.auth.account(ctx, addr)
            accounts.append({
                "address": addr.hex(),
                "balance": self.bank.balance(ctx, addr),
                "sequence": acc["sequence"] if acc else 0,
            })
        raw_modules = {}
        for prefix in self.EXPORT_PREFIXES:
            for k, v in ctx.store.iterate_prefix(prefix):
                raw_modules[k.hex()] = v.hex()
        validators = [
            {"operator": op.hex(), "power": power}
            for op, power in self.staking.validators(ctx)
        ]
        return {
            "chain_id": self.chain_id,
            "app_version": self.app_version,
            "exported_height": self.height,
            "time_unix": self.genesis_time,
            "accounts": accounts,
            "validators": validators,  # informational; raw_modules carries state
            "raw_modules": raw_modules,
        }

    def relay_recv_packet(
        self,
        packet: dict,
        proof: dict | None = None,
        proof_height: int | None = None,
    ) -> dict:
        """Core-relay boundary: deliver an inbound IBC packet (the reference
        receives these as relayer-submitted MsgRecvPacket through consensus;
        the single-process node applies them directly to committed state).
        Channels bound to a client REQUIRE a commitment proof against a
        tracked counterparty root (ibc-go VerifyPacketCommitment)."""
        ctx = self._deliver_ctx(InfiniteGasMeter())
        ack = self.ibc.recv_packet(ctx, packet, proof, proof_height)
        ctx.store.write()
        return ack

    def relay_acknowledge(
        self, packet: dict, ack: dict,
        proof: dict | None = None, proof_height: int | None = None,
    ) -> None:
        ctx = self._deliver_ctx(InfiniteGasMeter())
        self.ibc.acknowledge_packet(ctx, packet, ack, proof, proof_height)
        ctx.store.write()

    def relay_timeout(
        self, packet: dict,
        proof: dict | None = None, proof_height: int | None = None,
    ) -> None:
        ctx = self._deliver_ctx(InfiniteGasMeter())
        self.ibc.timeout_packet(ctx, packet, proof, proof_height)
        ctx.store.write()

    # convenience: one full consensus round in-process
    def produce_block(self, raw_txs: list[bytes], t: float | None = None) -> tuple[Block, list[TxResult]]:
        prop = self.prepare_proposal(raw_txs, t=t)
        assert self.process_proposal(prop.block), "own proposal rejected"
        results = self.finalize_block(prop.block)
        self.commit(prop.block)
        return prop.block, results
