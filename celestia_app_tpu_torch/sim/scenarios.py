"""The declarative adversarial scenario library (FORMATS.md §19): the port
of celestia_app_tpu/sim/scenarios.py (host code copied). ``run_scenario``
takes ``device``, where the world computes (sim/engine.Simulation); the
malicious fixtures are built there too. Spec documents are the reference's,
byte for byte, and give the reference's verdict bytes.

A scenario is a plain dict (JSON-able): the SimSpec world keys plus an
``ops`` list — the adversarial program. Ops compose the existing
primitives: the serving plane's withholding gate (das/server.withhold),
the malicious-producer fixtures (testing/malicious.py), topology cuts
(partitions, downs, eclipses), deterministic spam, and state-sync joins.
``run_scenario`` builds the world, installs the ops, runs the seeded
timeline, and reduces the raw results to ONE verdict dict — the BENCH
JSON payload of ``bench.py --scenario`` and the byte-identity witness of
the tier-1 determinism matrix.

Op grammar (each op is a dict with an ``op`` key):

  withhold_threshold   {height, fraction?}    every validator withholds
      the committed height's cells past the scheme's recoverability
      threshold the moment it commits: rs2d-nmt loses the minimal
      unrecoverable (k+1)x(k+1) subgrid (the ¼ bound — arXiv:1809.09044
      regime); cmt-ldpc loses ``fraction`` of its base layer (default
      1.0: past any peeling threshold — arXiv:1910.01247 stopping sets).
  incorrect_coding     {k?}                   after the LAST scheduled
      height commits, >2/3 collude to certify a non-codeword: the
      malicious fixtures build a committed-but-invalid entry
      (testing/malicious.py), every validator serves it (half the bad
      axis withheld so naive re-serving cannot mask it), and a forged
      header+certificate rides the light nodes' header gossip.
  partition            {t, groups}            validator indices per
      partition cell; unlisted validators (and all light nodes) stay in
      cell 0.          heal {t} reunites everyone.
  down / up            {t, validator}         whole-node outage windows.
  lazy                 {validator}            never proposes (its slots
      time out and rotate) but votes honestly.
  spam                 {t, every, until, count}  deterministic junk +
      oversized txs against every validator's admission path.
  eclipse              {t, lights, validator, height}  the listed light
      nodes see ONLY the given validator, which withholds `height` from
      its own core — the captor-withholder shape.
  statesync_join       {t, validator}         the validator (kept down
      from genesis by a paired ``down`` at t=0) snapshot-joins from the
      first reachable peer, then catch-up replays the rest.
  crash_storm          {heights, validators, down_s}  at each listed
      height's commit, a seeded pick of the listed validators drops at
      the post-commit instant (the consensus.post_apply fault point's
      moment) and returns ``down_s`` later.
  traffic              {t?, every?, until?, sequences?, pfbs_per_wave?,
      blob_sizes?, blobs_per_pfb?, gas_prices?, namespaces?}  seeded
      txsim-shaped PFB lanes inside virtual time: per-lane rng draws the
      tools/txsim.py size/namespace/gas-price distributions, every wave
      enters through the BATCHED admission path (add_txs: prevalidate +
      CheckTx) of every up validator, sequences chain on the primary's
      verdicts, and confirmations are counted from committed block txs.
  asym_fault           {kind, t?, until?, src?, dst?, path?, prob?,
      delay?, seed?}  a deterministic per-message asymmetric fault on
      the light fleet's transport (engine.AsymRule): drop/delay/corrupt
      keyed by sha256(seed|src|dst|path|msg-index) — per-message
      reproducible, unlike thread-interleaved fault draws.
  soak                 {eds_entries?, sig_cache?, commitment_cache?,
      ttl_blocks?, ttl_seconds?, expire_every?, snapshot_every?,
      snapshot_keep?, pack_every?, pack_keep?, stale_every?, stale_to?,
      stale_lanes?}  the long-horizon resource-churn harness: shrinks
      every validator's EDS/sig/commitment cache caps and mempool TTLs
      so LRUs actually cycle, runs the production expire tick on the
      virtual clock, writes + prunes state snapshots and proof packs at
      height marks, and feeds a stale-tx lane into a lazy validator's
      pool so TTL expiry (not commits) drains it. The verdict's "soak"
      block reports every resource's churn count.

Verdict metrics (FORMATS.md §19.2): blocks_to_detection, liveness_gap_s,
false_condemnation_rate, recovery_s, sim_lights, sim_virtual_blocks,
peak_rss_bytes (reported, but excluded from the byte-identity form —
memory peaks are not run-deterministic), per-op blocks (traffic / spam /
soak / asym_msgs), plus per-height block/app hashes and the event-trace
digest (the determinism witness).
"""

from __future__ import annotations

import json
import math
import tempfile

import numpy as np

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.da import codec as dacodec
from celestia_app_tpu_torch.sim import engine
from celestia_app_tpu_torch.sim.engine import (
    SimConsensusConfig,
    SimSpec,
    Simulation,
)


# ---------------------------------------------------------------------------
# op installation
# ---------------------------------------------------------------------------


def _ods(k: int, seed: int) -> np.ndarray:
    """A deterministic valid-share ODS for the malicious fixtures."""
    o = np.random.default_rng(seed).integers(  # lint: disable=det-rng
        0, 256, size=(k, k, appconsts.SHARE_SIZE), dtype=np.uint8)
    o[..., :appconsts.NAMESPACE_SIZE] = 0
    o[..., appconsts.NAMESPACE_SIZE - 1] = 7
    return o


def _threshold_cells(entry, fraction: float | None) -> list[tuple]:
    """The scheme's at-the-recoverability-threshold withholding set."""
    if entry.scheme == dacodec.RS2D_NAME:
        k = entry.cache_entry.k
        # the minimal unrecoverable pattern for 2D-RS: a (k+1)^2 subgrid
        # (any k available per axis iterates the crossword to completion;
        # k+1 missing on both axes wedges it) — the ¼ sampling bound's
        # worst case
        side = k + 1
        return [(r, c) for r in range(side) for c in range(side)]
    comm = entry.cache_entry.commitments
    frac = 1.0 if fraction is None else float(fraction)
    n = min(comm.n_base, max(1, math.ceil(comm.n_base * frac)))
    return [(0, i) for i in range(n)]


def _install_withhold_threshold(sim: Simulation, op: dict,
                                expect: dict) -> None:
    height = int(op["height"])
    expect.update(kind="withholding", fault_height=height)

    def arm(s: Simulation, committer) -> None:
        entry = committer.core._entry(height)
        cells = _threshold_cells(entry, op.get("fraction"))
        s.withhold_everywhere(height, cells)
        s.sched.note(f"op.withhold_threshold h={height} "
                     f"cells={len(cells)} scheme={entry.scheme}")

    sim.on_commit_height(height, arm)


def _install_incorrect_coding(sim: Simulation, op: dict,
                              expect: dict) -> None:
    from celestia_app_tpu_torch.chain import consensus as c
    from celestia_app_tpu_torch.chain.block import Header, validators_hash_of
    from celestia_app_tpu_torch.testing import malicious

    k = int(op.get("k", 4))
    after = int(op.get("after_height", sim.spec.heights))
    bad_h = after + 1  # past the last real height: never collides
    expect.update(kind="fraud", fault_height=bad_h)

    def inject(s: Simulation, committer) -> None:
        scheme = s.spec.scheme
        ods = _ods(k, seed=5)
        # the scheme-keyed committed-non-codeword fixture: entry +
        # provable location + a withholding set that forces escalation
        # while keeping the fraud equation's members served — one hook,
        # no per-scheme branches here (testing/malicious.py)
        entry, _location, withheld, wire_scheme = \
            malicious.incorrect_coding_fixture(scheme, ods, device=s.device)
        app0 = committer.vnode.app  # the one node sure to hold `after`
        header = Header(
            chain_id=s.chain_id, height=bad_h,
            time_unix=s.block_timestamp(bad_h),
            data_hash=entry.data_root, square_size=k,
            app_hash=b"\x77" * 32,
            proposer=committer.vnode.address,
            app_version=app0.app_version,
            last_block_hash=app0.last_block_hash,
            validators_hash=validators_hash_of(
                [(v.vnode.address, 10) for v in s.validators]),
            da_scheme=wire_scheme,
        )
        votes = tuple(
            c.Vote(
                bad_h, header.hash(), v.vnode.address,
                v.vnode.priv.sign(c.Vote.sign_bytes(
                    s.chain_id, bad_h, header.hash(), "precommit", 0)),
                "precommit", 0,
            )
            for v in s.validators
        )
        cert = c.CommitCertificate(bad_h, header.hash(), votes, 0)
        s.forged_headers[bad_h] = (header, cert)
        for v in s.validators:
            v.core.seed_scheme_entry(bad_h, entry)
            v.core.withhold(bad_h, withheld)
        s.sched.note(f"op.incorrect_coding h={bad_h} scheme={scheme} "
                     f"k={k} withheld={len(withheld)}")

    sim.on_commit_height(after, inject)


def _install_ops(sim: Simulation) -> dict:
    """Install every op of the spec; returns the expectations dict the
    verdict reducer consumes."""
    expect: dict = {"kind": None, "fault_height": None, "marks": [],
                    "collectors": []}
    for op in sim.spec.ops:
        name = op["op"]
        if name == "withhold_threshold":
            _install_withhold_threshold(sim, op, expect)
        elif name == "incorrect_coding":
            _install_incorrect_coding(sim, op, expect)
        elif name == "partition":
            groups = [list(g) for g in op["groups"]]

            def cut(s: Simulation, groups=groups) -> None:
                for gi, members in enumerate(groups):
                    for idx in members:
                        v = s.validator_by_index(idx)
                        s.net.group[v.name] = gi
                s.sched.note(f"op.partition groups={groups}")

            sim.at(float(op["t"]), lambda cut=cut: cut(sim),
                   "op.partition")
        elif name == "heal":
            t = float(op["t"])
            expect["marks"].append(("heal", t, None))

            def heal(s: Simulation = sim) -> None:
                s.net.group.clear()
                s.sched.note("op.heal")

            sim.at(t, heal, "op.heal")
        elif name == "down":
            idx = int(op["validator"])

            def down(s: Simulation = sim, idx=idx) -> None:
                s.validator_by_index(idx).go_down()

            sim.at(float(op["t"]), down, f"op.down val={idx}")
        elif name == "up":
            idx = int(op["validator"])
            t = float(op["t"])
            expect["marks"].append(
                ("up", t, sim.validator_by_index(idx).name))

            def up(s: Simulation = sim, idx=idx) -> None:
                s.validator_by_index(idx).go_up()

            sim.at(t, up, f"op.up val={idx}")
        elif name == "lazy":
            sim.validator_by_index(int(op["validator"])).lazy = True
        elif name == "spam":
            _install_spam(sim, op, expect)
        elif name == "traffic":
            _install_traffic(sim, op, expect)
        elif name == "asym_fault":
            _install_asym(sim, op, expect)
        elif name == "soak":
            _install_soak(sim, op, expect)
        elif name == "eclipse":
            _install_eclipse(sim, op, expect)
        elif name == "statesync_join":
            idx = int(op["validator"])
            t = float(op["t"])
            expect["marks"].append(
                ("join", t, sim.validator_by_index(idx).name))

            def join(s: Simulation = sim, idx=idx) -> None:
                _statesync_join(s, idx)

            sim.at(t, join, f"op.statesync_join val={idx}")
        elif name == "crash_storm":
            _install_crash_storm(sim, op, expect)
        elif name == "slo":
            _install_slo(sim, op, expect)
        else:
            raise ValueError(f"unknown scenario op {name!r}")
    return expect


def _install_spam(sim: Simulation, op: dict, expect: dict) -> None:
    """Junk + oversized floods through the REAL batched admission path
    (add_txs: admission-plane prevalidation, then per-tx CheckTx and the
    pool's byte gate) — the scenario exercises the REJECTION plane and
    its counters, and its verdict block proves nothing junk was pooled."""
    every = float(op.get("every", 0.5))
    until = float(op.get("until", sim.spec.auto_duration(sim.ccfg)))
    count = int(op.get("count", 16))
    state = {"i": 0, "sent": 0, "rejected": 0, "admitted": 0}

    def flood() -> None:
        t = sim.sched.clock.monotonic()
        for v in sim.validators:
            batch = []
            for _j in range(count):
                state["i"] += 1
                # undecodable: prevalidation cannot parse it, CheckTx
                # refuses it, and it must never reach the pool
                batch.append((b"spam-" + str(state["i"]).encode()) * 7)
            # the byte-cap gate too: one oversized tx per wave
            batch.append(
                b"\x5a" * (appconsts.MEMPOOL_MAX_TX_BYTES + 1))
            results = v.vnode.add_txs(batch)
            state["sent"] += len(batch)
            state["rejected"] += sum(1 for r in results if r.code != 0)
            state["admitted"] += sum(1 for r in results if r.code == 0)
        sim.sched.note(f"op.spam wave i={state['i']}")
        if t + every <= until:
            sim.sched.call_after(every, flood, "op.spam")

    sim.at(float(op.get("t", 0.5)), flood, "op.spam")

    def collect(s: Simulation) -> dict:
        pool_rejected = sum(
            v.vnode.pool.metrics.counters.get("rejected", 0)
            for v in s.validators)
        return {"spam": {**{k: state[k] for k in
                            ("sent", "rejected", "admitted")},
                         "pool_rejected": pool_rejected}}

    expect["collectors"].append(collect)


def _install_slo(sim: Simulation, op: dict, expect: dict) -> None:
    """Fleet-wide SLO judging inside the scenario plane
    (tools/fleetmon.py): the op carries its rule list inline
    ({"op": "slo", "rules": [...]}, FORMATS §22.1), the telemetry
    registry is baselined at install time, and the verdict evaluates the
    RUN'S DELTA — counters accumulated by earlier cells in the same
    process never leak into this scenario's verdict. The whole verdict
    joins `verdict_of`, so rules here should pin sim-deterministic
    families (counters, count/sum of deterministic histograms); latency
    quantile budgets belong to the HTTP fleetmon against a live devnet,
    where verdict bytes are compared per fleet STATE, not per seed."""
    from celestia_app_tpu_torch.tools import fleetmon
    from celestia_app_tpu_torch.utils import telemetry

    rules = fleetmon.normalize_rules(op.get("rules") or [])
    base = telemetry.export()

    def collect(s: Simulation) -> dict:
        node = fleetmon.registry_node(base=base)
        verdict = fleetmon.evaluate(rules, {"nodes": {"sim": node}})
        s.sched.note(f"op.slo pass={verdict['pass']} "
                     f"failed={len(verdict['failed'])}")
        return {"slo": verdict}

    expect["collectors"].append(collect)


def _install_traffic(sim: Simulation, op: dict, expect: dict) -> None:
    """Seeded txsim-shaped PFB lanes inside virtual time: the
    tools/txsim.py sequence-worker distributions (blob count/size,
    namespace, gas price), drawn from per-lane seeded rngs, submitted
    through every up validator's BATCHED admission path. The primary's
    verdict decides whether a lane's sequence advances (the txsim
    resync analog); commits are watched so the verdict can report how
    much admitted traffic actually landed in blocks."""
    from celestia_app_tpu_torch.chain import modules
    from celestia_app_tpu_torch.da.blob import Blob
    from celestia_app_tpu_torch.da.namespace import Namespace

    t0 = float(op.get("t", 0.8))
    every = float(op.get("every", 0.9))
    until = float(op.get("until", sim.spec.auto_duration(sim.ccfg)))
    per_wave = int(op.get("pfbs_per_wave", 1))
    blob_sizes = tuple(op.get("blob_sizes", (96, 512)))
    blobs_per_pfb = tuple(op.get("blobs_per_pfb", (1, 2)))
    gas_prices = tuple(op.get("gas_prices", (0.002, 0.02)))
    namespaces = int(op.get("namespaces", 4))
    n_seq = int(op.get("sequences", 2))
    lanes = [
        {"priv": p, "addr": p.public_key().address(), "tag": i,
         # one independent stream per lane off the scenario seed: the
         # sim analog of txsim's per-sequence default_rng(seed, seq)
         "rng": np.random.default_rng([sim.spec.seed, 8800 + i])}  # lint: disable=det-rng
        for i, p in enumerate(sim.claim_traffic_accounts(n_seq))
    ]
    stats = {"submitted": 0, "accepted": 0, "rejected": 0,
             "confirmed": 0}
    pending: set[bytes] = set()  # admitted raws awaiting a commit

    def draw_pfb(lane: dict) -> bytes:
        rng = lane["rng"]
        n_blobs = int(rng.integers(blobs_per_pfb[0],
                                   blobs_per_pfb[1] + 1))
        blobs = []
        for _b in range(n_blobs):
            size = int(rng.integers(blob_sizes[0], blob_sizes[1] + 1))
            ns_id = 1 + int(rng.integers(0, max(1, namespaces)))
            ns = Namespace.v0(bytes([lane["tag"] + 1, ns_id]) * 5)
            blobs.append(Blob(ns, rng.integers(
                0, 256, size, dtype=np.uint8).tobytes()))
        gas = int(modules.estimate_pfb_gas(
            [len(b.data) for b in blobs]) * 1.2)
        price = float(rng.uniform(gas_prices[0], gas_prices[1]))
        fee = max(1, int(gas * price) + 1)
        return sim.signer.create_pay_for_blobs(
            lane["addr"], blobs, fee=fee, gas_limit=gas)

    def wave() -> None:
        ups = [v for v in sim.validators if v.up]
        if ups:
            drawn = [(lane, draw_pfb(lane))
                     for lane in lanes for _ in range(per_wave)]
            batch = [raw for _lane, raw in drawn]
            results = ups[0].vnode.add_txs(batch)
            for (lane, raw), res in zip(drawn, results):
                stats["submitted"] += 1
                if res.code == 0:
                    stats["accepted"] += 1
                    # the lane chains on the primary's verdict; a
                    # rejection leaves the sequence for the next wave
                    sim.signer.accounts[lane["addr"]].sequence += 1
                    pending.add(raw)
                else:
                    stats["rejected"] += 1
            for v in ups[1:]:
                v.vnode.add_txs(batch)
        t = sim.sched.clock.monotonic()
        if t + every <= until:
            sim.sched.call_after(every, wave, "op.traffic")

    sim.at(t0, wave, "op.traffic")

    def confirm(s: Simulation, _val, _height, block) -> None:
        for raw in block.txs:
            if raw in pending:
                pending.discard(raw)
                stats["confirmed"] += 1

    sim.commit_listeners.append(confirm)
    expect["collectors"].append(lambda s: {"traffic": {
        **stats, "in_flight": len(pending)}})


def _install_asym(sim: Simulation, op: dict, expect: dict) -> None:
    from celestia_app_tpu_torch.sim.engine import AsymRule

    rule = AsymRule(
        kind=str(op["kind"]),
        src=str(op.get("src", "light")),
        dst=str(op.get("dst", "")),
        path=str(op.get("path", "")),
        prob=float(op.get("prob", 0.2)),
        delay=float(op.get("delay", 0.05)),
        seed=int(op.get("seed", sim.spec.seed)),
    )
    if rule.kind not in ("drop", "delay", "corrupt"):
        raise ValueError(f"unknown asym_fault kind {rule.kind!r}")

    def arm() -> None:
        sim.net.asym_rules.append(rule)
        sim.sched.note(f"op.asym_fault kind={rule.kind} src={rule.src} "
                       f"path={rule.path} prob={rule.prob}")

    sim.at(float(op.get("t", 0.0)), arm, "op.asym_fault")
    if op.get("until") is not None:
        def disarm() -> None:
            if rule in sim.net.asym_rules:
                sim.net.asym_rules.remove(rule)
            sim.sched.note(f"op.asym_fault.disarm kind={rule.kind}")

        sim.at(float(op["until"]), disarm, "op.asym_fault.disarm")


def _install_soak(sim: Simulation, op: dict, expect: dict) -> None:
    """The long-horizon resource-churn harness: every bounded resource
    the node runs on — EDS-cache LRU, verified sig/commitment LRUs,
    mempool TTL, snapshot keep-N, pack prune — is capped small enough
    (and the run is long enough) that each cycles at least twice, while
    the verdict proves the degradation stayed graceful."""
    import os

    from celestia_app_tpu_torch.chain import consensus as c
    from celestia_app_tpu_torch.chain import sync as sync_mod
    from celestia_app_tpu_torch.chain.tx import MsgSend
    from celestia_app_tpu_torch.das import packs as packs_mod

    eds_entries = int(op.get("eds_entries", 2))
    sig_cache = int(op.get("sig_cache", 24))
    commitment_cache = int(op.get("commitment_cache", 12))
    ttl_blocks = int(op.get("ttl_blocks", 3))
    ttl_seconds = float(op.get("ttl_seconds", 0.0))
    expire_every = float(op.get("expire_every", 1.0))
    snapshot_every = int(op.get("snapshot_every", 4))
    snapshot_keep = int(op.get("snapshot_keep", 2))
    pack_every = int(op.get("pack_every", 3))
    pack_keep = int(op.get("pack_keep", 2))
    stale_every = float(op.get("stale_every", 0.8))
    stale_to = int(op.get("stale_to", sim.spec.validators - 1))
    n_stale = int(op.get("stale_lanes", 1))
    state = {"snapshot_writes": 0, "snapshot_prunes": 0,
             "pack_builds": 0, "stale_submitted": 0}

    def shrink() -> None:
        for v in sim.validators:
            app = v.vnode.app
            # caps mutate IN PLACE: put() reads them live, and the ante
            # handler holds a construction-time reference to the sig
            # cache that a replacement would silently orphan
            app.eds_cache.max_entries = eds_entries
            app.sig_cache.maxsize = sig_cache
            app.commitment_cache.maxsize = commitment_cache
            v.vnode.pool.ttl_blocks = ttl_blocks
            if ttl_seconds > 0:
                v.vnode.pool.ttl_seconds = ttl_seconds
        sim.sched.note(f"op.soak.caps eds={eds_entries} sig={sig_cache} "
                       f"commitment={commitment_cache} "
                       f"ttl_blocks={ttl_blocks}")

    sim.at(0.0, shrink, "op.soak.caps")

    # the production node-loop's mempool TTL tick, on the virtual clock
    def expire_tick() -> None:
        for v in sim.validators:
            v.vnode.pool.expire(v.vnode.app.height)
        sim.sched.call_after(expire_every, expire_tick, "op.soak.expire")

    sim.at(expire_every, expire_tick, "op.soak.expire")

    # snapshot churn: write + keep-N prune at height marks (the
    # committer holds the height's state at its commit instant)
    snaproot = os.path.join(sim.workdir, "soak-snapshots")
    os.makedirs(snaproot, exist_ok=True)

    def snap(s: Simulation, committer) -> None:
        manifest, chunks = c.snapshot_app_chunks(committer.vnode.app)
        out = os.path.join(snaproot, str(int(manifest["height"])))
        if os.path.exists(out):
            return
        sync_mod.write_snapshot_dir(manifest, chunks, out)
        state["snapshot_writes"] += 1
        before = sum(
            1 for name in os.listdir(snaproot)
            if os.path.exists(os.path.join(snaproot, name,
                                           "manifest.json")))
        sync_mod.prune_snapshots(snaproot, keep=snapshot_keep)
        state["snapshot_prunes"] += max(0, before - snapshot_keep)
        s.sched.note(f"op.soak.snapshot h={manifest['height']}")

    for h in range(snapshot_every, sim.spec.heights + 1, snapshot_every):
        sim.on_commit_height(h, snap)

    # pack churn: one dedicated PackStore fed each marked height's
    # committed entry; build() itself prunes to keep-N
    pack_store = packs_mod.PackStore(
        os.path.join(sim.workdir, "soak-packs"), keep=pack_keep)

    def pack(s: Simulation, committer, h: int) -> None:
        entry = committer.core._entry(h).cache_entry
        pack_store.build(h, entry, device=s.device)
        state["pack_builds"] += 1
        s.sched.note(f"op.soak.pack h={h}")

    for h in range(pack_every, sim.spec.heights + 1, pack_every):
        sim.on_commit_height(h, lambda s, cm, h=h: pack(s, cm, h))

    # the stale-tx lane: sequence-0 sends with varying payloads into a
    # LAZY validator's pool only — it never proposes, so nothing ever
    # commits them and ONLY the TTL tick can drain the pool
    lazy = sim.validator_by_index(stale_to)
    lazy.lazy = True
    stale_privs = sim.claim_traffic_accounts(n_stale)
    sink = sim.privs[0].public_key().address()

    def stale_tick() -> None:
        for p in stale_privs:
            addr = p.public_key().address()
            acct = sim.signer.accounts[addr]
            acct.sequence = 0  # never commits: state sequence stays 0
            state["stale_submitted"] += 1
            tx = sim.signer.create_tx(
                addr, [MsgSend(addr, sink,
                               1000 + state["stale_submitted"])],
                fee=2000, gas_limit=100_000,
            )
            lazy.vnode.add_tx(tx.encode())
        sim.sched.call_after(stale_every, stale_tick, "op.soak.stale")

    sim.at(max(stale_every, 0.2), stale_tick, "op.soak.stale")

    def collect(s: Simulation) -> dict:
        apps = [v.vnode.app for v in s.validators]
        return {"soak": {
            "eds_evictions": sum(a.eds_cache.evictions for a in apps),
            "sig_evictions": sum(a.sig_cache.evictions for a in apps),
            "commitment_evictions": sum(
                a.commitment_cache.evictions for a in apps),
            "mempool_expired": sum(
                v.vnode.pool.metrics.counters.get("expired_height", 0)
                + v.vnode.pool.metrics.counters.get("expired_time", 0)
                for v in s.validators),
            "snapshot_writes": state["snapshot_writes"],
            "snapshot_prunes": state["snapshot_prunes"],
            "pack_builds": state["pack_builds"],
            "pack_prunes": max(0, state["pack_builds"] - pack_keep),
            "stale_submitted": state["stale_submitted"],
        }}

    expect["collectors"].append(collect)


def _install_eclipse(sim: Simulation, op: dict, expect: dict) -> None:
    t = float(op["t"])
    lights = [int(i) for i in op["lights"]]
    captor = sim.validator_by_index(int(op.get("validator", 0)))
    height = int(op["height"])
    expect.update(kind="withholding", fault_height=height)

    def eclipse() -> None:
        for i in lights:
            name = sim.lights[i % len(sim.lights)].name
            sim.net.allowed[name] = {captor.name}
        sim.sched.note(
            f"op.eclipse lights={len(lights)} captor={captor.name}")

    sim.at(t, eclipse, "op.eclipse")

    def arm(s: Simulation, committer) -> None:
        entry = committer.core._entry(height)
        captor.core.withhold(height,
                             _threshold_cells(entry, op.get("fraction")))
        s.sched.note(f"op.eclipse_withhold h={height}")

    sim.on_commit_height(height, arm)


def _statesync_join(sim: Simulation, idx: int) -> None:
    from celestia_app_tpu_torch.chain import consensus as c

    joiner = sim.validator_by_index(idx)
    peer = next(
        (v for v in sim.validators
         if v is not joiner and v.name not in sim.net.down
         and v.vnode.app.height > joiner.vnode.app.height + 1),
        None,
    )
    if peer is not None:
        manifest, chunks = c.snapshot_app_chunks(peer.vnode.app)
        if int(manifest["height"]) > joiner.vnode.app.height:
            c.state_sync_bootstrap(joiner.vnode, manifest, chunks)
            sim.sched.note(
                f"op.statesync_join {joiner.name} "
                f"h={manifest['height']} from={peer.name}")
    joiner.go_up()


def _install_crash_storm(sim: Simulation, op: dict, expect: dict) -> None:
    heights = [int(h) for h in op["heights"]]
    victims = [int(i) for i in op["validators"]]
    down_s = float(op.get("down_s", 2.0))

    for h in heights:
        def crash(s: Simulation, _committer, h=h) -> None:
            # seeded pick at the post-commit instant — the in-process
            # stand-in for a crash fault at consensus.post_apply
            idx = victims[s.sched.rng.randrange(len(victims))]
            v = s.validator_by_index(idx)
            if not v.up:
                return  # already down: one outage at a time per victim
            v.go_down()
            s.sched.note(f"op.crash h={h} victim={v.name}")
            s.sched.call_after(down_s, v.go_up, f"op.revive {v.name}")

        sim.on_commit_height(h, crash)


# ---------------------------------------------------------------------------
# verdicts
# ---------------------------------------------------------------------------


def _liveness_gap(commit_times: dict[int, float]) -> float:
    prev = 0.0
    gap = 0.0
    for h in sorted(commit_times):
        gap = max(gap, commit_times[h] - prev)
        prev = commit_times[h]
    return round(gap, 9)


def _detection(sim: Simulation, expect: dict) -> tuple:
    """(blocks_to_detection, detection_t) for the armed fault."""
    kind, fh = expect["kind"], expect["fault_height"]
    if kind is None:
        return None, None
    if kind == "fraud":
        hits = [d for d in sim.light_halts
                if d.get("height") == fh
                and d.get("reason") == "bad-encoding"]
    else:
        hits = [d for d in sim.detections
                if d["height"] == fh
                and d["status"] in ("unavailable", "error")]
    if not hits:
        return None, None
    det_t = min(d["t"] for d in hits)
    committed_by_then = sum(
        1 for t in sim.commit_times.values() if t <= det_t)
    # blocks the chain grew between the fault's activation height and
    # detection (>= 1: detection within the fault height's own era).
    # A fraud height sits past the chain tip, so its activation is the
    # tip it was injected at.
    activation = min(fh, max(sim.commit_times, default=fh))
    return max(1, committed_by_then - activation + 1), det_t


def _false_condemnations(sim: Simulation, expect: dict) -> int:
    fh = expect["fault_height"] if expect["kind"] == "fraud" else None
    return sum(
        1 for halt in sim.light_halts
        if not (fh is not None and halt.get("height") == fh)
    )


def _recovery(sim: Simulation, expect: dict):
    """Virtual seconds from the last heal/up/join mark to the network
    being whole again: the marked validator (for `up`/`join`) — or EVERY
    validator (for `heal`) — back at the committed head, walking the
    per-validator commit/adoption log."""
    out = None
    for kind, t_op, target in expect["marks"]:
        out = None  # the LAST mark decides: an earlier success must
        # not mask a later recovery that never completed
        watch = ([target] if target is not None
                 else [v.name for v in sim.validators])
        cur = {name: 0 for name in (v.name for v in sim.validators)}
        head = 0
        for t, name, height in sorted(sim.val_commit_log):
            cur[name] = max(cur[name], height)
            head = max(head, height)
            if t >= t_op and min(cur[n] for n in watch) >= head:
                out = round(t - t_op, 9)
                break
    return out


def verdict_of(sim: Simulation, expect: dict) -> dict:
    blocks_to_detection, det_t = _detection(sim, expect)
    false_halts = _false_condemnations(sim, expect)
    n_lights = max(1, len(sim.lights))
    return {
        "scenario": sim.spec.name,
        "scheme": sim.spec.scheme,
        "seed": sim.spec.seed,
        "validators": len(sim.validators),
        "light_nodes": len(sim.lights),
        "heights": sim.spec.heights,
        "heights_committed": max(sim.commit_times, default=0),
        "liveness_gap_s": _liveness_gap(sim.commit_times),
        "blocks_to_detection": blocks_to_detection,
        "detection_t": det_t,
        "false_condemnation_rate": round(false_halts / n_lights, 9),
        "light_halts": len(sim.light_halts),
        "unavailable_reports": sum(
            1 for d in sim.detections if d["status"] == "unavailable"),
        "recovery_s": _recovery(sim, expect),
        "dropped_msgs": sim.net.dropped,
        "events": sim.sched.executed,
        "block_hashes": {str(h): sim.block_hashes[h]
                         for h in sorted(sim.block_hashes)},
        "app_hashes": {str(h): sim.app_hashes[h]
                       for h in sorted(sim.app_hashes)},
        "trace_digest": sim.sched.trace_digest(),
        # fleet-scale telemetry (FORMATS §19.2): how BIG this cell was,
        # and what the process peaked at getting there. peak_rss_bytes
        # is measured, not simulated — verdict_bytes drops it.
        "sim_lights": len(sim.lights),
        "sim_virtual_blocks": max(sim.commit_times, default=0),
        "peak_rss_bytes": engine.peak_rss_bytes(),
        "asym_msgs": {k: sim.net.asym_hits[k]
                      for k in sorted(sim.net.asym_hits)},
        # per-op blocks (traffic/spam/soak collectors installed by the
        # ops program; absent keys mean the op was not armed)
        **{k: v for fn in expect["collectors"]
           for k, v in fn(sim).items()},
    }


def verdict_bytes(verdict: dict) -> bytes:
    """The canonical byte form two same-seed runs must match exactly.

    `peak_rss_bytes` is excluded: it is a measurement of THIS process
    (allocator layout, import order, prior cells in the same run), not
    of the simulated world, so it legitimately differs between two
    byte-identical simulations."""
    return json.dumps({k: v for k, v in verdict.items()
                       if k != "peak_rss_bytes"},
                      sort_keys=True).encode()


# ---------------------------------------------------------------------------
# the library + runner
# ---------------------------------------------------------------------------

#: name -> (description, spec-builder(scheme, seed, **overrides) -> dict)
SCENARIOS: dict[str, tuple[str, object]] = {}


def _scenario(name: str, desc: str):
    def register(builder):
        SCENARIOS[name] = (desc, builder)
        return builder

    return register


def _base(name: str, scheme: str, seed: int, **over) -> dict:
    doc = {"name": name, "scheme": scheme, "seed": seed,
           "validators": 8, "light_nodes": 64, "heights": 5,
           "samples_per_header": 2}
    doc.update(over)
    return doc


@_scenario("honest", "fault-free chain: the false-condemnation and "
                     "cross-seed consensus-invariance control")
def _honest(scheme: str, seed: int, **over) -> dict:
    return _base("honest", scheme, seed, **over)


@_scenario("withhold-threshold",
           "every validator withholds one height past the scheme's "
           "recoverability threshold at its commit")
def _withhold(scheme: str, seed: int, **over) -> dict:
    doc = _base("withhold-threshold", scheme, seed, **over)
    fault_h = max(2, doc["heights"] - 1)
    doc["ops"] = [{"op": "withhold_threshold", "height": fault_h}]
    return doc


@_scenario("incorrect-coding",
           ">2/3 certify a committed non-codeword; the fleet escalates "
           "to a verified fraud proof and condemns the root")
def _incorrect(scheme: str, seed: int, **over) -> dict:
    doc = _base("incorrect-coding", scheme, seed, **over)
    doc.setdefault("duration", 0.0)
    doc["ops"] = [{"op": "incorrect_coding", "k": 4}]
    return doc


@_scenario("partition-churn",
           "a >1/3 minority is cut off mid-run and healed: the majority "
           "keeps committing, the minority catches up")
def _partition(scheme: str, seed: int, **over) -> dict:
    doc = _base("partition-churn", scheme, seed, **over)
    n = doc["validators"]
    minority = list(range(n - max(1, n // 4), n))
    majority = [i for i in range(n) if i not in minority]
    doc["ops"] = [
        {"op": "partition", "t": 2.2,
         "groups": [majority, minority]},
        {"op": "heal", "t": 6.2},
    ]
    return doc


@_scenario("lazy-validator",
           "one validator never proposes: its slots time out, rotate, "
           "and the chain stays live")
def _lazy(scheme: str, seed: int, **over) -> dict:
    doc = _base("lazy-validator", scheme, seed, **over)
    doc["ops"] = [{"op": "lazy", "validator": 1}]
    return doc


@_scenario("spam-flood",
           "sustained junk + oversized tx floods against every "
           "validator's admission path while real load commits")
def _spam(scheme: str, seed: int, **over) -> dict:
    doc = _base("spam-flood", scheme, seed, **over)
    doc.setdefault("txs_per_height", 1)
    doc["ops"] = [{"op": "spam", "t": 0.5, "every": 0.7, "count": 12,
                   "until": 6.0}]
    return doc


@_scenario("eclipse",
           "a slice of the light fleet sees only one captor validator, "
           "which withholds a height from them alone")
def _eclipse(scheme: str, seed: int, **over) -> dict:
    doc = _base("eclipse", scheme, seed, **over)
    fault_h = max(2, doc["heights"] - 1)
    doc["ops"] = [{"op": "eclipse", "t": 0.2,
                   "lights": list(range(doc["light_nodes"] // 2)),
                   "validator": 0, "height": fault_h}]
    return doc


@_scenario("crash-storm",
           "seeded validator crashes at post-commit instants across a "
           "height window, each reviving and catching up")
def _crash(scheme: str, seed: int, **over) -> dict:
    doc = _base("crash-storm", scheme, seed, **over)
    n = doc["validators"]
    doc["ops"] = [{"op": "crash_storm",
                   "heights": [2, 3],
                   "validators": list(range(n // 2, n)),
                   "down_s": 2.5}]
    return doc


@_scenario("flaky-network",
           "seeded probabilistic drops on the light fleet's transport "
           "(the net.request fault point): rotation + retries absorb "
           "them, sampling verdicts stay clean")
def _flaky(scheme: str, seed: int, **over) -> dict:
    doc = _base("flaky-network", scheme, seed, **over)
    doc["faults"] = [{"point": "net.request", "action": "drop",
                      "prob": 0.25, "match": {"owner": "^light"}}]
    return doc


@_scenario("statesync-join",
           "a validator dark since genesis snapshot-joins mid-run under "
           "load and catches up to the head")
def _join(scheme: str, seed: int, **over) -> dict:
    doc = _base("statesync-join", scheme, seed, **over)
    idx = doc["validators"] - 1
    doc["ops"] = [
        {"op": "down", "t": 0.0, "validator": idx},
        {"op": "statesync_join", "t": 4.2, "validator": idx},
    ]
    return doc


@_scenario("long-soak",
           "long-horizon resource churn: every bounded resource (EDS/"
           "sig/commitment LRUs, mempool TTL, snapshot keep-N, pack "
           "prune) cycles >=2x under seeded PFB traffic and asymmetric "
           "per-message faults, with graceful-degradation verdicts")
def _long_soak(scheme: str, seed: int, **over) -> dict:
    doc = _base("long-soak", scheme, seed,
                validators=4, light_nodes=24, heights=30,
                samples_per_header=2, txs_per_height=1,
                sweep_interval=2.0, trace_keep=50_000)
    doc.update(over)
    doc.setdefault("ops", [
        {"op": "traffic", "t": 0.8, "every": 0.9, "sequences": 2,
         "pfbs_per_wave": 1},
        {"op": "asym_fault", "kind": "corrupt", "src": "light",
         "prob": 0.15},
        {"op": "asym_fault", "kind": "delay", "src": "light",
         "prob": 0.1, "delay": 0.05},
        {"op": "soak", "eds_entries": 2, "sig_cache": 24,
         "commitment_cache": 12, "ttl_blocks": 3, "expire_every": 1.0,
         "snapshot_every": 4, "snapshot_keep": 2,
         "pack_every": 3, "pack_keep": 2, "stale_every": 0.8},
    ])
    return doc


@_scenario("fleet-scale",
           "the network-scale determinism cell: 1000+ continuation-"
           "driven DASer lights over 1000+ virtual blocks in one "
           "process, byte-identical verdicts per seed")
def _fleet_scale(scheme: str, seed: int, **over) -> dict:
    doc = _base("fleet-scale", scheme, seed,
                validators=4, light_nodes=1000, heights=1000,
                samples_per_header=1, txs_per_height=0,
                sweep_interval=5.0, light_job_size=64,
                max_events=6_000_000, trace_keep=100_000)
    doc.update(over)
    return doc


def scenario_spec(name: str, scheme: str = "rs2d-nmt", seed: int = 0,
                  **over) -> dict:
    """The library's named spec, as a plain dict (edit freely)."""
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; one of {sorted(SCENARIOS)}")
    _desc, builder = SCENARIOS[name]
    return builder(scheme, seed, **over)


def run_scenario(doc: dict, workdir: str | None = None,
                 ccfg: SimConsensusConfig | None = None,
                 device=None) -> dict:
    """Build, run, and reduce one scenario spec to its verdict dict, the
    world computing on `device` (the card unless the caller asks for the
    CPU; a kernel wrapper's error propagates, sim/engine.py).
    ``faults`` specs are armed on the process fault registry (reseeded
    to the scenario seed so probabilistic triggers replay exactly) for
    the run's duration and disarmed after — the scenario grammar's
    third leg beside malicious entries and topology ops."""
    from celestia_app_tpu_torch import faults as faults_mod

    spec = SimSpec.from_dict(doc)
    if ccfg is None and "consensus" in doc:
        ccfg = SimConsensusConfig(**doc["consensus"])
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix=f"sim-{spec.name}-")
    sim = Simulation(spec, workdir, ccfg=ccfg, device=device)
    expect = _install_ops(sim)
    armed: list[int] = []
    if spec.faults:
        faults_mod.REGISTRY.reseed(spec.seed)
        armed = faults_mod.arm_from_spec([dict(f) for f in spec.faults])
    try:
        sim.run()
    finally:
        for fid in armed:
            faults_mod.disarm(fault_id=fid)
    return verdict_of(sim, expect)
