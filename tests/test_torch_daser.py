"""The port's sampling light node (das/daser.py, das/checkpoint.py) against
the JAX package's, run as a mixed pair (tolerance: exact).

The reference's tests/test_das.py and tests/test_codec_devnet.py cases run
twice: a port DASer samples a reference NodeService, and a reference DASer
samples a port NodeService, each over real HTTP on its own 3-validator
chain (the two chains are built from one seed and are equal byte for
byte). The reports, the checkpoint files, the summaries, the BEFP members
and the condemned roots of the two runs must be equal:

- a fleet follows every height, a restart resumes from its checkpoint and
  samples nothing, a certified non-codeword k = 4 square escalates to a
  verified BEFP that halts the hunter, and a reborn DASer stays halted;
- a withheld but repairable height recovers;
- a BEFP assembled from served orthogonal proofs verifies (and one of an
  honest square does not) in both packages;
- under the CMT and PCMT schemes, the codec escalation condemns a
  mis-coded height and recovers a withheld honest one;
- checkpoints written by either package load in the other;
- a sample round trip joins the block's trace (tests/test_obs.py), and
  a repair's spans land in the light node's own trace tables.

The port runs on ``device="cpu"`` (the reference on its host engine).
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import pytest

from test_torch_app import Pkg
from test_torch_consensus import genesis

CHAIN = "torch-daser-test"
T0 = 1_700_000_000.0
N_VALIDATORS = 3
NS_USER = b"\x61\x01" * 4  # the follower's namespace (two blobs of each PFB)
NS_OTHER = b"\x62\x02" * 4  # the third blob of each PFB
PAIRS = (("port", "ref"), ("ref", "port"))  # (client package, server package)


def engine_kw(p) -> dict:
    return {"engine": "host"} if p.which == "ref" else {"device": "cpu"}


class Chain:
    """A disk-backed `LocalNetwork` of one package: N_VALIDATORS validators
    from fixed seeds, `blocks` heights each with a send and (with `pfbs`) a
    PFB of two blobs in NS_USER and one in NS_OTHER. Validator 0 keeps the
    proof and blob packs of its last four heights."""

    def __init__(self, which: str, root: str, blocks: int = 3, scheme: str | None = None,
                 pfbs: bool = True):
        p = self.p = Pkg(which)
        self.cons = p.mod("chain.consensus")
        self.privs = [p.PrivateKey.from_seed(bytes([i + 1])) for i in range(N_VALIDATORS)]
        kw = engine_kw(p)
        if scheme is not None:
            kw["da_scheme"] = scheme
        gen = genesis(self.privs)
        self.nodes = [self.cons.ValidatorNode(f"val{i}", self.privs[i], gen, CHAIN,
                                              data_dir=os.path.join(root, which, f"val{i}"),
                                              pack_keep=4 if i == 0 else None, **kw)
                      for i in range(N_VALIDATORS)]
        self.net = self.cons.LocalNetwork(self.nodes)
        self.signer = p.Signer(CHAIN)
        for i, k in enumerate(self.privs):
            self.signer.add_account(k, number=i)
        self.rng = np.random.default_rng(5)
        self.t = T0
        self.blobs_by_height: dict[int, list[bytes]] = {}
        for _ in range(blocks):
            self.grow(pfbs)

    def addr(self, i: int) -> bytes:
        return self.privs[i].public_key().address()

    def blobs(self) -> list:
        return [self.p.Blob(self.p.Namespace.v0(ns),
                            self.rng.integers(0, 256, int(self.rng.integers(300, 1500)), dtype=np.uint8).tobytes())
                for ns in (NS_USER, NS_USER, NS_OTHER)]

    def grow(self, pfbs: bool = True) -> None:
        a0, a1 = self.addr(0), self.addr(1)
        raws = [self.signer.create_tx(a0, [self.p.tx.MsgSend(a0, a1, 100)], fee=2000, gas_limit=100_000).encode()]
        self.signer.accounts[a0].sequence += 1
        blobs = self.blobs() if pfbs else []
        if blobs:
            raws.append(self.signer.create_pay_for_blobs(a0, blobs, fee=200_000, gas_limit=1_200_000))
            self.signer.accounts[a0].sequence += 1
        for raw in raws:
            assert self.net.broadcast_tx(raw)
        self.t += 10.0
        blk, cert = self.net.produce_height(t=self.t)
        assert blk is not None and cert is not None
        self.blobs_by_height[blk.header.height] = [b.data for b in blobs if b.namespace.raw[-8:] == NS_USER]
        for n in self.nodes:
            assert n.app.da_warmer.wait_idle(60)

    def trust(self, client):
        """A genesis trusted state of `client`'s light module."""
        light = client.mod("chain.light")
        return light.TrustedState(
            height=0, header_hash=b"",
            validators={n.address: n.priv.public_key().compressed for n in self.nodes},
            powers={n.address: 10 for n in self.nodes})

    def light(self, client):
        light = client.mod("chain.light")
        return light.LightClient(CHAIN, self.trust(client))

    def close(self) -> None:
        for n in self.nodes:
            n.app.da_warmer.wait_idle(60)
            n.app.close()


_CHAINS: dict = {}


def shared_chain(which: str, blocks: int = 3, scheme: str | None = None, pfbs: bool = True) -> Chain:
    """One Chain per (package, shape) and process: on the CPU a port height
    costs seconds of plain SHA-256 in every validator's warmer, so the
    tests of these files read one chain and never grow it (each opens its
    own NodeService, so a withholding or a seeded square stays with its
    test). Closed when the process exits."""
    key = (which, blocks, scheme, pfbs)
    if key not in _CHAINS:
        if not _CHAINS:
            atexit.register(_close_chains)
        root = tempfile.mkdtemp(prefix="torch-light-chain-")
        _CHAINS[key] = (Chain(which, root, blocks, scheme, pfbs), root)
    return _CHAINS[key][0]


def _close_chains() -> None:
    for chain, root in _CHAINS.values():
        chain.close()
        shutil.rmtree(root, ignore_errors=True)


class Served:
    """A shared chain with a fresh NodeService on its validator 0."""

    def __init__(self, chain: Chain):
        self.chain, self.p, self.nodes = chain, chain.p, chain.nodes
        self.svc = chain.p.mod("service.server").NodeService(chain.nodes[0], port=0)
        self.svc.serve_background()
        self.url = f"http://127.0.0.1:{self.svc.port}"

    def light(self, client):
        return self.chain.light(client)


@pytest.fixture
def chains():
    """`chains(which, **shape)`: a NodeService of package `which` on the
    shared chain of that shape, shut down after the test."""
    made = []

    def make(which, **kw):
        made.append(Served(shared_chain(which, **kw)))
        return made[-1]

    yield make
    for s in made:
        s.svc.shutdown()


def daser(client, peers, light, store, **kw):
    """A DASer of package `client` (the port's on the CPU)."""
    if client.which == "port":
        kw["device"] = "cpu"
    return client.mod("das.daser").DASer(peers, light, store, **kw)


def store(client, path):
    return client.mod("das.checkpoint").CheckpointStore(str(path))


def canon(obj):
    """JSON-comparable form (tuples become lists)."""
    return json.loads(json.dumps(obj, sort_keys=True, default=lambda b: b.hex()))


def seed_hitting(width: int, withheld: set, s: int) -> int:
    """tests/test_das.py's `_seed_hitting`: a sampler seed whose first s
    draws (one pending height on one worker) hit a withheld cell."""
    for seed in range(500):
        rng = np.random.default_rng(seed).spawn(1)[0]
        coords = {(int(rng.integers(0, width)), int(rng.integers(0, width))) for _ in range(s)}
        if coords & withheld:
            return seed
    raise AssertionError("no hitting seed in range")


def seed_hitting_codec(n_base: int, withheld: set, s: int) -> int:
    """tests/test_codec_devnet.py's `_seed_hitting_cmt`."""
    for seed in range(500):
        rng = np.random.default_rng(seed).spawn(1)[0]
        if {(0, int(rng.integers(0, n_base))) for _ in range(s)} & withheld:
            return seed
    raise AssertionError("no hitting seed in range")


def honest_square(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, size=(k, k, 512), dtype=np.uint8)
    ods[..., :29] = 0
    ods[..., 28] = 9  # one sorted user namespace
    return ods


def extended(ods: np.ndarray) -> np.ndarray:
    from celestia_app_tpu_torch.ops import rs

    return rs.extend_square_np(ods)


def blind_dah(p, eds_arr: np.ndarray):
    """Package `p`'s DAH over axis roots of a given (possibly corrupt)
    square: what a malicious producer commits."""
    from test_torch_repair import blind_dah as port_blind_dah

    d = port_blind_dah(eds_arr)
    return p.mod("da.dah").DataAvailabilityHeader(row_roots=d.row_roots, col_roots=d.col_roots)


def forged_height(c: Served, client, height: int, data_root: bytes, k: int, scheme_id=None):
    """(header, cert) of package `client`: a header at `height` committing
    `data_root`, precommitted by every validator of `c` in round 0."""
    block, cons = client.mod("chain.block"), client.mod("chain.consensus")
    app = c.nodes[0].app
    extra = {} if scheme_id is None else {"da_scheme": scheme_id}
    header = block.Header(
        chain_id=CHAIN, height=height, time_unix=1_700_000_999.0, data_hash=data_root, square_size=k,
        app_hash=b"\x77" * 32, proposer=c.nodes[0].address, app_version=app.app_version,
        last_block_hash=app.last_block_hash,
        validators_hash=block.validators_hash_of([(n.address, 10) for n in c.nodes]), **extra)
    privs = [client.PrivateKey.from_seed(bytes([i + 1])) for i in range(N_VALIDATORS)]
    votes = tuple(cons.Vote(height, header.hash(), k.public_key().address(),
                            k.sign(cons.Vote.sign_bytes(CHAIN, height, header.hash(), "precommit", 0)),
                            "precommit", 0) for k in privs)
    return header, cons.CommitCertificate(height, header.hash(), votes, 0)


def with_forged(client, peers, height: int, forged):
    """A header source serving the chain's certified headers, and `forged`
    at `height` (header gossip beside the chain's own)."""
    base = client.mod("das.daser").http_header_source(peers)
    return lambda h: forged if h == height else base(h)


def befp_members(befp) -> list:
    return canon([[befp.axis, befp.index]] + [[s.position, s.share, s.proof.start, s.proof.end, s.proof.total,
                                              list(s.proof.nodes)] for s in befp.shares])


# ---------------------------------------------------------------------------
# rs2d: tests/test_das.py
# ---------------------------------------------------------------------------


def fleet_run(client, c: Served, tmp) -> dict:
    """test_daser_fleet_e2e_fraud_and_checkpointed_restart, observed."""
    daser_mod = client.mod("das.daser")
    cfg = daser_mod.DASerConfig(samples_per_header=8, workers=2, job_size=2, retries=2, backoff=0.01)
    stores = [store(client, tmp / f"daser{i}" / "cp.json") for i in range(2)]
    fleet = [daser(client, [c.url], c.light(client), stores[i], cfg=cfg, rng=np.random.default_rng(1000 + i),
                   name=f"daser{i}") for i in range(2)]
    seen: dict = {"sweeps": [d.sync() for d in fleet], "reports": [dict(d.reports) for d in fleet]}
    sampling = client.mod("da.sampling")
    for d in fleet:
        for h in (1, 2, 3):
            assert d.reports[h]["status"] == "sampled"
            assert d.reports[h]["confidence"] == sampling.withholding_catch_confidence(8)
    seen["checkpoints"] = [json.load(open(s.path)) for s in stores]

    served = c.svc.das_core.availability(2)["samples_served"]
    restarted = daser(client, [c.url], c.light(client), stores[0], cfg=cfg, name="daser0-restarted")
    assert restarted.cp.sample_from == 4
    seen["restart"] = restarted.sync()
    assert seen["restart"]["sampled"] == [] and c.svc.das_core.availability(2)["samples_served"] == served

    # the byzantine height: >2/3 certify a non-codeword k = 4 square
    k, bad_row = 4, 2
    eds_arr = extended(honest_square(k, seed=5))
    eds_arr[bad_row, 5] ^= 0x5A
    server = c.p
    bdah = blind_dah(server, eds_arr)
    bad_h = c.nodes[0].app.height + 1
    c.svc.das_core.seed_entry(bad_h, server.mod("da.dah").ExtendedDataSquare(eds_arr), bdah)
    withheld = {(bad_row, j) for j in range(k)}
    c.svc.das_core.withhold(bad_h, withheld)
    peers = daser_mod.PeerSet([c.url], timeout=5.0, retries=2, backoff=0.01)
    hunter = daser(client, peers, c.light(client), stores[0], cfg=cfg,
                   header_source=with_forged(client, peers, bad_h, forged_height(c, client, bad_h, bdah.hash(), k)),
                   rng=np.random.default_rng(seed_hitting(2 * k, withheld, 8)), name="daser-hunter")
    built = []
    orig = hunter._build_befp

    def keep(*a):
        built.append(orig(*a))
        return built[-1]

    hunter._build_befp = keep
    out = hunter.sync()
    assert out["halted"] == {"height": bad_h, "reason": "bad-encoding", "data_root": bdah.hash().hex()}
    rep = hunter.reports[bad_h]
    assert rep["status"] == "fraud" and (rep["axis"], rep["index"]) == ("row", bad_row)
    assert hunter.light.condemned_roots == {bdah.hash()}
    seen.update(hunt=out, hunt_reports=dict(hunter.reports), befp=befp_members(built[0]),
                condemned=sorted(hunter.light.condemned_roots), halted_checkpoint=json.load(open(stores[0].path)))
    reborn = daser(client, [c.url], c.light(client), stores[0], cfg=cfg, name="daser-post-halt")
    assert reborn.halted and reborn.sync() == {"halted": out["halted"]}
    assert not fleet[1].halted
    return canon(seen)


def recover_run(client, c: Served, tmp) -> dict:
    """test_daser_recovers_withheld_but_repairable_block, observed."""
    daser_mod = client.mod("das.daser")
    width = c.svc.das_core.header(1)["square_width"]
    withheld = {(0, 0)}
    c.svc.das_core.withhold(1, withheld)
    cfg = daser_mod.DASerConfig(samples_per_header=4, workers=1, retries=2, backoff=0.01)
    cp = store(client, tmp / "d" / "cp.json")
    d = daser(client, [c.url], c.light(client), cp, cfg=cfg,
              rng=np.random.default_rng(seed_hitting(width, withheld, 4)))
    out = d.sync()
    assert out["halted"] is None and out["sample_from"] == 4
    assert d.reports[1]["status"] == "recovered"
    assert [d.reports[h]["status"] for h in (2, 3)] == ["sampled", "sampled"]
    # the repair's spans land in the light node's own trace tables
    names = {r["name"] for r in d.traces.read("spans", limit=10_000)}
    assert {"da.repair.sweep", "da.repair.verify_roots", "das.sample_height"} <= names
    return canon({"out": out, "reports": d.reports, "checkpoint": json.load(open(cp.path))})


def test_fleet_restart_and_fraud_match_across_packages(chains, tmp_path):
    """Port DASer against a reference NodeService, reference DASer against
    a port NodeService: the two runs observe the same bytes."""
    runs = [fleet_run(Pkg(client), chains(server), tmp_path / client) for client, server in PAIRS]
    assert runs[0] == runs[1]


def test_recovery_matches_across_packages(chains, tmp_path):
    runs = [recover_run(Pkg(client), chains(server), tmp_path / client) for client, server in PAIRS]
    assert runs[0] == runs[1]


def test_sample_round_trip_joins_the_block_trace(chains, tmp_path):
    """tests/test_obs.py's DAS round trip, both ways: the serving node's
    das.serve_sample spans (pulled over /trace/spans) are parented to the
    light node's das.fetch_cells spans through the X-Celestia-Trace
    header, under the height's deterministic trace id."""
    import urllib.request

    seen = []
    for client, server in PAIRS:
        cp = Pkg(client)
        c = chains(server)
        cfg = cp.mod("das.daser").DASerConfig(samples_per_header=4, workers=1, job_size=1, prefer_packs=False,
                                              retries=2, backoff=0.01)
        d = daser(cp, [c.url], c.light(cp), store(cp, tmp_path / client / "cp.json"), cfg=cfg,
                  rng=np.random.default_rng(3), name="light0")
        assert d.sync()["sampled"] == [1, 2, 3]
        tid = cp.mod("obs").trace_id_for(CHAIN, 1)
        light_rows = [r for r in d.traces.read("spans", limit=10_000) if r["trace_id"] == tid]
        with urllib.request.urlopen(f"{c.url}/trace/spans?since=0&limit=10000", timeout=10) as r:
            served = [row for row in json.loads(r.read())["rows"] if row["trace_id"] == tid]
        fetch_ids = {r["span_id"] for r in light_rows if r["name"] == "das.fetch_cells"}
        parents = {r["parent_id"] for r in served if r["name"] == "das.serve_sample"}
        assert fetch_ids and parents & fetch_ids, (fetch_ids, parents)
        seen.append((sorted({r["name"] for r in light_rows}), "prepare_proposal" in {r["name"] for r in served}
                     or any(r["name"] == "prepare_proposal" for n in c.nodes for r in n.app.traces.read("spans"))))
    assert seen[0] == seen[1]


def test_befp_from_served_orthogonal_proofs_matches(chains, tmp_path):
    """test_befp_from_served_orthogonal_proofs_is_independent, both ways:
    each package's DASer assembles the BEFP from the other package's
    served column proofs; the members are equal, and both packages'
    verify_befp accept it (and refuse the honest square's)."""
    from test_torch_fraud import to_port, to_reference

    k = 4
    bad = extended(honest_square(k, seed=9))
    bad[1, 6] ^= 0xFF
    good = extended(honest_square(k, seed=10))
    out = {}
    for client, server in PAIRS:
        cp, sp = Pkg(client), Pkg(server)
        c = chains(server)
        dah_s = sp.mod("da.dah")
        for h, arr in ((50, bad), (51, good)):
            c.svc.das_core.seed_entry(h, dah_s.ExtendedDataSquare(arr), blind_dah(sp, arr))
        d = daser(cp, [c.url], c.light(cp), store(cp, tmp_path / client / "cp.json"))
        for h, arr in ((50, bad), (51, good)):
            cdah = blind_dah(cp, arr)
            befp = d._build_befp(h, cdah, "row", 1)
            assert befp is not None and len(befp.shares) == k
            port_befp = befp if client == "port" else to_port(befp)
            ref_befp = to_reference(befp) if client == "port" else befp
            verdicts = (Pkg("port").mod("da.fraud").verify_befp(blind_dah(Pkg("port"), arr), port_befp, device="cpu"),
                        Pkg("ref").mod("da.fraud").verify_befp(blind_dah(Pkg("ref"), arr), ref_befp))
            assert verdicts == ((h == 50),) * 2
            out.setdefault(h, []).append(befp_members(befp))
    assert out[50][0] == out[50][1] and out[51][0] == out[51][1]


def test_checkpoints_round_trip_across_packages(tmp_path):
    """tests/test_das.py's atomic round trip, each package's store writing
    and the other's loading: the same documents and the same Checkpoint."""
    port, ref = Pkg("port"), Pkg("ref")
    for writer, reader in ((port, ref), (ref, port)):
        path = tmp_path / writer.which / "das" / "checkpoint.json"
        w = store(writer, path)
        cp = w.load()
        assert (cp.sample_from, cp.network_head, cp.failed, cp.halted) == (1, 0, {}, None)
        cp.sample_from, cp.network_head = 7, 12
        cp.failed[9] = 2
        w.save(cp)
        assert not os.path.exists(w.path + ".tmp")
        got = store(reader, path).load()
        assert dataclasses.astuple(got) == dataclasses.astuple(cp)
        got.halted = {"height": 12, "reason": "bad-encoding", "data_root": "ab"}
        store(reader, path).save(got)
        assert w.load().halted == got.halted
        assert json.load(open(path)) == got.to_json() == writer.mod("das.checkpoint").Checkpoint(
            **dataclasses.asdict(got)).to_json()


def test_daser_needs_a_device_or_a_card(monkeypatch, tmp_path):
    """The port's DASer runs its escalations on the card unless the caller
    asks for the CPU; with no card and no ``device``, it raises."""
    import torch

    from celestia_app_tpu_torch.chain import light
    from celestia_app_tpu_torch.das import checkpoint, daser as daser_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lc = light.LightClient(CHAIN, light.TrustedState(0, b"", {}, {}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        daser_mod.DASer(["http://127.0.0.1:1"], lc, checkpoint.CheckpointStore(str(tmp_path / "cp.json")))
    d = daser_mod.DASer(["http://127.0.0.1:1"], lc, checkpoint.CheckpointStore(str(tmp_path / "cp.json")),
                        device="cpu")
    assert d.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the codec schemes: tests/test_codec_devnet.py
# ---------------------------------------------------------------------------


def codec_fraud_run(client, c: Served, tmp, scheme: str) -> dict:
    daser_mod, server = client.mod("das.daser"), c.p
    dacodec = client.mod("da.codec")
    codec = dacodec.get(scheme)
    cfg = daser_mod.DASerConfig(samples_per_header=8, workers=2, job_size=2, retries=2, backoff=0.01)
    cp = store(client, tmp / "daser" / "cp.json")
    d = daser(client, [c.url], c.light(client), cp, cfg=cfg, rng=np.random.default_rng(42), name="codec-d0")
    out = d.sync()
    assert out["halted"] is None and out["head"] == 2 and out["sampled"] == [1, 2]
    for h in (1, 2):
        assert d.reports[h]["status"] == "sampled" and d.reports[h]["scheme"] == scheme
        assert d.reports[h]["confidence"] == codec.confidence(8)
    seen = {"sweep": out, "reports": dict(d.reports)}

    k = 4
    ods = np.random.RandomState(5).randint(0, 256, size=(k, k, 512), dtype=np.uint8)
    malicious = server.mod("testing.malicious")
    scheme_kw = {} if server.which == "ref" else {"device": "cpu"}
    if scheme == "cmt-ldpc":
        entry = malicious.cmt_bad_parity_entry(ods, equation=3, **scheme_kw)
        location = [0, 3]
        members = set(server.mod("da.cmt").equation_members(entry.commitments, 0, 3))
    else:
        entry = malicious.pcmt_bad_parity_entry(ods, **scheme_kw)
        location = list(entry.fraud_location)
        members = set(server.mod("da.pcmt").equation_members(entry.commitments, *entry.fraud_location))
    comm = entry.commitments
    bad_h = c.nodes[0].app.height + 1
    c.svc.das_core.seed_scheme_entry(bad_h, entry)
    candidates = [i for i in range(comm.n_base) if i not in members]
    withheld = {(0, i) for i in candidates[: comm.n_base // 4]}
    c.svc.das_core.withhold(bad_h, withheld)
    peers = daser_mod.PeerSet([c.url], timeout=5.0, retries=2, backoff=0.01)
    scheme_id = dacodec.get(scheme).scheme_id
    hunter = daser(client, peers, c.light(client), cp, cfg=cfg,
                   header_source=with_forged(client, peers, bad_h,
                                             forged_height(c, client, bad_h, entry.data_root, k, scheme_id)),
                   rng=np.random.default_rng(seed_hitting_codec(comm.n_base, withheld, 8)), name="codec-hunter")
    out = hunter.sync()
    assert out["halted"] == {"height": bad_h, "reason": "bad-encoding", "data_root": entry.data_root.hex()}
    assert hunter.reports[bad_h]["status"] == "fraud" and hunter.reports[bad_h]["location"] == location
    assert hunter.light.condemned_roots == {entry.data_root}
    reborn = daser(client, [c.url], c.light(client), cp, cfg=cfg, name="codec-post-halt")
    assert reborn.halted and reborn.sync() == {"halted": out["halted"]}
    seen.update(hunt=out, hunt_reports=dict(hunter.reports), condemned=sorted(hunter.light.condemned_roots),
                checkpoint=json.load(open(cp.path)))
    return canon(seen)


@pytest.mark.parametrize("scheme", ["cmt-ldpc", "pcmt-polar"])
def test_codec_fraud_matches_across_packages(chains, tmp_path, scheme):
    runs = [codec_fraud_run(Pkg(client), chains(server, blocks=2, scheme=scheme, pfbs=False),
                            tmp_path / client, scheme) for client, server in PAIRS]
    assert runs[0] == runs[1]


def test_codec_withheld_honest_block_recovers_across_packages(chains, tmp_path):
    runs = []
    for client, server in PAIRS:
        cp = Pkg(client)
        c = chains(server, blocks=2, scheme="cmt-ldpc", pfbs=False)
        doc = c.svc.das_core.header(1)
        blk = c.nodes[0].app.db.load_block(1)
        comm = cp.mod("da.codec").get("cmt-ldpc").commitments_from_doc(doc, blk.header.data_hash.hex(),
                                                                        blk.header.square_size)
        withheld = {(0, 0)}
        c.svc.das_core.withhold(1, withheld)
        cfg = cp.mod("das.daser").DASerConfig(samples_per_header=8, workers=1, job_size=2, retries=2, backoff=0.01)
        d = daser(cp, [c.url], c.light(cp), store(cp, tmp_path / client / "cp.json"), cfg=cfg,
                  rng=np.random.default_rng(seed_hitting_codec(comm.n_base, withheld, 8)), name="cmt-recover")
        out = d.sync()
        assert out["halted"] is None and d.reports[1]["status"] == "recovered"
        runs.append(canon({"out": out, "reports": d.reports}))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("scheme", ["rs2d-nmt", "cmt-ldpc"])
def test_a_kernel_error_in_the_escalation_propagates(chains, tmp_path, monkeypatch, scheme):
    """A K1 or K2 wrapper error inside the escalation's repair is no
    verdict on the block: it raises out of ``sync()`` and the height is
    not counted ``"unavailable"``. The wrapper's error is a ValueError
    (a bad operand or a misshapen batch), as an unsolvable repair's is."""
    from celestia_app_tpu_torch import cuda_build
    from celestia_app_tpu_torch.ops import rs_kernel, sha256_kernel
    from celestia_app_tpu_torch.utils import telemetry

    cp = Pkg("port")
    kw = {} if scheme == "rs2d-nmt" else {"blocks": 2, "scheme": scheme, "pfbs": False}
    c = chains("ref", **kw)
    withheld = {(0, 0)}
    c.svc.das_core.withhold(1, withheld)
    if scheme == "rs2d-nmt":
        cfg = cp.mod("das.daser").DASerConfig(samples_per_header=4, workers=1, retries=2, backoff=0.01)
        seed = seed_hitting(c.svc.das_core.header(1)["square_width"], withheld, 4)
        orig = rs_kernel.extend_lines
        monkeypatch.setattr(rs_kernel, "extend_lines", lambda groups, operand: orig(groups, operand[:-1]))
    else:
        doc = c.svc.das_core.header(1)
        blk = c.nodes[0].app.db.load_block(1)
        comm = cp.mod("da.codec").get(scheme).commitments_from_doc(doc, blk.header.data_hash.hex(),
                                                                  blk.header.square_size)
        cfg = cp.mod("das.daser").DASerConfig(samples_per_header=8, workers=1, job_size=2, retries=2, backoff=0.01)
        seed = seed_hitting_codec(comm.n_base, withheld, 8)
        orig = sha256_kernel.compress_words
        monkeypatch.setattr(sha256_kernel, "compress_words", lambda blocks: orig(blocks[:, :15]))
    d = daser(cp, [c.url], c.light(cp), store(cp, tmp_path / "cp.json"), cfg=cfg,
              rng=np.random.default_rng(seed), name="kernel-error")
    before = telemetry.snapshot()["counters"]
    with pytest.raises(ValueError) as got:
        d.sync()
    assert isinstance(got.value, cuda_build.KernelError)
    after = telemetry.snapshot()["counters"]
    assert after.get("daser.escalations", 0) == before.get("daser.escalations", 0) + 1
    assert after.get("daser.unavailable", 0) == before.get("daser.unavailable", 0)
    assert 1 not in d.reports and not d.halted
