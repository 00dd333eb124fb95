"""The port's ValidatorService and SocketNetwork against the JAX package's.

- One reference and one port service, each over a validator with the same
  key and genesis, are driven through the orchestrated routes
  (/broadcast_tx, /consensus/propose, /prevote, /precommit, /commit) with
  the same requests: every answer is the same JSON (RFC 6979 signatures
  are deterministic). At the same height every GET route (consensus,
  sync, gossip, DAS, blob, faults, the legacy snapshot, unknown paths)
  answers the same status and body; /consensus/status is equal on its
  chain fields and by keys on its process-wide blocks, and /metrics and
  /trace are compared by keys, not by values.
- A forged /consensus/commit is refused, and /consensus/precommit refuses
  a polka pooled from a stale round.
- A port SocketNetwork drives four reference services, and a reference
  SocketNetwork four port services, to the same chain.
- /faults arm, inspect and disarm answer alike over HTTP.

Everything runs on ``device="cpu"`` (the reference on its host engine).
"""

from __future__ import annotations

import base64
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_sync import CHAIN, T0, genesis_for, pkg, settle, validator_node
from test_torch_transport import rebased

PACKAGES = ("ref", "port")


def call(url: str, path: str, doc=None, timeout: float = 30.0):
    """(status, content type, body bytes) of one GET (doc None) or POST."""
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url + path, data=data, method="GET" if doc is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers.get("Content-Type"), e.read()


def keys_of(doc):
    """The key structure of a JSON document, without its values."""
    if isinstance(doc, dict):
        return {k: keys_of(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [keys_of(v) for v in doc[:1]]
    return type(doc).__name__


class Pair:
    """One service per package over validators with the same key."""

    def __init__(self, tmp):
        self.pkgs = {w: pkg(w) for w in PACKAGES}
        for p in self.pkgs.values():  # /faults reports what earlier tests in this process fired
            p.faults.reset()
        self.genesis = genesis_for([self.pkgs["port"].PrivateKey.from_seed(b"svc-val")])
        self.nodes, self.svcs, self.urls = {}, {}, {}
        for w, p in self.pkgs.items():
            v = validator_node(p, "svc", b"svc-val", self.genesis, os.path.join(str(tmp), w, "data"))
            svc = p.service.ValidatorService(v)
            svc.reactor = p.reactor.ConsensusReactor(v, [], svc.lock, p.reactor.ReactorConfig())
            svc.serve_background()
            self.nodes[w], self.svcs[w], self.urls[w] = v, svc, f"http://127.0.0.1:{svc.port}"

    def both(self, path: str, doc=None) -> dict:
        return {w: call(self.urls[w], path, doc) for w in PACKAGES}

    def stop(self):
        for svc in self.svcs.values():
            svc.shutdown()
        settle(self.nodes.values())


@pytest.fixture
def pair(tmp_path):
    made = Pair(tmp_path)
    yield made
    made.stop()


def traffic(p, seed: int, n_blobs: int = 2) -> list[bytes]:
    """A send and a PFB from the validator's account (sequence from 0)."""
    priv = p.PrivateKey.from_seed(b"svc-val")
    a = priv.public_key().address()
    signer = p.mod("client.tx_client").Signer(CHAIN)
    signer.add_account(priv, number=0)
    rng = np.random.default_rng(seed)
    raws = [signer.create_tx(a, [p.mod("chain.tx").MsgSend(a, a, 5)], fee=2000,
                             gas_limit=100_000).encode()]
    signer.accounts[a].sequence += 1
    Blob, Namespace = p.mod("da.blob").Blob, p.mod("da.namespace").Namespace
    blobs = [Blob(Namespace.v0(bytes([0x61 + j]) * 8),
                  rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()) for j in range(n_blobs)]
    raws.append(signer.create_pay_for_blobs(a, blobs, fee=200_000, gas_limit=1_200_000))
    return raws


def orchestrate(pair: Pair, height: int) -> list:
    """One height through the orchestrated routes on both services;
    returns the answers (which must agree)."""
    answers = []

    def both(path, doc_for):
        got = {w: call(pair.urls[w], path, doc_for(w)) for w in PACKAGES}
        assert got["port"][0] == got["ref"][0] == 200, (path, got)
        docs = {w: json.loads(got[w][2]) for w in PACKAGES}
        assert docs["port"] == docs["ref"], path
        answers.append(docs["port"])
        return docs["port"]

    block = both("/consensus/propose", lambda w: {"time": T0 + height})["block"]
    pv = both("/consensus/prevote", lambda w: {"block": block, "round": 0})["vote"]
    pc = both("/consensus/precommit", lambda w: {"block": block, "polka": True,
                                                 "prevotes": [pv], "round": 0})["vote"]
    assert pc["block_hash"] is not None
    c = pair.pkgs["port"].c
    b = c.block_from_json(block)
    cert = c.CommitCertificate(height, b.header.hash(), (c.vote_from_json(pc),), 0)
    out = both("/consensus/commit", lambda w: {"block": block, "cert": c.cert_to_json(cert),
                                                "evidence": []})
    assert out["height"] == height
    return answers


GET_ROUTES = (
    "/consensus/height", "/sync/snapshots", "/sync/chunk?height=1&index=0",
    "/gossip/commit_at?height=2", "/gossip/commits?from=1&to=3",
    "/gossip/want_tx?hash=" + "00" * 32, "/gossip/want_tx?hash=zz",
    "/das/head", "/das/header?height=2", "/das/header?height=7",
    "/das/sample?height=2&row=0&col=1", "/das/sample?height=2&row=1&col=0&axis=col",
    "/das/sample?height=2&row=x", "/das/availability?height=2", "/das/pack?height=2",
    "/das/pack/chunk?height=2&index=0", "/blob/pack?height=2",
    "/consensus/snapshot", "/consensus/snapshot?min_height=5", "/faults", "/nope",
)


def test_routes_answer_like_the_reference(pair):
    port_p = pair.pkgs["port"]
    raws = traffic(port_p, seed=3)
    for raw in raws:
        got = pair.both("/broadcast_tx", {"tx": base64.b64encode(raw).decode()})
        assert got["port"] == got["ref"] and json.loads(got["port"][2])["code"] == 0
    for h in (1, 2, 3):
        orchestrate(pair, h)
    assert pair.nodes["port"].app.last_app_hash == pair.nodes["ref"].app.last_app_hash
    for v in pair.nodes.values():
        assert v.app.da_warmer.wait_idle(30)
    ns = port_p.mod("da.namespace").Namespace
    get_routes = GET_ROUTES + tuple(
        f"/blob/get?height=2&namespace={ns.v0(bytes([t]) * 8).raw.hex()}" for t in (0x61, 0x62, 0x70))
    for path in get_routes:
        got = pair.both(path)
        assert got["port"] == got["ref"], path
    for path, doc in (("/das/samples", {"height": 2, "cells": [[0, 0], [3, 2]]}),
                      ("/das/samples", {"groups": [{"height": 2, "cells": [[1, 1]]},
                                                   {"height": 9, "cells": [[0, 0]]}]}),
                      ("/das/headers", {"heights": [1, 2]}),
                      ("/blob/namespaces", {"queries": [{"height": 2, "namespace": "00" * 29}]}),
                      ("/consensus/nope", {}), ("/gossip/vote", {"vote": {}})):
        got = pair.both(path, doc)
        assert got["port"] == got["ref"], path
    status = {w: json.loads(call(pair.urls[w], "/consensus/status")[2]) for w in PACKAGES}
    fixed = ("name", "address", "chain_id", "height", "app_version", "app_hash", "mempool",
             "mempool_bytes", "mempool_stats", "locked")
    assert {k: status["port"][k] for k in fixed} == {k: status["ref"][k] for k in fixed}
    assert keys_of(status["port"]) == keys_of(status["ref"])
    traces = {w: json.loads(call(pair.urls[w], "/trace/block_summary")[2]) for w in PACKAGES}
    assert keys_of(traces["port"]) == keys_of(traces["ref"]) and len(traces["port"]["rows"]) == 3
    metrics = {w: call(pair.urls[w], "/metrics") for w in PACKAGES}
    names = {w: {line.split("{")[0].split(" ")[0] for line in m[2].decode().splitlines()
                 if line and not line.startswith("#")} for w, m in metrics.items()}
    assert metrics["port"][0] == 200 and metrics["port"][1] == metrics["ref"][1]
    for family in ("celestia_das_samples_served", "celestia_das_live_assembled",
                   "celestia_das_sample_batches"):
        assert {n for n in names["port"] if n.startswith(family)} and \
            {n for n in names["ref"] if n.startswith(family)}
    # /debug/profile goes to the port's torch profiler: a JSON answer, never a 500
    code, _ctype, body = call(pair.urls["port"], "/debug/profile", {"seconds": "x"})
    assert code in (200, 400) and isinstance(json.loads(body), dict)


def test_forged_commit_and_stale_polka_refused(pair):
    """A certificate signed by a stranger does not commit; a precommit
    asked for round 1 with the round-0 prevotes is a nil vote."""
    p = pair.pkgs["port"]
    url = pair.urls["port"]
    block = json.loads(call(url, "/consensus/propose", {"time": T0 + 1})[2])["block"]
    b = p.c.block_from_json(block)
    stranger = p.PrivateKey.from_seed(b"stranger")
    forged_vote = p.c.Vote(1, b.header.hash(), stranger.public_key().address(),
                           stranger.sign(p.c.Vote.sign_bytes(CHAIN, 1, b.header.hash(),
                                                             "precommit", 0)), "precommit", 0)
    cert = p.c.CommitCertificate(1, b.header.hash(), (forged_vote,), 0)
    code, _, body = call(url, "/consensus/commit", {"block": block, "cert": p.c.cert_to_json(cert)})
    assert code == 400 and "failed local verification" in json.loads(body)["error"]
    assert pair.nodes["port"].app.height == 0
    pv0 = json.loads(call(url, "/consensus/prevote", {"block": block, "round": 0})[2])["vote"]
    code, _, body = call(url, "/consensus/precommit", {"block": block, "polka": True,
                                                      "prevotes": [pv0], "round": 1})
    assert code == 200 and json.loads(body)["vote"]["block_hash"] is None
    code, _, body = call(url, "/consensus/commit", {"block": block, "cert": p.c.cert_to_json(
        p.c.CommitCertificate(1, b"\x01" * 32, (forged_vote,), 0))})
    assert code == 400 and "does not cover" in json.loads(body)["error"]


def test_faults_routes_over_http(pair):
    arm = {"point": "das.serve_sample", "action": "error", "count": 1,
           "match": {"height": "^2$"}}
    steps = (("/faults/arm", arm), ("/faults", None),
             ("/faults/arm", {"point": "x", "action": "nope"}),
             ("/faults/disarm", {"point": "das.serve_sample"}), ("/faults", None),
             ("/faults/reset", {"seed": 3}), ("/faults/what", {}), ("/faults/arm", arm),
             ("/faults", None))
    seq, base = {w: [] for w in PACKAGES}, {}
    try:
        for path, doc in steps:
            for w in PACKAGES:
                code, ctype, body = call(pair.urls[w], path, doc)
                out = json.loads(body)
                if path == "/faults/arm" and code == 200:
                    base.setdefault(w, out["id"])
                seq[w].append((path, code, ctype, rebased(out, base.get(w, 0))))
    finally:
        for w in PACKAGES:
            pair.pkgs[w].faults.reset()
    assert seq["port"] == seq["ref"]
    codes = [code for _path, code, _ctype, _doc in seq["port"]]
    assert codes == [200, 200, 400, 200, 200, 200, 400, 200, 200]
    assert seq["port"][1][3]["armed"] and not seq["port"][4][3]["armed"]
    assert seq["port"][7][3]["id"] > 0 and seq["port"][8][3]["armed"]


@pytest.mark.parametrize("scheduler,services", [("port", "ref"), ("ref", "port")])
def test_socket_network_drives_the_other_package(tmp_path, scheduler, services):
    """A SocketNetwork of one package schedules four services of the other:
    both directions commit the same two heights with the same app hashes."""
    d, s = pkg(scheduler), pkg(services)
    privs = [s.PrivateKey.from_seed(f"sock-{i}".encode()) for i in range(4)]
    gen = genesis_for(privs)
    nodes = [s.c.ValidatorNode(f"val{i}", privs[i], gen, CHAIN,
                               data_dir=str(tmp_path / f"val{i}"), **s.device) for i in range(4)]
    svcs = [s.service.ValidatorService(v) for v in nodes]
    try:
        for svc in svcs:
            svc.serve_background()
        net = d.remote.SocketNetwork(
            [d.remote.RemoteValidator(f"http://127.0.0.1:{svc.port}") for svc in svcs], gen, CHAIN)
        signer = d.mod("client.tx_client").Signer(CHAIN)
        signer.add_account(privs[0], number=0)
        a0, a1 = (k.public_key().address() for k in privs[:2])
        assert net.broadcast_tx(signer.create_tx(a0, [d.mod("chain.tx").MsgSend(a0, a1, 9)],
                                                 fee=2000, gas_limit=100_000).encode())
        got = [net.produce_height(T0 + h) for h in (1, 2)]
        assert [h for h, _ in got] == [1, 2]
        assert {v.app.last_app_hash.hex() for v in nodes} == {got[-1][1]}
        assert all(len(v.pool) == 0 for v in nodes)
    finally:
        for svc in svcs:
            svc.shutdown()
        settle(nodes)
    # the same chain whichever package schedules it
    test_socket_network_drives_the_other_package.hashes[(scheduler, services)] = got
    seen = test_socket_network_drives_the_other_package.hashes
    if len(seen) == 2:
        assert seen[("port", "ref")] == seen[("ref", "port")]


test_socket_network_drives_the_other_package.hashes = {}
