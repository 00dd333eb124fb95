"""The port's full-node HTTP surface (service/server.py NodeService) and its
DA shim (service/da_service.py DACore) against the JAX package's
(tolerance: exact).

- Every route of the reference's NodeService docstring, on both packages'
  services over one shared 3-validator chain each (equal byte for byte):
  the same status codes and the same JSON or raw bytes, in one fixed
  order of calls, including /ibc/header, /da/extend_commit and
  /da/prove_shares. Where a body carries process state (the telemetry
  snapshot in /status, the Prometheus text, trace rows) or names the
  package's profiler (the refusal of /debug/profile), its shape is
  compared instead.
- ``DACore`` against the reference's host engine on seeded ODS at
  k = 1 ... 8: the same DAH, proofs and errors; a repeated
  ExtendAndCommit runs no pipeline; the standalone DAService.
- ``shutdown`` deregisters the commit-seed listener.

The port runs on ``device="cpu"`` (the reference on its host engine).
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_app import Pkg
from test_torch_daser import NS_USER, PAIRS, chains  # noqa: F401  (chains: fixture)

SHARE = 512


def call(url: str, method: str, path: str, payload=None):
    """(status, body): JSON bodies parsed, raw bodies as hex."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, ctype, body = r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        code, ctype, body = e.code, e.headers.get("Content-Type", ""), e.read()
    if "json" in ctype:
        return code, json.loads(body)
    if "octet-stream" in ctype:
        return code, body.hex()
    return code, body.decode()


def ods_shares(k: int, seed: int = 7) -> list[bytes]:
    """tests/test_da_service.py's `_ods_shares`: k*k namespace-ordered
    shares."""
    rng = np.random.default_rng(seed)
    shares = []
    for i in range(k * k):
        ns = bytes([0] * 18) + bytes([1 + (i % 3)]) + bytes([0] * 10)
        shares.append(ns + rng.integers(0, 256, SHARE - 29, dtype=np.uint8).tobytes())
    return sorted(shares)


def b64_ods(shares: list[bytes]) -> str:
    return base64.b64encode(b"".join(shares)).decode()


def route_calls(served) -> list:
    """The fixed sequence of requests, each answer in order."""
    app = served.nodes[0].app
    user = Pkg("port").Namespace.v0(NS_USER).raw.hex()
    absent = Pkg("port").Namespace.v0(b"\x70\x07" * 4).raw.hex()
    key = sorted(app.store._data)[0].hex()
    a0 = served.chain.addr(0).hex()
    shares = ods_shares(4, seed=11)
    ods = b64_ods(shares)
    blk2 = app.db.load_block(2)
    send = served.chain.signer.create_tx(served.chain.addr(2), [served.p.tx.MsgSend(served.chain.addr(2),
                                                                                    served.chain.addr(1), 7)],
                                         fee=2000, gas_limit=100_000).encode()
    tx_b64 = base64.b64encode(send).decode()
    committed = base64.b64encode(blk2.txs[0]).decode()
    import hashlib

    out = []

    def get(path):
        out.append((path, *call(served.url, "GET", path)))

    def post(path, payload):
        out.append((path, *call(served.url, "POST", path, payload)))

    get("/status")
    for h in (1, 3, 99):
        get(f"/block/{h}")
    get("/das/head")
    get("/das/header?height=2")
    get("/das/sample?height=2&row=1&col=2")
    get("/das/sample?height=2&row=0&col=3&axis=col")
    get("/das/sample?height=2&row=999&col=0")
    post("/das/samples", {"height": 3, "cells": [[0, 0], [1, 2], [7, 7]]})
    post("/das/samples", {"groups": [{"height": h, "cells": [[0, 0], [1, 1]]} for h in (3, 1, 9)]})
    post("/das/headers", {"heights": [1, 3, 9]})
    get("/das/pack?height=3")
    get("/das/pack/chunk?height=3&index=0")
    get("/das/availability?height=2")
    for ns in (user, absent):
        get(f"/blob/get?height=2&namespace={ns}")
    get("/blob/pack?height=2")
    get("/blob/pack/chunk?height=2&index=0")
    post("/blob/namespaces", {"queries": [{"height": 3, "namespace": user}, {"height": 1, "namespace": absent}]})
    get("/sync/snapshots")
    get("/sync/chunk?height=1&index=0")
    post("/faults/reset", {"seed": 3})
    get("/faults")
    post("/faults/arm", {"point": "net.request", "action": "error", "count": 1})
    get("/faults")
    post("/faults/disarm", {})
    post("/faults/arm", {"point": "no.such", "action": "explode"})
    post("/faults/reset", {"seed": 0})
    get("/metrics")
    get("/trace/spans?since=0&limit=5")
    get("/no/such/route")
    post("/simulate_tx", {"tx": tx_b64})
    post("/broadcast_tx", {"tx": base64.b64encode(b"\x01\x02junk").decode()})
    post("/broadcast_tx", {"tx": tx_b64})
    post("/broadcast_tx", {"tx": tx_b64})
    post("/produce_block", {})
    post("/abci_query", {"path": "status", "data": {}})
    post("/abci_query", {"path": "custom/txInclusionProof", "data": {"height": 2, "tx_index": 1}})
    post("/abci_query", {"path": "custom/shareInclusionProof",
                         "data": {"height": 2, "start": 1, "end": 3, "namespace": user}})
    post("/abci_query", {"path": "custom/namespaceData", "data": {"height": 3, "namespace": user}})
    post("/abci_query", {"path": "custom/dah", "data": {"height": 1}})
    post("/abci_query", {"path": "custom/sampleCell", "data": {"height": 1, "row": 0, "col": 1}})
    post("/abci_query", {"path": "bank/balance", "data": {"address": a0}})
    post("/abci_query", {"path": "auth/account", "data": {"address": a0}})
    post("/abci_query", {"path": "staking/validators", "data": {}})
    post("/abci_query", {"path": "blob/params", "data": {}})
    post("/abci_query", {"path": "minfee/params", "data": {}})
    post("/abci_query", {"path": "tx", "data": {"hash": hashlib.sha256(base64.b64decode(committed)).hexdigest()}})
    post("/abci_query", {"path": "signal/tally", "data": {"version": 3}})
    post("/abci_query", {"path": "blobstream/latest_nonce", "data": {}})
    post("/abci_query", {"path": "no/such", "data": {}})
    post("/da/extend_commit", {"ods": ods, "square_size": 4})
    post("/da/extend_commit", {"ods": ods})
    root = out[-1][2]["data_root"]
    post("/da/prove_shares", {"data_root": root, "start": 5, "end": 9, "namespace": shares[5][:29].hex()})
    post("/da/prove_shares", {"ods": ods, "start": 0, "end": 2})
    post("/da/prove_shares", {"data_root": "ab" * 32, "start": 0, "end": 1})
    post("/da/extend_commit", {"ods": base64.b64encode(b"\x00" * (3 * SHARE)).decode()})
    post("/da/extend_commit", {})
    post("/da/nope", {})
    post("/debug/profile", {"seconds": -1})
    post("/ibc/prove", {"key": key})
    post("/ibc/prove", {"key": "ff" * 20, "absence": True})
    post("/ibc/prove", {"key": "ff" * 20})
    post("/ibc/ack", {"packet": {"destination_port": "transfer", "destination_channel": "channel-0",
                                 "sequence": 1}})
    post("/ibc/client_height", {"client_id": "07-tendermint-0"})
    for h in (1, 2, 3, 99):
        post("/ibc/header", {"height": h})
    post("/ibc/events", {"type": "send_packet"})
    post("/no/such/route", {})
    return out


def shape(value):
    """The keys of a body that carries process state."""
    return sorted(value) if isinstance(value, dict) else type(value).__name__


def comparable(path: str, code: int, body):
    if path == "/status":
        body = {**body, **{k: shape(body[k]) for k in ("telemetry", "mempool", "admission", "blob")}}
    elif path == "/abci_query" and isinstance(body, dict) and "telemetry" in body:
        body = {**body, "telemetry": shape(body["telemetry"])}
    elif path == "/metrics":
        body = any(ln.startswith("# TYPE celestia_") for ln in body.splitlines())
    elif path == "/debug/profile":
        # refused by both (400); the reason names each package's profiler
        body = sorted(body)
    elif path.startswith("/trace/"):
        body = sorted(body)
    elif path == "/faults" or path.startswith("/faults/"):
        # fire counts and arm ids run on across the process's earlier tests
        def strip(v):
            if isinstance(v, dict):
                return {k: strip(x) for k, x in v.items() if k not in ("fired", "id")}
            return [strip(x) for x in v] if isinstance(v, list) else v
        body = strip(body)
    return path, code, body


def test_every_route_answers_like_the_reference(chains):
    runs = {}
    for _client, server in PAIRS:
        served = chains(server)
        runs[server] = [comparable(*row) for row in route_calls(served)]
    differ = [(got, want) for got, want in zip(runs["port"], runs["ref"]) if got != want]
    assert not differ, differ
    assert len(runs["port"]) == len(runs["ref"])
    codes = {path: code for path, code, _ in runs["port"]}
    # the routes a light node and a rollup depend on answered, the
    # refusals are client errors
    assert codes["/ibc/header"] == 404 and codes["/produce_block"] == 400
    assert [row for row in runs["port"] if row[0] == "/ibc/header"][0][1] == 200


def test_da_routes_give_the_committed_data_root(chains):
    """/da/extend_commit of a committed height's ODS gives its header's
    data_hash, and /da/prove_shares of a blob's share range verifies
    against it, on both services."""
    for _client, server in PAIRS:
        served = chains(server)
        p = served.p
        app = served.nodes[0].app
        block, square = p.mod("chain.query").rebuild_square(app, 2)
        ods = b"".join(square.share_bytes())
        out = call(served.url, "POST", "/da/extend_commit", {"ods": base64.b64encode(ods).decode()})[1]
        assert out["data_root"] == block.header.data_hash.hex()
        start, end = p.mod("da.proof").blob_share_range(square, 0, 0)
        doc = call(served.url, "POST", "/da/prove_shares",
                   {"data_root": out["data_root"], "start": start, "end": end})[1]
        proof = Pkg("port").mod("chain.query").share_proof_from_json(doc["proof"])
        assert proof.verify(block.header.data_hash)
        assert Pkg("ref").mod("chain.query").share_proof_from_json(doc["proof"]).verify(block.header.data_hash)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_da_core_matches_reference(k):
    port = Pkg("port").mod("service.da_service")
    ref = Pkg("ref").mod("service.da_service")
    shares = ods_shares(k, seed=k)
    ods = b64_ods(shares)
    pc, rc = port.DACore(device="cpu"), ref.DACore(engine="host")
    assert pc.extend_and_commit({"ods": ods, "square_size": k}) == rc.extend_and_commit({"ods": ods,
                                                                                           "square_size": k})
    root = rc.extend_and_commit({"ods": ods})["data_root"]
    for req in ({"data_root": root, "start": 0, "end": k * k},
                {"data_root": root, "start": k * k // 2, "end": k * k, "namespace": shares[-1][:29].hex()},
                {"ods": ods, "start": 0, "end": 1}):
        assert pc.prove_shares(req) == rc.prove_shares(req)
    bad = ({"ods": base64.b64encode(b"\x00" * (3 * SHARE)).decode()},
           {"ods": base64.b64encode(b"\x00" * 100).decode()},
           {"ods": b64_ods(ods_shares(2)), "square_size": 4})
    for req in bad:
        with pytest.raises(port.DAError) as got:
            pc.extend_and_commit(req)
        with pytest.raises(ref.DAError) as want:
            rc.extend_and_commit(req)
        assert str(got.value) == str(want.value)
    for req in ({"data_root": "ab" * 32, "start": 0, "end": 1}, {"data_root": root, "start": 3, "end": 3},
                {"data_root": root, "start": k * k, "end": k * k + 1}, {"data_root": root},
                {"data_root": root, "start": 0, "end": 1, "namespace": "zz"}, {"start": 0, "end": 1}):
        with pytest.raises(port.DAError) as got:
            pc.prove_shares(req)
        with pytest.raises(ref.DAError) as want:
            rc.prove_shares(req)
        assert str(got.value) == str(want.value)
    with pytest.raises(port.DAError, match="missing field"):
        pc.handle("/da/extend_commit", {})


def test_da_core_repeat_is_a_cache_hit_and_the_cache_is_bounded(monkeypatch):
    from celestia_app_tpu_torch.da import eds as eds_mod
    from celestia_app_tpu_torch.service import da_service

    runs = []
    orig = eds_mod.pipeline
    monkeypatch.setattr(eds_mod, "pipeline", lambda *a, **kw: runs.append(1) or orig(*a, **kw))
    core = da_service.DACore(device="cpu", cache_squares=1)
    a = {"ods": b64_ods(ods_shares(2, seed=1))}
    first = core.extend_and_commit(a)
    assert core.extend_and_commit(a) == first and len(runs) == 1
    core.extend_and_commit({"ods": b64_ods(ods_shares(2, seed=2))})
    assert len(runs) == 2
    with pytest.raises(da_service.DAError, match="no cached square"):
        core.prove_shares({"data_root": first["data_root"], "start": 0, "end": 1})
    core.extend_and_commit(a)  # evicted: computed again
    assert len(runs) == 3


def test_standalone_da_service_over_http():
    from celestia_app_tpu_torch.chain.query import share_proof_from_json
    from celestia_app_tpu_torch.service import da_service

    svc = da_service.DAService(da_service.DACore(device="cpu"), port=0).serve_background()
    ref = Pkg("ref").mod("service.da_service").DACore(engine="host")
    try:
        url = f"http://127.0.0.1:{svc.port}"
        shares = ods_shares(2, seed=3)
        code, out = call(url, "POST", "/da/extend_commit", {"ods": b64_ods(shares)})
        assert code == 200 and out == ref.extend_and_commit({"ods": b64_ods(shares)})
        code, doc = call(url, "POST", "/da/prove_shares", {"data_root": out["data_root"], "start": 0, "end": 4,
                                                            "namespace": shares[0][:29].hex()})
        assert code == 200 and share_proof_from_json(doc["proof"]).verify(bytes.fromhex(out["data_root"]))
        code, err = call(url, "POST", "/da/extend_commit", {"ods": "AAAA"})
        assert code == 400 and "share size" in err["error"]
        assert call(url, "GET", "/status") == (200, {"service": "da", "device": "cpu"})
    finally:
        svc.shutdown()


def test_shutdown_deregisters_the_seed_listener(chains):
    served = chains("port")
    app = served.nodes[0].app
    listener = served.svc.das_core.seed_cache_entry
    assert listener in app.da_seed_listeners
    served.svc.shutdown()
    assert listener not in app.da_seed_listeners
    served.svc = type("Stopped", (), {"shutdown": lambda self: None})()


def test_a_kernel_error_answers_500(chains, monkeypatch):
    """A kernel wrapper's error is the node's fault, not the client's: a
    GET route (whose other ValueErrors are parse failures, 400) and a
    POST /da route answer 500 and count ``http.500``."""
    from celestia_app_tpu_torch import cuda_build
    from celestia_app_tpu_torch.das import server as das_server
    from celestia_app_tpu_torch.service import da_service
    from celestia_app_tpu_torch.utils import telemetry

    served = chains("port")

    def wrapper_error(*args, **kwargs):
        raise cuda_build.KernelValueError("operand must be (128, 128) uint8, got (127, 128) torch.uint8")

    monkeypatch.setattr(das_server, "route_das", wrapper_error)
    monkeypatch.setattr(da_service.DACore, "_pipeline", wrapper_error)
    before = telemetry.snapshot()["counters"].get("http.500", 0)
    code, body = call(served.url, "GET", "/das/header?height=1")
    assert code == 500 and "KernelValueError" in body["error"]
    code, body = call(served.url, "POST", "/da/extend_commit", {"ods": b64_ods(ods_shares(2))})
    assert code == 500 and "KernelValueError" in body["error"]
    assert telemetry.snapshot()["counters"].get("http.500", 0) == before + 2
