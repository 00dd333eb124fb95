"""The port's consensus reactor over localhost HTTP, alone and beside the
JAX package's (tests/test_autonomous_consensus.py's scenarios).

- Four port ValidatorServices with reactors commit identical heights, a
  tx sent to one validator's /broadcast_tx reaches every state through the
  CAT gossip, and a dead proposer's slots rotate to the next round.
- A port validator whose reactor starts late catches up by blocksync.
- A mixed mesh of two reference and two port services gossiping over
  localhost HTTP commits one chain: the same app hash at every height, and
  commit records on disk that carry the same signed proposal envelope at
  every height and verify in both packages. (Each validator assembles its
  own certificate from the votes it received, as in the reference, so
  the certificates' vote sets may differ between validators.)
- A port laggard blocksyncs from reference peers.
- The kernel wrappers' launch counters stay exact when 8 threads count at
  once.

Everything runs on ``device="cpu"`` (the reference on its host engine).
Every fixture stops its reactors and services and joins the warmers.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import threading
import time
import urllib.request

import pytest

from test_torch_sync import CHAIN, genesis_for, pkg, settle

FAST = dict(timeout_propose=8.0, timeout_prevote=4.0, timeout_precommit=4.0,
            timeout_delta=1.0, block_interval=0.01, poll=0.005,
            gossip_timeout=2.0, sync_grace=0.5)


class Net:
    """Validators of the given packages wired as a fully-connected gossip
    mesh over localhost HTTP. `kinds[i]` is "ref" or "port"."""

    def __init__(self, kinds, seed: str, home=None):
        self.pkgs = [pkg(k) for k in kinds]
        self.privs = [self.pkgs[i].PrivateKey.from_seed(f"{seed}-{i}".encode())
                      for i in range(len(kinds))]
        self.genesis = genesis = genesis_for(self.privs)
        self.nodes = [p.c.ValidatorNode(f"val{i}", self.privs[i], genesis, CHAIN,
                                        data_dir=str(home / f"val{i}") if home else None,
                                        **p.device)
                      for i, p in enumerate(self.pkgs)]
        self.services = [p.service.ValidatorService(v) for p, v in zip(self.pkgs, self.nodes)]
        for s in self.services:
            s.serve_background()
        self.urls = [f"http://127.0.0.1:{s.port}" for s in self.services]
        self.down: set[int] = set()

    def start_reactor(self, i: int, **overrides) -> None:
        peers = [u for j, u in enumerate(self.urls) if j != i]
        self.services[i].attach_reactor(
            peers, self.pkgs[i].reactor.ReactorConfig(**{**FAST, **overrides}))

    def start_all(self, **overrides) -> None:
        for i in range(len(self.services)):
            self.start_reactor(i, **overrides)

    def kill(self, i: int) -> None:
        self.services[i].shutdown()
        self.down.add(i)

    def stop(self) -> None:
        for i, s in enumerate(self.services):
            if i not in self.down:
                s.shutdown()
        settle(self.nodes)

    def heights(self) -> list[int]:
        return [v.app.height for v in self.nodes]

    def wait_heights(self, target: int, nodes=None, timeout: float = 60.0) -> None:
        nodes = nodes if nodes is not None else range(len(self.nodes))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(self.nodes[i].app.height >= target for i in nodes):
                return
            time.sleep(0.05)
        raise AssertionError(f"timeout waiting for height {target}: {self.heights()}")

    def assert_no_divergence(self, nodes=None) -> int:
        """Every height committed by two or more of `nodes` has one hash."""
        nodes = nodes if nodes is not None else range(len(self.nodes))
        reactors = [self.services[i].reactor for i in nodes]
        heights = set().union(*(r.app_hashes for r in reactors))
        common = 0
        for h in sorted(heights):
            seen = {r.app_hashes[h] for r in reactors if h in r.app_hashes}
            assert len(seen) <= 1, f"divergence at height {h}: {seen}"
            common += sum(h in r.app_hashes for r in reactors) >= 2
        assert common > 0, "no height was committed by two nodes"
        for r in reactors:
            assert r.loop_errors == 0
        return common


@pytest.fixture
def make_net():
    made = []

    def make(kinds, seed: str, home=None) -> Net:
        made.append(Net(kinds, seed, home))
        return made[-1]

    yield make
    for net in made:
        net.stop()


def post(url: str, path: str, doc: dict, timeout: float = 10.0) -> dict:
    req = urllib.request.Request(url + path, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def send_tx(net: Net, via: int, amount: int) -> bytes:
    """A MsgSend from validator 0's account to validator 1's, posted to
    validator `via`'s /broadcast_tx; returns the receiver's address."""
    p = net.pkgs[via]
    signer = p.mod("client.tx_client").Signer(CHAIN)
    signer.add_account(net.privs[0], number=0)
    a0, a1 = (net.privs[i].public_key().address() for i in (0, 1))
    tx = signer.create_tx(a0, [p.mod("chain.tx").MsgSend(a0, a1, amount)],
                          fee=2000, gas_limit=100_000)
    out = post(net.urls[via], "/broadcast_tx", {"tx": base64.b64encode(tx.encode()).decode()})
    assert out["code"] == 0, out
    return a1


def wait_credited(net: Net, addr: bytes, timeout: float = 60.0) -> None:
    def credited(p, v) -> bool:
        st = p.mod("chain.state")
        ctx = st.Context(v.app.store, st.InfiniteGasMeter(), v.app.height, 0,
                         CHAIN, v.app.app_version)
        return v.app.bank.balance(ctx, addr) > 10**12

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(credited(p, v) for p, v in zip(net.pkgs, net.nodes)):
            return
        time.sleep(0.05)
    raise AssertionError(f"tx not committed everywhere: {net.heights()}")


def test_port_mesh_commits_identically_and_rotates(make_net):
    """Four port reactors, no coordinator: heights commit with one hash,
    a tx reaches every state by CAT gossip, and after a validator dies its
    proposer slots time out into round 1 while the rest keep committing."""
    net = make_net(["port"] * 4, "torch-auto")
    net.start_all(timeout_propose=3.0)
    net.wait_heights(2)
    wait_credited(net, send_tx(net, 0, 777))
    net.assert_no_divergence()

    tel = net.pkgs[0].telemetry
    failures = tel.snapshot()["counters"].get("reactor.round_failures", 0)
    net.kill(2)
    alive = [0, 1, 3]
    base = max(net.nodes[i].app.height for i in alive)
    # four heights hold every proposer slot of the rotation, the dead
    # validator's included (three miss it whenever its slot comes fourth)
    net.wait_heights(base + 4, nodes=alive, timeout=90.0)
    net.assert_no_divergence(nodes=alive)
    assert tel.snapshot()["counters"].get("reactor.round_failures", 0) > failures


def test_late_starter_catches_up(make_net, tmp_path):
    """Server up, reactor down while the others commit: the late reactor
    adopts the committed heights from its peers' commit records."""
    net = make_net(["port"] * 4, "torch-late", home=tmp_path)
    for i in range(3):  # the sleeper's proposer slots time out fast
        net.start_reactor(i, timeout_propose=2.0)
    net.wait_heights(3, nodes=[0, 1, 2])
    assert net.nodes[3].app.height == 0
    net.start_reactor(3, timeout_propose=2.0)
    net.wait_heights(net.nodes[0].app.height + 1, timeout=90.0)
    net.assert_no_divergence()
    assert net.services[3].reactor.blocksync_fetch_errors == 0


def records(home, i: int) -> dict[int, dict]:
    d = home / f"val{i}" / "commits"
    return {int(n.split(".")[0]): json.loads((d / n).read_text())
            for n in os.listdir(d) if n.endswith(".json")}


def test_mixed_mesh_commits_one_chain(make_net, tmp_path):
    """Two reference and two port services gossip over localhost HTTP and
    commit one chain: same app hashes, and every validator's commit record
    of a height carries the same signed proposal and a certificate for the
    same block that both packages verify."""
    net = make_net(["ref", "port", "ref", "port"], "torch-mixed", home=tmp_path)
    net.start_all()
    net.wait_heights(2)
    wait_credited(net, send_tx(net, 1, 4242))
    net.wait_heights(max(net.heights()) + 1)
    net.assert_no_divergence()
    for v in net.nodes:
        v.app.da_warmer.wait_idle(10)
    recs = [records(tmp_path, i) for i in range(4)]
    common = set.intersection(*(set(r) for r in recs))
    assert len(common) >= 3
    powers = {bytes.fromhex(x["operator"]): 10 for x in net.genesis["validators"]}
    for h in sorted(common):
        props = {json.dumps(r[h]["proposal"], sort_keys=True) for r in recs}
        assert len(props) == 1, f"height {h}: proposals differ"
        assert len({r[h]["cert"]["block_hash"] for r in recs}) == 1
        for r in recs:
            for p, v in zip(net.pkgs, net.nodes):
                cert = p.c.cert_from_json(r[h]["cert"])
                assert cert.height == h
                assert cert.verify(CHAIN, v.validator_pubkeys, 40, powers)


def test_port_laggard_blocksyncs_from_ref_peers(make_net, tmp_path):
    """Three reference validators commit; a port validator whose reactor
    starts late replays their commit records to the same app hash."""
    net = make_net(["ref", "ref", "ref", "port"], "torch-lag", home=tmp_path)
    for i in range(3):
        net.start_reactor(i, timeout_propose=2.0)
    net.wait_heights(4, nodes=[0, 1, 2])
    net.start_reactor(3, timeout_propose=2.0)
    target = net.nodes[0].app.height + 1
    net.wait_heights(target, timeout=90.0)
    net.assert_no_divergence()
    port = net.services[3].reactor
    assert port.blocksync_fetch_errors == 0 and port.statesync_errors == 0
    h = net.nodes[3].app.height
    assert net.services[0].reactor.app_hashes[h] == net.nodes[3].app.last_app_hash.hex()


def test_launch_counters_exact_under_threads():
    """Eight threads add to both wrappers' launch counters at once (as HTTP
    handlers, reactors and warmers do on a card): no add is lost."""
    from celestia_app_tpu_torch import cuda_build
    from celestia_app_tpu_torch.ops import rs_kernel, sha256_kernel

    wrappers = (sha256_kernel.compress_words, rs_kernel.extend_lines)
    start = [w.launches for w in wrappers]
    per_thread = 20_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the runtime allows
    try:
        gate = threading.Barrier(8)

        def hammer():
            gate.wait()
            for _ in range(per_thread):
                for w in wrappers:
                    cuda_build.count_launch(w)

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert [w.launches - s for w, s in zip(wrappers, start)] == [8 * per_thread] * 2
    for w, s in zip(wrappers, start):
        w.launches = s
    # both wrappers count through the locked add, nowhere else
    import inspect

    for mod, name in ((sha256_kernel, "compress_words"), (rs_kernel, "extend_lines")):
        src = inspect.getsource(mod)
        assert src.count(f"cuda_build.count_launch({name})") == 1
        assert f"{name}.launches +=" not in src
