"""The port's tx client (client/tx_client.py: TxClient, HttpNodeClient and
the two rejection parsers) against the JAX package's (tolerance: exact).

- ``parse_expected_sequence`` and ``parse_required_min_gas_price`` give
  the reference's values on the antes' own rejection logs (a stale
  sequence, a fee under the floor) and on near-miss strings.
- ``TxClient`` in process (tests/test_app.py): a send, a PFB with
  simulate-based gas, the re-price after an insufficient-gas-price
  rejection and the resync after a sequence mismatch give the same
  results, balances and signer sequences in both packages.
- ``TxClient`` over ``HttpNodeClient`` (tests/test_service_plane.py),
  as a mixed pair: each package's client submits to the other package's
  NodeService while a block loop commits; the confirmations, gas and
  balances are the same.

The port runs on ``device="cpu"`` (the reference on its host engine).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

from test_torch_app import CHAIN, Pkg, addr, ctx_of, make_app
from test_torch_daser import PAIRS

T0 = 1_700_000_000.0


def balance(p, app, who: bytes) -> int:
    return app.bank.balance(ctx_of(p, app), who)


def result(res) -> tuple:
    return (res.code, res.log, res.gas_wanted, res.gas_used)


def rejection_logs(p) -> list[str]:
    """The ante's logs for a stale sequence and an underpriced fee."""
    app, signer, privs = make_app(p)
    a, b = addr(privs[0]), addr(privs[1])
    signer.accounts[a].sequence = 3
    stale = app.check_tx(signer.create_tx(a, [p.tx.MsgSend(a, b, 1)], fee=2000, gas_limit=100_000).encode())
    signer.accounts[a].sequence = 0
    cheap = app.check_tx(signer.create_tx(a, [p.tx.MsgSend(a, b, 1)], fee=1, gas_limit=100_000).encode())
    assert stale.code != 0 and cheap.code != 0
    return [stale.log, cheap.log]


def test_parsers_match_reference():
    port, ref = Pkg("port").mod("client.tx_client"), Pkg("ref").mod("client.tx_client")
    logs = rejection_logs(Pkg("port"))
    assert logs == rejection_logs(Pkg("ref"))
    strings = logs + [
        "account sequence mismatch, expected 12, got 3: incorrect account sequence",
        "expected 7, got", "insufficient gas price: 0.000000010 < min 0.002000000",
        "insufficient gas price: 1 < min 2.5", "insufficient gas price: < min", "", "some other error",
    ]
    for s in strings:
        assert port.parse_expected_sequence(s) == ref.parse_expected_sequence(s), s
        assert port.parse_required_min_gas_price(s) == ref.parse_required_min_gas_price(s), s
    assert port.parse_expected_sequence(logs[0]) == 0
    assert port.parse_required_min_gas_price(logs[1]) == 0.002


def in_process(which: str, scenario: str) -> dict:
    p = Pkg(which)
    app, signer, privs = make_app(p)
    node = p.Node(app)
    client = p.mod("client.tx_client").TxClient(node, signer)
    a, b = addr(privs[0]), addr(privs[1])
    rng = np.random.default_rng(0)
    if scenario == "send":
        height, res = client.submit_send(a, b, 12345)
    elif scenario == "pfb":
        blobs = [p.Blob(p.Namespace.v0(b"app"), rng.integers(0, 256, n, dtype=np.uint8).tobytes())
                 for n in (2000, 50)]
        height, res = client.submit_pay_for_blob(a, blobs)
        assert any(e["type"].endswith("EventPayForBlobs") for e in res.events)
        assert client.estimate_gas(a, [], blobs) >= res.gas_used
    elif scenario == "reprice":
        client.default_gas_price = 1e-12
        height, res = client.submit_send(a, b, 77)
    else:  # resync: the signer's cached sequence is stale
        signer.accounts[a].sequence = 5
        height, res = client.submit_send(a, b, 9)
    assert res.code == 0, res.log
    app.da_warmer.wait_idle(30)
    return {"height": height, "result": result(res), "balance_b": balance(p, app, b),
            "sequence": signer.accounts[a].sequence, "gas_price": client.default_gas_price}


@pytest.mark.parametrize("scenario", ["send", "pfb", "reprice", "resync"])
def test_in_process_tx_client_matches_reference(scenario):
    assert in_process("port", scenario) == in_process("ref", scenario)


class Served:
    """A disk-backed single-validator node of one package with a
    NodeService, and a loop committing a block every `period` seconds."""

    def __init__(self, which: str, root: str, period: float = 0.2):
        self.p = p = Pkg(which)
        self.app, self.signer, self.privs = make_app(p, data_dir=os.path.join(root, which))
        self.node = p.Node(self.app)
        self.svc = p.mod("service.server").NodeService(self.node, port=0)
        self.svc.serve_background()
        self.url = f"http://127.0.0.1:{self.svc.port}"
        self.t = T0
        self.stop = threading.Event()
        self.period = period
        self.loop = threading.Thread(target=self._run, daemon=True)
        self.loop.start()

    def _run(self) -> None:
        while not self.stop.wait(self.period):
            with self.svc.lock:
                if self.node.mempool:
                    self.t += 10.0
                    self.node.produce_block(t=self.t)

    def close(self) -> None:
        self.stop.set()
        self.loop.join(30)
        self.svc.shutdown()
        self.app.da_warmer.wait_idle(30)
        self.app.close()


def over_http(client_pkg, served: Served) -> dict:
    mod = client_pkg.mod("client.tx_client")
    remote = mod.HttpNodeClient(served.url)
    signer = client_pkg.Signer(CHAIN)
    privs = [client_pkg.PrivateKey.from_seed(bytes([i])) for i in range(3)]
    for i, k in enumerate(privs):
        signer.add_account(k, number=i)
    client = mod.TxClient(remote, signer)
    a, b = addr(privs[2]), addr(privs[1])
    rng = np.random.default_rng(1)
    blobs = [client_pkg.Blob(client_pkg.Namespace.v0(b"rmtns"), rng.integers(0, 256, 900, dtype=np.uint8).tobytes())]
    try:
        probe = signer.create_pay_for_blobs(a, blobs, fee=1, gas_limit=1 << 40)
        gas = remote.simulate_tx(probe)
        with pytest.raises(RuntimeError, match="simulation failed"):
            remote.simulate_tx(b"\x00junk")
        pfb = client.submit_pay_for_blob(a, blobs)
        send = client.submit_send(a, b, 31)
        signer.accounts[a].sequence = 0  # stale: the node's rejection resyncs it
        late = client.submit_send(a, b, 32)
        assert pfb["found"] and send["found"] and late["found"]
        status = remote.status()
        with pytest.raises(OSError, match="404"):
            remote._request("GET", "/no/such/route")
    finally:
        remote.close()
    return {"gas": gas, "confirms": [{k: v for k, v in c.items() if k != "height"} for c in (pfb, send, late)],
            "sequence": signer.accounts[a].sequence, "balance_b": balance(served.p, served.app, b),
            "chain": status["chain_id"]}


def test_tx_client_over_http_mixed_pair(tmp_path):
    runs = []
    for client, server in PAIRS:
        served = Served(server, str(tmp_path / client))
        try:
            runs.append(over_http(Pkg(client), served))
        finally:
            served.close()
    assert runs[0] == runs[1]
    assert runs[0]["sequence"] == 3 and runs[0]["balance_b"] == 10**12 + 63
