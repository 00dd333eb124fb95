"""The port's command line (`celestia_app_tpu_torch.cli.main`) against the
reference's (`celestia_app_tpu.cli.main`), on the CPU.

Each package runs in its own temporary home (the reference may store its
chain in the native engine's segments, which the port does not read), the
port with ``--device cpu``. The wall clock both read is fixed, so the two
chains are the same chain: the genesis ceremony gives the same files,
``config``, ``keys``, ``addr-conversion`` and ``download-genesis`` the same
answers, and ``start --blocks 3``, paced ``txsim --rounds 2``, ``tx send``
and ``tx pay-for-blob`` the same data roots, app hashes and ``status``.
Snapshots, ``rollback``, ``export``, ``blocktime`` and ``blockscan`` give
the same documents. The port's command set is the reference's minus the
deferred commands, with no ``--grpc`` or ``--engine`` flag; a home that
holds only native segments is refused; without a card every command
raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import http.server
import io
import json
import os
import threading
import time

import pytest
import torch

from celestia_app_tpu import cli as ref_cli
from celestia_app_tpu.net import transport as ref_transport
from celestia_app_tpu_torch import cli
from celestia_app_tpu_torch.net import transport

CLIS = {"ref": ref_cli, "port": cli}
CLOCK = 1_800_000_000.0
CHAIN = "cli-test"


def run(pkg: str, argv: list[str]) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of one in-process CLI call; the port's
    runs on the CPU."""
    if pkg == "port":
        argv = [*argv, "--device", "cpu"]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = CLIS[pkg].main(argv)
    return rc, out.getvalue(), err.getvalue()


def both(argv_of, expect_rc: int | None = 0) -> dict:
    """Run `argv_of(pkg)` through both CLIs: {pkg: (rc, out, err)}."""
    got = {pkg: run(pkg, argv_of(pkg)) for pkg in CLIS}
    if expect_rc is not None:
        for pkg, (rc, _, err) in got.items():
            assert rc == expect_rc, (pkg, err[-2000:])
    return got


def strip_home(text: str, home: str) -> str:
    return text.replace(home, "<home>")


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both CLIs through the same node life: init, start --blocks 3,
    txsim --rounds 2, tx send, tx pay-for-blob. {pkg: home}, and the
    outputs by step."""
    base = tmp_path_factory.mktemp("chain")
    homes = {pkg: str(base / pkg) for pkg in CLIS}
    steps = {
        "init": lambda pkg: ["init", "--home", homes[pkg], "--chain-id", CHAIN],
        "start": lambda pkg: ["start", "--home", homes[pkg], "--blocks", "3",
                              "--block-time", "0.05", "--listen", "0"],
        "status_after_start": lambda pkg: ["status", "--home", homes[pkg]],
        "txsim": lambda pkg: ["txsim", "--home", homes[pkg], "--rounds", "2"],
        "send": lambda pkg: ["tx", "send", "--home", homes[pkg], "--from-seed", "0",
                             "--to", "ab" * 20, "--amount", "5"],
        "pfb": lambda pkg: ["tx", "pay-for-blob", "--home", homes[pkg], "--from-seed", "1",
                            "--namespace", "01" * 5, "--data", "deadbeef" * 40],
        "query_status": lambda pkg: ["query", "--home", homes[pkg], "status"],
    }
    outputs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: CLOCK)
        for name, argv_of in steps.items():
            outputs[name] = both(argv_of)
    return homes, outputs


def without_telemetry(doc_text: str) -> dict:
    """A status document without its process-wide telemetry block (each
    package has its own registry, counting every earlier test too)."""
    doc = json.loads(doc_text)
    doc.pop("telemetry", None)
    return doc


# -- the genesis toolkit, config, keys ----------------------------------------


def test_the_gentx_ceremony_writes_the_same_files(tmp_path, fixed_clock):
    homes = {pkg: str(tmp_path / pkg) for pkg in CLIS}
    both(lambda pkg: ["init", "--home", homes[pkg], "--chain-id", "gen-test"])
    for i in range(4):
        seed = f"val-{i}"
        from celestia_app_tpu_torch.chain.crypto import PrivateKey

        addr = PrivateKey.from_seed(seed.encode()).public_key().address().hex()
        both(lambda pkg: ["genesis", "add-account", "--home", homes[pkg], "--address", addr,
                          "--balance", str(10**9 + i)])
        both(lambda pkg: ["genesis", "gentx", "--home", homes[pkg], "--seed", seed,
                          "--moniker", f"m{i}", "--power", str(5 + i)])
    got = both(lambda pkg: ["genesis", "collect-gentxs", "--home", homes[pkg]])
    assert got["ref"][1] == got["port"][1]
    got = both(lambda pkg: ["genesis", "validate", "--home", homes[pkg]])
    assert got["ref"][1] == got["port"][1] == "genesis.json is valid\n"
    for rel in ["genesis.json"] + [f"gentx/{n}" for n in sorted(os.listdir(os.path.join(homes["ref"], "gentx")))]:
        with open(os.path.join(homes["ref"], rel), "rb") as a, open(os.path.join(homes["port"], rel), "rb") as b:
            assert a.read() == b.read(), rel
    with open(os.path.join(homes["port"], "genesis.json")) as f:
        assert len(json.load(f)["validators"]) == 5


def test_the_genesis_refusals_match(tmp_path, fixed_clock):
    homes = {pkg: str(tmp_path / pkg) for pkg in CLIS}
    both(lambda pkg: ["init", "--home", homes[pkg], "--chain-id", "gen-test"])
    first = json.load(open(os.path.join(homes["port"], "genesis.json")))["accounts"][0]["address"]
    for address, balance in ((first, "1"), ("zz" * 20, "1"), ("ab" * 4, "1"), ("cd" * 20, "-3")):
        got = both(lambda pkg: ["genesis", "add-account", "--home", homes[pkg], "--address", address,
                                "--balance", balance], expect_rc=1)
        assert got["ref"][2] == got["port"][2]
    both(lambda pkg: ["genesis", "gentx", "--home", homes[pkg], "--seed", "ghost", "--power", "3"])
    got = both(lambda pkg: ["genesis", "collect-gentxs", "--home", homes[pkg]], expect_rc=1)
    assert strip_home(got["ref"][2], homes["ref"]) == strip_home(got["port"][2], homes["port"])
    for pkg in CLIS:
        path = os.path.join(homes[pkg], "genesis.json")
        genesis = json.load(open(path))
        genesis["validators"][0]["power"] = 0
        genesis["accounts"].append({"address": "ab" * 20, "balance": -5})
        json.dump(genesis, open(path, "w"))
    got = both(lambda pkg: ["genesis", "validate", "--home", homes[pkg]], expect_rc=1)
    assert got["ref"][2] == got["port"][2]


def test_config_get_and_set_match(tmp_path, fixed_clock):
    homes = {pkg: str(tmp_path / pkg) for pkg in CLIS}
    both(lambda pkg: ["init", "--home", homes[pkg], "--chain-id", "cfg-test"])
    configs = {}
    for pkg in CLIS:
        configs[pkg] = json.load(open(os.path.join(homes[pkg], "config.json")))
    assert configs["ref"].pop("engine") == "auto" and configs["port"].pop("device") == "cpu"
    assert configs["ref"] == configs["port"]
    for argv, rc in ((["config", "set", "min_gas_price", "0.004"], 0),
                     (["config", "get", "min_gas_price"], 0),
                     (["config", "set", "pack_keep", "null"], 0),
                     (["config", "set", "no_such_key", "1"], 1),
                     (["config", "get", "no_such_key"], 1),
                     (["config", "set", "min_gas_price"], 1)):
        got = both(lambda pkg: [*argv, "--home", homes[pkg]], expect_rc=rc)
        assert got["ref"][1] == got["port"][1]
        # the known-key list of the refusals names engine or device
        assert got["ref"][2].replace("engine", "device") == got["port"][2]
    whole = both(lambda pkg: ["config", "get", "--home", homes[pkg]])
    ref_doc, port_doc = json.loads(whole["ref"][1]), json.loads(whole["port"][1])
    assert ref_doc.pop("engine") == "auto" and port_doc.pop("device") == "cpu"
    assert ref_doc == port_doc and port_doc["min_gas_price"] == 0.004


@pytest.mark.parametrize("argv", [
    ["keys", "derive", "0"],
    ["keys", "derive", "validator-7"],
    ["addr-conversion", "cfec602e746588b0740e2a8e47ff44f79a68f47a"],
    ["addr-conversion", "celestia1elkxqtn5vkytqaqw928y0l6y77dx3ar65u99vh"],
])
def test_keys_and_addr_conversion_match(argv):
    got = both(lambda pkg: argv)
    assert got["ref"][1] == got["port"][1]


class _GenesisServer:
    """A localhost server for the pinned-genesis download: every GET answers
    `body`."""

    def __init__(self, body: bytes):
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                server.paths.append(self.path)
                self.send_response(200)
                self.send_header("Content-Length", str(len(server.body)))
                self.end_headers()
                self.wfile.write(server.body)

            def log_message(self, *args):
                pass

        self.body, self.paths = body, []
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_download_genesis_matches(tmp_path, monkeypatch):
    """The download goes to a localhost server: each package's transport
    is pointed there before the command runs, and any other URL fails the
    test without a request."""
    body = b'{"genesis": "pinned"}'
    server = _GenesisServer(body)
    upstream = "https://raw.githubusercontent.com/celestiaorg/networks/master/"

    def local(url, path="", payload=None, raw=False, timeout=10):
        assert url.startswith(upstream) and path == "" and raw, url
        import urllib.request

        with urllib.request.urlopen(server.url + "/" + url[len(upstream):], timeout=timeout) as r:
            return r.read()

    monkeypatch.setattr(ref_transport.DEFAULT, "request", local)
    monkeypatch.setattr(transport.DEFAULT, "request", local)
    pinned = hashlib.sha256(body).hexdigest()
    monkeypatch.setitem(ref_cli._GENESIS_SHA256, "unit-test-net", pinned)
    monkeypatch.setitem(cli._GENESIS_SHA256, "unit-test-net", pinned)
    homes = {pkg: str(tmp_path / pkg) for pkg in CLIS}
    try:
        got = both(lambda pkg: ["download-genesis", "unit-test-net", "--home", homes[pkg]])
        assert strip_home(got["ref"][1], homes["ref"]) == strip_home(got["port"][1], homes["port"])
        for pkg in CLIS:
            assert open(os.path.join(homes[pkg], "genesis.json"), "rb").read() == body
        # a verified local file is not fetched again; a wrong one is refused
        got = both(lambda pkg: ["download-genesis", "unit-test-net", "--home", homes[pkg]])
        assert server.paths == ["/unit-test-net/genesis.json"] * 2
        got = both(lambda pkg: ["download-genesis", "celestia", "--home", homes[pkg]], expect_rc=1)
        assert server.paths == ["/unit-test-net/genesis.json"] * 2
        # a fetched file with the wrong hash is removed
        server.body = b"tampered"
        got = both(lambda pkg: ["download-genesis", "mocha-4", "--home", str(tmp_path / pkg / "m")],
                   expect_rc=1)
        assert strip_home(got["ref"][2], str(tmp_path / "ref")) == strip_home(got["port"][2], str(tmp_path / "port"))
        assert not os.path.exists(tmp_path / "port" / "m" / "genesis.json")
        got = both(lambda pkg: ["download-genesis", "no-such-net", "--home", homes[pkg]], expect_rc=1)
        assert got["ref"][2] == got["port"][2]
    finally:
        server.close()


# -- one node's life ------------------------------------------------------------


def test_a_node_life_gives_the_same_chain(chain):
    homes, outputs = chain
    for step in ("start", "txsim", "send", "pfb"):
        ref_out, port_out = outputs[step]["ref"][1], outputs[step]["port"][1]
        assert ref_out == port_out, step
    for step in ("status_after_start", "query_status"):
        ref_doc = without_telemetry(outputs[step]["ref"][1])
        assert ref_doc == without_telemetry(outputs[step]["port"][1]), step
    status = without_telemetry(outputs["query_status"]["port"][1])
    assert status["height"] == 7  # 3 started, 2 txsim rounds, a send, a PFB
    txsim = json.loads(outputs["txsim"]["port"][1])
    assert txsim["pfbs_accepted"] == 4 and txsim["sends_accepted"] == 2 and txsim["blocks"] == 2
    # start's height lines name the same data roots
    roots = {pkg: [ln.split("data root ")[1] for ln in outputs["start"][pkg][2].splitlines()
                   if "data root" in ln] for pkg in CLIS}
    assert len(roots["port"]) == 3 and roots["ref"] == roots["port"]


def test_blockscan_and_blocktime_match_over_each_home(chain):
    homes, _ = chain
    scans = both(lambda pkg: ["blockscan", "--home", homes[pkg]])
    ref_rows = [json.loads(ln) for ln in scans["ref"][1].splitlines()]
    port_rows = [json.loads(ln) for ln in scans["port"][1].splitlines()]
    assert [r["height"] for r in port_rows] == list(range(1, 8))
    assert sum(r["blob_txs"] for r in port_rows) == 5
    for row in ref_rows + port_rows:
        row.pop("time_unix")
    assert ref_rows == port_rows
    times = both(lambda pkg: ["blocktime", "--home", homes[pkg], "--last", "4"])
    ref_doc, port_doc = json.loads(times["ref"][1]), json.loads(times["port"][1])
    assert set(ref_doc) == set(port_doc)
    assert (ref_doc["blocks"], ref_doc["from_height"], ref_doc["to_height"]) == \
        (port_doc["blocks"], port_doc["from_height"], port_doc["to_height"]) == (5, 3, 7)


def test_snapshot_rollback_and_export_match(chain, tmp_path, fixed_clock):
    homes, _ = chain
    snaps = {pkg: str(tmp_path / f"{pkg}-snap") for pkg in CLIS}
    got = both(lambda pkg: ["snapshot", "create", "--home", homes[pkg], "--out", snaps[pkg]])
    assert got["ref"][1] == got["port"][1]
    for name in ["manifest.json"] + sorted(n for n in os.listdir(snaps["ref"]) if n.startswith("chunk_")):
        assert open(os.path.join(snaps["ref"], name), "rb").read() == \
            open(os.path.join(snaps["port"], name), "rb").read(), name
    fresh = {pkg: str(tmp_path / f"{pkg}-fresh") for pkg in CLIS}
    both(lambda pkg: ["init", "--home", fresh[pkg], "--chain-id", CHAIN])
    for pkg in CLIS:
        with open(os.path.join(homes[pkg], "genesis.json"), "rb") as src, \
                open(os.path.join(fresh[pkg], "genesis.json"), "wb") as dst:
            dst.write(src.read())
    got = both(lambda pkg: ["snapshot", "restore", "--home", fresh[pkg], "--out", snaps[pkg]])
    assert got["ref"][1] == got["port"][1] and json.loads(got["port"][1])["restored_height"] == 7
    got = both(lambda pkg: ["export", "--home", fresh[pkg]])
    assert got["ref"][1] == got["port"][1]
    got = both(lambda pkg: ["rollback", "--home", homes[pkg], "5"])
    assert got["ref"][1] == got["port"][1] == "rolled back to height 5\n"
    got = both(lambda pkg: ["export", "--home", homes[pkg]])
    assert got["ref"][1] == got["port"][1]
    assert without_telemetry(run("port", ["status", "--home", homes["port"]])[1])["height"] == 5


# -- the port's own rules ---------------------------------------------------------


def _parser_of(pkg_cli, monkeypatch) -> argparse.ArgumentParser:
    """The parser `main` builds, caught at parse time."""
    caught = []

    def catch(self, args=None, namespace=None):
        caught.append(self)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(SystemExit):
        pkg_cli.main([])
    monkeypatch.undo()
    return caught[0]


def _commands(parser) -> dict[str, argparse.ArgumentParser]:
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                inner = _commands(sub)
                out.update({f"{name} {k}": v for k, v in inner.items()} if inner else {name: sub})
    return out


def test_the_command_set_is_the_reference_minus_the_deferred(monkeypatch):
    ref_cmds = _commands(_parser_of(ref_cli, monkeypatch))
    port_cmds = _commands(_parser_of(cli, monkeypatch))
    assert set(cli.DEFERRED) <= set(ref_cmds)
    assert cli.DEFERRED == ("relayer", "analyze")
    assert {"multihost-worker", "multihost-dryrun"} <= set(port_cmds)
    assert set(port_cmds) == set(ref_cmds) - set(cli.DEFERRED)
    for name, parser in port_cmds.items():
        flags = {opt for a in parser._actions for opt in a.option_strings}
        assert "--device" in flags, name
        assert not flags & {"--grpc", "--engine"}, name
        ref_flags = {opt for a in ref_cmds[name]._actions for opt in a.option_strings}
        assert flags == (ref_flags - {"--grpc", "--engine"}) | {"--device"}, name


def test_a_native_segment_home_is_refused(tmp_path):
    home = str(tmp_path / "home")
    assert run("port", ["init", "--home", home, "--chain-id", CHAIN])[0] == 0
    os.makedirs(os.path.join(home, "data"))
    open(os.path.join(home, "data", "seg-00000000.log"), "wb").close()
    for argv in (["blockscan"], ["blocktime"], ["status"], ["export"], ["start", "--blocks", "1"]):
        with pytest.raises(NotImplementedError, match="native"):
            run("port", [*argv, "--home", home])


def test_without_a_card_every_command_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    home = str(tmp_path / "home")
    for argv in (["keys", "derive", "0"], ["init", "--home", home], ["da-serve", "--listen", "0"],
                 ["devnet", "--home", home, "--blocks", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert not os.path.exists(home)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["init", "--home", home, "--device", "cuda"])
    assert run("port", ["init", "--home", home])[0] == 0
    # a home written for the CPU runs there without the flag; a home with
    # no device key (the reference's) is a card home
    assert cli.main(["status", "--home", home]) == 0
    cfg_path = os.path.join(home, "config.json")
    cfg = json.load(open(cfg_path))
    cfg["engine"] = cfg.pop("device")
    json.dump(cfg, open(cfg_path, "w"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["status", "--home", home])


def test_device_mesh_is_the_card_with_the_mesh_plane(tmp_path, monkeypatch):
    """``--device mesh`` (the reference's ``--engine mesh``) needs a card,
    runs on it, and gives the App a mesh over every visible card, none on a
    one-card host; ``init`` records it."""
    from celestia_app_tpu_torch.parallel import mesh as mesh_mod

    assert cli._torch_device("mesh") == "cuda" and cli._torch_device("cpu") == "cpu"
    assert cli._mesh_of("cpu") is None
    monkeypatch.setattr(mesh_mod, "visible_cards", lambda: [torch.device("cpu")] * 2)
    assert cli._mesh_of("mesh").shape == {"data": 1, "seq": 2}
    monkeypatch.setattr(mesh_mod, "visible_cards", lambda: [torch.device("cpu")])
    assert cli._mesh_of("mesh") is None
    home = str(tmp_path / "home")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device for --device mesh"):
            cli.main(["init", "--home", home, "--device", "mesh"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # resolve only; init touches no card
    assert cli.main(["init", "--home", home, "--chain-id", CHAIN, "--device", "mesh"]) == 0
    assert json.load(open(os.path.join(home, "config.json")))["device"] == "mesh"


def test_multihost_dryrun_command():
    """``multihost-dryrun`` on the CPU: two gloo worker processes of two
    seq shards each, every host matching the one-device pipeline."""
    rc, out, err = run("port", ["multihost-dryrun", "--processes", "2", "--devices-per-host", "2",
                                "--k", "4", "--batch", "2"])
    assert rc == 0, err[-2000:]
    doc = json.loads(out.strip().splitlines()[-1])
    assert (doc["global_devices"], doc["mesh"], doc["device"]) == (4, {"data": 1, "seq": 4}, "cpu")
    assert doc["all_hosts_match_oracle"] is True
