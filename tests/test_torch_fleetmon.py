"""The port's fleet-wide SLO verdict engine (tools/fleetmon.py) against the
JAX package's (tolerance: exact).

The same exposition text, registry activity, scraped documents and rule
files go through both packages: the parsed metric families, the
normalized rules, the rule-file errors, the verdicts and their canonical
bytes must be equal. Both modules are host code."""

from __future__ import annotations

import json

import pytest

from celestia_app_tpu.tools import fleetmon as ref
from celestia_app_tpu.utils import telemetry as ref_telemetry
from celestia_app_tpu_torch.tools import fleetmon as port
from celestia_app_tpu_torch.utils import telemetry as port_telemetry

RULES = {"slo": [
    {"name": "no-500s", "metric": "http.500", "op": "==", "value": 0},
    {"name": "served", "metric": "das.samples_served", "op": ">=", "value": 3, "agg": "sum"},
    {"name": "served-max", "metric": "das.samples_served", "op": "<=", "value": 100, "agg": "max"},
    {"name": "row-route", "metric": "http.requests", "labels": {"route": "/das/sample"}, "op": ">", "value": 0},
    {"name": "open-breakers", "metric": "net.breakers_open", "kind": "gauge", "op": "<=", "value": 1,
     "agg": "min"},
    {"name": "p99-sample", "metric": "das.sample_batch", "kind": "p99", "op": "<", "value": 0.5},
    {"name": "p50-sample", "metric": "das.sample_batch", "kind": "p50", "op": "<", "value": 0.5},
    {"name": "sample-count", "metric": "das.sample_batch", "kind": "count", "op": "==", "value": 4},
    {"name": "sample-sum", "metric": "das.sample_batch", "kind": "sum", "op": "<", "value": 1},
    {"name": "sample-max", "metric": "das.sample_batch", "kind": "max", "op": "<", "value": 1},
    {"name": "height", "source": "status", "path": "reactor.height", "op": ">=", "value": 3},
    {"name": "served-cells", "source": "availability", "path": "served", "op": ">", "value": 0},
]}

MALFORMED = (
    [],                                        # empty
    {"slo": "x"},                              # not a list
    [{"metric": "x"}],                         # no name
    ["rule"],                                  # not a dict
    [{"name": "a", "op": "~="}],               # bad op
    [{"name": "a", "agg": "median"}],          # bad agg
    [{"name": "a", "source": "logs"}],         # bad source
    [{"name": "a", "metric": "m", "kind": "p42"}],  # bad kind
    [{"name": "a"}],                           # metrics rule without metric
    [{"name": "a", "source": "status"}],       # status needs path
    [{"name": "a", "metric": "m", "value": "zero"}],  # non-numeric
    [{"name": "a", "metric": "m", "value": True}],    # a bool is no number
    [{"name": "a", "metric": "m", "labels": ["x"]}],  # labels not a dict
)


def exposition(telemetry, served: int, p: float) -> str:
    """A Prometheus text exposition from a fresh registry of `telemetry`."""
    reg = telemetry.Registry()
    reg.incr("http.500", 0)
    reg.incr("das.samples_served", served)
    reg.incr("http.requests", 2, labels={"route": "/das/sample"})
    reg.incr("http.requests", 5, labels={"route": "/das/header"})
    reg.gauge("net.breakers_open", 1)
    for dt in (0.001 * p, 0.004 * p, 0.02 * p, 0.3 * p):
        reg.observe("das.sample_batch", dt)
    reg.observe("das.sample_batch", 0.002, labels={"axis": "col"})
    return reg.prometheus()


class Client:
    """A scrape client with canned documents (the PeerClient surface
    `scrape_node` reads)."""

    def __init__(self, docs: dict):
        self.docs = docs

    def get(self, url: str, path: str, raw: bool = False):
        got = self.docs[url].get(path)
        if got is None:
            raise OSError(f"{url}{path}: refused")
        return got


def fleet_docs() -> dict:
    text = exposition(port_telemetry, 3, 1.0)
    return {
        "sim://a": {"/metrics": text.encode(), "/consensus/status": {"height": 4, "reactor": {"height": 4}},
                    "/das/availability?height=4": {"served": 12}},
        "sim://b": {"/metrics": exposition(port_telemetry, 9, 2.0).encode(), "/status": {"height": 2},
                    "/das/availability?height=2": {"served": 0}},
        "sim://dark": {},
    }


def test_exposition_texts_are_equal():
    assert exposition(port_telemetry, 3, 1.0) == exposition(ref_telemetry, 3, 1.0)


@pytest.mark.parametrize("served,p", [(0, 1.0), (3, 1.0), (9, 2.0), (12345, 0.01)])
def test_parse_prometheus_matches(served, p):
    text = exposition(port_telemetry, served, p)
    got = port.parse_prometheus(text)
    assert got == ref.parse_prometheus(text)
    assert got["counter"]["das_samples_served"] == {"": float(served)}
    assert sum(got["hist"]["das_sample_batch"]['axis="col"']["buckets"]) == 1
    # another prefix reads nothing
    assert port.parse_prometheus(text, prefix="other") == ref.parse_prometheus(text, prefix="other")


def test_registry_node_delta_matches():
    """The same activity on each package's process registry: the deltas
    since a baseline export are equal."""
    bases = (port_telemetry.export(), ref_telemetry.export())
    for telemetry in (port_telemetry, ref_telemetry):
        telemetry.incr("fleetmon.test_counter", 3)
        telemetry.incr("fleetmon.test_labeled", 2, labels={"peer": "a"})
        telemetry.gauge("fleetmon.test_gauge", 7.5)
        telemetry.observe("fleetmon.test_timer", 0.004)
    got = port.registry_node(base=bases[0])
    want = ref.registry_node(base=bases[1])

    def ours(node: dict) -> dict:
        return {kind: {fam: cells for fam, cells in fams.items() if fam.startswith("fleetmon_test")}
                for kind, fams in node.items()}

    assert ours(got) == ours(want)
    assert ours(got)["counter"]["fleetmon_test_counter"] == {"": 3.0}
    assert ours(got)["hist"]["fleetmon_test_timer"][""]["count"] == 1


def test_normalize_rules_matches():
    assert port.normalize_rules(RULES) == ref.normalize_rules(RULES)
    assert port.normalize_rules(RULES["slo"]) == ref.normalize_rules(RULES["slo"])


@pytest.mark.parametrize("doc", MALFORMED, ids=range(len(MALFORMED)))
def test_malformed_rule_files_fail_alike(doc):
    with pytest.raises(ValueError) as got:
        port.normalize_rules(doc)
    with pytest.raises(ValueError) as want:
        ref.normalize_rules(doc)
    assert str(got.value) == str(want.value)


def test_scrape_and_evaluate_match():
    """A fleet of two scraped nodes and a dark one, judged by every rule
    kind, source and aggregate: equal fleets, verdicts and bytes."""
    urls = ["sim://a", "sim://b/", "sim://dark"]
    got_fleet = port.scrape_fleet(urls, client=Client(fleet_docs()))
    want_fleet = ref.scrape_fleet(urls, client=Client(fleet_docs()))
    assert got_fleet == want_fleet
    assert got_fleet["nodes"]["sim://dark"] == {"metrics": None, "status": None, "availability": None,
                                                "error": "OSError"}
    rules = port.normalize_rules(RULES)
    got = port.evaluate(rules, got_fleet)
    want = ref.evaluate(ref.normalize_rules(RULES), want_fleet)
    assert port.verdict_bytes(got) == ref.verdict_bytes(want)
    assert got["dark_nodes"] == ["sim://dark"] and got["pass"] is False
    # without the dark node the aggregate rules see both live nodes
    live = {"nodes": {u: n for u, n in got_fleet["nodes"].items() if u != "sim://dark"}}
    got_live = port.evaluate(rules, live)
    assert port.verdict_bytes(got_live) == ref.verdict_bytes(ref.evaluate(ref.normalize_rules(RULES), live))
    assert {r["name"]: r["pass"] for r in got_live["rules"]}["served"] is True
    assert port.evaluate(rules, {"nodes": {}})["pass"] is False


def test_cli_exit_codes_match(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"slo": [{"name": "a", "op": "~="}]}))
    assert port.main(["--nodes", "sim://x", "--rules", str(bad)]) == 1
    assert ref.main(["--nodes", "sim://x", "--rules", str(bad)]) == 1
    assert port.main(["--nodes", "sim://x", "--rules", str(tmp_path / "missing.json")]) == 1
    capsys.readouterr()
