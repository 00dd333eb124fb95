"""The port's scenario plane (sim/engine.py, sim/scenarios.py) against the
JAX package's (tolerance: exact).

tests/test_scenarios.py's and tests/test_scenario_plane.py's cases, at
their sizes: every spec runs through both packages' ``run_scenario`` (the
port's on ``device="cpu"``) and the two verdicts must be byte-equal through
``verdict_bytes`` — per-height block and app hashes, the event-trace
digest, detections, halts, recovery and every op's block — before the
reference's own assertions are held against the port's verdict. So the
port's validators commit the reference's chain, its light fleet samples,
escalates and condemns as the reference's does, and both stay
deterministic per seed. The big sweeps and the fleet-scale cell mirror the
reference's slow tier."""

from __future__ import annotations

import numpy as np
import pytest

from celestia_app_tpu.sim import scenarios as ref
from celestia_app_tpu_torch.sim import run_scenario, scenario_spec
from celestia_app_tpu_torch.sim.scenarios import SCENARIOS, verdict_bytes
from celestia_app_tpu_torch.utils import telemetry

SCHEMES = ("rs2d-nmt", "cmt-ldpc", "pcmt-polar")


@pytest.fixture(autouse=True)
def _fault_registries_kept():
    """A spec's `faults` arm and fire each package's process-wide fault
    registry (a run disarms what it armed, but the fired counts and the
    next fault id stay). Each test leaves both registries as it found
    them: later files in the same worker compare the two packages'
    /faults documents."""
    from celestia_app_tpu import faults as ref_faults
    from celestia_app_tpu_torch import faults as port_faults

    registries = (ref_faults.REGISTRY, port_faults.REGISTRY)
    kept = [(dict(r._specs), r._next_id, r._rng.getstate(), dict(r._fired)) for r in registries]
    yield
    for r, (specs, next_id, rng, fired) in zip(registries, kept):
        with r._lock:
            r._specs, r._next_id, r._fired = specs, next_id, fired
            r._rng.setstate(rng)


def _both(doc: dict, tmp_path, sub: str) -> dict:
    """The port's verdict of `doc`, after requiring it byte-equal to the
    reference's."""
    want = ref.run_scenario(dict(doc), workdir=str(tmp_path / f"{sub}-ref"))
    got = run_scenario(dict(doc), workdir=str(tmp_path / f"{sub}-port"), device="cpu")
    assert verdict_bytes(got) == ref.verdict_bytes(want), \
        {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k] and k != "peak_rss_bytes"}
    return got


def _run(name: str, tmp_path, sub: str = "w", **over) -> dict:
    return _both(scenario_spec(name, **over), tmp_path, sub)


# -- determinism (the acceptance matrix) ------------------------------------


def test_scenario_matrix_determinism_at_scale(tmp_path):
    """8 validators + 64 light nodes, twice with one seed: byte-identical
    verdicts, and the reference's."""
    doc = scenario_spec("honest", seed=42, validators=8, light_nodes=64, heights=6)
    v1 = _both(doc, tmp_path, "run1")
    v2 = run_scenario(dict(doc), workdir=str(tmp_path / "run2"), device="cpu")
    assert v1["validators"] >= 8 and v1["light_nodes"] >= 64
    assert v1["heights_committed"] == 6
    assert len(v1["block_hashes"]) == 6 and len(v1["app_hashes"]) == 6
    assert verdict_bytes(v1) == verdict_bytes(v2)


def test_different_seeds_reorder_but_never_perturb_consensus(tmp_path):
    base = dict(validators=4, light_nodes=8, heights=4)
    v_a = _run("honest", tmp_path, "a", seed=1, **base)
    v_b = _run("honest", tmp_path, "b", seed=2, **base)
    assert v_a["trace_digest"] != v_b["trace_digest"]
    assert v_a["block_hashes"] == v_b["block_hashes"]
    assert v_a["app_hashes"] == v_b["app_hashes"]


# -- false condemnation ------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_honest_chain_records_zero_false_condemnations(tmp_path, scheme):
    before = telemetry.snapshot().get("counters", {}).get("light.malformed_fraud_proofs", 0)
    v = _run("honest", tmp_path, scheme, scheme=scheme, validators=4, light_nodes=16, heights=4)
    after = telemetry.snapshot().get("counters", {}).get("light.malformed_fraud_proofs", 0)
    assert v["false_condemnation_rate"] == 0
    assert v["light_halts"] == 0
    assert v["heights_committed"] == 4
    assert after - before == 0


# -- withholding at the recoverability threshold ----------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_withholding_at_threshold_is_detected(tmp_path, scheme):
    v = _run("withhold-threshold", tmp_path, scheme, scheme=scheme, validators=4, light_nodes=12, heights=4)
    assert v["blocks_to_detection"] is not None
    assert v["unavailable_reports"] >= 1
    # availability is NOT validity: withholding condemns nothing
    assert v["light_halts"] == 0
    assert v["false_condemnation_rate"] == 0
    assert v["heights_committed"] == 4


# -- committed incorrect coding -> verified fraud proof ---------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_incorrect_coding_escalates_to_condemnation(tmp_path, scheme):
    v = _run("incorrect-coding", tmp_path, scheme, scheme=scheme, validators=4, light_nodes=12, heights=3)
    assert v["blocks_to_detection"] is not None
    assert v["light_halts"] >= 1  # fraud-proof-verified halts
    # every halt is AT the forged height: none of them is false
    assert v["false_condemnation_rate"] == 0


# -- liveness, churn, recovery ----------------------------------------------


def test_partition_heals_and_minority_catches_up(tmp_path):
    v = _run("partition-churn", tmp_path, validators=4, light_nodes=8, heights=4)
    assert v["heights_committed"] == 4  # majority stayed live
    assert v["dropped_msgs"] > 0  # the cut really cut
    assert v["recovery_s"] is not None  # commits resumed after heal
    assert v["false_condemnation_rate"] == 0


def test_lazy_validator_rotates_and_chain_stays_live(tmp_path):
    v = _run("lazy-validator", tmp_path, validators=4, light_nodes=8, heights=4)
    assert v["heights_committed"] == 4
    # its slots cost a propose timeout, visible as the liveness gap
    assert v["liveness_gap_s"] >= 2.0
    assert v["false_condemnation_rate"] == 0


def test_spam_flood_never_stalls_commits(tmp_path):
    v = _run("spam-flood", tmp_path, validators=4, light_nodes=8, heights=4)
    assert v["heights_committed"] == 4
    assert v["liveness_gap_s"] < 2.0  # junk admission cannot gate rounds
    assert v["false_condemnation_rate"] == 0


def test_statesync_join_under_load_reaches_head(tmp_path):
    v = _run("statesync-join", tmp_path, validators=4, light_nodes=8, heights=4)
    assert v["heights_committed"] == 4
    assert v["recovery_s"] is not None  # the joiner reached the head
    assert v["false_condemnation_rate"] == 0


def test_crash_storm_revives_and_catches_up(tmp_path):
    v = _run("crash-storm", tmp_path, validators=4, light_nodes=8, heights=4)
    assert v["heights_committed"] == 4
    assert v["false_condemnation_rate"] == 0


def test_flaky_network_faults_are_seeded_and_absorbed(tmp_path):
    """Probabilistic net.request drops (the port's fault registry, reseeded
    to the scenario seed) replay exactly: two same-seed runs are
    byte-identical, and equal to the reference's."""
    from celestia_app_tpu_torch import faults as faults_mod

    doc = scenario_spec("flaky-network", seed=5, validators=4, light_nodes=8, heights=4)
    armed_before = faults_mod.REGISTRY.armed_count()
    fired_before = faults_mod.snapshot()["fired"].get("net.request", 0)
    v1 = _both(doc, tmp_path, "f1")
    fired = faults_mod.snapshot()["fired"].get("net.request", 0)
    v2 = run_scenario(dict(doc), workdir=str(tmp_path / "f2"), device="cpu")
    assert fired > fired_before  # the arm really dropped requests
    assert verdict_bytes(v1) == verdict_bytes(v2)
    assert v1["heights_committed"] == 4
    assert v1["false_condemnation_rate"] == 0
    # scenario arms are scoped to the run: disarmed afterwards
    assert faults_mod.REGISTRY.armed_count() == armed_before


def test_eclipsed_lights_detect_their_captors_withholding(tmp_path):
    v = _run("eclipse", tmp_path, validators=4, light_nodes=8, heights=4)
    assert v["unavailable_reports"] >= 1  # the eclipsed slice noticed
    assert v["light_halts"] == 0
    assert v["heights_committed"] == 4


# -- spec hygiene -----------------------------------------------------------


def test_spec_rejects_unknown_keys_and_ops(tmp_path):
    with pytest.raises(ValueError, match="unknown scenario spec keys"):
        run_scenario({"name": "x", "bogus_knob": 1}, device="cpu")
    with pytest.raises(ValueError, match="unknown scenario op"):
        run_scenario({"name": "x", "validators": 2, "light_nodes": 1, "heights": 1,
                      "ops": [{"op": "meteor_strike"}]}, workdir=str(tmp_path / "x"), device="cpu")
    with pytest.raises(ValueError, match="unknown scenario"):
        scenario_spec("no-such-scenario")
    with pytest.raises(ValueError, match="unknown asym_fault kind"):
        run_scenario({"name": "x", "validators": 2, "light_nodes": 1, "heights": 1,
                      "ops": [{"op": "asym_fault", "kind": "reorder"}]},
                     workdir=str(tmp_path / "y"), device="cpu")


def test_library_matches_the_reference():
    need = {"honest", "withhold-threshold", "incorrect-coding", "partition-churn", "lazy-validator",
            "spam-flood", "eclipse", "crash-storm", "statesync-join"}
    assert need <= set(SCENARIOS)
    assert set(SCENARIOS) == set(ref.SCENARIOS)
    for name, (desc, _builder) in SCENARIOS.items():
        assert desc == ref.SCENARIOS[name][0]
        for scheme in SCHEMES:
            assert scenario_spec(name, scheme, 3) == ref.scenario_spec(name, scheme, 3)


# -- the network-scale plane (tests/test_scenario_plane.py) ------------------


@pytest.mark.parametrize("scheme", ["rs2d-nmt", "cmt-ldpc"])
@pytest.mark.parametrize("job_size", [1, 4])
def test_continuation_sweep_equals_threaded_sync(chains, tmp_path, scheme, job_size):
    """Two same-seed port DASers over one port NodeService: the threaded
    sync() driver and a bare begin_sweep()/step() loop give identical
    reports, checkpoints and summaries, and a reference DASer stepped
    the same way over the same service gives them too."""
    from test_torch_app import Pkg
    from test_torch_daser import daser, store

    port, refp = Pkg("port"), Pkg("ref")
    c = chains("port", blocks=3, scheme=None if scheme == "rs2d-nmt" else scheme, pfbs=False)

    def make(p, tag):
        cfg = p.mod("das.daser").DASerConfig(samples_per_header=4, workers=1, job_size=job_size, retries=2,
                                             backoff=0.01)
        return daser(p, [c.url], c.light(p), store(p, tmp_path / tag / "cp.json"), cfg=cfg,
                     rng=np.random.default_rng(7), name=tag)

    def stepped(d):
        cont = d.begin_sweep()
        steps = 0
        while cont.step():
            steps += 1
            assert steps < 10_000, "continuation failed to terminate"
        assert cont.done
        return cont.summary

    threaded = make(port, "threaded")
    out_threaded = threaded.sync()
    mine, theirs = make(port, "stepped"), make(refp, "ref-stepped")
    assert out_threaded == stepped(mine) == stepped(theirs)
    assert out_threaded["head"] == 3
    assert threaded.reports == mine.reports == theirs.reports
    assert threaded.reports[1]["status"] == "sampled"
    assert (threaded.store.load().to_json() == mine.store.load().to_json()
            == theirs.store.load().to_json())
    # a second sweep from the carried checkpoint is a no-op on both
    out2 = threaded.sync()
    assert out2 == stepped(mine)
    assert out2["sampled"] == []


@pytest.fixture
def chains():
    from test_torch_daser import Served, shared_chain

    made = []

    def make(which, **kw):
        made.append(Served(shared_chain(which, **kw)))
        return made[-1]

    yield make
    for s in made:
        s.svc.shutdown()


def test_spam_flood_rejected_by_real_admission(tmp_path):
    doc = scenario_spec("spam-flood", "rs2d-nmt", 0, validators=4, light_nodes=8)
    v = _both(doc, tmp_path, "spam")
    assert v["spam"]["sent"] > 0
    assert v["spam"]["admitted"] == 0
    assert v["spam"]["rejected"] == v["spam"]["sent"]
    assert v["spam"]["pool_rejected"] >= v["spam"]["sent"]
    assert v["heights_committed"] == doc["heights"]
    assert v["light_halts"] == 0


def test_long_soak_cycles_resources_and_matches(tmp_path):
    """The compressed long-soak cell: seeded PFB lanes, asymmetric corrupt
    and delay faults on the light fleet, every tracked resource cycling
    >= 2x, no false condemnation — and the verdict byte-equal to the
    reference's (whose own test runs it twice for determinism)."""
    doc = scenario_spec(
        "long-soak", "rs2d-nmt", 0, validators=4, light_nodes=8, heights=14,
        ops=[
            {"op": "traffic", "t": 0.8, "every": 0.9, "sequences": 2},
            {"op": "asym_fault", "kind": "corrupt", "src": "light", "prob": 0.2},
            {"op": "asym_fault", "kind": "delay", "src": "light", "prob": 0.15, "delay": 0.05},
            {"op": "soak", "eds_entries": 2, "sig_cache": 12, "commitment_cache": 8, "ttl_blocks": 2,
             "expire_every": 0.9, "snapshot_every": 3, "snapshot_keep": 2, "pack_every": 2,
             "pack_keep": 2, "stale_every": 0.6},
        ])
    v1 = _both(doc, tmp_path, "soak")
    soak = v1["soak"]
    for resource in ("eds_evictions", "sig_evictions", "commitment_evictions", "mempool_expired",
                     "snapshot_writes", "pack_builds"):
        assert soak[resource] >= 2, (resource, soak)
    assert soak["snapshot_prunes"] >= 2
    assert soak["pack_prunes"] >= 2
    assert v1["asym_msgs"].get("corrupt", 0) > 0
    assert v1["asym_msgs"].get("delay", 0) > 0
    assert v1["traffic"]["accepted"] > 0
    assert v1["traffic"]["confirmed"] > 0
    assert v1["false_condemnation_rate"] == 0.0
    assert v1["light_halts"] == 0
    assert v1["heights_committed"] == 14
    assert v1["sim_lights"] == 8
    assert v1["sim_virtual_blocks"] == 14
    assert v1["peak_rss_bytes"] > 0


def test_asym_drop_faults_are_deterministic_and_survivable(tmp_path):
    def doc(seed):
        return scenario_spec("honest", "rs2d-nmt", seed, validators=4, light_nodes=8, heights=4,
                             ops=[{"op": "asym_fault", "kind": "drop", "src": "light", "prob": 0.2}])

    v1 = _both(doc(3), tmp_path, "s3")
    assert v1["asym_msgs"].get("drop", 0) > 0
    assert v1["light_halts"] == 0
    assert v1["false_condemnation_rate"] == 0.0
    assert v1["heights_committed"] == 4
    v2 = run_scenario(doc(3), workdir=str(tmp_path / "s3-again"), device="cpu")
    assert verdict_bytes(v1) == verdict_bytes(v2)
    # a different seed reorders the world: same survivability verdict,
    # different event tape
    v3 = run_scenario(doc(4), workdir=str(tmp_path / "s4"), device="cpu")
    assert v3["light_halts"] == 0
    assert v3["trace_digest"] != v1["trace_digest"]


def test_slo_op_matches_the_reference(tmp_path):
    """The slo op (tools/fleetmon over the run's telemetry delta). Both
    packages judge the in-process node dark: the op hands evaluate() the
    metric families themselves where a node's {"metrics": ...} is read
    (sim/scenarios.py _install_slo), so every rule observes null. The port
    keeps the reference's bytes; the same delta wrapped as a node passes."""
    from celestia_app_tpu_torch.tools import fleetmon

    rules = [{"name": "no-500s", "metric": "http.500", "op": "==", "value": 0},
             {"name": "sampled", "metric": "daser.requests", "op": ">", "value": 0}]
    base = telemetry.export()
    v = _run("honest", tmp_path, "slo", validators=4, light_nodes=4, heights=3,
             ops=[{"op": "slo", "rules": rules}])
    assert v["slo"]["dark_nodes"] == ["sim"] and v["slo"]["failed"] == ["no-500s", "sampled"]
    node = {"metrics": fleetmon.registry_node(base=base)}
    judged = fleetmon.evaluate(fleetmon.normalize_rules(rules), {"nodes": {"sim": node}})
    assert judged["pass"] is True and judged["dark_nodes"] == []


# -- the big sweeps (slow tier, as the reference marks its own) --------------


@pytest.mark.slow
def test_big_sweep_hundreds_of_lights(tmp_path):
    for scheme in SCHEMES[:2]:
        v = _run("withhold-threshold", tmp_path, f"big-{scheme}", scheme=scheme, seed=7, validators=10,
                 light_nodes=192, heights=8)
        assert v["heights_committed"] == 8
        assert v["blocks_to_detection"] is not None
        assert v["false_condemnation_rate"] == 0
    v = _run("crash-storm", tmp_path, "big-crash", validators=10, light_nodes=128, heights=8)
    assert v["heights_committed"] == 8
    assert v["false_condemnation_rate"] == 0


@pytest.mark.slow
def test_big_sweep_determinism(tmp_path):
    doc = scenario_spec("crash-storm", seed=3, validators=10, light_nodes=128, heights=8)
    v1 = _both(doc, tmp_path, "r1")
    v2 = run_scenario(dict(doc), workdir=str(tmp_path / "r2"), device="cpu")
    assert verdict_bytes(v1) == verdict_bytes(v2)


@pytest.mark.slow
def test_fleet_scale_1000_lights_1000_blocks_byte_identical(tmp_path):
    doc = scenario_spec("fleet-scale", "rs2d-nmt", 0)
    v1 = _both(doc, tmp_path, "fleet1")
    assert v1["sim_lights"] == 1000
    assert v1["sim_virtual_blocks"] >= 1000
    assert v1["light_halts"] == 0
    assert v1["false_condemnation_rate"] == 0.0
    assert v1["peak_rss_bytes"] < 4 * 2**30, v1["peak_rss_bytes"]
    v2 = run_scenario(dict(doc), workdir=str(tmp_path / "fleet2"), device="cpu")
    assert verdict_bytes(v1) == verdict_bytes(v2)
