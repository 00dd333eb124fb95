"""The port's scenario-plane foundations (sim/scheduler.py and the clocks the
library loops read) against the JAX package's, and the port's kernel-fault
contract inside a simulation.

tests/test_sim_engine.py's cases run on the port: the seeded scheduler's
ordering, trace and event bound (the port's trace digests equal the
reference's for the same schedule), the virtual-clock reactor, transport
breaker, PeerSet backoff, DASer and mempool cases. Then the contract the
reference has no counterpart of: a K1 or K2 wrapper error
(``cuda_build.KernelError``) raised in a simulated validator or light node
propagates out of ``run_scenario`` as itself — never a ``SampleError``, an
``unavailable`` report, a halted light or a failed round. The port runs on
``device="cpu"``."""

from __future__ import annotations

import sys
import threading
import time

import pytest

from celestia_app_tpu.sim.scheduler import Scheduler as RefScheduler
from celestia_app_tpu_torch import cuda_build
from celestia_app_tpu_torch.ops import rs_kernel, sha256_kernel
from celestia_app_tpu_torch.sim import scenarios
from celestia_app_tpu_torch.sim.scheduler import Scheduler
from celestia_app_tpu_torch.utils.clock import SYSTEM, SystemClock, VirtualClock

# -- the clock abstraction --------------------------------------------------


def test_virtual_clock_semantics():
    clk = VirtualClock(epoch=1_700_000_000.0)
    assert clk.monotonic() == 0.0
    assert clk.now() == 1_700_000_000.0
    clk.sleep(2.5)
    assert clk.monotonic() == 2.5
    assert clk.now() == 1_700_000_002.5
    clk.sleep(-1.0)  # negative sleeps are no-ops, never rewinds
    assert clk.monotonic() == 2.5
    clk.advance_to(1.0)  # never backwards
    assert clk.monotonic() == 2.5
    clk.advance_to(10.0)
    assert clk.monotonic() == 10.0


def test_virtual_clock_wait_resolves_against_virtual_time():
    clk = VirtualClock()
    ev = threading.Event()
    t0 = time.monotonic()
    assert clk.wait(ev, 3600.0) is False  # an hour of chain time...
    assert time.monotonic() - t0 < 1.0  # ...in real milliseconds
    assert clk.monotonic() == 3600.0
    ev.set()
    assert clk.wait(ev, 10.0) is True
    assert clk.monotonic() == 3600.0  # a set event costs no virtual time


def test_system_clock_wait_is_interruptible():
    ev = threading.Event()
    threading.Timer(0.05, ev.set).start()
    t0 = time.monotonic()
    assert SystemClock().wait(ev, 30.0) is True
    assert time.monotonic() - t0 < 5.0  # woke on the event, not timeout


# -- the seeded scheduler ---------------------------------------------------


def _ordering(cls, seed: int) -> tuple[list[str], str]:
    sched = cls(seed)
    out: list[str] = []
    for name in "abcdefgh":
        # all at the same instant: order is decided by the seeded
        # tiebreak alone
        sched.call_at(1.0, lambda n=name: out.append(n), f"ev.{name}")
    sched.run(until=2.0)
    return out, sched.trace_digest()


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_seeded_ordering_matches_the_reference(seed):
    assert _ordering(Scheduler, seed) == _ordering(Scheduler, seed)
    assert _ordering(Scheduler, seed) == _ordering(RefScheduler, seed)


def test_scheduler_seeded_ordering_is_deterministic():
    orders = {tuple(_ordering(Scheduler, s)[0]) for s in range(6)}
    assert len(orders) > 1  # different seeds explore different orders


def _trace_run(cls):
    sched = cls(0)
    seen = []
    sched.call_after(1.0, lambda: seen.append(sched.clock.monotonic()), "one")
    sched.call_after(0.25, lambda: sched.call_after(
        0.25, lambda: seen.append(sched.clock.monotonic()), "inner"), "outer")
    sched.note("noted")
    sched.run(until=10.0)
    return sched, seen


def test_scheduler_trace_and_time():
    sched, seen = _trace_run(Scheduler)
    assert seen == [0.5, 1.0]
    assert [label for _t, label in sched.trace] == ["noted", "outer", "inner", "one"]
    assert sched.trace_digest() == sched.trace_digest()
    assert sched.clock.monotonic() == 10.0
    ref, ref_seen = _trace_run(RefScheduler)
    assert (seen, sched.trace, sched.trace_digest()) == (ref_seen, ref.trace, ref.trace_digest())


def test_scheduler_trace_keep_bounds_rows_not_the_digest():
    def run(cls, keep: int):
        sched = cls(3)
        sched.trace_keep = keep
        for i in range(100):
            sched.call_at(i * 0.01, lambda: None, f"ev{i}")
        sched.run(until=5.0)
        return sched

    kept, full = run(Scheduler, 10), run(Scheduler, 0)
    assert len(kept.trace) <= 20 and len(full.trace) == 100
    assert kept.trace_digest() == full.trace_digest() == run(RefScheduler, 10).trace_digest()


def test_scheduler_event_bound_trips():
    sched = Scheduler(0)

    def feedback():
        sched.call_after(0.001, feedback, "loop")

    sched.call_at(0.0, feedback, "loop")
    with pytest.raises(RuntimeError, match="exceeded"):
        sched.run(until=1e9, max_events=500)


def test_scheduler_landing_on_the_bound_is_no_runaway():
    sched = Scheduler(0)
    for i in range(5):
        sched.call_at(float(i), lambda: None, "ev")
    sched.run(until=100.0, max_events=5)  # drained exactly at the bound
    assert sched.executed == 5


# -- reactor: interruptible waits -------------------------------------------


def _one_validator_reactor(tmp_path, poll: float, block_interval: float):
    from celestia_app_tpu_torch.chain import consensus as c
    from celestia_app_tpu_torch.chain.crypto import PrivateKey
    from celestia_app_tpu_torch.chain.reactor import ConsensusReactor, ReactorConfig

    priv = PrivateKey.from_seed(b"sim-engine-reactor")
    genesis = {
        "time_unix": 1_700_000_000.0,
        "accounts": [{"address": priv.public_key().address().hex(),
                      "balance": 10**12}],
        "validators": [{"operator": priv.public_key().address().hex(),
                        "power": 10,
                        "pubkey": priv.public_key().compressed.hex()}],
    }
    vnode = c.ValidatorNode("solo", priv, genesis, "sim-reactor-test",
                            data_dir=str(tmp_path / "solo"), device="cpu")
    cfg = ReactorConfig(poll=poll, block_interval=block_interval,
                        timeout_propose=poll * 2, timeout_prevote=poll,
                        timeout_precommit=poll)
    return vnode, ConsensusReactor(vnode, [], threading.Lock(), cfg)


def test_reactor_stop_does_not_block_on_sleeps(tmp_path):
    """stop() returns the moment _stop is set, not after the 30 s
    inter-height pause or a 5 s poll wait."""
    vnode, reactor = _one_validator_reactor(tmp_path, poll=5.0, block_interval=30.0)
    reactor.start()
    try:
        deadline = time.monotonic() + 60.0
        while vnode.app.height < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert vnode.app.height >= 1, "solo validator never committed"
    finally:
        t0 = time.monotonic()
        reactor.stop()
        elapsed = time.monotonic() - t0
        vnode.app.da_warmer.wait_idle(60)
        vnode.app.close()
    assert elapsed < 3.0, f"stop() blocked {elapsed:.1f}s behind a sleep"


def test_reactor_defaults_to_system_clock(tmp_path):
    vnode, reactor = _one_validator_reactor(tmp_path, 0.02, 0.05)
    assert reactor.clock is SYSTEM
    assert reactor.net.clock is SYSTEM  # handed down to the transport
    vnode.app.close()


# -- transport breaker + backoff on an injected clock -----------------------


def test_breaker_timers_run_on_the_injected_clock():
    from celestia_app_tpu_torch.net.transport import PeerClient, TransportConfig

    clk = VirtualClock()
    pc = PeerClient(TransportConfig(failure_threshold=2, reset_timeout=10.0),
                    name="simtest", clock=clk)
    url = "http://127.0.0.1:1"
    assert pc.available(url)
    pc.penalize(url, "bad chunk")
    pc.penalize(url, "bad chunk")
    assert not pc.available(url)  # breaker opened on the virtual clock
    clk.sleep(9.0)
    assert not pc.available(url)
    clk.sleep(1.0)  # reset_timeout reached in VIRTUAL seconds
    assert pc.available(url)


def test_peerset_backoff_advances_virtual_time_only():
    from celestia_app_tpu_torch.das.daser import PeerError, PeerSet

    class Refusing:
        def request(self, url, path, payload=None, raw=False):
            raise OSError("refused")

        def penalize(self, url, reason):
            pass

    clk = VirtualClock()
    ps = PeerSet(["sim://a", "sim://b"], retries=3, backoff=0.5,
                 client=Refusing(), clock=clk)
    t0 = time.monotonic()
    with pytest.raises(PeerError):
        ps.request("/das/head")
    assert time.monotonic() - t0 < 1.0  # no real sleeping
    assert clk.monotonic() == 0.5 + 1.0  # two backoff rounds, doubled


def test_daser_defaults_to_system_clock(tmp_path):
    from celestia_app_tpu_torch.chain import light
    from celestia_app_tpu_torch.das.checkpoint import CheckpointStore
    from celestia_app_tpu_torch.das.daser import DASer

    trust = light.TrustedState(height=0, header_hash=b"", validators={}, powers={})
    d = DASer(["http://127.0.0.1:1"], light.LightClient("clk-test", trust),
              CheckpointStore(str(tmp_path / "cp.json")), device="cpu")
    assert d.clock is SYSTEM
    assert d.peers.clock is SYSTEM


# -- mempool TTL stamps through the injected clock --------------------------


def test_mempool_ttl_expires_on_virtual_time():
    from celestia_app_tpu_torch.mempool.pool import CATPool

    clk = VirtualClock()
    pool = CATPool(ttl_blocks=10_000, ttl_seconds=30.0, clock=clk)
    pool.add(b"tx-virtual", height=1)
    assert len(pool) == 1
    # real time passes, virtual time does not: no expiry
    assert pool.expire(height=1) == []
    clk.sleep(31.0)  # half a minute of chain time, instantly
    dropped = pool.expire(height=1)
    assert [e.raw for e in dropped] == [b"tx-virtual"]
    assert len(pool) == 0


def test_mempool_defaults_to_system_clock():
    from celestia_app_tpu_torch.mempool.pool import CATPool

    pool = CATPool()
    assert pool.clock is SYSTEM
    pool.add(b"tx-system", height=1)
    entry = pool.entries()[0]
    assert abs(entry.time_added - time.time()) < 60.0


# -- a kernel wrapper's error is no verdict ---------------------------------

# where the failing launch happens: (scenario, scheme, the kernel wrapper,
# the frames the launch must come from to fail)
SITES = {
    # a proposer's PrepareProposal (the square's extension and roots)
    "propose": ("honest", "rs2d-nmt", "extend_lines", {"_prepare_inner"}),
    # a follower's ProcessProposal: the App turns it into a reject, the
    # simulated validator re-raises it
    "process": ("honest", "rs2d-nmt", "compress_words", {"_process_proposal_inner"}),
    # serving a light node: the warmer's provers fail (counted, never
    # raised, as in production), then the serving rebuild and the lazy
    # prover build on the sampling request fail
    "serve": ("honest", "rs2d-nmt", "compress_words", {"_run", "_build_entry", "_one"}),
    # the malicious fixture of the incorrect-coding op
    "fixture": ("incorrect-coding", "rs2d-nmt", "compress_words", {"rs2d_bad_parity_entry"}),
    # a light node's repair of the mis-coded square
    "repair": ("incorrect-coding", "rs2d-nmt", "extend_lines", {"repair_eds"}),
    # a light node's check of the BEFP it assembled (the expected root)
    "befp": ("incorrect-coding", "rs2d-nmt", "compress_words", {"verify_befp"}),
}


def _failing(orig, frames: set, raised: list):
    def wrapper(*a, **kw):
        f = sys._getframe(1)
        while f is not None:
            if f.f_code.co_name in frames:
                err = cuda_build.KernelValueError(f"injected launch failure under {f.f_code.co_name}")
                raised.append(err)
                raise err
            f = f.f_back
        return orig(*a, **kw)
    return wrapper


@pytest.mark.parametrize("site", sorted(SITES))
def test_a_kernel_error_propagates_out_of_run_scenario(site, monkeypatch, tmp_path):
    name, scheme, kernel, frames = SITES[site]
    owner = sha256_kernel if kernel == "compress_words" else rs_kernel
    raised: list = []
    monkeypatch.setattr(owner, kernel, _failing(getattr(owner, kernel), frames, raised))
    doc = scenarios.scenario_spec(name, scheme, 0, validators=4, light_nodes=4, heights=3)
    with pytest.raises(cuda_build.KernelError) as got:
        scenarios.run_scenario(doc, workdir=str(tmp_path / site), device="cpu")
    # the very error a wrapper raised, not a SampleError or a verdict
    assert any(got.value is err for err in raised), (got.value, raised)


def test_the_kernel_fault_passes_the_light_fleet(tmp_path):
    """SimTransport carries a serving kernel error as a KernelFault, a
    BaseException the DASer's refusal handling does not catch."""
    from celestia_app_tpu_torch.sim import engine

    err = cuda_build.KernelValueError("x")
    fault = engine.KernelFault(err)
    assert fault.error is err and not isinstance(fault, Exception)


@pytest.mark.parametrize("route", ["samples", "headers"])
def test_sample_core_never_turns_a_kernel_error_into_a_sample_error(route, monkeypatch, tmp_path):
    """A serving rebuild whose K1 launch fails raises the wrapper's error
    out of SampleCore, where an unservable height is a SampleError."""
    from celestia_app_tpu_torch.das.server import SampleCore, SampleError, route_das

    from test_torch_app import Pkg, make_app

    app, _, _ = make_app(Pkg("port"), data_dir=str(tmp_path / "home"))
    app.produce_block([], t=1_700_000_100.0)
    app.da_warmer.wait_idle(60)
    core = SampleCore(app)
    app.eds_cache.clear()  # the rebuild computes the square again
    raised: list = []
    monkeypatch.setattr(sha256_kernel, "compress_words",
                        _failing(sha256_kernel.compress_words, {"_build_entry"}, raised))
    args = (("POST", "/das/samples", {}, {"height": 1, "cells": [[0, 0]]}) if route == "samples"
            else ("POST", "/das/headers", {}, {"heights": [1]}))
    with pytest.raises(cuda_build.KernelError) as got:
        route_das(core, *args)
    assert not isinstance(got.value, SampleError) and got.value is raised[0]
    with pytest.raises(SampleError):  # a height the chain never had still is one
        route_das(core, "POST", "/das/samples", {}, {"height": 9, "cells": [[0, 0]]})
    app.close()
