"""The port's mesh plane (parallel/mesh_engine and what routes through it)
against the JAX package's, on the CPU.

The port's meshes name the CPU device n times (``[cpu] * n``); the
reference runs its mesh engine on the 8 forced CPU devices of the test
process (tests/conftest.py). Each case of tests/test_mesh_plane.py that is
not marked slow has its counterpart here, held against the reference on
the same seeded input: mesh entries bit-identical to the host engine's
(squares, roots, proofs), explicit mesh against the auto rule, the
unshardable k = 1 square, device residency with host crossings pinned, DAS
served from a mesh entry, batched produce and a mesh App's chain with the
reference's hashes, sharded repair and axis roots, and mesh streaming. A
kernel error in a shard propagates: the mesh plane has no fallback.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from celestia_app_tpu.da import edscache as ref_edscache
from celestia_app_tpu.da import repair as ref_repair
from celestia_app_tpu.ops import nmt as ref_nmt
from celestia_app_tpu.parallel import mesh as ref_mesh
from celestia_app_tpu.parallel import streaming as ref_streaming
from celestia_app_tpu_torch import cuda_build
from celestia_app_tpu_torch.da import dah, edscache, repair, square
from celestia_app_tpu_torch.das.server import SampleCore
from celestia_app_tpu_torch.ops import nmt, rs, rs_kernel
from celestia_app_tpu_torch.parallel import mesh as mesh_mod
from celestia_app_tpu_torch.parallel import mesh_engine, streaming
from celestia_app_tpu_torch.utils import telemetry

from test_torch_app import Pkg

CPU = torch.device("cpu")
MESH8 = mesh_mod.make_mesh(devices=[CPU] * 8)  # (data, seq) = (1, 8)


def random_ods(k: int, seed: int) -> np.ndarray:
    ods = np.random.default_rng(seed).integers(0, 256, size=(k, k, 512), dtype=np.uint8)
    ods[:, :, 0] = 0
    ods[:, :, 1:19] = 0
    return ods


def counter(name: str) -> int:
    return telemetry.snapshot()["counters"].get(name, 0)


def same_proof(a, b) -> None:
    (sa, pa), (sb, pb) = a, b
    assert sa == sb
    assert (pa.start, pa.end, pa.total, list(pa.nodes)) == (pb.start, pb.end, pb.total, list(pb.nodes))


# -- bit identity ---------------------------------------------------------------


@pytest.mark.parametrize("k", [8, 32])
def test_mesh_entry_bit_identical_to_host(k):
    ods = random_ods(k, 1000 + k)
    host = ref_edscache.compute_entry(ods, "host")
    entry = edscache.compute_entry(ods, "cpu", mesh=MESH8)
    assert isinstance(entry, edscache.DeviceEntry) and entry.k == k
    assert entry.data_root == host.data_root
    assert (entry.dah.row_roots, entry.dah.col_roots) == (host.dah.row_roots, host.dah.col_roots)
    np.testing.assert_array_equal(entry.eds.squares, host.eds.squares)
    if k == 8:  # and the reference's own mesh engine
        assert ref_edscache.compute_entry(ods, "mesh").data_root == entry.data_root
    rows, cols = entry.get_prover(), entry.get_col_prover()
    want_rows, want_cols = host.get_prover("host"), host.get_col_prover("host")
    rng = np.random.default_rng(k)
    for _ in range(4):
        r, c = (int(x) for x in rng.integers(0, 2 * k, size=2))
        same_proof(rows.prove_cell(r, c), want_rows.prove_cell(r, c))
        same_proof(cols.prove_cell(c, r), want_cols.prove_cell(c, r))


def test_explicit_mesh_and_the_auto_rule(monkeypatch):
    """A Mesh is the reference's engine="mesh"; mesh=None is its auto rule,
    which never shards on the CPU or on one card, and on two or more cards
    shards squares of k >= 512 only (the reference's default is 256)."""
    ods = random_ods(16, 7)
    monkeypatch.setenv("CELESTIA_MESH_MIN_K", "16")  # the reference's knob, for its auto engine
    want = ref_edscache.compute_entry(ods, "auto")
    assert isinstance(want, ref_edscache.DeviceEntry)
    sharded = edscache.compute_entry(ods, "cpu", mesh=MESH8)
    plain = edscache.compute_entry(ods, "cpu")
    assert isinstance(sharded, edscache.DeviceEntry) and not isinstance(plain, edscache.DeviceEntry)
    assert sharded.data_root == plain.data_root == want.data_root

    assert not mesh_engine.mesh_active_for(16, None, "cpu")
    assert mesh_engine.mesh_active_for(16, MESH8) and not mesh_engine.mesh_active_for(1, MESH8)
    # the rule itself, with two "cards" (CPU stand-ins) visible
    monkeypatch.setattr(mesh_mod, "visible_cards", lambda: [CPU, CPU])
    assert mesh_engine.DEFAULT_MESH_MIN_K == 512
    assert mesh_engine.mesh_active_for(512) and not mesh_engine.mesh_active_for(256)
    assert not mesh_engine.mesh_active_for(512, None, "cpu")  # a CPU caller shards nothing
    assert mesh_engine.mesh_for(256).shape == {"data": 1, "seq": 2}
    assert mesh_engine.mesh_for(1) is None
    monkeypatch.setattr(mesh_mod, "visible_cards", lambda: [CPU])
    assert mesh_engine.mesh_for(256) is None and mesh_engine.card_mesh() is None


def test_mesh_engine_unshardable_square_degrades():
    """The k = 1 empty block takes the one-device path under a mesh."""
    ods = dah.shares_to_ods(square.empty_square().share_bytes())
    entry = edscache.compute_entry(ods, "cpu", mesh=MESH8)
    assert not isinstance(entry, edscache.DeviceEntry)
    assert entry.data_root == ref_edscache.compute_entry(ods, "host").data_root
    with pytest.raises(RuntimeError, match="seq extent"):
        mesh_engine.compute_entry_mesh(ods, MESH8)


# -- residency ------------------------------------------------------------------


def test_device_residency_and_host_crossings():
    k = 8
    entry = edscache.compute_entry(random_ods(k, 42), "cpu", mesh=MESH8)
    assert entry.residency() == "device"
    c0 = counter("edscache.host_crossings")
    assert len(entry.dah.row_roots) == 2 * k and len(entry.data_root) == 32
    entry.warm()
    assert entry.warmed() and counter("edscache.host_crossings") == c0
    assert entry.residency() == "device"
    entry.get_prover().prove_cell(0, 0)
    after_first = counter("edscache.host_crossings")
    assert after_first > c0 and entry.residency() == "device+host"
    entry.get_prover().prove_cell(1, 3)
    entry.get_prover().prove_cell(2 * k - 1, 2 * k - 1)
    assert counter("edscache.host_crossings") == after_first


def test_device_entry_serves_das_with_crossings_pinned():
    from celestia_app_tpu.chain.app import App as RefApp
    from celestia_app_tpu.das.server import SampleCore as RefSampleCore

    port = Pkg("port")
    app = port.App(chain_id="mesh-serve")
    app.init_chain({"time_unix": 0})
    core = SampleCore(app)
    entry = edscache.compute_entry(random_ods(8, 99), "cpu", mesh=MESH8)
    entry.warm()
    core.seed_cache_entry(5, entry)
    first, first_col = core.sample(5, 0, 0), core.sample(5, 7, 1, axis="col")
    c0 = counter("edscache.host_crossings")
    again, col = core.sample(5, 3, 4), core.sample(5, 2, 6, axis="col")
    assert counter("edscache.host_crossings") == c0
    ref_app = RefApp(chain_id="mesh-serve", engine="host")
    ref_app.init_chain({"time_unix": 0})
    ref_core = RefSampleCore(ref_app)
    ref_core.seed_cache_entry(5, ref_edscache.compute_entry(random_ods(8, 99), "host"))
    assert first == ref_core.sample(5, 0, 0)
    assert first_col == ref_core.sample(5, 7, 1, axis="col")
    assert again == ref_core.sample(5, 3, 4)
    assert col == ref_core.sample(5, 2, 6, axis="col")
    assert core.availability(5)["residency"] == "device+host"


# -- batched produce and a mesh chain ---------------------------------------------


def funded(p, chain_id: str, n: int = 4, **kw):
    privs = [p.PrivateKey.from_seed(b"mesh-%d" % i) for i in range(n)]
    addrs = [k.public_key().address() for k in privs]
    app = p.App(chain_id=chain_id, **kw)
    app.init_chain({
        "time_unix": 1_700_000_000.0,
        "accounts": [{"address": a.hex(), "balance": 10**12} for a in addrs],
        "validators": [{"operator": addrs[0].hex(), "power": 10}],
        "gov_max_square_size": 2,
    })
    node = p.Node(app)
    signer = p.Signer(chain_id)
    for i, k in enumerate(privs):
        signer.add_account(k, number=i)
    for _ in range(4):
        for i, a in enumerate(addrs):
            tx = signer.create_tx(a, [p.tx.MsgSend(a, addrs[(i + 1) % n], 1)], fee=2000, gas_limit=100_000)
            signer.accounts[a].sequence += 1
            node.broadcast_tx(tx.encode())
    return app, node


def test_batched_produce_commits_identical_hashes(monkeypatch):
    """A mesh App's batched produce (the planned squares through the sharded
    pipeline) commits the reference's per-block hashes."""
    from celestia_app_tpu_torch.parallel import sharded_eds

    real, sharded = sharded_eds.sharded_pipeline, []
    monkeypatch.setattr(sharded_eds, "sharded_pipeline",
                        lambda mesh, ods: sharded.append(mesh.shape) or real(mesh, ods))
    port, ref = Pkg("port"), Pkg("ref")
    app, node = funded(port, "mesh-batch-eq", mesh=mesh_mod.make_mesh(devices=[CPU] * 2))
    ref_app, ref_node = funded(ref, "mesh-batch-eq")
    d0, m0, s0 = counter("mesh.batched_dispatches"), counter("producer.plan_misses"), \
        counter("mesh.batched_blocks")
    out = node.produce_blocks_batched(3, t=1_700_000_100.0)
    assert counter("mesh.batched_dispatches") > d0 and counter("mesh.batched_blocks") > s0
    assert counter("producer.plan_misses") == m0
    assert sharded, "the planned squares went through the sharded pipeline"
    want = [ref_node.produce_block(t=1_700_000_100.0 + i) for i in range(3)]
    assert len(out) == 3
    for (blk, _), (ref_blk, _) in zip(out, want):
        assert blk.header.hash() == ref_blk.header.hash()
        assert blk.header.data_hash == ref_blk.header.data_hash
        assert blk.txs == ref_blk.txs
    assert app.last_app_hash == ref_app.last_app_hash
    app.da_warmer.wait_idle(30)


def test_mesh_app_chain_matches_one_device_and_reference():
    """Two port chains over the same tx (a mesh App, a one-device App) and
    the reference's host chain commit the same headers and serve the same
    samples."""

    def chain(p, **kw):
        priv = p.PrivateKey.from_seed(b"mesh-e2e")
        a = priv.public_key().address()
        app = p.App(chain_id="mesh-e2e", **kw)
        app.init_chain({"time_unix": 1_700_000_000.0,
                        "accounts": [{"address": a.hex(), "balance": 10**12}],
                        "validators": [{"operator": a.hex(), "power": 1}]})
        node = p.Node(app)
        core = node.attach_das_core(p.mod("das.server").SampleCore(app))
        signer = p.Signer("mesh-e2e")
        signer.add_account(priv, number=0)
        node.broadcast_tx(signer.create_tx(a, [p.tx.MsgSend(a, a, 1)], fee=2000, gas_limit=100_000).encode())
        blk, _ = node.produce_block(t=1_700_000_001.0)
        app.da_warmer.wait_idle(30)
        return app, core, blk

    port = Pkg("port")
    mesh_app, mesh_core, mesh_blk = chain(port, mesh=mesh_mod.make_mesh(devices=[CPU] * 4))
    one_app, one_core, one_blk = chain(port)
    ref_app, ref_core, ref_blk = chain(Pkg("ref"))
    assert mesh_blk.header.hash() == one_blk.header.hash() == ref_blk.header.hash()
    assert mesh_app.last_app_hash == one_app.last_app_hash == ref_app.last_app_hash
    for args, kw in (((1, 0, 0), {}), ((1, 1, 1), {"axis": "col"})):
        assert mesh_core.sample(*args, **kw) == one_core.sample(*args, **kw) == ref_core.sample(*args, **kw)


# -- sharded repair and axis roots ----------------------------------------------------


def test_mesh_sharded_ops_bit_identical():
    """Axis roots and a whole-columns repair with their batches split over a
    mesh: the reference's bytes, and the batch-shard counter moves."""
    k = 8
    host = ref_edscache.compute_entry(random_ods(k, 321), "host")
    eds = np.asarray(host.eds.squares)
    slabs, idx = eds.copy(), list(range(2 * k))
    want = ref_nmt.eds_axis_roots(slabs, idx, k)
    s0 = counter("mesh.batch_shards")
    got = nmt.eds_axis_roots(slabs, idx, k, "cpu", MESH8)
    assert counter("mesh.batch_shards") == s0 + 2  # the slabs and their indices
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nmt.eds_axis_roots(torch.from_numpy(slabs), idx, k, "cpu", MESH8), want)

    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[:, k + 2:] = False  # k - 2 columns lost: one pattern for every row
    garbled = eds.copy()
    garbled[~present] = 0
    rows, cols = list(host.dah.row_roots), list(host.dah.col_roots)
    s0 = counter("mesh.batch_shards")
    fixed = repair.repair_eds(garbled, present, rows, cols, device="cpu", mesh=MESH8)
    assert counter("mesh.batch_shards") > s0
    np.testing.assert_array_equal(fixed, eds)
    np.testing.assert_array_equal(fixed, ref_repair.repair_eds(garbled, present, rows, cols, engine="batched"))
    np.testing.assert_array_equal(fixed, ref_repair.repair_eds(garbled, present, rows, cols, engine="scalar"))

    # a batch that does not divide over the mesh runs on one device
    run = rs.repair_axes_fn(k, tuple(range(k)), "cpu")
    batch = torch.from_numpy(eds[:3].copy())
    s0 = counter("mesh.batch_shards")
    assert torch.equal(run(batch, MESH8), run(batch)) and counter("mesh.batch_shards") == s0


# -- streaming ------------------------------------------------------------------


def test_mesh_streaming_matches_the_reference():
    """stream_blocks_mesh over a (2, 2) mesh: the reference's data roots on
    its own (2, 2) mesh; the bench's dict on a [cpu] * 4 mesh."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    k = 8

    def layout(i):
        return np.stack([ref_streaming._synthetic_layout(k, 2 * i + j) for j in range(2)])

    jmesh = JaxMesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2), (ref_mesh.DATA_AXIS, ref_mesh.SEQ_AXIS))
    want = ref_streaming.stream_blocks_mesh(layout, 2, jmesh, k)
    got = streaming.stream_blocks_mesh(layout, 2, mesh_mod.Mesh(((CPU, CPU), (CPU, CPU))), k)
    assert got == want and len(got) == 4
    out = streaming.bench_stream_mesh(k=k, n_batches=2, n_devices=4, devices=[CPU] * 4)
    assert (out["metric"], out["blocks"], out["mesh"]) == ("stream_mesh_blocks_per_sec_k8", 2, {"data": 1, "seq": 4})
    assert out["value"] > 0


# -- no fallback ------------------------------------------------------------------


def test_a_kernel_error_in_a_shard_propagates(monkeypatch):
    """A kernel wrapper's error in the third shard's launch reaches the
    caller of compute_entry, compute_entries_batched and the sharded repair:
    no one-device result takes its place."""
    real = rs_kernel.extend_lines
    calls = []

    def failing(groups, operand):
        calls.append(1)
        if len(calls) == 3:
            raise cuda_build.KernelLaunchError("rs_extend_lines launch failed: CUDA error 700")
        return real(groups, operand)

    ods = random_ods(8, 3)
    header, eds, _ = dah.new_dah_from_ods(ods, device="cpu")
    present = np.ones((16, 16), dtype=bool)
    present[:, 10:] = False  # every row decodes: 16 axes, 2 per shard
    monkeypatch.setattr(rs_kernel, "extend_lines", failing)
    with pytest.raises(cuda_build.KernelLaunchError):
        edscache.compute_entry(ods, "cpu", mesh=MESH8)
    calls.clear()
    with pytest.raises(cuda_build.KernelLaunchError):
        mesh_engine.compute_entries_batched(ods[None], device="cpu", mesh=MESH8)
    calls.clear()
    with pytest.raises(cuda_build.KernelLaunchError):
        repair.repair_eds(eds.squares, present, list(header.row_roots), list(header.col_roots),
                          device="cpu", mesh=MESH8)
    assert len(calls) == 3
