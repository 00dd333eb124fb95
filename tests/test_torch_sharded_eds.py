"""The port's sharded pipeline (celestia_app_tpu_torch/parallel/sharded_eds)
against the JAX package's, on the CPU.

The port's meshes name the CPU device n times (``[cpu] * n``): every shard
runs its steps on the CPU through the plain kernel versions. The
reference's `jitted_sharded_pipeline` runs on the 8 forced CPU devices of
the test process (tests/conftest.py), and its one-device `eds` pipeline on
the first of them. Seeded numpy ODS; every byte must be equal.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from celestia_app_tpu.da import eds as ref_eds
from celestia_app_tpu.da import namespace as ref_ns
from celestia_app_tpu.ops import rs as ref_rs
from celestia_app_tpu.parallel import mesh as ref_mesh
from celestia_app_tpu.parallel import sharded_eds as ref_sharded
from celestia_app_tpu.utils import refimpl
from celestia_app_tpu_torch.da import eds
from celestia_app_tpu_torch.ops import leopard
from celestia_app_tpu_torch.parallel import mesh as mesh_mod
from celestia_app_tpu_torch.parallel import sharded_eds

CPU = torch.device("cpu")


def random_ods(rng: np.random.Generator, k: int) -> np.ndarray:
    """A plausible ODS: shares with user-range namespace prefixes."""
    ods = rng.integers(0, 256, size=(k, k, 512), dtype=np.uint8)
    ods[:, :, 0] = 0
    ods[:, :, 1:19] = 0
    return ods


def cpu_mesh(data: int, seq: int) -> mesh_mod.Mesh:
    return mesh_mod.Mesh(((CPU,) * seq,) * data)


def ref_mesh_of(data: int, seq: int) -> JaxMesh:
    devs = jax.devices("cpu")[:data * seq]
    return JaxMesh(np.array(devs).reshape(data, seq), (ref_mesh.DATA_AXIS, ref_mesh.SEQ_AXIS))


def as_np(out) -> tuple:
    return tuple(np.asarray(t) for t in out)


@pytest.mark.parametrize("k,batch,shape", [(8, 2, None), (4, 2, None), (16, 4, (2, 4))])
def test_sharded_matches_the_reference(k, batch, shape):
    """(k, batch) cases of tests/test_sharded_eds.py on the 8-device factoring
    of both packages, and k = 16 at (data, seq) = (2, 4)."""
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    if shape is None:
        mesh = mesh_mod.make_mesh(8, k=k, devices=[CPU] * 8)
        jmesh = ref_mesh.make_mesh(8, k=k, devices=jax.devices("cpu"))
    else:
        mesh, jmesh = cpu_mesh(*shape), ref_mesh_of(*shape)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.shape[mesh_mod.SEQ_AXIS] >= 2, "the case must shard rows"
    rng = np.random.default_rng(1234 + k)
    ods = np.stack([random_ods(rng, k) for _ in range(batch)])

    got = as_np(sharded_eds.sharded_pipeline(mesh, ods))
    want = as_np(ref_sharded.jitted_sharded_pipeline(jmesh, k)(ods))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    single = ref_eds.jitted_pipeline(k)
    for b in range(batch):
        with jax.default_device(jax.devices("cpu")[0]):
            one = as_np(single(ods[b]))
        for g, w in zip(got, one):
            np.testing.assert_array_equal(g[b], w)


def test_a_tensor_batch_and_the_one_device_pipeline():
    """A batch already on the device is sliced, not uploaded, and gives the
    port's own one-device pipeline's bytes, on a (2, 2) mesh."""
    rng = np.random.default_rng(5)
    ods = np.stack([random_ods(rng, 8) for _ in range(2)])
    got = sharded_eds.sharded_pipeline(cpu_mesh(2, 2), torch.from_numpy(ods))
    for g, w in zip(got, eds.pipeline_batched(ods, "cpu")):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 128])
def test_mesh_factoring_matches_the_reference(k):
    for n in range(1, 9):
        got = mesh_mod.make_mesh(n, k=k, devices=[CPU] * 8)
        want = ref_mesh.make_mesh(n, k=k, devices=jax.devices("cpu"))
        assert got.shape == dict(want.shape), (n, k)
        assert got.size == n
    assert mesh_mod.make_mesh(devices=[CPU] * 6).shape == {"data": 3, "seq": 2}
    with pytest.raises(ValueError, match="n_devices"):
        mesh_mod.make_mesh(9, devices=[CPU] * 8)
    if not torch.cuda.is_available():  # the default device list is the cards
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_mesh()


def test_the_seq_extent_must_divide_k():
    ods = np.zeros((1, 4, 4, 512), dtype=np.uint8)
    with pytest.raises(ValueError, match="must divide square size"):
        sharded_eds.sharded_pipeline(cpu_mesh(1, 8), ods)
    with pytest.raises(ValueError, match="must divide over data axis"):
        sharded_eds.sharded_pipeline(cpu_mesh(2, 2), ods)


def test_parity_namespace_in_sharded_roots():
    """Q3-only rows carry the parity namespace range in their roots, and the
    roots equal the reference's mesh's."""
    k = 8
    ods = random_ods(np.random.default_rng(7), k)[None]
    _, row_roots, col_roots, _ = as_np(sharded_eds.sharded_pipeline(
        mesh_mod.make_mesh(8, k=k, devices=[CPU] * 8), ods))
    parity = np.frombuffer(ref_ns.PARITY_NS_RAW, dtype=np.uint8)
    for r in range(k, 2 * k):
        np.testing.assert_array_equal(row_roots[0, r, :29], parity)
        np.testing.assert_array_equal(row_roots[0, r, 29:58], parity)
        np.testing.assert_array_equal(col_roots[0, r, :29], parity)
    with jax.default_device(jax.devices("cpu")[0]):
        _, rows, cols, _ = as_np(ref_eds.jitted_pipeline(k)(ods[0]))
    np.testing.assert_array_equal(row_roots[0], rows)
    np.testing.assert_array_equal(col_roots[0], cols)


def test_gf16_passes_shard_like_the_one_device_code(monkeypatch):
    """The GF(2^16) row and column passes under sharding, at k = 8 with the
    16-bit code forced in the port (the reference's
    CELESTIA_GF16_THRESHOLD trick): byte-equal to the one-device pipeline
    under the same code, whose 16-bit extension tests/test_torch_leopard16.py
    holds against the reference's."""
    monkeypatch.setattr(leopard, "uses_gf16", lambda k: k > 4)
    k = 8
    assert leopard.field_for(k) == 16
    rng = np.random.default_rng(99)
    ods = np.stack([random_ods(rng, k) for _ in range(2)])
    got = sharded_eds.sharded_pipeline(cpu_mesh(2, 4), ods)
    for g, w in zip(got, eds.pipeline_batched(ods, "cpu")):
        assert torch.equal(g, w)


@pytest.mark.slow
def test_gf16_k256_seq2_matches_the_reference():
    """k = 256 (the protocol's GF(2^16) code) at seq 2, held against the
    reference's host Leopard-16 encode and hashlib trees. About 30 s on a
    CPU; the same size runs on the card in chip_smoke.py's mesh_plane."""
    k = 256
    ods = random_ods(np.random.default_rng(256), k)
    ods[:, :, :29] = ods[0, 0, :29]  # one namespace: the hashlib trees check the order
    eds_s, rows, cols, root = as_np(sharded_eds.sharded_pipeline(cpu_mesh(1, 2), ods[None]))
    want = np.asarray(ref_rs.extend_square_np(ods))
    np.testing.assert_array_equal(eds_s[0], want)
    want_rows, want_cols = refimpl.axis_roots_host(want)
    assert [bytes(r) for r in rows[0]] == want_rows
    assert [bytes(c) for c in cols[0]] == want_cols
