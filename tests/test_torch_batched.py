"""Batched blocks and device-resident entries in the port, against the JAX
package and against the port's own single-block path (tolerance: exact,
byte for byte): K2's plain version on batched strided views, the batched
extension and Merkle roots, `pipeline_batched` per block against
`jitted_pipeline_batched` and B single `pipeline` calls, with the launches
of one block; `compute_entries_batched`; `DeviceEntry` crossings, its lazy
square, levels, provers and namespace reads against the reference
`DeviceEntry`'s; the cached SHA-256 padding tail; and square building and
DAH bounds at the k = 256 and 512 sizes that `max_square_size=512` admits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu.da import dah as jax_dah
from celestia_app_tpu.da import edscache as jax_edscache
from celestia_app_tpu.da import eds as jax_eds
from celestia_app_tpu.da import namespace_device as jax_namespace_device
from celestia_app_tpu.da import square as jax_square
from celestia_app_tpu_torch.da import dah, eds, edscache, namespace_device, proof_device, square
from celestia_app_tpu_torch.ops import merkle, rs, rs_kernel, sha256, sha256_kernel
from celestia_app_tpu_torch.parallel import mesh as mesh_mod
from celestia_app_tpu_torch.parallel import mesh_engine
from celestia_app_tpu_torch.utils import telemetry
from test_torch_proof import seeded_block
from test_torch_square import _jax_pfbs, _mix, _port_pfbs

KS = [1, 2, 4, 8]


def batch_of(k: int, b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, size=(b, k, k, 512), dtype=np.uint8)
    ods[..., :29] = 0
    ods[..., 28] = 5
    return ods


def counting(monkeypatch):
    """Counts the calls of both kernel wrappers (on the CPU they take their
    plain versions, where the wrappers' own launch counts stay at 0)."""
    calls = {"k1": 0, "k2": 0}
    real_k1, real_k2 = sha256_kernel.compress_words, rs_kernel.extend_lines

    def k1(blocks):
        calls["k1"] += 1
        return real_k1(blocks)

    def k2(groups, operand):
        calls["k2"] += 1
        return real_k2(groups, operand)

    monkeypatch.setattr(sha256_kernel, "compress_words", k1)
    monkeypatch.setattr(rs_kernel, "extend_lines", k2)
    return calls


# -- K2 and the extension over a batch -----------------------------------------


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", KS)
def test_k2_plain_version_on_batched_strided_views(k, b):
    """extend_lines on (blocks, lines, k, 512) views of a batched EDS (rows
    of Q0, and its columns through a transposed view) writes what the
    per-square launches write."""
    ods = torch.from_numpy(batch_of(k, b, seed=10 * k + b))
    operand = rs.bit_operand(k, "cpu")
    got = torch.zeros((b, 2 * k, 2 * k, 512), dtype=torch.uint8)
    got[:, :k, :k] = ods
    rs_kernel.extend_lines(((got[:, :k, :k], got[:, :k, k:]),
                            (got[:, :k, :k].transpose(1, 2), got[:, k:, :k].transpose(1, 2))), operand)
    rs_kernel.extend_lines(((got[:, k:, :k], got[:, k:, k:]),), operand)
    for i in range(b):
        np.testing.assert_array_equal(got[i].numpy(), rs.extend_square_fn(k, "cpu")(ods[i]).numpy())
        np.testing.assert_array_equal(got[i].numpy(), rs.extend_square_np(ods[i].numpy()))
    # the plain version itself takes the leading dimensions
    np.testing.assert_array_equal(rs_kernel.extend_pass_ref(ods, operand).numpy(),
                                  torch.stack([rs_kernel.extend_pass_ref(o, operand) for o in ods]).numpy())


def test_k2_layout_of_a_batched_view():
    eds_b = torch.zeros((3, 8, 8, 512), dtype=torch.uint8)
    layout = rs_kernel._layout(eds_b[:, :4, :4], "source")
    assert layout == (0, 3, 64, 4, 8, 4, 1)  # first slot, blocks, block stride, lines, stride, k, stride
    assert rs_kernel._layout(eds_b[0, :4, :4], "source") == (0, 1, 0, 4, 8, 4, 1)
    # a destination that overlaps a source across blocks is refused
    op = rs.bit_operand(4, "cpu")
    with pytest.raises(ValueError, match="overlaps"):
        rs_kernel.extend_lines(((eds_b[:, :4, :4], eds_b[:, 2:6, :4]),), op)
    with pytest.raises(ValueError, match="differ"):
        rs_kernel.extend_lines(((eds_b[:, :4, :4], eds_b[0, :4, 4:]),), op)
    with pytest.raises(ValueError, match="share-aligned"):
        rs_kernel._layout(torch.zeros(2 * 4 * 4 * 512 + 256, dtype=torch.uint8)[256:].view(2, 4, 4, 512), "source")
    with pytest.raises(ValueError, match="contiguous"):
        rs_kernel._layout(torch.zeros((2, 4, 4, 1024), dtype=torch.uint8)[..., ::2], "source")


@pytest.mark.parametrize("k", KS)
def test_batched_extension_makes_two_launches(k, monkeypatch):
    calls = counting(monkeypatch)
    ods = batch_of(k, 4, seed=k)
    out = rs.extend_square_fn(k, "cpu")(torch.from_numpy(ods))
    assert calls["k2"] == 2 and out.shape == (4, 2 * k, 2 * k, 512)
    for i in range(4):
        np.testing.assert_array_equal(out[i].numpy(), rs.extend_square_np(ods[i]))
    with pytest.raises(ValueError, match="ODS must be"):
        rs.extend_square_fn(k, "cpu")(torch.zeros((2, 2, k, k, 512), dtype=torch.uint8))


def test_eds_of_a_batch_is_checked():
    with pytest.raises(ValueError, match="contiguous"):
        rs_kernel.extend_eds(torch.zeros((2, 8, 8, 512), dtype=torch.uint8).transpose(1, 2), "q3",
                             rs.bit_operand(4, "cpu"))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_merkle_root_pow2_over_a_batch(n):
    leaves = torch.from_numpy(np.random.default_rng(n).integers(0, 256, (3, n, 90), dtype=np.uint8))
    got = merkle.merkle_root_pow2(leaves)
    assert got.shape == (3, 32)
    for i in range(3):
        assert torch.equal(got[i], merkle.merkle_root_pow2(leaves[i]))
    with pytest.raises(ValueError, match="power of two"):
        merkle.merkle_root_pow2(torch.zeros((2, 3, 90), dtype=torch.uint8))


# -- the batched pipeline ------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_pipeline_batched_matches_reference_and_single_calls(k, monkeypatch):
    ods = batch_of(k, 3, seed=30 + k)
    calls = counting(monkeypatch)
    e, rows, cols, roots = eds.pipeline_batched(ods, device="cpu")
    log2 = (2 * k).bit_length() - 1
    assert calls == {"k1": 1 + log2 + 1 + (log2 + 1), "k2": 2}  # one block's launches for B = 3
    assert (e.shape, rows.shape, cols.shape, roots.shape) == (
        (3, 2 * k, 2 * k, 512), (3, 2 * k, 90), (3, 2 * k, 90), (3, 32))
    monkeypatch.undo()
    want = jax_eds.jitted_pipeline_batched(k)(jnp.asarray(ods))
    for got, exp in zip((e, rows, cols, roots), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    for i in range(3):
        single = eds.pipeline(ods[i], device="cpu")
        for got, exp in zip((e[i], rows[i], cols[i], roots[i]), single):
            assert torch.equal(got, exp)
    r_rows, r_cols, r_roots = eds.roots_only_batched(ods, device="cpu")
    assert torch.equal(r_rows, rows) and torch.equal(r_cols, cols) and torch.equal(r_roots, roots)


def test_pipeline_batched_rejects_bad_shapes():
    with pytest.raises(ValueError, match="batch"):
        eds.pipeline_batched(np.zeros((2, 2, 512), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="ODS must be"):
        eds.pipeline_batched(np.zeros((2, 2, 4, 512), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="ODS must be"):
        eds.pipeline(np.zeros((2, 2, 2, 512), np.uint8), device="cpu")


def test_pipeline_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eds.pipeline_batched(batch_of(1, 1, 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_engine.compute_entries_batched(batch_of(1, 1, 0))


@pytest.mark.parametrize("k", [2, 4])
def test_compute_entries_batched(k, monkeypatch):
    ods = batch_of(k, 3, seed=40 + k)
    before = dict(telemetry.snapshot()["counters"])
    calls = counting(monkeypatch)
    entries = mesh_engine.compute_entries_batched(ods, device="cpu")
    assert calls["k2"] == 2
    monkeypatch.undo()
    after = telemetry.snapshot()["counters"]
    for name, n in (("da.extend_runs", 3), ("mesh.batched_dispatches", 1), ("mesh.batched_blocks", 3)):
        assert after[name] - before.get(name, 0) == n, name
    for i, entry in enumerate(entries):
        assert isinstance(entry, edscache.DeviceEntry) and entry.k == k
        want = jax_edscache.compute_entry(ods[i], engine="device")
        assert entry.data_root == want.data_root == entry.dah.hash()
        assert (entry.dah.row_roots, entry.dah.col_roots) == (want.dah.row_roots, want.dah.col_roots)
        np.testing.assert_array_equal(entry.eds.squares, want.eds.squares)


def test_compute_entries_batched_engines():
    # no mesh, and a mesh of one device (the reference's mesh engine on
    # one device), run the one-device program; a mesh of two CPU shards
    # runs the sharded pipeline: the same roots
    want = [bytes(eds.pipeline(o, device="cpu")[3].numpy()) for o in batch_of(2, 2, 0)]
    for mesh in (None, mesh_mod.make_mesh(devices=["cpu"]), mesh_mod.make_mesh(2, k=2, devices=["cpu"] * 2)):
        entries = mesh_engine.compute_entries_batched(batch_of(2, 2, 0), device="cpu", mesh=mesh)
        assert [e.data_root for e in entries] == want
    entries = mesh_engine.compute_entries_batched(torch.from_numpy(batch_of(1, 2, 1)), device="cpu")
    assert [e.data_root for e in entries] == [
        bytes(eds.pipeline(o, device="cpu")[3].numpy()) for o in batch_of(1, 2, 1)]


# -- DeviceEntry ---------------------------------------------------------------


def _crossings() -> dict:
    return edscache.crossings()


def _delta(before: dict) -> dict:
    now = edscache.crossings()
    return {key: now[key] - before[key] for key in before}


def _device_entry(ods: np.ndarray) -> edscache.DeviceEntry:
    (entry,) = mesh_engine.compute_entries_batched(ods[None], device="cpu")
    return entry


@pytest.mark.parametrize("k", [2, 4])
def test_device_entry_crossings_lazy_square_and_levels(k):
    _, _, ods = seeded_block(k)
    entry = _device_entry(ods)
    before = _crossings()
    assert entry._eds is None and not entry.warmed()
    entry.warm()
    assert entry.warmed() and _delta(before)["host_crossings"] == 0
    for col in (False, True):
        square_t = entry._eds_dev.transpose(0, 1) if col else entry._eds_dev
        want = proof_device.row_levels(square_t, "cpu")
        for got_level, want_level in zip(entry.device_levels(col), want):
            for got, exp in zip(got_level, want_level):
                assert torch.equal(got, exp)
    assert _delta(before)["host_crossings"] == 0
    entry.get_prover().prove_shares(0, 1, ods[0, 0, :29].tobytes())
    assert _delta(before) == {"host_crossings": 2, "host_crossings.eds": 1, "host_crossings.levels": 1,
                              "host_crossings.col_levels": 0}
    assert entry._eds is not None
    entry.get_prover().prove_cell(0, 0)
    entry.get_col_prover().prove_cell(0, 0)
    entry.get_col_prover()
    assert _delta(before) == {"host_crossings": 3, "host_crossings.eds": 1, "host_crossings.levels": 1,
                              "host_crossings.col_levels": 1}
    np.testing.assert_array_equal(entry.eds.squares, entry._eds_dev.numpy())


@pytest.mark.parametrize("k", [2, 4, 8])
def test_device_entry_proofs_and_reads_match_the_reference_device_entry(k):
    sq, _, ods = seeded_block(k)
    entry = _device_entry(ods)
    host_entry = edscache.compute_entry(ods, device="cpu")
    jd, jeds, jroot = jax_dah.new_dah_from_ods(ods)
    want = jax_edscache.DeviceEntry(jnp.asarray(jeds.squares), jd, jroot)
    assert entry.data_root == jroot
    want.warm()
    entry.warm()
    for getter in ("get_prover", "get_col_prover"):
        got_p, host_p = getattr(entry, getter)(), getattr(host_entry, getter)(device="cpu")
        want_p = getattr(want, getter)()
        for level, host_level, want_level in zip(got_p.levels, host_p.levels, want_p.levels):
            for got, host, exp in zip(level, host_level, want_level):
                np.testing.assert_array_equal(got, np.asarray(exp))
                np.testing.assert_array_equal(got, host)
        w = 2 * k
        for r, c in [(0, 0), (0, w - 1), (w - 1, 0), (k - 1, k)]:
            assert dataclasses.astuple(got_p.prove_cell(r, c)[1]) == dataclasses.astuple(want_p.prove_cell(r, c)[1])
        got_sp = got_p.prove_shares(0, k, ods[0, 0, :29].tobytes())
        want_sp = want_p.prove_shares(0, k, ods[0, 0, :29].tobytes())
        assert dataclasses.astuple(got_sp) == dataclasses.astuple(want_sp)
    present = sorted({ods[r, c, :29].tobytes() for r in range(k) for c in range(k)})
    queries = present + [bytes(29), (int.from_bytes(present[0], "big") + 1).to_bytes(29, "big")]
    before = _crossings()
    got = namespace_device.get_namespace_data_batched(entry, queries, device="cpu")
    assert _delta(before)["host_crossings"] == 0  # the prover was built above; the search reads resident mins
    want_nd = jax_namespace_device.get_namespace_data_batched(want.get_prover(), queries, engine="host")
    assert [dataclasses.astuple(g) for g in got] == [dataclasses.astuple(w) for w in want_nd]
    assert [dataclasses.astuple(g) for g in got] == [
        dataclasses.astuple(g) for g in namespace_device.get_namespace_data_batched(
            host_entry.get_prover(device="cpu"), queries, device="cpu")]


def test_namespace_read_of_a_device_entry_reads_resident_mins(monkeypatch):
    _, _, ods = seeded_block(4)
    entry = _device_entry(ods)
    np.testing.assert_array_equal(entry.leaf_namespaces().numpy(), ods[:, :, :29].reshape(16, 29))
    uploads = []
    real = namespace_device.leaf_namespaces
    monkeypatch.setattr(namespace_device, "leaf_namespaces", lambda p: uploads.append(p) or real(p))
    before = _crossings()
    namespace_device.get_namespace_data_batched(entry, [ods[0, 0, :29].tobytes()], device="cpu")
    assert uploads == []  # the host leaf namespaces are never taken for a DeviceEntry
    assert _delta(before) == {"host_crossings": 2, "host_crossings.eds": 1, "host_crossings.levels": 1,
                              "host_crossings.col_levels": 0}
    with pytest.raises(ValueError, match="lies on"):
        namespace_device.get_namespace_data_batched(entry, [bytes(29)], device="meta")


def test_device_entry_in_the_cache():
    _, _, ods = seeded_block(2)
    entry = _device_entry(ods)
    cache = edscache.EdsCache()
    assert cache.put(edscache.cache_key(ods), entry) is entry
    assert cache.get_or_compute(ods, device="cpu") is entry
    assert cache.lookup_root(entry.data_root) is entry
    assert edscache.entry_nbytes(entry) == (2 * 2) ** 2 * 512 * 2


# -- the SHA-256 padding tail --------------------------------------------------


def test_padding_tail_is_built_once_per_length(monkeypatch):
    msgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (5, 181), dtype=np.uint8))
    first = sha256.pack_blocks(msgs)

    def no_upload(*args, **kwargs):
        raise AssertionError("pack_blocks built its tail from host memory again")

    monkeypatch.setattr(torch, "tensor", no_upload)
    assert torch.equal(sha256.pack_blocks(msgs), first)
    assert sha256.padding_tail(181, "cpu") is sha256.padding_tail(181, torch.device("cpu"))
    monkeypatch.undo()
    tail = sha256.padding_tail(55, "cpu")
    assert tail.tolist() == [0x80] + list((55 * 8).to_bytes(8, "big"))  # 55 + 9 bytes: one block
    assert sha256.padding_tail(56, "cpu").tolist() == [0x80] + [0] * 63 + list((56 * 8).to_bytes(8, "big"))


# -- big squares: layout and header bounds -------------------------------------


@pytest.mark.parametrize("blobs,want_k", [(42, 256), (8, 64)])
def test_square_build_at_max_square_size_512_matches_reference(blobs, want_k):
    """A block of 200 KB blobs, the upstream big-block manifests' size, laid
    out under max_square_size=512: more than 16,384 shares need k = 256."""
    rng = np.random.default_rng(blobs)
    ns = [bytes(18) + rng.bytes(10) for _ in range(4)]
    pfbs = [(rng.bytes(300), [(b"\x00" + ns[i % 4], rng.bytes(200_000))]) for i in range(blobs)]
    txs = [rng.bytes(200) for _ in range(20)]
    sq = square.build(txs, _port_pfbs(pfbs), 512, 64)
    want = jax_square.build(txs, _jax_pfbs(pfbs), 512, 64)
    assert sq.size == want.size == want_k
    assert sq.share_bytes() == want.share_bytes() and sq.blob_start_indexes == want.blob_start_indexes
    assert dah.shares_to_ods(sq.share_bytes()).shape == (want_k, want_k, 512)
    with pytest.raises(ValueError, match="does not fit"):
        square.construct(txs, _port_pfbs(pfbs), want_k // 2, 64)
    txs2, pfbs2 = _mix(7, 3, 2, 300)
    assert square.build(txs2, _port_pfbs(pfbs2), 512, 64).share_bytes() == \
        jax_square.build(txs2, _jax_pfbs(pfbs2), 512, 64).share_bytes()


@pytest.mark.parametrize("width", [2, 512, 1024, 2048])
def test_dah_bounds_at_the_big_square_sizes(width):
    roots = tuple(bytes([i % 256]) * 90 for i in range(width))
    got = dah.DataAvailabilityHeader(row_roots=roots, col_roots=roots)
    want = jax_dah.DataAvailabilityHeader(row_roots=roots, col_roots=roots)
    assert got.hash() == want.hash()
    outcome = []
    for header in (got, want):
        try:
            header.validate_basic()
            outcome.append("ok")
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    assert (outcome[0] == "ok") == (width <= dah.MAX_EXTENDED_SQUARE_WIDTH)
