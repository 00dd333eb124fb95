"""The port's namespace reads against the JAX package, field for field
(tolerance: exact): the batched search (on the CPU) and the host scan, for
present namespaces, absent ones inside a row's namespace window (successor
proof) and absent ones outside every window (no proof), each verified
against the DAH; and tampered or mislabelled reads fail to verify."""

import dataclasses

import numpy as np
import pytest
import torch

from celestia_app_tpu.da import namespace_data as jax_namespace_data
from celestia_app_tpu.da import namespace_device as jax_namespace_device
from celestia_app_tpu_torch.da import dah, namespace_data, namespace_device, proof_device
from test_torch_proof import KS, fields, provers, seeded_block


def _queries(sq, ods):
    """Present namespaces in sorted order, then absent ones: one between two
    present namespaces (inside a row window where the square has several),
    one below every share, one just above the PFB namespace, and a
    duplicate of the first query."""
    k = sq.size
    present = sorted({ods[r, c, :29].tobytes() for r in range(k) for c in range(k)})
    absent = [bytes(29)]
    blob_ns = sorted({b.namespace.raw for e in sq.pfbs for b in e.blobs})
    if len(blob_ns) >= 2:
        lo = int.from_bytes(blob_ns[0], "big")
        absent.append((lo + 1).to_bytes(29, "big"))  # between the first two blob namespaces
    absent.append((int.from_bytes(present[0], "big") + 1).to_bytes(29, "big"))
    absent = [ns for ns in absent if ns not in present]
    return present + absent + [present[0]], present


@pytest.mark.parametrize("k", KS)
def test_batched_matches_reference(k):
    sq, _, ods = seeded_block(k)
    prover, want_prover, d, _ = provers(ods)
    queries, present = _queries(sq, ods)
    got = namespace_device.get_namespace_data_batched(prover, queries, device="cpu")
    want = jax_namespace_device.get_namespace_data_batched(want_prover, queries, engine="host")
    assert len(got) == len(queries)
    for q, nd, w in zip(queries, got, want):
        assert fields(nd) == fields(w)
        assert fields(nd) == fields(jax_namespace_data.get_namespace_data(want_prover, q))
        assert fields(nd) == fields(namespace_data.get_namespace_data(prover, q))
        assert namespace_data.verify_namespace_data(d, q, nd)
        assert bool(nd.shares) == (q in present)
    kinds = {(bool(nd.shares), nd.proof is not None) for nd in got}
    assert (True, True) in kinds and (False, False) in kinds
    if k >= 4:
        assert (False, True) in kinds  # an absence with a successor proof


def test_search_orders_hits_row_major():
    leaf = torch.tensor([[1], [2], [2], [2], [3]], dtype=torch.uint8).expand(5, 29).contiguous()
    qs = torch.tensor([[2], [9], [3]], dtype=torch.uint8).expand(3, 29).contiguous()
    starts, ends, counts = namespace_device.search(leaf, qs).tolist()
    assert (starts, ends, counts) == ([1, 5, 4], [4, 0, 5], [3, 0, 1])


def test_non_contiguous_namespace_raises():
    """A square that is not namespace-sorted is refused by both paths."""
    k = 4
    rng = np.random.default_rng(3)
    ods = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    ods[..., :19] = 0
    target = ods[0, 0, :29].copy()
    ods[2, 1, :29] = target  # a second, separate run of the first namespace
    d, eds, _ = dah.new_dah_from_ods(ods, device="cpu")
    prover = proof_device.BlockProver(eds, d, device="cpu")
    with pytest.raises(AssertionError):
        namespace_device.get_namespace_data_batched(prover, [target.tobytes()], device="cpu")
    with pytest.raises(AssertionError):
        namespace_data.get_namespace_data(prover, target.tobytes())


def test_tampered_reads_fail():
    sq, _, ods = seeded_block(8)
    prover, _, d, _ = provers(ods)
    queries, present = _queries(sq, ods)
    blob_ns = sorted({b.namespace.raw for e in sq.pfbs for b in e.blobs})
    got = namespace_device.get_namespace_data_batched(prover, blob_ns + queries[len(present):-1],
                                                      device="cpu")
    multi = next(nd for nd in got if len(nd.shares) > 1)
    assert namespace_data.verify_namespace_data(d, multi.namespace, multi)
    # a dropped share breaks the proof
    assert not namespace_data.verify_namespace_data(
        d, multi.namespace, dataclasses.replace(multi, shares=multi.shares[:-1]))
    # claiming a present namespace absent fails
    assert not namespace_data.verify_namespace_data(
        d, multi.namespace, dataclasses.replace(multi, shares=[], proof=None))
    # a result for another namespace does not answer this one
    other = next(nd for nd in got if nd.namespace != multi.namespace and nd.shares)
    assert not namespace_data.verify_namespace_data(d, multi.namespace, other)
    # a successor proof for a namespace that is present fails
    succ = next((nd for nd in got if not nd.shares and nd.proof is not None), None)
    if succ is not None:
        assert not namespace_data.verify_namespace_data(
            d, multi.namespace, dataclasses.replace(succ, namespace=multi.namespace))


def test_helpers_match_reference():
    ns = bytes(19) + b"\x07" * 10
    assert namespace_device.parse_namespace(ns.hex()) == jax_namespace_device.parse_namespace(ns.hex())
    assert namespace_device.decode_namespace("") == b""
    for bad in ("zz", "00" * 28):
        with pytest.raises(ValueError):
            namespace_device.parse_namespace(bad)
    share = ns + bytes(512 - 29)
    arr = np.frombuffer(share, dtype=np.uint8)
    assert namespace_device.share_namespace(share) == namespace_device.share_namespace(arr) == ns
    assert namespace_device.share_namespace(arr) == jax_namespace_device.share_namespace(arr)
    sq, _, ods = seeded_block(4)
    prover, want_prover, _, _ = provers(ods)
    np.testing.assert_array_equal(namespace_device.leaf_namespaces(prover),
                                  jax_namespace_device.leaf_namespaces(want_prover))
    assert namespace_device.get_namespace_data_batched(prover, [], device="cpu") == []
    with pytest.raises(ValueError):
        namespace_device.get_namespace_data_batched(prover, [bytes(28)], device="cpu")
    with pytest.raises(ValueError):
        namespace_data.get_namespace_data(prover, bytes(30))


def test_batched_read_needs_a_card_by_default(monkeypatch):
    _, _, ods = seeded_block(2)
    prover, _, _, _ = provers(ods)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        namespace_device.get_namespace_data_batched(prover, [bytes(29)])
