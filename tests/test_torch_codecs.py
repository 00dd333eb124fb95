"""The port's CMT and PCMT codecs (da/cmt.py, da/pcmt.py), their registry,
cache dispatch and malicious producers against the JAX package (tolerance:
exact bytes): data roots, every layer and hash list, the frozen roots, the
empty-block roots, sample docs and tamper rejection, repair at the declared
threshold and below it, bad-encoding attribution, fraud proofs (equal
dataclasses, accepted on the bad commitments and rejected on honest ones),
the registry and the cache keys, at k <= 16."""

import base64
import dataclasses

import numpy as np
import pytest
import torch

from celestia_app_tpu.da import codec as jax_codec
from celestia_app_tpu.da import edscache as jax_edscache
from celestia_app_tpu.testing import malicious as jax_malicious
from celestia_app_tpu_torch.da import cmt, codec, codec_rs2d, edscache, pcmt
from celestia_app_tpu_torch.testing import malicious
from celestia_app_tpu_torch.utils import fast_host

SCHEMES = (codec.CMT_NAME, codec.PCMT_NAME)
KS = (4, 8, 16)

# the frozen roots tests/test_codec_iface.py pins for the JAX package
FROZEN_MIN_ROOT = {
    "cmt-ldpc": "b14c97a1825a294c0cd9727539c36e8a7b14976b2dd29e7895b79075f1425da7",
    "pcmt-polar": "ea8f58f171338ec6e9acb8d41651279bdae26755a3e24835d5415a70f4af04e1",
}
FROZEN_ROOT = {
    "cmt-ldpc": {4: "ecb93696cccd83f43aa92b324296a17fce6c5b3b24c136f50b1e3ed57e3b36da",
                 8: "e8bb3e85b5bfae79438fd436acd1afa22d002a679395c861bb9fba59dfb893ea"},
    "pcmt-polar": {4: "30cd7537522eb44d4daf235a253a29f8336f694626039a4e85b505605fb15986",
                   8: "fe7c3a6cd47a6cb58244971c39e663f46456c8e8e5fb0b47e00c9f1a5a9154cd"},
}


def _ods(k: int, seed: int = 7) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, size=(k, k, 512), dtype=np.uint8)


def _commitments(c, entry, k):
    return c.commitments_from_doc(c.commitments_doc(entry), entry.data_root.hex(), k)


def _bad_entries(scheme: str, ods: np.ndarray):
    """(port entry, reference entry, fraud location) of one malicious block."""
    if scheme == codec.CMT_NAME:
        return (malicious.cmt_bad_parity_entry(ods, 3, device="cpu"),
                jax_malicious.cmt_bad_parity_entry(ods, 3), (0, 3))
    port = malicious.pcmt_bad_parity_entry(ods, device="cpu")
    ref = jax_malicious.pcmt_bad_parity_entry(ods)
    assert port.fraud_location == ref.fraud_location
    return port, ref, port.fraud_location


def _all_samples(c, comm, entry) -> dict:
    return {cell: c.verify_sample(comm, c.open_sample(entry, cell))[1] for cell in c.sample_space(comm)}


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("k", KS)
def test_encode_matches_reference(scheme, k):
    ods = _ods(k, seed=k)
    entry = codec.get(scheme).compute_entry(ods, device="cpu")
    want = jax_codec.get(scheme).compute_entry(ods, "host")
    assert entry.data_root == want.data_root == entry.dah.hash()
    assert entry.dah == type(entry.dah)(**dataclasses.asdict(want.dah))
    assert entry.scheme == scheme and entry.k == k and entry.eds is None
    assert len(entry.layers) == len(want.layers) == len(entry.dah.plan)
    for got, exp in zip(entry.layers + entry.hash_lists, want.layers + want.hash_lists):
        np.testing.assert_array_equal(got, exp)
    if scheme == codec.PCMT_NAME:
        for levels, want_levels in zip(entry.subtrees, want.subtrees, strict=True):
            for got, exp in zip(levels, want_levels, strict=True):
                np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(entry.ods(), ods)
    # the host yardstick: numpy encode and hashlib, layer by layer
    for layer, hashes in zip(entry.layers, entry.hash_lists):
        np.testing.assert_array_equal(fast_host.sha_many(layer), hashes)
    c = codec.get(scheme)
    assert c.commitments_doc(entry) == jax_codec.get(scheme).commitments_doc(want)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_frozen_and_empty_block_roots(scheme):
    c = codec.get(scheme)
    for k, want in FROZEN_ROOT[scheme].items():
        assert c.compute_entry(_ods(k), device="cpu").data_root.hex() == want
    assert c.min_entry(device="cpu").data_root.hex() == FROZEN_MIN_ROOT[scheme]
    assert jax_codec.get(scheme).min_entry("host").data_root.hex() == FROZEN_MIN_ROOT[scheme]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("k", [8, 16])
def test_sample_docs_match_reference_and_tamper_fails(scheme, k):
    c, ref = codec.get(scheme), jax_codec.get(scheme)
    ods = _ods(k)
    entry, want = c.compute_entry(ods, device="cpu"), ref.compute_entry(ods, "host")
    comm = _commitments(c, entry, k)
    ref_comm = _commitments(ref, want, k)
    space = c.sample_space(comm)
    assert space == ref.sample_space(ref_comm)
    assert c.hashes_per_sample_verify(comm) == ref.hashes_per_sample_verify(ref_comm)
    plan = comm.plan
    probes = [space[0], space[len(space) // 2], space[-1]] + [(j, 0) for j in range(1, len(plan))]
    for cell in probes:
        doc = c.open_sample(entry, cell)
        assert doc == ref.open_sample(want, cell)
        assert c.verify_sample(comm, doc) == ref.verify_sample(ref_comm, doc)
        assert c.verify_sample(comm, doc)[0] == cell
        assert c.sample_wire_bytes(doc, comm) == ref.sample_wire_bytes(doc, ref_comm)
        raw = bytearray(base64.b64decode(doc["symbol"]))
        raw[0] ^= 1
        assert c.verify_sample(comm, {**doc, "symbol": base64.b64encode(bytes(raw)).decode()}) is None
        for s, step in enumerate(doc["steps"]):
            for i in range(len(step)):
                steps = [list(st) for st in doc["steps"]]
                sib = bytearray(base64.b64decode(steps[s][i]))
                sib[0] ^= 1
                steps[s][i] = base64.b64encode(bytes(sib)).decode()
                assert c.verify_sample(comm, {**doc, "steps": steps}) is None
        moved = c.verify_sample(comm, {**doc, "index": (doc["index"] + 1) % comm.n_base})
        assert moved is None or moved[0] != cell
    for bad in ({}, {"layer": "x"}, {"layer": len(plan), "index": 0, "symbol": "", "steps": []}):
        assert c.verify_sample(comm, bad) is None
    with pytest.raises(codec.CodecError):
        c.open_sample(entry, (len(plan), 0))
    with pytest.raises(codec.CodecError):
        c.sample_wire_bytes(c.open_sample(entry, space[0]))


def _outcome(fn):
    """What a repair returns, or the type and text of what it raises."""
    try:
        return fn()
    except ValueError as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("k", [4, 8, 16])
def test_repair_at_threshold_and_below(scheme, k):
    c, ref = codec.get(scheme), jax_codec.get(scheme)
    ods = _ods(k)
    entry = c.compute_entry(ods, device="cpu")
    comm = _commitments(c, entry, k)
    ref_comm = _commitments(ref, ref.compute_entry(ods, "host"), k)
    samples = _all_samples(c, comm, entry)
    space = c.sample_space(comm)
    drop = set(np.random.RandomState(11).choice(len(space), size=len(space) * c.CATCH_BP // 10000,
                                                replace=False).tolist())
    kept = {cell: b for i, (cell, b) in enumerate(samples.items()) if i not in drop}
    got = _outcome(lambda: c.repair(comm, kept, device="cpu"))
    want = _outcome(lambda: ref.repair(ref_comm, kept, "host"))
    if isinstance(want, tuple):
        assert got == want  # the same stall, with the same count
    else:
        np.testing.assert_array_equal(got, want)
    if k >= 8:  # the declared threshold peels at the reference's own test size and up
        np.testing.assert_array_equal(got, ods)
    sliver = dict(list(samples.items())[: max(2, len(space) // 16)])
    with pytest.raises(ValueError) as exc:
        c.repair(comm, sliver, device="cpu")
    assert not isinstance(exc.value, codec.BadEncodingDetected)
    assert _outcome(lambda: c.repair(comm, sliver, device="cpu")) == _outcome(
        lambda: ref.repair(ref_comm, sliver, "host"))
    with pytest.raises(ValueError, match="no base-layer samples"):
        c.repair(comm, {(1, 0): b"\x00"} if len(comm.plan) > 1 else {}, device="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("k", [4, 8])
def test_bad_encoding_attribution_matches_reference(scheme, k):
    c, ref = codec.get(scheme), jax_codec.get(scheme)
    ods = _ods(k)
    bad, ref_bad, location = _bad_entries(scheme, ods)
    assert bad.data_root == ref_bad.data_root
    for got, exp in zip(bad.layers, ref_bad.layers):
        np.testing.assert_array_equal(got, exp)
    comm = bad.dah
    samples = _all_samples(c, comm, bad)  # sampling alone cannot see it
    err = cmt.CmtBadEncodingError if scheme == codec.CMT_NAME else pcmt.PcmtBadEncodingError
    with pytest.raises(err) as exc:
        c.repair(comm, samples, device="cpu")
    assert exc.value.location == (exc.value.layer, exc.value.equation) == location
    with pytest.raises(jax_codec.BadEncodingDetected) as ref_exc:
        ref.repair(ref_bad.dah, samples, "host")
    assert ref_exc.value.location == location
    assert c.fraud_cells(comm, location) == ref.fraud_cells(ref_bad.dah, location)
    # one member withheld: inconsistent, no longer attributable
    short = {cell: b for cell, b in samples.items() if cell != c.fraud_cells(comm, location)[0]}
    with pytest.raises(ValueError) as exc2:
        c.repair(comm, short, device="cpu")
    assert not isinstance(exc2.value, codec.BadEncodingDetected)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fraud_proofs_match_reference(scheme):
    k = 8
    c, ref = codec.get(scheme), jax_codec.get(scheme)
    ods = _ods(k)
    bad, ref_bad, location = _bad_entries(scheme, ods)
    proof = c.build_fraud_proof(bad, location)
    assert isinstance(proof, c.fraud_proof_type())
    assert dataclasses.astuple(proof) == dataclasses.astuple(ref.build_fraud_proof(ref_bad, location))
    assert c.verify_fraud_proof(bad.dah, proof) is True
    honest = c.compute_entry(ods, device="cpu")
    honest_comm = _commitments(c, honest, k)
    assert c.verify_fraud_proof(honest_comm, proof) is False
    assert c.verify_fraud_proof(honest_comm, c.build_fraud_proof(honest, location)) is False
    # assembled from served members, the same proof
    members = [(cell, c.verify_sample(bad.dah, c.open_sample(bad, cell))[1], c.open_sample(bad, cell))
               for cell in c.fraud_cells(bad.dah, location)]
    assert c.fraud_proof_from_members(bad.dah, location, members) == proof
    # malformed: wrong equation, reordered members, another scheme's commitments
    layer, eq = location
    assert c.verify_fraud_proof(bad.dah, dataclasses.replace(proof, equation=eq + 1)) is False
    assert c.verify_fraud_proof(bad.dah, dataclasses.replace(proof, members=proof.members[::-1])) is False
    assert c.verify_fraud_proof(bad.dah, dataclasses.replace(proof, layer=99)) is False
    other = codec.get(codec.PCMT_NAME if scheme == codec.CMT_NAME else codec.CMT_NAME)
    assert c.verify_fraud_proof(other.compute_entry(ods, device="cpu").dah, proof) is False
    assert c.verify_fraud_proof(honest.dah.__class__(k=k, root_hashes=()), proof) is False


def test_registry_carries_three_schemes():
    assert codec.names() == jax_codec.names() == ["cmt-ldpc", "pcmt-polar", "rs2d-nmt"]
    assert codec.registered_ids() == jax_codec.registered_ids() == [0, 1, 2]
    assert isinstance(codec.by_id(1), cmt.CmtCodec) and codec.by_id(1) is codec.get("cmt-ldpc")
    assert isinstance(codec.by_id(2), pcmt.PcmtCodec) and codec.by_id(2) is codec.get("pcmt-polar")
    assert isinstance(codec.by_id(0), codec_rs2d.Rs2dNmtCodec)
    for i in (0, 1, 2):
        port, ref = codec.by_id(i), jax_codec.by_id(i)
        assert (port.name, port.scheme_id, port.CATCH_BP) == (ref.name, ref.scheme_id, ref.CATCH_BP)
        for s in (1, 16, 100):
            assert port.confidence(s) == ref.confidence(s)
    listing = "0=rs2d-nmt, 1=cmt-ldpc, 2=pcmt-polar"
    with pytest.raises(codec.CodecError, match=f"unknown DA scheme id 7 \\(registered: {listing}\\)"):
        codec.by_id(7)
    with pytest.raises(codec.CodecError, match=f"unknown DA scheme 'nope' \\(registered: {listing}\\)"):
        codec.get("nope")
    with pytest.raises(codec.CodecError):
        edscache.compute_entry(_ods(1), device="cpu", scheme="nope")


def test_cache_keys_and_scheme_dispatch(monkeypatch):
    ods = _ods(4)
    keys = {s: edscache.cache_key(ods, s) for s in (codec.RS2D_NAME,) + SCHEMES}
    assert len(set(keys.values())) == 3
    for s, key in keys.items():
        assert key == jax_edscache.cache_key(ods, s)
    assert keys[codec.RS2D_NAME] == edscache.cache_key(ods)
    cache = edscache.EdsCache()
    for s in SCHEMES:
        entry = cache.get_or_compute(ods, device="cpu", scheme=s)
        assert entry.scheme == s and cache.get(keys[s]) is entry
        assert cache.lookup_root(entry.data_root) is entry
        assert cache.get_or_compute(ods, device="cpu", scheme=s) is entry
    assert (cache.hits, cache.misses) == (4, 2)
    calls = []
    monkeypatch.setattr(cmt, "build_layers", lambda *a: calls.append(a))
    cache.get_or_compute(ods, device="cpu", scheme=codec.CMT_NAME)
    assert calls == []  # a hit encodes nothing

    class Sized:
        k, data_root = 128, b"r" * 32

        def nbytes(self):
            return 12345

    assert edscache.entry_nbytes(Sized()) == jax_edscache.entry_nbytes(Sized()) == 12345
    entry = cache.get(keys[codec.CMT_NAME])
    assert edscache.entry_nbytes(entry) == jax_edscache.entry_nbytes(entry) == 8 * 8 * 512 * 2


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ods = _ods(4)
    for s in SCHEMES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            codec.get(s).compute_entry(ods)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            edscache.EdsCache().get_or_compute(ods, scheme=s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        malicious.cmt_bad_parity_entry(ods, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        malicious.pcmt_bad_parity_entry(ods)
    entry = codec.get(codec.CMT_NAME).compute_entry(ods, device="cpu")
    samples = {cell: entry.layers[0][cell[1]].tobytes() for cell in codec.get(codec.CMT_NAME).sample_space(entry.dah)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codec.get(codec.CMT_NAME).repair(entry.dah, samples)
