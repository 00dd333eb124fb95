"""The port's sampling and rs2d-nmt codec against the JAX package
(tolerance: exact, and equal floats for the confidence arithmetic): sample
reports for the same rng seed, codec docs, sample wire sizes and hash
counts, the codec's repair and fraud proofs, and the registry's three
schemes and its refusal of unknown ones, at k <= 16."""

import dataclasses

import numpy as np
import pytest

from celestia_app_tpu.da import codec as jax_codec
from celestia_app_tpu.da import dah as jax_dah
from celestia_app_tpu.da import proof_device as jax_proof_device
from celestia_app_tpu.da import sampling as jax_sampling
from celestia_app_tpu_torch.da import codec, codec_rs2d, dah, fraud, proof_device, sampling
from test_torch_repair import KS, blind_dah, extended, square_of

MIN_DAH_HASH = bytes.fromhex("3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353")


def provers(k: int, seed: int):
    """(port DAH, port prover, JAX DAH, JAX prover) of one seeded block."""
    ods = square_of(k, seed=seed)
    d, eds, _ = dah.new_dah_from_ods(ods, device="cpu")
    jd, jeds, _ = jax_dah.new_dah_from_ods(ods)
    assert (d.row_roots, d.col_roots) == (jd.row_roots, jd.col_roots)
    return d, proof_device.BlockProver(eds, d, device="cpu"), jd, jax_proof_device.BlockProver(jeds, jd)


def report(module, d, fetch, n, seed):
    return dataclasses.astuple(module.sample_block(d, fetch, n, np.random.default_rng(seed)))


@pytest.mark.parametrize("k", [1, 4, 16])
def test_sample_reports_match_reference(k):
    d, prover, jd, jprover = provers(k, seed=50 + k)
    got = report(sampling, d, prover.prove_cell, 16, seed=k)
    assert got == report(jax_sampling, jd, jprover.prove_cell, 16, seed=k)
    assert got[1] == 16 and got[2] == [] and got[3] == 1 - 0.75 ** 16

    def withholding(prove_cell):
        def fetch(row, col):  # the server hides Q3
            if row >= k and col >= k:
                raise OSError("not serving that cell")
            return prove_cell(row, col)
        return fetch

    errors = sampling.sample_block.fetch_errors
    got = report(sampling, d, withholding(prover.prove_cell), 40, seed=100 + k)
    assert got == report(jax_sampling, jd, withholding(jprover.prove_cell), 40, seed=100 + k)
    assert got[2] and all(r >= k and c >= k for r, c in got[2])
    assert sampling.sample_block.fetch_errors - errors == len(got[2])


def test_tampered_and_misplaced_samples_fail():
    k = 4
    d, prover, jd, _ = provers(k, seed=61)
    share, proof = prover.prove_cell(1, 2)
    for args in (((1, 2, b"\x00" * 512, proof)), (1, 3, share, proof), (1, 2, share[:-1], proof),
                 (2 * k, 2, share, proof)):
        assert sampling.verify_sample(d, *args) is False
        assert jax_sampling.verify_sample(jd, *args) is False
    assert sampling.verify_sample(d, 1, 2, share, proof) is True
    # a parity cell takes the parity namespace
    share, proof = prover.prove_cell(k + 1, 2 * k - 1)
    assert sampling.leaf_namespace(k + 1, 2 * k - 1, share, k) == jax_sampling.leaf_namespace(
        k + 1, 2 * k - 1, share, k) != share[:29]
    assert sampling.verify_sample(d, k + 1, 2 * k - 1, share, proof)


def test_confidence_arithmetic_matches_reference():
    port, ref = codec.get(codec.RS2D_NAME), jax_codec.get(jax_codec.RS2D_NAME)
    for s in (0, 1, 8, 16, 100):
        assert port.confidence(s) == ref.confidence(s)
        assert sampling.catch_confidence(s) == jax_sampling.catch_confidence(s)
        assert sampling.withholding_catch_confidence(s) == jax_sampling.withholding_catch_confidence(s)
    for target in (0.5, 0.9, 0.99, 0.999999):
        assert port.samples_for_confidence(target) == ref.samples_for_confidence(target)
        assert sampling.samples_for_confidence(target) == jax_sampling.samples_for_confidence(target)
    assert port.catch_probability() == ref.catch_probability() == 0.25
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(codec.CodecError, match="not in"):
            port.samples_for_confidence(bad)


def test_registry_carries_rs2d_only():
    # the name predates the CMT and PCMT ports: rs2d-nmt is the default and
    # the registry now carries the reference's three schemes
    assert codec.names() == [codec.CMT_NAME, codec.PCMT_NAME, codec.RS2D_NAME] == jax_codec.names()
    assert codec.registered_ids() == [codec.SCHEME_RS2D, codec.SCHEME_CMT, codec.SCHEME_PCMT]
    assert codec.default() is codec.by_id(0) is codec.get("rs2d-nmt")
    assert isinstance(codec.default(), codec_rs2d.Rs2dNmtCodec)
    assert (codec.SCHEME_RS2D, codec.SCHEME_CMT, codec.SCHEME_PCMT) == (
        jax_codec.SCHEME_RS2D, jax_codec.SCHEME_CMT, jax_codec.SCHEME_PCMT)
    assert (codec.RS2D_NAME, codec.CMT_NAME, codec.PCMT_NAME) == (
        jax_codec.RS2D_NAME, jax_codec.CMT_NAME, jax_codec.PCMT_NAME)
    for name in (codec.CMT_NAME, codec.PCMT_NAME):
        assert sampling.catch_confidence(1, name) == jax_sampling.catch_confidence(1, name) == 0.25
    listing = "0=rs2d-nmt, 1=cmt-ldpc, 2=pcmt-polar"
    with pytest.raises(codec.CodecError, match=f"unknown DA scheme 'nope' \\(registered: {listing}\\)"):
        codec.get("nope")
    with pytest.raises(codec.CodecError, match="'nope'"):
        sampling.catch_confidence(1, "nope")
    for scheme_id in (3, 7):
        with pytest.raises(codec.CodecError, match=f"id {scheme_id} \\(registered: {listing}\\)"):
            codec.by_id(scheme_id)
    assert issubclass(codec.CodecError, ValueError)


@pytest.mark.parametrize("k", KS)
def test_codec_docs_and_samples_match_reference(k):
    ods = square_of(k, seed=70 + k)
    port, ref = codec.default(), jax_codec.default()
    entry = port.compute_entry(ods, device="cpu")
    want = ref.compute_entry(ods, "device")
    doc = port.commitments_doc(entry)
    assert doc == ref.commitments_doc(want)
    d = port.commitments_from_doc(doc, entry.data_root.hex(), k)
    assert (d.row_roots, d.col_roots) == (want.dah.row_roots, want.dah.col_roots)
    assert port.sample_space(d) == ref.sample_space(want.dah)
    assert port.hashes_per_sample_verify(d) == ref.hashes_per_sample_verify(want.dah)
    for cell in [(0, 0), (2 * k - 1, 2 * k - 1), (k - 1, k), (k, 0)]:
        sample = port.open_sample(entry, cell, device="cpu")
        assert sample == ref.open_sample(want, cell)
        assert port.sample_wire_bytes(sample, d) == ref.sample_wire_bytes(sample, want.dah)
        assert port.verify_sample(d, sample) == (cell, entry.eds.squares[cell].tobytes())
        assert port.verify_sample(d, dict(sample, col=(cell[1] + 1) % (2 * k))) is None
        assert port.verify_sample(d, {"row": 0}) is None
    for bad, match in ((dict(doc, row_roots=["zz"]), "malformed"), (doc, "bind"),
                       (dict(doc, row_roots=doc["row_roots"][:1]), "too few")):
        with pytest.raises(codec.CodecError, match=match) as got:
            port.commitments_from_doc(bad, ("00" * 32) if bad is doc else entry.data_root.hex(), k)
        with pytest.raises(jax_codec.CodecError) as wanted:
            ref.commitments_from_doc(bad, ("00" * 32) if bad is doc else entry.data_root.hex(), k)
        assert str(got.value) == str(wanted.value)
    if k > 1:
        with pytest.raises(codec.CodecError, match="width"):
            port.commitments_from_doc(doc, entry.data_root.hex(), k // 2)
    assert port.fraud_proof_type() is fraud.BadEncodingProof


def test_min_entry_is_the_golden_empty_block():
    entry = codec.default().min_entry(device="cpu")
    assert entry.data_root == MIN_DAH_HASH == jax_codec.default().min_entry("device").data_root


@pytest.mark.parametrize("k", [2, 4])
def test_codec_repair_and_fraud_match_reference(k):
    port, ref = codec.default(), jax_codec.default()
    ods = square_of(k, seed=80 + k)
    entry = port.compute_entry(ods, device="cpu")
    rng = np.random.default_rng(k)
    cols = rng.choice(2 * k, size=k, replace=False)  # k withheld columns
    samples = {(r, c): entry.eds.squares[r, c].tobytes() for r in range(2 * k) for c in range(2 * k)
               if c not in cols}
    got = port.repair(entry.dah, samples, device="cpu")
    np.testing.assert_array_equal(got, ods)
    np.testing.assert_array_equal(got, ref.repair(jax_dah.DataAvailabilityHeader(
        row_roots=entry.dah.row_roots, col_roots=entry.dah.col_roots), samples))
    with pytest.raises(ValueError, match="unsolvable"):
        port.repair(entry.dah, dict(list(samples.items())[:k - 1]), device="cpu")

    # a committed non-codeword: the codec raises its own error at the axis
    square = extended(ods)
    square[1, 2 * k - 1] ^= 0x77
    d_bad = blind_dah(square)
    samples = {(r, c): square[r, c].tobytes() for r in range(2 * k) for c in range(2 * k)
               if not (r == 1 and c >= k)}
    with pytest.raises(codec_rs2d.Rs2dBadEncoding) as err:
        port.repair(d_bad, samples, device="cpu")
    assert err.value.location == ("row", 1) and (err.value.axis, err.value.index) == ("row", 1)
    assert isinstance(err.value, codec.BadEncodingDetected)
    with pytest.raises(jax_codec.BadEncodingDetected) as want:
        ref.repair(jax_dah.DataAvailabilityHeader(row_roots=d_bad.row_roots, col_roots=d_bad.col_roots), samples)
    assert want.value.location == err.value.location and str(want.value) == str(err.value)
    bad_entry = type(entry)(dah.ExtendedDataSquare(square), d_bad, d_bad.hash())
    befp = port.build_fraud_proof(bad_entry, err.value.location)
    assert port.verify_fraud_proof(d_bad, befp, device="cpu") is True
    assert port.verify_fraud_proof(entry.dah, port.build_fraud_proof(entry, ("row", 1)), device="cpu") is False
