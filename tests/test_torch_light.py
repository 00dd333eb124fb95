"""The port's light client against the JAX package's on fraud proofs
(tolerance: exact verdicts and condemned roots).

- A valid bad-encoding fraud proof (BEFP) of a k = 4 square with one
  flipped parity cell condemns the root on ``device="cpu"`` exactly as
  the reference's ``LightClient`` does; an honest root is not condemned.
- Proofs that do not parse against the commitments (tampered, or of
  another scheme's shape) are refused and counted in
  ``light.malformed_fraud_proofs`` in both packages.
- An error of the device work is no verdict: a RuntimeError of the card
  (a monkeypatched ``verify_befp``, or no card at all) and a K1 or K2
  wrapper error propagate out of ``submit_fraud_proof``, and nothing is
  counted or condemned.
"""

import dataclasses

import pytest
import torch

from celestia_app_tpu.chain import light as jax_light
from celestia_app_tpu.da import dah as jax_dah
from celestia_app_tpu.da import fraud as jax_fraud
from celestia_app_tpu.utils import telemetry as jax_telemetry
from celestia_app_tpu_torch import cuda_build
from celestia_app_tpu_torch.chain import light
from celestia_app_tpu_torch.da import cmt, dah, fraud
from celestia_app_tpu_torch.ops import rs_kernel, sha256_kernel
from celestia_app_tpu_torch.utils import telemetry
from test_torch_fraud import corrupt_square, reference_dah, to_port, to_reference
from test_torch_repair import blind_dah, square_of

CHAIN = "torch-light-test"


def clients():
    """A port and a reference light client with an empty trusted set (the
    fraud check does not read it)."""
    return (light.LightClient(CHAIN, light.TrustedState(0, b"", {}, {})),
            jax_light.LightClient(CHAIN, jax_light.TrustedState(0, b"", {}, {})))


def malformed(module) -> int:
    return module.snapshot()["counters"].get("light.malformed_fraud_proofs", 0)


def bad_case(seed: int = 5):
    """(DAH committing a k = 4 non-codeword, a valid BEFP of its bad row)."""
    square, index = corrupt_square(4, seed=seed, axis="row")
    return blind_dah(square), fraud.generate_befp(dah.ExtendedDataSquare(square), "row", index)


def test_valid_befp_condemns_the_root_like_the_reference():
    d, befp = bad_case()
    port, ref = clients()
    before = (malformed(telemetry), malformed(jax_telemetry))
    assert port.submit_fraud_proof(d, befp, device="cpu") is True
    assert ref.submit_fraud_proof(reference_dah(d), to_reference(befp)) is True
    assert port.condemned_roots == ref.condemned_roots == {d.hash()}
    assert (malformed(telemetry), malformed(jax_telemetry)) == before


def test_honest_root_is_not_condemned():
    k = 4
    d_ok, eds, _ = dah.new_dah_from_ods(square_of(k, seed=7), device="cpu")
    befp = fraud.generate_befp(eds, "row", 1)
    port, ref = clients()
    assert port.submit_fraud_proof(d_ok, befp, device="cpu") is False
    assert ref.submit_fraud_proof(reference_dah(d_ok), to_reference(befp)) is False
    assert port.condemned_roots == ref.condemned_roots == set()


def test_malformed_proofs_are_refused_and_counted_like_the_reference():
    d, befp = bad_case(seed=11)
    cmt_entry = cmt.build_layers(square_of(4, seed=3), device="cpu")
    commitments = cmt.CmtCodec().commitments_from_doc(
        cmt.CmtCodec().commitments_doc(cmt_entry), cmt_entry.data_root.hex(), 4)
    port, ref = clients()
    # a proof of the bad row against another scheme's commitments: the
    # proof's own fault, in both packages
    before = (malformed(telemetry), malformed(jax_telemetry))
    assert port.submit_fraud_proof(commitments, befp, device="cpu") is False
    assert ref.submit_fraud_proof(commitments, to_reference(befp)) is False
    assert (malformed(telemetry), malformed(jax_telemetry)) == (before[0] + 1, before[1] + 1)
    # tampered members: verify_befp's own checks say False, nothing counted
    forged = dataclasses.replace(befp, shares=(dataclasses.replace(befp.shares[0], share=b"\xee" * 512),)
                                 + befp.shares[1:])
    assert port.submit_fraud_proof(d, forged, device="cpu") is False
    assert ref.submit_fraud_proof(reference_dah(d), to_reference(forged)) is False
    assert port.condemned_roots == ref.condemned_roots == set()
    # an object of no registered proof type selects no codec
    assert port.submit_fraud_proof(d, object(), device="cpu") is False
    assert ref.submit_fraud_proof(reference_dah(d), object()) is False


def test_a_card_error_propagates(monkeypatch):
    d, befp = bad_case()
    port, _ = clients()
    before = malformed(telemetry)

    def card_error(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(fraud, "verify_befp", card_error)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port.submit_fraud_proof(d, befp, device="cpu")
    assert port.condemned_roots == set() and malformed(telemetry) == before


def test_no_card_raises_instead_of_refusing(monkeypatch):
    """Without ``device=`` the check runs on the card; where there is none
    that is an error, not a refused proof."""
    d, befp = bad_case()
    port, _ = clients()
    before = malformed(telemetry)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.submit_fraud_proof(d, befp)
    assert port.condemned_roots == set() and malformed(telemetry) == before


@pytest.mark.parametrize("target", ["extend_lines", "compress_words"])
def test_a_kernel_wrapper_error_propagates(monkeypatch, target):
    """The wrapper's own argument errors are ValueErrors and TypeErrors, as
    a proof's are, but they are no verdict: they propagate."""
    d, befp = bad_case()
    port, _ = clients()
    before = malformed(telemetry)
    if target == "extend_lines":
        orig = rs_kernel.extend_lines
        monkeypatch.setattr(rs_kernel, "extend_lines", lambda groups, operand: orig(groups, operand[:-1]))
        want = ValueError
    else:
        orig = sha256_kernel.compress_words
        monkeypatch.setattr(sha256_kernel, "compress_words", lambda blocks: orig(blocks.to(torch.int64)))
        want = TypeError
    with pytest.raises(want) as got:
        port.submit_fraud_proof(d, befp, device="cpu")
    assert isinstance(got.value, cuda_build.KernelError)
    assert port.condemned_roots == set() and malformed(telemetry) == before


def test_reference_befp_condemns_in_the_port():
    """A BEFP the reference built condemns the same root in the port."""
    square, index = corrupt_square(4, seed=21, axis="col")
    d = blind_dah(square)
    want = jax_fraud.generate_befp(jax_dah.ExtendedDataSquare(square), "col", index)
    port, ref = clients()
    assert port.submit_fraud_proof(d, to_port(want), device="cpu") is True
    assert ref.submit_fraud_proof(reference_dah(d), want) is True
    assert port.condemned_roots == ref.condemned_roots == {d.hash()}


def test_an_attribute_error_of_the_check_propagates(monkeypatch):
    """A fault of the port's own check (here an AttributeError) is no
    verdict either: only a proof of another scheme, or one that does not
    parse, is refused and counted."""
    d, befp = bad_case()
    port, _ = clients()
    before = malformed(telemetry)

    def port_bug(*args, **kwargs):
        raise AttributeError("'NoneType' object has no attribute 'row_roots'")

    monkeypatch.setattr(fraud, "verify_befp", port_bug)
    with pytest.raises(AttributeError, match="row_roots"):
        port.submit_fraud_proof(d, befp, device="cpu")
    assert port.condemned_roots == set() and malformed(telemetry) == before
