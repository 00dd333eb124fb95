"""The port's malicious fixtures (testing/malicious.py) and host oracles
(utils/refimpl.py, utils/fast_host.py) against the JAX package's
(tolerance: exact).

tests/test_malicious.py's five cases run on both packages' Apps with the
same seeded txs: honest ProcessProposal must reject every forged block,
and the forged blocks must be the same bytes. The committed-non-codeword
producers of all three schemes give the reference's entries byte for byte
(extended square or coded layers, axis roots or root hashes, data root,
provable location, withheld cells, wire id), built on ``device="cpu"``
through the kernels' plain versions. ``blind_dah`` — one pipeline pass,
whose NMT checks no namespace order — gives the reference's blind-tree
roots on an out-of-order square."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from celestia_app_tpu.testing import malicious as ref
from celestia_app_tpu.utils import fast_host as ref_fast
from celestia_app_tpu.utils import refimpl as ref_refimpl
from celestia_app_tpu_torch.testing import malicious as port
from celestia_app_tpu_torch.utils import fast_host, nmt_host, refimpl

from test_torch_app import Pkg, make_app

T = 1_700_000_100.0
PKGS = {"ref": ref, "port": port}


def _pfb_txs(p, signer, privs, rng, n=3):
    """Raw blob txs for n blobs with distinct namespaces."""
    addr = privs[0].public_key().address()
    txs = []
    for i in range(n):
        blob = p.Blob(p.Namespace.v0(bytes([i + 1]) * 7),
                      rng.integers(0, 256, 600 + i * 480, dtype=np.uint8).tobytes())
        txs.append(signer.create_pay_for_blobs(addr, [blob], fee=200_000, gas_limit=1_000_000))
        signer.accounts[addr].sequence += 1
    return txs


def _ods(k: int, seed: int) -> np.ndarray:
    o = np.random.default_rng(seed).integers(0, 256, size=(k, k, 512), dtype=np.uint8)
    o[..., :29] = 0
    o[..., 28] = 7
    return o


def _swapped(ods: np.ndarray) -> np.ndarray:
    """An out-of-order ODS: the first two cells carry namespaces 9 and 3."""
    out = ods.copy()
    out[0, 0, 28], out[0, 1, 28] = 9, 3
    return out


# -- tests/test_malicious.py on both packages --------------------------------


def test_honest_tree_rejects_out_of_order_push():
    tree = nmt_host.NmtTree()
    tree.push(b"\x02" * 29, b"data")
    with pytest.raises(ValueError):
        tree.push(b"\x01" * 29, b"data")
    roots = []
    for m in (port, ref):
        blind = m.BlindNmtTree()
        blind.push(b"\x02" * 29, b"x")
        blind.push(b"\x01" * 29, b"y")  # no error: the malicious hasher
        roots.append(blind.root())
    assert roots[0] is not None and roots[0] == roots[1]


def _forge(which: str, scenario: str, seed: int, n: int):
    """One package's honest block and its forged counterpart, with the
    honest App's verdicts on both."""
    p = Pkg(which)
    rng = np.random.default_rng(seed)
    app, signer, privs = make_app(p)
    txs = _pfb_txs(p, signer, privs, rng, n=n)
    res = app.prepare_proposal(txs, t=T)
    honest = res.block
    if scenario == "out_of_order":
        forged = PKGS[which].out_of_order_prepare(app, txs, t=T)
    else:
        h = honest.header
        bad = {"data_root": dict(data_hash=bytes([h.data_hash[0] ^ 1]) + h.data_hash[1:]),
               "square_size": dict(square_size=h.square_size * 2)}[scenario]
        forged = p.Block(header=dataclasses.replace(h, **bad), txs=honest.txs)
    return (app.process_proposal(honest), app.process_proposal(forged), honest.header.hash(),
            forged.header.hash(), forged.header.data_hash)


@pytest.mark.parametrize("scenario,seed,n", [("out_of_order", 0, 3), ("data_root", 1, 2),
                                             ("square_size", 2, 2)])
def test_forged_proposal_rejected(scenario, seed, n):
    got = _forge("port", scenario, seed, n)
    assert got[0] is True and got[1] is False
    assert got[2] != got[3]
    assert got == _forge("ref", scenario, seed, n)


def test_blind_dah_differs_from_honest():
    """The blind trees give a root over the swapped square that an honest
    recomputation cannot reproduce, and the reference's root."""
    out = []
    for which in ("port", "ref"):
        p = Pkg(which)
        app, signer, privs = make_app(p)
        txs = _pfb_txs(p, signer, privs, np.random.default_rng(3))
        res = app.prepare_proposal(txs, t=T)
        swapped = PKGS[which].swap_first_two_blobs(res.square)
        assert swapped != res.square.share_bytes()
        ods = p.mod("da.dah").shares_to_ods(swapped)
        kw = {"device": "cpu"} if which == "port" else {}
        dah, forged_root = PKGS[which].blind_dah(ods, **kw)
        assert forged_root != res.block.header.data_hash
        out.append((swapped, dah.row_roots, dah.col_roots, forged_root))
    assert out[0] == out[1]


def test_swap_needs_two_blobs():
    p = Pkg("port")
    app, signer, privs = make_app(p)
    res = app.prepare_proposal(_pfb_txs(p, signer, privs, np.random.default_rng(4), n=1), t=T)
    with pytest.raises(ValueError, match="at least two blobs"):
        port.swap_first_two_blobs(res.square)


# -- the committed-non-codeword producers ------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_blind_dah_on_an_out_of_order_square(k):
    """The pipeline's NMT is blind: on an ODS whose namespaces are out of
    order it gives the reference's BlindNmtTree roots (where an honest
    tree raises)."""
    ods = _swapped(_ods(max(k, 2), 11)) if k > 1 else _ods(1, 11)
    dah, root = port.blind_dah(ods, device="cpu")
    want_dah, want_root = ref.blind_dah(ods)
    assert (dah.row_roots, dah.col_roots, root) == (want_dah.row_roots, want_dah.col_roots, want_root)
    if k > 1:
        with pytest.raises(ValueError, match="out of order"):
            refimpl.pipeline_host(ods)


def _entry_bytes(entry) -> tuple:
    """Every committed byte of an entry of any scheme."""
    if hasattr(entry, "eds") and hasattr(entry.dah, "row_roots"):
        return (entry.eds.squares.tobytes(), entry.dah.row_roots, entry.dah.col_roots, entry.data_root)
    layers = tuple(np.asarray(layer).tobytes() for layer in entry.layers)
    return (layers, entry.commitments.root_hashes, entry.data_root)


@pytest.mark.parametrize("k,row,xor", [(4, 0, 0x5A), (4, 1, 0x5A), (8, 5, 0x01)])
def test_rs2d_bad_parity_entry_matches(k, row, xor):
    ods = _ods(k, 5)
    got = port.rs2d_bad_parity_entry(ods, row=row, xor_byte=xor, device="cpu")
    want = ref.rs2d_bad_parity_entry(ods, row=row, xor_byte=xor)
    assert _entry_bytes(got) == _entry_bytes(want)
    assert got.eds.squares[row, k + 2, 0] != fast_host.extend_square_fast(ods)[row, k + 2, 0]


@pytest.mark.parametrize("scheme", ["rs2d-nmt", "cmt-ldpc", "pcmt-polar"])
def test_incorrect_coding_fixture_matches(scheme):
    ods = _ods(4, 5)  # the scenario op's square
    entry, location, withheld, wire = port.incorrect_coding_fixture(scheme, ods, device="cpu")
    r_entry, r_location, r_withheld, r_wire = ref.incorrect_coding_fixture(scheme, ods)
    assert (tuple(location), withheld, wire) == (tuple(r_location), r_withheld, r_wire)
    assert _entry_bytes(entry) == _entry_bytes(r_entry)
    assert getattr(entry, "fraud_location", None) == getattr(r_entry, "fraud_location", None)


def test_incorrect_coding_fixture_rejects_unknown_schemes():
    with pytest.raises(ValueError, match="no malicious fixture"):
        port.incorrect_coding_fixture("rs3d", _ods(2, 0), device="cpu")


# -- the host oracles ----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_host_pipelines_match_the_reference(k):
    ods = _ods(k, 21)
    got, want = fast_host.pipeline_fast(ods), ref_fast.pipeline_fast(ods)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    host, ref_host = refimpl.pipeline_host(ods), ref_refimpl.pipeline_host(ods)
    assert np.array_equal(host[0], ref_host[0]) and host[1:] == ref_host[1:]
    # the two host pipelines agree with each other too
    assert np.array_equal(host[0], got[0]) and bytes(got[3]) == host[3]
    levels, ref_levels = fast_host.nmt_levels_fast(
        fast_host._axis_leaf_ns(got[0], k), got[0]), ref_fast.nmt_levels_fast(
        ref_fast._axis_leaf_ns(got[0], k), got[0])
    assert all(np.array_equal(a, b) for lv, rv in zip(levels, ref_levels) for a, b in zip(lv, rv))


def test_host_oracles_refuse_the_16_bit_range():
    ods = np.zeros((256, 256, 512), dtype=np.uint8)
    with pytest.raises(ValueError) as got:
        refimpl.extend_square_host(ods)
    with pytest.raises(ValueError) as want:
        ref_refimpl.extend_square_host(ods)
    assert str(got.value) == str(want.value) and "k <= 128" in str(got.value)
    with pytest.raises(ValueError) as got:
        fast_host.extend_square_fast(ods)
    with pytest.raises(ValueError) as want:
        ref_fast.extend_square_fast(ods)
    assert str(got.value) == str(want.value)
