"""The port's proof plane against the JAX package, byte for byte (tolerance:
exact): RFC-6962 and NMT host proofs, the BlockProver's row levels, share,
tx and cell proofs and commitments from the EDS, on seeded blocks at
k = 1 ... 16; and tampered proofs fail to verify."""

import dataclasses

import numpy as np
import pytest
import torch

from celestia_app_tpu.da import dah as jax_dah
from celestia_app_tpu.da import proof as jax_proof
from celestia_app_tpu.da import proof_device as jax_proof_device
from celestia_app_tpu.da import square as jax_square
from celestia_app_tpu.utils import merkle_host as jax_merkle_host
from celestia_app_tpu.utils import nmt_host as jax_nmt_host
from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.da import commitment, dah, proof, proof_device, square
from celestia_app_tpu_torch.utils import merkle_host, nmt_host
from test_torch_square import _jax_pfbs, _mix, _port_pfbs

THRESHOLD = appconsts.SUBTREE_ROOT_THRESHOLD
KS = [1, 2, 4, 8, 16]


def fields(obj):
    """A proof object as nested plain tuples, for field-by-field equality
    across the two packages' dataclasses."""
    return dataclasses.astuple(obj)


def seeded_block(k: int):
    """A seeded block that fills a k x k square, laid out by both packages:
    (port square, JAX square, ODS)."""
    txs, pfbs = _mix(k, max(1, k // 2), 3 * k, max(2, k * k * 482 // (2 * k)))
    sq = square.build(txs, _port_pfbs(pfbs), k, THRESHOLD)
    jsq = jax_square.build(txs, _jax_pfbs(pfbs), k, THRESHOLD)
    assert sq.size == k and sq.share_bytes() == jsq.share_bytes()
    return sq, jsq, dah.shares_to_ods(sq.share_bytes())


def provers(ods):
    """(port prover, JAX prover, port DAH, data root) of one ODS."""
    d, eds, root = dah.new_dah_from_ods(ods, device="cpu")
    jd, jeds, jroot = jax_dah.new_dah_from_ods(ods)
    assert root == jroot
    return (proof_device.BlockProver(eds, d, device="cpu"),
            jax_proof_device.BlockProver(jeds, jd), d, root)


# -- RFC-6962 and NMT host proofs -------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13])
def test_merkle_proofs_match_reference(n):
    rng = np.random.default_rng(n)
    leaves = [rng.bytes(int(rng.integers(0, 100))) for _ in range(n)]
    root, proofs = merkle_host.proofs_from_leaves(leaves)
    want_root, want = jax_merkle_host.proofs_from_leaves(leaves)
    assert root == want_root == merkle_host.hash_from_leaves(leaves)
    assert [fields(p) for p in proofs] == [fields(p) for p in want]
    for p, leaf in zip(proofs, leaves):
        assert p.root() == root and p.verify(root, leaf)
        assert not p.verify(root, leaf + b"x")
        assert not p.verify(bytes(32), leaf)
    if n > 1:
        bad = dataclasses.replace(proofs[0], index=n)
        assert not bad.verify(root, leaves[0])


def _nmt_leaves(rng, n):
    """n sorted (namespace, share) leaves with repeated namespaces."""
    pool = sorted(b"\x00" + bytes(18) + rng.bytes(10) for _ in range(max(1, n // 2)))
    nss = sorted(pool[int(i)] for i in rng.integers(0, len(pool), n))
    return [(ns, ns + rng.bytes(512 - 29)) for ns in nss]


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 16])
def test_nmt_range_proofs_match_reference(n):
    rng = np.random.default_rng(100 + n)
    leaves = _nmt_leaves(rng, n)
    tree, want_tree = nmt_host.NmtTree(), jax_nmt_host.NmtTree()
    for ns, data in leaves:
        tree.push(ns, data)
        want_tree.push(ns, data)
    root = nmt_host.serialize(tree.root())
    assert root == jax_nmt_host.serialize(want_tree.root())
    assert nmt_host.deserialize(root) == tree.root()
    for start in range(n):
        for end in range(start + 1, n + 1):
            pf = tree.prove_range(start, end)
            assert fields(pf) == fields(want_tree.prove_range(start, end))
            assert pf.verify(root, leaves[start:end])
            assert not pf.verify(root, leaves[start:end - 1])
            ns, data = leaves[start]
            tampered = (ns, data[:-1] + bytes([data[-1] ^ 1]))
            assert not pf.verify(root, [tampered] + leaves[start + 1:end])
    with pytest.raises(ValueError):
        tree.prove_range(0, n + 1)


def test_nmt_tree_rules_match_reference():
    tree, want = nmt_host.NmtTree(), jax_nmt_host.NmtTree()
    assert tree.root() == want.root()
    ns_hi, ns_lo = b"\x00" * 28 + b"\x02", b"\x00" * 28 + b"\x01"
    tree.push(ns_hi, b"a")
    with pytest.raises(ValueError):
        tree.push(ns_lo, b"b")
    parity = nmt_host.PARITY
    left = nmt_host.leaf_node(ns_lo, b"x")
    right = nmt_host.leaf_node(parity, b"y")
    assert nmt_host.inner_node(left, right) == jax_nmt_host.inner_node(left, right)
    assert nmt_host.inner_node(left, right)[1] == ns_lo  # IgnoreMaxNamespace
    with pytest.raises(ValueError):
        nmt_host.deserialize(b"\x00" * 89)


# -- BlockProver against the JAX package ------------------------------------


@pytest.mark.parametrize("k", KS)
def test_block_prover_matches_reference(k):
    sq, jsq, ods = seeded_block(k)
    prover, want, d, root = provers(ods)
    assert len(prover.levels) == len(want.levels) == 2 + int(np.log2(k))
    for level, want_level in zip(prover.levels, want.levels):
        for got, exp in zip(level, want_level):
            np.testing.assert_array_equal(got, np.asarray(exp))

    ranges = [proof.blob_share_range(sq, i, j)
              for i, e in enumerate(sq.pfbs) for j in range(len(e.blobs))]
    assert ranges == [jax_proof.blob_share_range(jsq, i, j)
                      for i, e in enumerate(jsq.pfbs) for j in range(len(e.blobs))]
    ranges += [(0, 1), (0, k * k), (k - 1, k + 1 if k > 1 else k), (k * k - 1, k * k)]
    for lo, hi in ranges:
        ns = ods.reshape(-1, 512)[lo, :29].tobytes()
        got = prover.prove_shares(lo, hi, ns)
        assert fields(got) == fields(want.prove_shares(lo, hi, ns)), (lo, hi)
        assert fields(got) == fields(proof.new_share_inclusion_proof(prover.eds, d, lo, hi, ns))
        assert got.verify(root)

    for i in range(len(sq.txs) + len(sq.pfbs)):
        assert proof.tx_share_range(sq, i) == jax_proof.tx_share_range(jsq, i)
        got = prover.prove_tx(sq, i)
        assert fields(got) == fields(want.prove_tx(jsq, i))
        assert fields(got) == fields(proof.new_tx_inclusion_proof(sq, prover.eds, d, i))
        assert got.verify(root)

    for i, e in enumerate(sq.pfbs):
        for j, b in enumerate(e.blobs):
            got = prover.commitment_from_eds(sq, i, j, THRESHOLD)
            assert got == want.commitment_from_eds(jsq, i, j, THRESHOLD)
            assert got == commitment.create_commitment(b, THRESHOLD)
            lo, hi = proof.blob_share_range(sq, i, j)
            assert prover.prove_shares(lo, hi, b.namespace.raw).all_shares_in_namespace()

    w = 2 * k
    for r, c in [(0, 0), (0, w - 1), (w - 1, 0), (w - 1, w - 1), (k - 1, k), (k, k - 1)]:
        share, pf = prover.prove_cell(r, c)
        want_share, want_pf = want.prove_cell(r, c)
        assert share == want_share and fields(pf) == fields(want_pf)
        ns = share[:29] if r < k and c < k else nmt_host.PARITY
        assert pf.verify(d.row_roots[r], [(ns, share)])


def test_prover_rejects_bad_ranges_and_cells():
    sq, _, ods = seeded_block(4)
    prover, _, _, _ = provers(ods)
    for lo, hi in [(0, 17), (3, 3), (-1, 2)]:
        with pytest.raises(ValueError):
            prover.prove_shares(lo, hi, bytes(29))
    for r, c in [(8, 0), (0, 8), (-1, 0)]:
        with pytest.raises(ValueError):
            prover.prove_cell(r, c)
    with pytest.raises(ValueError):
        prover.prove_tx(sq, len(sq.txs) + len(sq.pfbs))


def test_tampered_proofs_fail():
    sq, _, ods = seeded_block(8)
    prover, _, d, root = provers(ods)
    lo, hi = proof.blob_share_range(sq, 0, 0)
    good = prover.prove_shares(max(0, lo - 3), hi + 3, bytes(29))
    assert good.verify(root) and len(good.share_proofs) >= 1

    flipped = bytearray(good.data[0])
    flipped[100] ^= 1
    assert not dataclasses.replace(good, data=[bytes(flipped)] + good.data[1:]).verify(root)
    assert not dataclasses.replace(good, data=good.data[:-1]).verify(root)
    assert not good.verify(bytes(32))

    nproof = good.share_proofs[0]
    node = bytearray(nproof.nodes[0])
    node[-1] ^= 1
    bad_nodes = dataclasses.replace(nproof, nodes=[bytes(node)] + nproof.nodes[1:])
    assert not dataclasses.replace(good, share_proofs=[bad_nodes] + good.share_proofs[1:]).verify(root)

    # a row proof relabelled as another row fails (RowProof binds leaf index to row)
    rp = good.row_proof
    shifted = dataclasses.replace(rp, start_row=rp.start_row + 1, end_row=rp.end_row + 1)
    assert not dataclasses.replace(good, row_proof=shifted).verify(root)
    root_flip = bytearray(rp.row_roots[0])
    root_flip[0] ^= 1
    bad_roots = dataclasses.replace(rp, row_roots=[bytes(root_flip)] + rp.row_roots[1:])
    assert not bad_roots.verify(root)

    share, cell = prover.prove_cell(9, 3)
    assert cell.verify(d.row_roots[9], [(nmt_host.PARITY, share)])
    assert not cell.verify(d.row_roots[8], [(nmt_host.PARITY, share)])


def test_row_levels_count_and_default_device(monkeypatch):
    _, _, ods = seeded_block(4)
    _, eds, _ = dah.new_dah_from_ods(ods, device="cpu")
    levels = proof_device.row_levels(eds.squares, device="cpu")
    assert [lv[2].shape for lv in levels] == [(8, 8, 32), (8, 4, 32), (8, 2, 32), (8, 1, 32)]
    host = proof_device.levels_to_host(levels)
    for got, want in zip(host, levels):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
    # the transposed (strided) square gives the column trees
    cols = proof_device.row_levels(np.swapaxes(eds.squares, 0, 1), device="cpu")
    d, _, _ = dah.new_dah_from_ods(ods, device="cpu")
    top = cols[-1]
    assert tuple(bytes(torch.cat([top[0][r, 0], top[1][r, 0], top[2][r, 0]]).numpy())
                 for r in range(8)) == d.col_roots
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        proof_device.row_levels(eds.squares)
    with pytest.raises(RuntimeError):
        proof_device.BlockProver(eds, d)
    # precomputed host levels need no level pass, hence no card
    prover = proof_device.BlockProver(eds, d, levels=host)
    assert prover.prove_shares(0, 16, bytes(29)).verify(d.hash())
