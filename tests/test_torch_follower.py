"""The port's rollup blob follower (client/follower.py) against the JAX
package's, run as a mixed pair (tolerance: exact).

The follower cases of the reference's tests/test_read_plane.py (d), (e)
and (f) run twice on one shared 3-validator chain per package (three
heights, each with a PFB of two blobs in the followed namespace and one in
another): a port follower reads a reference NodeService, and a reference
follower reads a port NodeService.

- Catch-up delivers every height's blobs byte-equal to the PFBs' blobs,
  through the blob packs first; the checkpoint docs of the two runs are
  equal; a restarted follower resumes from its checkpoint and reads
  nothing; another namespace's checkpoint is not resumed.
- A namespace the chain never wrote yields a verified absence per height.
- Every tampered doc is refused and counted (a wrong data root, a flipped
  share byte, a fake absence, a pack chunk whose bytes do not hash to the
  manifest, a commitments doc of another height), without progress.
- ``blobs_from_shares`` equals the reference's on share runs of many blobs,
  also where namespace padding shares sit in the run (an empty payload
  each, in both packages).

The port runs on ``device="cpu"`` (the reference on its host engine).
"""

from __future__ import annotations

import base64
import json

import numpy as np
import pytest

from test_torch_app import Pkg
from test_torch_daser import NS_OTHER, NS_USER, PAIRS, chains, store  # noqa: F401  (chains: fixture)

NS_ABSENT = b"\x70\x07" * 4


def ns(p, user: bytes) -> bytes:
    return p.Namespace.v0(user).raw


def counters(p) -> dict:
    return p.mod("utils.telemetry").snapshot()["counters"]


def delta(c0: dict, c1: dict, key: str) -> int:
    return c1.get(key, 0) - c0.get(key, 0)


def follower(client, served, namespace: bytes, path, **cfg):
    mod = client.mod("client.follower")
    return mod.BlobFollower([served.url], namespace, served.light(client), store(client, path),
                            cfg=mod.FollowerConfig(request_timeout=5.0, retries=2, backoff=0.01, **cfg))


def catch_up_run(client, served, tmp) -> dict:
    cp = tmp / "cp" / "follower.json"
    f = follower(client, served, ns(client, NS_USER), cp)
    c0 = counters(client)
    out = f.sync()
    c1 = counters(client)
    assert out == {"head": 3, "next_height": 4, "verified": 3}
    blobs = f.pop_blobs()
    assert blobs == served.chain.blobs_by_height
    assert delta(c0, c1, "follower.heights") == 3 and delta(c0, c1, "follower.blobs") == 6
    assert delta(c0, c1, "follower.pack_reads") == 3 and delta(c0, c1, "follower.live_reads") == 0
    assert delta(c0, c1, "follower.verify_failures") == 0
    doc = json.load(open(cp))
    assert doc == {"version": 1, "namespace": ns(client, NS_USER).hex(), "next_height": 4, "network_head": 3}

    # a restart resumes from the checkpoint and reads nothing
    f2 = follower(client, served, ns(client, NS_USER), cp)
    assert f2.next_height == 4
    c2 = counters(client)
    assert f2.sync() == {"head": 3, "next_height": 4, "verified": 0}
    c3 = counters(client)
    assert f2.pop_blobs() == {}
    assert all(delta(c2, c3, f"follower.{k}") == 0 for k in ("heights", "pack_reads", "live_reads"))
    # another namespace's checkpoint is not ours to resume
    assert follower(client, served, ns(client, NS_OTHER), cp).next_height == 1
    return {"out": out, "blobs": {h: [b.hex() for b in v] for h, v in blobs.items()}, "checkpoint": doc,
            "status": client.mod("client.follower").follower_status().keys()}


def test_catch_up_and_restart_match_across_packages(chains, tmp_path):
    runs = []
    for client, server in PAIRS:
        run = catch_up_run(Pkg(client), chains(server), tmp_path / client)
        run["status"] = sorted(run["status"])
        runs.append(run)
    assert runs[0] == runs[1]


def test_absence_is_verified_across_packages(chains, tmp_path):
    runs = []
    for client, server in PAIRS:
        cp = Pkg(client)
        served = chains(server)
        doc = cp.mod("das.daser").PeerSet([served.url]).request(
            f"/blob/get?height=1&namespace={ns(cp, NS_ABSENT).hex()}")
        assert doc["present"] is False and doc["shares"] == []
        f = follower(cp, served, ns(cp, NS_ABSENT), tmp_path / client / "cp-absent.json")
        c0 = counters(cp)
        out = f.sync()
        c1 = counters(cp)
        assert out == {"head": 3, "next_height": 4, "verified": 3} and f.pop_blobs() == {}
        assert delta(c0, c1, "follower.absences") == 3 and delta(c0, c1, "follower.verify_failures") == 0
        runs.append(out)
    assert runs[0] == runs[1]


def test_tampered_docs_are_refused_across_packages(chains, tmp_path):
    for client, server in PAIRS:
        cp = Pkg(client)
        FollowerError = cp.mod("client.follower").FollowerError
        f = follower(cp, chains(server), ns(cp, NS_USER), tmp_path / client / "cp-t.json", prefer_packs=False)
        f._follow_head()
        root_hex, square_size = f._roots[1]
        dah = f._certified_dah(1, root_hex, square_size)
        doc = f._fetch_live_doc(1)
        c0 = counters(cp)
        with pytest.raises(FollowerError, match="certified root"):
            f._verified_nd(1, dah, root_hex, {**doc, "data_root": "00" * 32})
        flipped = bytearray(base64.b64decode(doc["shares"][0]))
        flipped[40] ^= 0xFF
        bad_share = {**doc, "shares": [base64.b64encode(bytes(flipped)).decode()] + doc["shares"][1:]}
        with pytest.raises(FollowerError, match="failed verification"):
            f._verified_nd(1, dah, root_hex, bad_share)
        with pytest.raises(FollowerError, match="failed verification"):
            f._verified_nd(1, dah, root_hex, {**doc, "present": False, "shares": [], "proof": None})
        with pytest.raises(FollowerError, match="undecodable"):
            f._verified_nd(1, dah, root_hex, {**doc, "shares": ["abc"]})
        assert delta(c0, counters(cp), "follower.verify_failures") == 4
        # end to end: a tampering peer aborts the sweep, no progress
        f._fetch_live_doc = lambda _h: bad_share
        with pytest.raises(FollowerError):
            f.sync()
        assert f.next_height == 1


def test_tampered_pack_chunk_falls_back_across_packages(chains, tmp_path):
    """A pack chunk whose bytes do not hash to the manifest is refused, its
    peer penalized, and the height read through the live route: the
    delivered blobs are the same."""
    for client, server in PAIRS:
        cp = Pkg(client)
        served = chains(server)
        f = follower(cp, served, ns(cp, NS_USER), tmp_path / client / "cp-p.json")
        orig = f.peers.request_pinned

        def tampered(url, path, payload=None, raw=False):
            got = orig(url, path, payload, raw=raw)
            if path.startswith("/blob/pack/chunk"):
                got = bytearray(got)
                got[len(got) // 2] ^= 0xFF
                got = bytes(got)
            return got

        f.peers.request_pinned = tampered
        c0 = counters(cp)
        out = f.sync()
        c1 = counters(cp)
        assert out["verified"] == 3 and f.pop_blobs() == served.chain.blobs_by_height
        assert delta(c0, c1, "follower.verify_failures") == 3 and delta(c0, c1, "net.penalized") >= 1
        assert delta(c0, c1, "follower.live_reads") == 3 and delta(c0, c1, "follower.pack_reads") == 0


def test_byzantine_commitments_are_refused_across_packages(chains, tmp_path):
    """A peer serving height 2 the commitments doc of height 1 is refused
    at the bind step; height 1 stays verified; an honest peer un-sticks
    the same follower."""
    for client, server in PAIRS:
        cp = Pkg(client)
        f = follower(cp, chains(server), ns(cp, NS_USER), tmp_path / client / "cp-b.json")
        f._follow_head()
        assert f._roots[1][0] != f._roots[2][0]
        doc1 = f.peers.request("/das/header?height=1")
        orig = f.peers.request

        def poisoned(path, payload=None, raw=False):
            return doc1 if path == "/das/header?height=2" else orig(path, payload=payload, raw=raw)

        f.peers.request = poisoned
        c0 = counters(cp)
        with pytest.raises(cp.mod("client.follower").FollowerError, match="certified data root"):
            f.sync()
        assert delta(c0, counters(cp), "follower.verify_failures") >= 1 and f.next_height == 2
        f.peers.request = orig
        assert f.sync() == {"head": 3, "next_height": 4, "verified": 2}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blobs_from_shares_matches_reference(seed):
    """Share runs of several blobs (short, one-share, many-share) split
    into the same payloads by both packages."""
    port, ref = Pkg("port"), Pkg("ref")
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(1, 3000, 4)] + [478, 479]
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    shares_mod = port.mod("da.shares")
    ns = port.Namespace.v0(NS_USER)
    run = [sh.raw for data in payloads for sh in shares_mod.split_blob(ns, data)]
    got = port.mod("client.follower").blobs_from_shares(run)
    want = ref.mod("client.follower").blobs_from_shares(run)
    assert got == want == payloads
    # a namespace padding share (sequence start, length 0) in the run is an
    # empty payload in both packages, as the reference delivers it
    first = shares_mod.sparse_shares_needed(len(payloads[0]))
    padded = run[:first] + [shares_mod.namespace_padding_share(ns).raw] * 2 + run[first:]
    got = port.mod("client.follower").blobs_from_shares(padded)
    assert got == ref.mod("client.follower").blobs_from_shares(padded)
    assert [p for p in got if p] == payloads and got.count(b"") == 2
    with pytest.raises(ValueError) as e_port:
        port.mod("client.follower").blobs_from_shares(run[1:2])
    with pytest.raises(ValueError) as e_ref:
        ref.mod("client.follower").blobs_from_shares(run[1:2])
    assert str(e_port.value) == str(e_ref.value)
