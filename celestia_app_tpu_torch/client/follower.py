"""Rollup follower: a verifying namespace reader (the read plane's client).

The consuming half of the read plane (docs/DESIGN.md "The read plane"):
a rollup node that trusts nothing but a genesis validator set follows ONE
namespace across heights, and every byte it delivers to the rollup's
execution layer is proven:

- **headers**: fetched per height (/ibc/header) and verified through the
  light client (chain/light.py) — >2/3 of the trusted set signed, hash
  linkage checked, condemned data roots refused. The follower never takes
  a serving peer's word for what the chain committed.
- **commitments**: the height's DAH doc (/das/header) is parsed AND
  verified against the certified data root by the scheme codec
  (``commitments_from_doc``) — a Byzantine peer serving fake row roots
  that happen to "prove" fake blobs is rejected HERE, before any blob
  bytes are even fetched.
- **blobs**: resolved from the peer's static blob pack when one is
  advertised (chunk sha256-checked against the manifest, fetched pinned
  to the advertising peer, mismatch penalized on the shared transport
  health score) or the live /blob/get route; either way the response's
  inclusion (or absence) proof must pass
  ``da/namespace_data.verify_namespace_data`` against the certified DAH.
  Absence is a verified claim too: a height with no blobs yields a
  checked absence witness, not a shrug.
- **checkpointing**: progress persists fsync-before-replace
  (das/checkpoint.CheckpointStore.save_doc) after every verified height,
  so a restarted follower resumes at ``next_height`` instead of
  re-reading the chain; the snapshot is taken under the follower's lock
  and the fsync paid outside it.

Telemetry: ``follower.heights`` / ``follower.blobs`` /
``follower.absences`` / ``follower.pack_reads`` / ``follower.live_reads``
/ ``follower.verify_failures``. Wire formats: docs/FORMATS.md §21.

Port of celestia_app_tpu/client/follower.py: the same requests, checks,
blobs and checkpoint doc. Following and verifying run on the host, as in
the reference, so a follower needs no device.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import threading

from celestia_app_tpu_torch.chain import light as light_mod
from celestia_app_tpu_torch.da import codec as dacodec
from celestia_app_tpu_torch.da import namespace_data as nsd_mod
from celestia_app_tpu_torch.das.checkpoint import CheckpointStore
from celestia_app_tpu_torch.das.daser import PeerError, PeerSet
from celestia_app_tpu_torch.utils import telemetry

NS = 29  # appconsts.NAMESPACE_SIZE without importing the wide module


class FollowerError(Exception):
    """A verification failure: a served proof did not check out against
    the certified commitments. This is the follower REFUSING data, not a
    transport error — transport problems retry inside the PeerSet."""


@dataclasses.dataclass
class FollowerConfig:
    request_timeout: float = 5.0
    retries: int = 3
    backoff: float = 0.05
    # resolve from advertised blob packs before the live route (a pack
    # miss — no manifest, namespace absent from it, or a chunk that
    # fails its hash — falls back to /blob/get)
    prefer_packs: bool = True
    # heights verified per sync() call (bounds one sweep's work)
    max_heights_per_sync: int = 256


def blobs_from_shares(shares: list[bytes]) -> list[bytes]:
    """Split a namespace's share run into blob payloads: sequences start
    at every start share (da/shares.py sparse layout); each reassembles
    independently so one namespace can carry many blobs per block."""
    from celestia_app_tpu_torch.da import shares as shares_mod

    wrapped = [shares_mod.Share(s) for s in shares]
    out: list[bytes] = []
    run: list = []
    for sh in wrapped:
        if sh.is_sequence_start and run:
            out.append(shares_mod.parse_sparse_shares(run))
            run = []
        run.append(sh)
    if run:
        out.append(shares_mod.parse_sparse_shares(run))
    return out


class BlobFollower:
    """Follow one namespace across heights, verifying everything.

    Drive it with ``sync()`` (one sweep: follow head, verify pending
    heights, checkpoint) — the DASer's drive shape, so the CLI loop and
    tests treat both daemons alike."""

    def __init__(self, peers, namespace: bytes,
                 light: light_mod.LightClient, store: CheckpointStore,
                 cfg: FollowerConfig | None = None, header_source=None,
                 name: str = "follower"):
        if len(namespace) != NS:
            raise ValueError(f"namespace must be {NS} bytes")
        self.cfg = cfg or FollowerConfig()
        self.peers = peers if isinstance(peers, PeerSet) else PeerSet(
            peers, timeout=self.cfg.request_timeout,
            retries=self.cfg.retries, backoff=self.cfg.backoff,
        )
        self.namespace = namespace
        self.light = light
        self.store = store
        self.name = name
        from celestia_app_tpu_torch.das import daser as daser_mod

        self.header_source = (header_source
                              or daser_mod.http_header_source(self.peers))
        self._lock = threading.Lock()
        # height -> (data_root_hex, square_size) for certified headers
        self._roots: dict[int, tuple[str, int]] = {}  # guarded-by: _lock
        # delivered blobs: height -> [payload bytes] (bounded by caller
        # draining via pop_blobs)
        self._blobs: dict[int, list[bytes]] = {}  # guarded-by: _lock
        self.next_height = 1  # first height NOT yet verified+delivered
        self._load_checkpoint()

    # -- checkpoint (das/checkpoint.py discipline, follower's own doc) ---

    def _load_checkpoint(self) -> None:
        """The follower's checkpoint doc is its own shape (§21.4), so it
        is read directly — CheckpointStore.load parses the DASer's."""
        path = self.store.path
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        if doc.get("namespace") != self.namespace.hex():
            # a different namespace's progress is not ours to resume
            return
        self.next_height = int(doc.get("next_height", 1))

    def _checkpoint_doc(self) -> dict:
        return {
            "version": 1,
            "namespace": self.namespace.hex(),
            "next_height": self.next_height,
            "network_head": self.light.trusted.height,
        }

    def _save_checkpoint(self) -> None:
        with self._lock:
            doc = self._checkpoint_doc()
        # fsync OUTSIDE the lock (blocking-under-lock discipline)
        self.store.save_doc(doc)

    # -- header following (the DASer's follow loop) ----------------------

    def _follow_head(self) -> None:
        try:
            head = int(self.peers.request("/das/head")["height"])
        except (PeerError, KeyError, ValueError, TypeError):
            return
        while self.light.trusted.height < head:
            h = self.light.trusted.height + 1
            got = self.header_source(h)
            if got is None:
                break  # not yet certified anywhere; next sweep
            header, cert = got
            self.light.update(header, cert)  # LightClientError propagates
            with self._lock:
                self._roots[h] = (header.data_hash.hex(),
                                  header.square_size)

    # -- resolution: pack first, live fallback ---------------------------

    def _fetch_pack_doc(self, height: int, root_hex: str) -> dict | None:
        """The namespace's doc out of the peer's static blob pack, or
        None on any miss (no pack, namespace not packed — i.e. absent —
        or a chunk that fails verification). A hash mismatch penalizes
        the serving peer; it must not count as absence."""
        try:
            url, m = self.peers.request_from(f"/blob/pack?height={height}")
        except PeerError:
            return None
        if not (isinstance(m, dict) and m.get("data_root") == root_hex
                and isinstance(m.get("namespaces"), list)
                and isinstance(m.get("chunk_hashes"), list)
                and int(m.get("chunk_namespaces", 0)) > 0):
            return None
        ns_hex = self.namespace.hex()
        if ns_hex not in m["namespaces"]:
            return None  # absent from the pack ⇒ prove absence live
        pos = m["namespaces"].index(ns_hex)
        index = pos // int(m["chunk_namespaces"])
        try:
            raw = self.peers.request_pinned(
                url, f"/blob/pack/chunk?height={height}&index={index}",
                raw=True)
        except (OSError, ValueError):
            return None
        if hashlib.sha256(raw).hexdigest() != m["chunk_hashes"][index]:
            self.peers.penalize(url, "blob pack chunk hash mismatch")
            telemetry.incr("follower.verify_failures")
            return None
        from celestia_app_tpu_torch.das.blob_packs import decode_chunk

        try:
            docs = decode_chunk(raw)
        except (ValueError, TypeError):
            # hash already checked out, so this is a malformed chunk the
            # SERVER built; fall back to the live route, visibly
            telemetry.incr("follower.verify_failures")
            return None
        for doc in docs:
            if isinstance(doc, dict) and doc.get("namespace") == ns_hex:
                telemetry.incr("follower.pack_reads")
                return doc
        return None

    def _fetch_live_doc(self, height: int) -> dict:
        doc = self.peers.request(
            f"/blob/get?height={height}&namespace={self.namespace.hex()}")
        telemetry.incr("follower.live_reads")
        return doc

    # -- verification ----------------------------------------------------

    def _certified_dah(self, height: int, root_hex: str,
                       square_size: int):
        """The height's commitments, fetched from an untrusted peer and
        VERIFIED against the certified data root (the DASer's
        commitments rule). Non-rs2d heights have no namespace surface —
        the follower refuses rather than trusting unverifiable docs."""
        doc = self.peers.request(f"/das/header?height={height}")
        scheme = doc.get("scheme", dacodec.RS2D_NAME)
        if scheme != dacodec.RS2D_NAME:
            raise FollowerError(
                f"height {height} commits {scheme}; namespace reads "
                f"need {dacodec.RS2D_NAME}"
            )
        codec = dacodec.get(scheme)
        try:
            return codec.commitments_from_doc(doc, root_hex, square_size)
        except (dacodec.CodecError, ValueError, KeyError, TypeError) as e:
            telemetry.incr("follower.verify_failures")
            raise FollowerError(
                f"height {height}: served commitments do not bind to the "
                f"certified data root: {e}"
            ) from None

    def _verified_nd(self, height: int, dah, root_hex: str,
                     doc: dict) -> "nsd_mod.NamespaceData":
        """Parse a served namespace doc and verify its claim against the
        certified DAH — raises FollowerError (and counts) on ANY
        mismatch: wrong data root, undecodable proof, or a proof that
        fails verify_namespace_data (tampered shares, incomplete range,
        fake absence)."""
        from celestia_app_tpu_torch.chain.query import share_proof_from_json

        def refuse(why: str):
            telemetry.incr("follower.verify_failures")
            return FollowerError(
                f"height {height} namespace {self.namespace.hex()[:12]}: "
                f"{why}"
            )

        if not isinstance(doc, dict):
            raise refuse("malformed response")
        if doc.get("data_root") != root_hex:
            raise refuse(
                f"response claims data root {str(doc.get('data_root'))[:16]}"
                f" but the certified root is {root_hex[:16]}"
            )
        try:
            shares = [base64.b64decode(s) for s in doc.get("shares", [])]
            proof = (share_proof_from_json(doc["proof"])
                     if doc.get("proof") else None)
        except (ValueError, KeyError, TypeError):
            raise refuse("undecodable shares/proof") from None
        nd = nsd_mod.NamespaceData(namespace=self.namespace,
                                   shares=shares, proof=proof)
        if not nsd_mod.verify_namespace_data(dah, self.namespace, nd):
            raise refuse("inclusion/absence proof failed verification")
        return nd

    # -- the sweep --------------------------------------------------------

    def _read_height(self, height: int) -> dict:
        with self._lock:
            root_hex, square_size = self._roots[height]
        dah = self._certified_dah(height, root_hex, square_size)
        doc = None
        if self.cfg.prefer_packs:
            doc = self._fetch_pack_doc(height, root_hex)
        if doc is None:
            doc = self._fetch_live_doc(height)
        nd = self._verified_nd(height, dah, root_hex, doc)
        telemetry.incr("follower.heights")
        if nd.shares:
            payloads = blobs_from_shares(nd.shares)
            telemetry.incr("follower.blobs", len(payloads))
            with self._lock:
                self._blobs[height] = payloads
            return {"height": height, "blobs": len(payloads)}
        telemetry.incr("follower.absences")
        return {"height": height, "blobs": 0}

    def sync(self) -> dict:
        """One sweep: follow the head, verify every pending height (up
        to the config bound), checkpoint. Returns the sweep report."""
        self._follow_head()
        done = 0
        while (self.next_height <= self.light.trusted.height
               and done < self.cfg.max_heights_per_sync):
            h = self.next_height
            with self._lock:
                have = h in self._roots
            if not have:
                break  # header gap (restart): re-follow next sweep
            self._read_height(h)
            with self._lock:
                self.next_height = h + 1
                self._roots.pop(h, None)
            done += 1
            self._save_checkpoint()
        return {
            "head": self.light.trusted.height,
            "next_height": self.next_height,
            "verified": done,
        }

    def pop_blobs(self) -> dict[int, list[bytes]]:
        """Drain delivered blob payloads (height -> [bytes]) — the
        rollup execution layer's intake."""
        with self._lock:
            out, self._blobs = self._blobs, {}
        return out

    def catch_up_roots(self) -> None:
        """Restart path: a resumed follower trusts its checkpoint's
        ``next_height`` but its LightClient starts back at genesis —
        re-follow certifies the missing headers (cheap) without
        re-reading completed heights (the expensive part)."""
        self._follow_head()
        with self._lock:
            for h in [h for h in self._roots if h < self.next_height]:
                self._roots.pop(h)


def follower_status() -> dict:
    """Follower-side counters for operator surfaces."""
    counters = telemetry.snapshot()["counters"]

    def g(name: str) -> int:
        return int(counters.get(name, 0))

    return {
        "heights": g("follower.heights"),
        "blobs": g("follower.blobs"),
        "absences": g("follower.absences"),
        "pack_reads": g("follower.pack_reads"),
        "live_reads": g("follower.live_reads"),
        "verify_failures": g("follower.verify_failures"),
    }


__all__ = [
    "BlobFollower", "FollowerConfig", "FollowerError",
    "blobs_from_shares", "follower_status",
]
