"""DASer: the light-node data-availability sampling daemon.

The client half of the DAS plane (celestia-node `das/daser.go` analog).
A DASer holds nothing but a genesis-rooted light client (chain/light.py)
and a checkpoint file, yet ends every sweep with a quantified availability
claim for each header it follows:

- **header following**: commit certificates are fetched per height and
  verified through the LightClient (>2/3 of the trusted set; condemned
  data roots refused), so every data root the sampler trusts was certified
  — the sampler never takes the serving node's word for what it committed.
- **catch-up scheduling**: pending heights are split into jobs and worked
  by a bounded pool of parallel workers (celestia-node's coordinator +
  catch-up workers), so a node that was down for a thousand blocks
  backfills at worker-pool parallelism while the head keeps advancing.
  A multi-height job samples as a WINDOW (serving plane, FORMATS §17.1):
  one batched /das/headers fetch + one grouped /das/samples round-trip
  cover the whole job, so sampling round-trips per height drop toward
  1/window instead of one request per (height, retry).
- **sampling**: s cells per header, drawn from THIS node's own rng
  (predictable coordinates let a withholder serve exactly what's asked),
  fetched in one batched request — or sliced out of the height's static
  proof pack when the serving peer advertises one (§17.2): chunks are
  sha256-checked against the manifest, every doc still verifies through
  the normal per-sample path, and any shortfall falls back to live
  assembly (a tampered chunk additionally penalizes the peer). Failures
  retry as a subset — immediately on the next peer in rotation
  (``daser.partial_retries``), then with exponential backoff — before
  anything escalates.
- **escalation** (a failed sample after retries): fetch every obtainable
  cell, verify each, and run the 2D repair fixpoint (da/repair.repair_eds)
  over the authenticated shares. Repair completing means the block WAS
  available (flaky peer); `BadEncodingError` means the producer committed
  a non-codeword — the DASer then assembles a bad-encoding fraud proof
  from orthogonal-axis cell proofs (served by das/server.py `axis=col`),
  verifies it via the light client (which condemns the data root), writes
  a HALTED checkpoint, and stops following the chain.
- **checkpointing**: progress persists fsync-before-replace
  (das/checkpoint.py); a restarted DASer re-verifies headers (cheap) but
  never re-samples completed heights (the expensive part).

Confidence math (da/sampling.py): each sample independently catches a
square with > 1/4 of extended cells withheld with probability > 1/4, so
s samples give 1-(3/4)^s; a fleet of m independent samplers compounds to
1-(3/4)^(m*s). docs/DESIGN.md "The DAS plane" has the derivation.

Port of celestia_app_tpu/das/daser.py: the same requests, reports,
checkpoints and fraud proofs. Sampling verifies its proofs on the host,
as the reference does. The escalation runs on ``device`` (the card
unless the caller asks for the CPU): the 2D repair (``repair_eds``, K2
decode passes and K1 axis roots), a codec's own repair, and the fraud
proof's check through ``LightClient.submit_fraud_proof``. An error of
that device work propagates out of ``sync()``, a kernel wrapper's
``cuda_build.KernelError`` too: only the unsolvable repair (any other
ValueError) makes a height ``"unavailable"``.
"""

from __future__ import annotations

import base64
import dataclasses
import queue as queue_mod
import threading

import numpy as np

from celestia_app_tpu_torch import appconsts, cuda_build, obs
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.chain import light as light_mod
from celestia_app_tpu_torch.da import codec as dacodec
from celestia_app_tpu_torch.da import fraud, repair, sampling
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
from celestia_app_tpu_torch.das.checkpoint import Checkpoint, CheckpointStore
from celestia_app_tpu_torch.net.transport import PeerClient, TransportConfig
from celestia_app_tpu_torch.utils import nmt_host, telemetry

log = obs.get_logger("das.daser")


class PeerError(OSError):
    """Every peer failed (or refused) a request after all retries."""


@dataclasses.dataclass
class DASerConfig:
    samples_per_header: int = 16  # s: confidence 1-(3/4)^s ≈ 0.99 at 16
    workers: int = 3  # parallel catch-up workers (bounded in-flight)
    job_size: int = 8  # heights per catch-up job — AND the multi-height
    # sampling window: a whole job goes out as one batched
    # POST /das/samples {groups} round-trip (serving plane, §17.1)
    retries: int = 3  # per-request peer-rotation rounds
    backoff: float = 0.05  # base backoff seconds (doubles per round)
    request_timeout: float = 5.0
    poll_interval: float = 0.25  # head-follow pause in run_background
    # prefer static proof-pack chunks when a serving peer advertises
    # them on /das/header (§17.2); verified chunks carry the same docs
    # as live assembly, a tampered chunk penalizes the peer and falls
    # back to live /das/samples. No-op against pack-less peers.
    prefer_packs: bool = True
    # keep only the newest N per-height reports (0 = unbounded). The
    # checkpoint, not `reports`, is the durable record; a long-horizon
    # fleet (1000+ samplers over thousands of virtual blocks in one
    # process) bounds this so memory stays O(fleet), not O(fleet*chain).
    report_keep: int = 0


class PeerSet:
    """Round-robin rotation over the sampler's peer URLs ON TOP of the
    shared hardened transport (net/transport.py): each retry round tries
    EVERY peer once, so a single withholding/flaky peer never decides
    availability while an honest peer holds the data. The per-peer
    backoff/breaker/health machinery lives in the PeerClient — one
    implementation shared with the reactor's gossip — while this class
    keeps the DASer's rotation semantics and its `daser.requests` /
    `daser.peer_errors` / `daser.retry_rounds` counters."""

    def __init__(self, urls: list[str], timeout: float = 5.0,
                 retries: int = 3, backoff: float = 0.05,
                 client: PeerClient | None = None, clock=None):
        if not urls:
            raise ValueError("PeerSet needs at least one peer URL")
        from celestia_app_tpu_torch.utils import clock as clock_mod

        self.urls = [u.rstrip("/") for u in urls]
        self.retries = retries
        self.backoff = backoff
        # retry-round backoff time source: SystemClock by default; the
        # scenario plane injects its VirtualClock so rotation backoffs
        # cost virtual seconds (utils/clock.py)
        self.clock = clock if clock is not None else clock_mod.SYSTEM
        # one transport attempt per (peer, round): the ROTATION is this
        # class's retry loop; a dead peer trips its breaker here exactly
        # as it would under the reactor, and subsequent rounds skip it at
        # BreakerOpen speed instead of paying connect timeouts
        self.client = client or PeerClient(
            TransportConfig(timeout=timeout, retries=1),
            name="daser",
        )
        self._i = 0
        self._lock = threading.Lock()

    def _order(self) -> list[str]:
        with self._lock:
            start = self._i
            self._i = (self._i + 1) % len(self.urls)
        return self.urls[start:] + self.urls[:start]

    def request(self, path: str, payload: dict | None = None,
                raw: bool = False):
        """GET (payload None) or POST `path`, rotating peers with
        exponential backoff between rounds; raises PeerError when every
        peer failed every round. HTTP error bodies ({"error": ...}) are
        treated as refusals and retried on the next peer."""
        return self.request_from(path, payload, raw=raw)[1]

    def request_from(self, path: str, payload: dict | None = None,
                     raw: bool = False):
        """`request`, but returns ``(peer_url, body)`` — callers that
        verify content hashes (pack chunk fetches) need to know WHICH
        peer served the bytes so a mismatch can be penalized on the
        shared health score (net.penalize)."""
        last = "no peers"
        delay = self.backoff
        for attempt in range(self.retries):
            for url in self._order():
                try:
                    telemetry.incr("daser.requests")
                    return url, self.client.request(url, path, payload,
                                                    raw=raw)
                except (OSError, ValueError) as e:
                    telemetry.incr("daser.peer_errors")
                    last = f"{url}{path}: {type(e).__name__}: {e}"
            if attempt + 1 < self.retries:
                telemetry.incr("daser.retry_rounds")
                self.clock.sleep(delay)
                delay *= 2
        raise PeerError(f"all peers failed: {last}")

    def penalize(self, url: str, reason: str) -> None:
        """Content-level failure report (e.g. a pack chunk whose sha256
        mismatched its manifest): feeds the shared transport's per-peer
        health score so a corrupt-serving peer is eventually
        breaker-skipped (net/transport.PeerClient.penalize)."""
        self.client.penalize(url, reason)

    def request_pinned(self, url: str, path: str,
                       payload: dict | None = None, raw: bool = False):
        """One attempt against ONE specific peer — no rotation. Pack
        chunk fetches use this: a chunk must be fetched from the peer
        whose manifest advertised it (chunk boundaries are per-node
        config), or an honest peer could be penalized for another
        node's advert. Raises OSError/ValueError on failure."""
        telemetry.incr("daser.requests")
        return self.client.request(url, path, payload, raw=raw)


def http_header_source(peers: PeerSet):
    """(height) -> (Header, CommitCertificate) via the node service's
    /ibc/header route (the same certified-header payload the IBC
    verifying client consumes). Returns None while the height is not yet
    certified on any peer."""
    from celestia_app_tpu_torch.chain import consensus

    def fetch(height: int):
        try:
            doc = peers.request("/ibc/header", {"height": height})
        except PeerError:
            return None
        try:
            return (consensus.header_from_json(doc["header"]),
                    consensus.cert_from_json(doc["cert"]))
        except (KeyError, ValueError, TypeError):
            return None

    return fetch


class DASer:
    """One light node's sampling daemon. Drive it with `sync()` (one full
    sweep: follow head, catch up, checkpoint) or `run_background()`.
    `device` is where escalations run (the card unless the caller asks
    for the CPU; without a card and without ``device="cpu"`` the
    constructor raises)."""

    def __init__(self, peers, light: light_mod.LightClient,
                 store: CheckpointStore,
                 cfg: DASerConfig | None = None,
                 header_source=None, rng=None, name: str = "daser",
                 clock=None, device=None):
        from celestia_app_tpu_torch.utils import clock as clock_mod

        self.device = device_mod.resolve(device)
        self.cfg = cfg or DASerConfig()
        # sweep/retry/backoff time source (utils/clock.py): SystemClock
        # by default; the scenario plane injects its VirtualClock so one
        # process can run hundreds of samplers over hours of chain time
        self.clock = clock if clock is not None else clock_mod.SYSTEM
        self.peers = peers if isinstance(peers, PeerSet) else PeerSet(
            peers, timeout=self.cfg.request_timeout,
            retries=self.cfg.retries, backoff=self.cfg.backoff,
            clock=self.clock,
        )
        self.light = light
        self.store = store
        self.name = name
        # the durable sampling watermark; workers consult halted, the
        # coordinator folds results into it
        self.cp: Checkpoint = store.load()  # guarded-by: _lock
        self.header_source = header_source or http_header_source(self.peers)
        # the light node's OWN entropy — a withholder that can predict
        # coordinates serves exactly the sampled cells and nothing else
        self.rng = rng if rng is not None else np.random.default_rng()  # lint: disable=det-rng
        # height -> (data_root hex, ods square size), from VERIFIED headers
        self._roots: dict[int, tuple[str, int]] = {}
        # this light node's OWN span plane (obs/spans.py): rows carry the
        # same deterministic per-height trace ids the serving chain uses,
        # so tools/timeline.py merges them into one waterfall
        self.traces = telemetry.TraceTables()
        self.reports: dict[int, dict] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # lock-free mirror of cp.halted for the workers' per-height hot
        # path: _fold holds _lock across an fsync'd checkpoint save, and
        # samplers must not queue behind the disk just to poll a flag
        self._halted_evt = threading.Event()
        # consecutive whole-window batch-route failures; >= 2 disables
        # the batched /das/headers + {groups} paths for this DASer (a
        # legacy peer set must not cost every window two rotation-and-
        # backoff exhaustions before the per-height fallback)
        self._batch_failures = 0  # guarded-by: _lock
        if self.cp.halted is not None:
            self._halted_evt.set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- state -----------------------------------------------------------

    @property
    def halted(self) -> bool:
        with self._lock:
            return self.cp.halted is not None

    def _halt(self, height: int, reason: str, data_root: str) -> None:
        # snapshot under the lock, fsync OUTSIDE it (found by the
        # blocking-under-lock rule): workers polling `halted` must not
        # queue behind a disk flush. A concurrent _fold save racing
        # this write is harmless — both docs are valid checkpoints and
        # the store's atomic replace can only UNDER-claim progress.
        doc = None
        with self._lock:
            if self.cp.halted is None:
                self.cp.halted = {
                    "height": height, "reason": reason,
                    "data_root": data_root,
                }
                self._halted_evt.set()
                doc = self.cp.to_json()
        if doc is not None:
            self.store.save_doc(doc)
        telemetry.incr("daser.halts")

    # -- header following (coordinator; sequential light-client trust) ---

    def _advance_head(self) -> None:
        try:
            head = int(self.peers.request("/das/head")["height"])
        except (PeerError, KeyError, ValueError, TypeError):
            return
        while self.light.trusted.height < head and not self._stop.is_set():
            h = self.light.trusted.height + 1
            got = self.header_source(h)
            if got is None:
                break  # not yet certified anywhere; try next sweep
            header, cert = got
            try:
                self.light.update(header, cert)
            except light_mod.LightClientError as e:
                if "condemned" in str(e):
                    self._halt(h, "condemned-root",
                               header.data_hash.hex())
                # valset changes need operator-supplied candidate sets;
                # either way this sweep stops following here
                break
            self._roots[h] = (header.data_hash.hex(), header.square_size)
            with self._lock:
                self.cp.network_head = max(self.cp.network_head, h)

    # -- sampling workers ------------------------------------------------

    @staticmethod
    def _parse_header_doc(doc: dict, root_hex: str, square_size: int):
        """(codec, commitments, pack-advert|None) from a served
        commitments doc: the doc names its scheme (absent ⇒ rs2d-nmt)
        and the codec parses AND verifies it against the certified root
        — bounds/shapes first, binding second, all on untrusted input
        (da/codec.py). The optional "pack" member advertises the
        height's static proof pack (§17.2); it is shape-checked here and
        content-checked chunk by chunk at fetch time."""
        codec = dacodec.get(doc.get("scheme", dacodec.RS2D_NAME))
        commitments = codec.commitments_from_doc(doc, root_hex,
                                                 square_size)
        pack = doc.get("pack")
        if not (isinstance(pack, dict)
                and isinstance(pack.get("chunk_hashes"), list)
                and isinstance(pack.get("chunk_cells"), int)
                and pack.get("chunk_cells", 0) > 0
                and pack.get("data_root") == root_hex):
            pack = None
        return codec, commitments, pack

    def _fetch_commitments(self, height: int, root_hex: str,
                           square_size: int):
        """One height's parsed header doc (the per-height fallback of
        the batched /das/headers window fetch). The pack advert (if
        any) is stamped with the peer that served it — chunk fetches
        pin to that peer."""
        telemetry.incr("daser.sampling_round_trips")
        url, doc = self.peers.request_from(
            f"/das/header?height={height}")
        codec, commitments, pack = self._parse_header_doc(
            doc, root_hex, square_size)
        if pack is not None:
            pack = {**pack, "peer": url}
        return codec, commitments, pack

    def _batch_routes_ok(self) -> bool:
        with self._lock:
            return self._batch_failures < 2

    def _note_batch(self, ok: bool) -> None:
        """Memoize whether the peer set answers the batched window
        routes: a legacy peer set would otherwise cost every window two
        full rotation-with-backoff exhaustions before falling back."""
        with self._lock:
            self._batch_failures = 0 if ok else self._batch_failures + 1

    def _fetch_headers_batch(self, job) -> tuple[str | None,
                                                 dict[int, dict]]:
        """(serving peer, height -> raw header doc) for a window, in
        ONE round-trip (POST /das/headers). Heights the peer could not
        serve (or a peer set without the batched route at all) simply
        come back absent — callers fall back to the per-height fetch."""
        heights = [h for h, _root, _size in job]
        if not self._batch_routes_ok():
            return None, {}
        try:
            telemetry.incr("daser.sampling_round_trips")
            url, out = self.peers.request_from("/das/headers",
                                               {"heights": heights})
            docs = out["headers"]
        except (PeerError, KeyError, TypeError, ValueError):
            self._note_batch(False)
            return None, {}
        self._note_batch(True)
        got: dict[int, dict] = {}
        for doc in docs if isinstance(docs, list) else []:
            try:
                h = int(doc["height"])
            except (KeyError, TypeError, ValueError):
                continue
            if h in heights and "error" not in doc:
                got[h] = doc
        return url, got

    @staticmethod
    def _decode_sample(s: dict) -> tuple[bytes, nmt_host.NmtRangeProof]:
        return (
            base64.b64decode(s["share"]),
            nmt_host.NmtRangeProof(
                start=int(s["proof"]["start"]),
                end=int(s["proof"]["end"]),
                total=int(s["proof"]["total"]),
                nodes=[base64.b64decode(n) for n in s["proof"]["nodes"]],
            ),
        )

    def _fetch_cells(self, height: int, cells, axis: str = "row") -> list[dict]:
        """Batched fetch; whole-request failures already rotate peers in
        PeerSet. Returns the per-cell sample docs (error members kept).
        The span context rides the request (X-Celestia-Trace), so the
        serving node's das.serve_sample span links back here."""
        with obs.span("das.fetch_cells", traces=self.traces,
                      height=height, cells=len(cells), axis=axis):
            telemetry.incr("daser.sampling_round_trips")
            out = self.peers.request(
                "/das/samples",
                {"height": height, "cells": [list(c) for c in cells],
                 "axis": axis},
            )
        return out["samples"]

    def _fetch_groups(self, draws: dict[int, list]) -> dict[int, dict]:
        """height -> single-height-shaped response for a window of
        heights, in ONE round-trip (POST /das/samples {groups}): the
        rewrite that takes catch-up from one request per (height, retry)
        to ~1/window. Raises PeerError when no peer serves the window."""
        if not self._batch_routes_ok():
            return {}
        groups = [{"height": h, "cells": [list(c) for c in cells]}
                  for h, cells in sorted(draws.items())]
        with obs.span("das.fetch_window", traces=self.traces,
                      heights=len(groups),
                      cells=sum(len(g["cells"]) for g in groups)):
            telemetry.incr("daser.sampling_round_trips")
            try:
                out = self.peers.request("/das/samples",
                                         {"groups": groups})
            except PeerError:
                self._note_batch(False)
                raise
        got: dict[int, dict] = {}
        for resp in out.get("groups") or []:
            try:
                got[int(resp["height"])] = resp
            except (KeyError, TypeError, ValueError):
                continue
        if got:
            self._note_batch(True)
        return got

    def _verify_docs(self, codec, commitments,
                     docs: list[dict]) -> tuple[dict, list]:
        """Scheme-dispatched doc verification: the rs2d inline DAH path
        or the codec interface — one call site for every fetch flavor
        (live batch, window group, pack chunk)."""
        if codec.name == dacodec.RS2D_NAME:
            return self._verify_cells(commitments, docs)
        return self._verify_cells_codec(codec, commitments, docs)

    # -- proof packs (client side) ----------------------------------------

    def _fetch_verified_chunk(self, height: int, ci: int,
                              want_hash: str,
                              peer: str) -> list[dict] | None:
        """One sha-verified pack chunk, PINNED to the peer whose header
        doc advertised the manifest (chunk boundaries/hashes are
        per-node config, so fetching from a rotated peer could penalize
        an honest node for another's advert). Returns the decoded doc
        list, or None on any shortfall; a hash-mismatched or
        undecodable body penalizes the advertising peer — corrupt (or
        lying) static serving must never decide availability."""
        import hashlib

        from celestia_app_tpu_torch.das import packs as packs_mod

        try:
            telemetry.incr("daser.sampling_round_trips")
            data = self.peers.request_pinned(
                peer, f"/das/pack/chunk?height={height}&index={ci}",
                raw=True,
            )
        except (OSError, ValueError):
            telemetry.incr("daser.pack_fallbacks")
            return None
        if hashlib.sha256(data).hexdigest() != want_hash:
            telemetry.incr("daser.pack_chunk_rejected")
            self.peers.penalize(
                peer, f"pack chunk {height}/{ci} hash mismatch")
            return None
        try:
            return packs_mod.decode_chunk(data)
        except ValueError:
            telemetry.incr("daser.pack_chunk_rejected")
            self.peers.penalize(
                peer, f"pack chunk {height}/{ci} undecodable")
            return None

    def _fetch_pack_docs(self, height: int, pack: dict, cells,
                         codec, commitments) -> list[dict] | None:
        """The sampled cells' docs out of static pack chunks: map each
        cell to its chunk by sample-space position, fetch the distinct
        chunks (pinned to the advertising peer), verify each chunk's
        sha256 against the advertised manifest, and slice out the cell
        docs. Returns None on ANY shortfall — the caller falls back to
        live assembly. Note the cell docs themselves are verified by
        the normal per-sample path afterwards, so a lying manifest buys
        an adversary nothing."""
        peer = pack.get("peer")
        if peer is None:
            return None
        space = codec.sample_space(commitments)
        index_of = {cell: i for i, cell in enumerate(space)}
        chunk_cells = int(pack["chunk_cells"])
        need: dict[int, list] = {}
        for cell in cells:
            i = index_of.get(tuple(cell))
            if i is None:
                return None
            need.setdefault(i // chunk_cells, []).append((cell, i))
        hashes = pack["chunk_hashes"]
        docs: list[dict] = []
        for ci in sorted(need):
            if not 0 <= ci < len(hashes):
                return None
            chunk_docs = self._fetch_verified_chunk(height, ci,
                                                    hashes[ci], peer)
            if chunk_docs is None:
                return None
            for _cell, i in need[ci]:
                off = i - ci * chunk_cells
                if not 0 <= off < len(chunk_docs):
                    telemetry.incr("daser.pack_fallbacks")
                    return None
                docs.append(chunk_docs[off])
        telemetry.incr("daser.pack_samples", len(docs))
        return docs

    def _verify_cells(self, dah: DataAvailabilityHeader,
                      docs: list[dict]) -> tuple[dict, list]:
        """Split served docs into {coord: (share, proof)} verified against
        the DAH and the list of failed coords."""
        good: dict[tuple[int, int], tuple] = {}
        failed: list[tuple[int, int]] = []
        for s in docs:
            coord = (int(s["row"]), int(s["col"]))
            if "error" in s:
                failed.append(coord)
                continue
            try:
                share, proof = self._decode_sample(s)
                ok = sampling.verify_sample(dah, coord[0], coord[1],
                                            share, proof)
            except (KeyError, ValueError, TypeError):
                ok = False
            if ok:
                good[coord] = (share, proof)
            else:
                failed.append(coord)
        return good, failed

    def _sample_height(self, height: int, root_hex: str,
                       square_size: int, rng=None) -> dict:
        """One height end-to-end; never raises. Returns the report dict
        ({"status": "sampled"|"recovered"|"fraud"|"unavailable"|"error"}).
        `rng` is the calling worker's own generator (numpy Generators are
        not thread-safe; sharing one across workers would correlate the
        draws the confidence bound assumes independent)."""
        # the light-node side of the height's trace: same deterministic
        # id the chain stamps, derived locally from (chain_id, height) —
        # the DAS sample round-trip joins the block's waterfall
        with obs.span(
            "das.sample_height", traces=self.traces,
            trace_id=obs.trace_id_for(self.light.chain_id, height),
            height=height, node=self.name,
        ) as sp:
            out = self._sample_height_inner(height, root_hex, square_size,
                                            rng)
            sp.set(status=out.get("status"))
            return out

    def _sample_height_inner(self, height: int, root_hex: str,
                             square_size: int, rng=None) -> dict:
        rng = rng if rng is not None else self.rng
        t0 = telemetry.start_timer()
        try:
            codec, commitments, pack = self._fetch_commitments(
                height, root_hex, square_size)
        except (PeerError, ValueError, KeyError) as e:
            telemetry.incr("daser.header_fetch_failures")
            return {"status": "error", "error": str(e)}
        cells = self._draw(codec, commitments, rng)
        out = self._sample_cells(height, codec, commitments, root_hex,
                                 cells, pack)
        telemetry.measure_since("daser.sample_height", t0)
        return out

    def _draw(self, codec, commitments, rng) -> list[tuple[int, int]]:
        """s cells from THIS sampler's own rng — uniform over the
        scheme's sample space (the rs2d draw stays the exact legacy pair
        sequence, so seeded samplers reproduce pre-window coordinates)."""
        s = self.cfg.samples_per_header
        if codec.name == dacodec.RS2D_NAME:
            width = len(commitments.row_roots)
            return [
                (int(rng.integers(0, width)), int(rng.integers(0, width)))
                for _ in range(s)
            ]
        space = codec.sample_space(commitments)
        return [space[int(rng.integers(0, len(space)))]
                for _ in range(s)]

    def _sample_cells(self, height: int, codec, commitments,
                      root_hex: str, cells, pack,
                      prefetched: list[dict] | None = None) -> dict:
        """Verify + retry + escalate one height's drawn cells. The docs
        come from (in preference order) a window group fetch
        (``prefetched``), the height's static proof pack, or a live
        batched fetch — all three verify through the same per-sample
        path, so the source never weakens the availability claim."""
        s = len(cells)
        docs = prefetched
        if docs is None and pack is not None and self.cfg.prefer_packs:
            docs = self._fetch_pack_docs(height, pack, cells, codec,
                                         commitments)
        if docs is None:
            try:
                docs = self._fetch_cells(height, cells)
            except PeerError as e:
                return {"status": "error", "error": str(e)}
        good, failed = self._verify_docs(codec, commitments, docs)
        good, failed = self._retry_failed(height, codec, commitments,
                                          good, failed)
        telemetry.incr("daser.samples_verified", len(good))
        report = {
            "samples": s,
            "verified": len(good),
            "failed": sorted(set(failed)),
        }
        if codec.name == dacodec.RS2D_NAME:
            report["confidence"] = sampling.withholding_catch_confidence(s)
        else:
            report["confidence"] = codec.confidence(s)
            report["scheme"] = codec.name
        if not failed:
            telemetry.incr("daser.headers_sampled")
            return {**report, "status": "sampled"}
        telemetry.incr("daser.samples_failed", len(set(failed)))
        if codec.name == dacodec.RS2D_NAME:
            return {**report,
                    **self._escalate(height, commitments, root_hex,
                                     pack=pack)}
        return {**report,
                **self._escalate_codec(height, codec, commitments,
                                       root_hex, pack=pack)}

    def _retry_failed(self, height: int, codec, commitments, good: dict,
                      failed: list) -> tuple[dict, list]:
        """Per-cell retries: a refused/garbled cell may be served by the
        next peer in rotation (PeerSet advances its starting peer per
        request). The FIRST retry of a partially-failed batch goes out
        immediately — one flaky cell must not cost the whole batch a
        backoff sleep (counted ``daser.partial_retries``); deterministic
        refusals then exhaust the backed-off rounds and escalate."""
        if failed:
            telemetry.incr("daser.partial_retries")
            try:
                docs = self._fetch_cells(height, failed)
                recovered, failed = self._verify_docs(codec, commitments,
                                                      docs)
                good.update(recovered)
            except PeerError:
                pass
        delay = self.cfg.backoff
        for _ in range(self.cfg.retries):
            if not failed:
                break
            self.clock.sleep(delay)
            delay *= 2
            try:
                docs = self._fetch_cells(height, failed)
            except PeerError:
                continue
            recovered, failed = self._verify_docs(codec, commitments,
                                                  docs)
            good.update(recovered)
        return good, failed

    # -- the catch-up window (serving plane) -----------------------------

    def _sample_window(self, job, rng) -> dict[int, dict]:
        """One catch-up job sampled as a WINDOW: one batched header
        fetch plus one multi-height grouped sample fetch cover every
        height in the job, so sampling round-trips per height drop
        toward 1/window (was one request per (height, retry)). Each
        height still verifies, retries, and escalates independently —
        a bad height in a window costs only its own follow-ups."""
        reports: dict[int, dict] = {}
        ctx: dict[int, tuple] = {}
        header_peer, header_docs = self._fetch_headers_batch(job)
        for h, root_hex, size in job:
            doc = header_docs.get(h)
            try:
                if doc is not None:
                    codec, commitments, pack = self._parse_header_doc(
                        doc, root_hex, size)
                    if pack is not None:
                        # chunk fetches pin to the advertising peer
                        pack = {**pack, "peer": header_peer}
                    ctx[h] = (codec, commitments, pack)
                else:
                    ctx[h] = self._fetch_commitments(h, root_hex, size)
            except (PeerError, ValueError, KeyError) as e:
                telemetry.incr("daser.header_fetch_failures")
                reports[h] = {"status": "error", "error": str(e)}
        draws = {h: self._draw(ctx[h][0], ctx[h][1], rng)
                 for h, _root, _size in job if h in ctx}
        groups: dict[int, dict] = {}
        if draws:
            try:
                groups = self._fetch_groups(draws)
            except PeerError:
                # no peer served the window: per-height fetches below
                # (pack or live) still get their chance
                groups = {}
        for h, root_hex, _size in job:
            if h in reports or self._stop.is_set() \
                    or self._halted_evt.is_set():
                continue
            codec, commitments, pack = ctx[h]
            resp = groups.get(h)
            prefetched = (resp.get("samples")
                          if resp is not None and "error" not in resp
                          else None)
            with obs.span(
                "das.sample_height", traces=self.traces,
                trace_id=obs.trace_id_for(self.light.chain_id, h),
                height=h, node=self.name, window=len(job),
            ) as sp:
                t0 = telemetry.start_timer()
                rep = self._sample_cells(h, codec, commitments, root_hex,
                                         draws[h], pack,
                                         prefetched=prefetched)
                telemetry.measure_since("daser.sample_height", t0)
                sp.set(status=rep.get("status"))
            reports[h] = rep
        return reports

    # -- non-default schemes: codec-interface sampling + escalation ------

    def _verify_cells_codec(self, codec, commitments,
                            docs: list[dict]) -> tuple[dict, list]:
        """Split served docs into {cell: (payload, doc)} verified via
        the codec and the list of failed cells. The full doc rides along
        because a fraud proof's members carry their served proofs."""
        good: dict[tuple[int, int], tuple] = {}
        failed: list[tuple[int, int]] = []
        for s in docs:
            coord = (int(s["row"]), int(s["col"]))
            if "error" in s:
                failed.append(coord)
                continue
            got = codec.verify_sample(commitments, s)
            if got is not None and got[0] == coord:
                good[coord] = (got[1], s)
            else:
                failed.append(coord)
        return good, failed

    def _escalate_codec(self, height: int, codec, commitments,
                        root_hex: str, pack: dict | None = None) -> dict:
        """Codec-interface escalation: fetch every obtainable base
        symbol in bounded batches, run the scheme's repair (the peeling
        decoder for cmt-ldpc), and either clear the block, condemn it
        with a verified fraud proof, or record it unavailable. Scheme-
        generic: the only detection type caught is the interface's
        BadEncodingDetected base, and proof assembly goes through the
        codec's fraud_cells/fraud_proof_from_members hooks."""
        telemetry.incr("daser.escalations")
        space = codec.sample_space(commitments)
        chunk = 256  # bounded request batches (the rs2d row discipline)
        batches = [space[start:start + chunk]
                   for start in range(0, len(space), chunk)]
        docs_map: dict[tuple[int, int], tuple] = {}
        for docs in self._fetch_all_docs(height, pack, batches):
            good, _failed = self._verify_cells_codec(codec, commitments,
                                                     docs)
            docs_map.update(good)
        if not docs_map:
            return {"status": "unavailable",
                    "error": "no peer served any reconstruction cells"}
        samples = {cell: payload
                   for cell, (payload, _doc) in docs_map.items()}
        try:
            t_rep = telemetry.start_timer()
            try:
                codec.repair(commitments, samples, self.device)
            finally:
                telemetry.measure_since("daser.repair", t_rep)
        except dacodec.BadEncodingDetected as e:
            proof = self._build_codec_fraud(height, codec, commitments,
                                            docs_map, e.location)
            if proof is not None and self.light.submit_fraud_proof(
                    commitments, proof, self.device):
                telemetry.incr("daser.befp_verified")
                self._halt(height, "bad-encoding", root_hex)
                return {"status": "fraud",
                        "location": list(e.location)}
            telemetry.incr("daser.befp_failed")
            return {"status": "unavailable",
                    "error": f"bad encoding at {e.location} but fraud "
                             "proof could not be assembled"}
        except cuda_build.KernelError:
            raise  # a kernel wrapper's ValueError is no verdict on the block
        except ValueError as e:
            telemetry.incr("daser.unavailable")
            return {"status": "unavailable", "error": str(e)}
        telemetry.incr("daser.recovered")
        return {"status": "recovered"}

    def _build_codec_fraud(self, height: int, codec, commitments,
                           docs_map: dict, location):
        """Assemble the scheme's compact fraud proof from served symbol
        docs (each already carries its own inclusion proof); any member
        missing from the escalation sweep is fetched by its cell."""
        try:
            cells = codec.fraud_cells(commitments, location)
        except NotImplementedError:
            return None
        carried = []
        for cell in cells:
            got = docs_map.get(cell)
            if got is None:
                try:
                    docs = self._fetch_cells(height, [cell])
                except PeerError:
                    return None
                good, _failed = self._verify_cells_codec(
                    codec, commitments, docs)
                got = good.get(cell)
            if got is None:
                return None
            payload, doc = got
            carried.append((cell, payload, doc))
        return codec.fraud_proof_from_members(commitments, location,
                                              carried)

    def _fetch_all_docs(self, height: int, pack: dict | None,
                        batches: list[list]):
        """Escalation's full fetch, yielding doc lists: every pack chunk
        when the height advertises one (static bytes, each sha-verified
        and pinned to the advertising peer — at k=128 this replaces 256
        assembled row requests with 256 file reads), else the bounded
        live batches. Any pack shortfall falls back to the live batches
        wholesale."""
        peer = pack.get("peer") if pack is not None else None
        if peer is not None and self.cfg.prefer_packs:
            all_docs: list[list[dict]] = []
            for ci, want in enumerate(pack["chunk_hashes"]):
                chunk_docs = self._fetch_verified_chunk(height, ci,
                                                        want, peer)
                if chunk_docs is None:
                    all_docs = []
                    break
                all_docs.append(chunk_docs)
            if all_docs:
                telemetry.incr(
                    "daser.pack_samples",
                    sum(len(d) for d in all_docs))
                yield from all_docs
                return
        for batch in batches:
            try:
                yield self._fetch_cells(height, batch)
            except PeerError:
                continue

    # -- escalation: repair -> fraud proof -------------------------------

    def _escalate(self, height: int, dah: DataAvailabilityHeader,
                  root_hex: str, pack: dict | None = None) -> dict:
        """A sample failed after retries: fetch everything obtainable,
        reconstruct, and either clear the block (it WAS available),
        condemn it with a verified BEFP, or record it unavailable."""
        telemetry.incr("daser.escalations")
        width = len(dah.row_roots)
        # row-sized batches, not one square-sized request: a k=128 square
        # is 64k cells (~100 MB of b64) — a single request would blow the
        # peer timeout and misreport an available block as unavailable.
        # A failed row batch just leaves its cells absent; the crossword
        # tolerates holes up to the repair threshold.
        docs: list[dict] = []
        for batch_docs in self._fetch_all_docs(
            height, pack,
            [[(r, c) for c in range(width)] for r in range(width)],
        ):
            docs += batch_docs
        if not docs:
            return {"status": "unavailable",
                    "error": "no peer served any reconstruction cells"}
        good, _failed = self._verify_cells(dah, docs)
        symbols = np.zeros((width, width, appconsts.SHARE_SIZE),
                           dtype=np.uint8)
        present = np.zeros((width, width), dtype=bool)
        for (r, c), (share, _proof) in good.items():
            symbols[r, c] = np.frombuffer(share, dtype=np.uint8)
            present[r, c] = True
        try:
            # the batched sweep engine (da/repair.py): per-pattern fused
            # decode matmuls + per-sweep batched root verification; its
            # da.repair.sweep / da.repair.verify_roots spans land in this
            # light node's trace tables and nest under das.sample_height
            t_rep = telemetry.start_timer()
            try:
                repair.repair_eds(symbols, present,
                                  list(dah.row_roots), list(dah.col_roots),
                                  device=self.device, traces=self.traces)
            finally:
                # the fraud/unsolvable outcomes are exactly the repairs
                # worth timing — measure on every path
                telemetry.measure_since("daser.repair", t_rep)
        except repair.BadEncodingError as e:
            befp = self._build_befp(height, dah, e.axis, e.index)
            if befp is not None and self.light.submit_fraud_proof(
                    dah, befp, self.device):
                telemetry.incr("daser.befp_verified")
                self._halt(height, "bad-encoding", root_hex)
                return {"status": "fraud", "axis": e.axis,
                        "index": e.index}
            telemetry.incr("daser.befp_failed")
            return {"status": "unavailable",
                    "error": f"bad {e.axis} {e.index} but BEFP "
                             "could not be assembled"}
        except cuda_build.KernelError:
            raise  # a kernel wrapper's ValueError is no verdict on the block
        except ValueError as e:
            telemetry.incr("daser.unavailable")
            return {"status": "unavailable", "error": str(e)}
        # the crossword completed and every axis root checked out: the
        # data IS recoverable, the failing samples were peer flakiness
        telemetry.incr("daser.recovered")
        return {"status": "recovered"}

    def _build_befp(self, height: int, dah: DataAvailabilityHeader,
                    axis: str, index: int):
        """Assemble a BadEncodingProof for the condemned axis from served
        orthogonal-axis cell proofs: for a bad ROW its cells are proven
        under the COLUMN roots (and vice versa) — the exact ShareWithProof
        members da/fraud.verify_befp checks, no full square needed."""
        width = len(dah.row_roots)
        k = width // 2
        ortho = "col" if axis == "row" else "row"
        cells = [(index, j) if axis == "row" else (j, index)
                 for j in range(width)]
        try:
            docs = self._fetch_cells(height, cells, axis=ortho)
        except PeerError:
            return None
        ortho_roots = dah.col_roots if axis == "row" else dah.row_roots
        shares: list[fraud.ShareWithProof] = []
        for s in docs:
            if "error" in s or len(shares) >= k:
                continue
            r, c = int(s["row"]), int(s["col"])
            j = c if axis == "row" else r
            try:
                share, proof = self._decode_sample(s)
            except (KeyError, ValueError):
                continue
            ns = fraud.leaf_ns(r, c, share, k)
            if (proof.start == index and proof.end == index + 1
                    and proof.verify(ortho_roots[j], [(ns, share)])):
                shares.append(fraud.ShareWithProof(
                    position=j, share=share, proof=proof,
                ))
        if len(shares) < k:
            return None
        return fraud.BadEncodingProof(axis=axis, index=index,
                                      shares=tuple(shares[:k]))

    # -- the sweep -------------------------------------------------------

    def _pending_heights(self) -> list[tuple[int, str, int]]:
        pend = []
        with self._lock:
            for h in range(self.cp.sample_from,
                           self.cp.network_head + 1):
                if h in self._roots:
                    pend.append((h, *self._roots[h]))
            for h in sorted(self.cp.failed):
                if h < self.cp.sample_from and h in self._roots:
                    # retry earlier failures
                    pend.append((h, *self._roots[h]))
        return pend

    def _sweep_job(self, job, rng) -> dict[int, dict]:
        """One catch-up job end to end on the caller's thread — the unit
        both sweep drivers (threaded workers and the continuation's
        steps) execute identically. A multi-height job goes out as one
        WINDOW (batched headers + grouped samples, serving plane §17.1);
        a single-height job walks the per-height path with the stop/halt
        gates the threaded worker always honored."""
        if len(job) > 1:
            return self._sample_window(job, rng)
        reps: dict[int, dict] = {}
        for h, root_hex, size in job:
            if self._stop.is_set() or self._halted_evt.is_set():
                break
            reps[h] = self._sample_height(h, root_hex, size, rng=rng)
        return reps

    def begin_sweep(self) -> "SweepCont":
        """A sweep as an explicit continuation: drive it with
        ``step()`` until False. Scheduler-friendly — a fleet of
        thousands of samplers interleaves one bounded unit of work per
        event instead of pinning an OS thread each (sim/engine.py)."""
        return SweepCont(self)

    def sync(self) -> dict:
        """One full sweep: follow the head through the light client, then
        catch up over every pending height with the bounded worker pool,
        fold results into the checkpoint, and persist it. Returns a
        summary {"head", "sample_from", "sampled", "failed", "halted"}.

        A thin threaded driver over the SweepCont phases: the plan and
        fold steps run here on the caller's thread; the job list is
        drained by the worker pool racing a queue, each worker executing
        the same ``_sweep_job`` unit the continuation steps through
        (pinned equivalent at workers=1 in tests/test_daser_cont.py)."""
        cont = self.begin_sweep()
        cont.step()  # plan: halted gate, head follow, job split, rngs
        if cont.phase == "jobs":
            jobs: queue_mod.Queue = queue_mod.Queue()
            for job in cont.jobs:
                jobs.put(job)

            errors: list[BaseException] = []

            def worker(rng) -> None:
                while not self._stop.is_set() \
                        and not self._halted_evt.is_set() and not errors:
                    try:
                        job = jobs.get_nowait()
                    except queue_mod.Empty:
                        return
                    try:
                        reps = self._sweep_job(job, rng)
                    except BaseException as e:  # re-raised by sync()
                        errors.append(e)
                        return
                    with self._lock:
                        cont.results.update(reps)
                        self.reports.update(reps)

            threads = [
                threading.Thread(target=worker, args=(child,), daemon=True)
                for child in cont.rngs
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                # a worker's error (the device work of an escalation) is
                # the caller's, as on the continuation's single thread
                raise errors[0]
            cont.phase = "fold"
        while cont.step():
            pass
        return cont.summary

    def _fold(self, results: dict[int, dict]) -> None:
        """Checkpoint bookkeeping: completed heights clear from the failed
        map; incomplete ones record an attempt; the sample_from watermark
        advances over every height that has a durable disposition."""
        done_now = set()
        telemetry.incr("daser.heights_swept", len(results))
        with self._lock:
            for h, rep in results.items():
                if rep["status"] in ("sampled", "recovered"):
                    self.cp.failed.pop(h, None)
                    done_now.add(h)
                elif rep["status"] in ("unavailable", "error"):
                    self.cp.failed[h] = self.cp.failed.get(h, 0) + 1
            while self.cp.sample_from <= self.cp.network_head and (
                    self.cp.sample_from in done_now
                    or self.cp.sample_from in self.cp.failed):
                self.cp.sample_from += 1
            # bound the verified-root map: everything durably sampled
            # and not awaiting a failed-height retry can go (headers
            # re-verify cheaply)
            floor = min(
                [self.cp.sample_from] + sorted(self.cp.failed)[:1])
            for h in [h for h in self._roots if h < floor]:
                del self._roots[h]
            keep = self.cfg.report_keep
            if keep > 0 and len(self.reports) > keep:
                # oldest-height reports go first; anything below the
                # watermark is already durably dispositioned in the
                # checkpoint and never re-swept
                for h in sorted(self.reports)[:len(self.reports) - keep]:
                    del self.reports[h]
            doc = self.cp.to_json()
        # fsync outside the lock (blocking-under-lock): status polls and
        # worker folds must not stall on the checkpoint flush
        self.store.save_doc(doc)

    # -- daemon lifecycle ------------------------------------------------

    def run_background(self) -> "DASer":
        def loop() -> None:
            while not self._stop.is_set() \
                    and not self._halted_evt.is_set():
                try:
                    self.sync()
                except Exception as e:  # keep the daemon alive, loudly
                    log.error("sweep error", daser=self.name, err=e)
                # interruptible head-follow pause through the injected
                # clock: stop() wakes it immediately, and a VirtualClock
                # resolves it against simulated time
                self.clock.wait(self._stop, self.cfg.poll_interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)


class SweepCont:
    """One sweep of a DASer as an explicit continuation.

    The sweep's state machine — plan (halted gate + head follow + job
    split) → one catch-up job per step → fold (checkpoint + summary) —
    lives in this object instead of a per-DASer OS thread, so a
    scheduler advances thousands of samplers by calling ``step()`` one
    bounded unit at a time (sim/engine.SimLightNode). ``sync()`` drives
    the identical phases with its worker pool racing the job list; at
    ``workers=1`` the two drivers execute the exact same request/rng
    sequence (the tier-1 equivalence pin).

    Phases: ``plan`` → ``jobs`` → ``fold`` → ``done``. ``step()``
    returns True while more work remains; ``summary`` holds the sweep's
    return dict once done. The per-job rng lanes spawn off the DASer's
    parent generator with the same ``min(workers, len(pending))`` count
    the threaded pool uses, so a seeded DASer's parent stream stays
    byte-identical under either driver."""

    def __init__(self, daser: DASer):
        self.daser = daser
        self.phase = "plan"
        self.jobs: list[list[tuple[int, str, int]]] = []
        self.rngs: list = []
        # written under the DASER's lock (a foreign lock, out of the
        # lexical guarded-by rule's model): sync()'s worker threads
        # merge job results here concurrently; the continuation driver
        # is single-threaded and _fold runs strictly after the last job
        self.results: dict[int, dict] = {}
        self.summary: dict | None = None
        self._ji = 0  # next job index (continuation driver only)

    @property
    def done(self) -> bool:
        return self.phase == "done"

    def step(self) -> bool:
        """Run one bounded unit of the sweep; True while more remain."""
        if self.phase == "plan":
            self._plan()
        elif self.phase == "jobs":
            self._job()
        elif self.phase == "fold":
            self._fold()
        return self.phase != "done"

    def _finish(self, summary: dict) -> None:
        self.summary = summary
        self.phase = "done"

    def _plan(self) -> None:
        d = self.daser
        with d._lock:
            if d.cp.halted is not None:
                self._finish({"halted": d.cp.halted})
                return
        d._advance_head()
        with d._lock:
            if d.cp.halted is not None:
                # a condemned root surfaced during following
                self._finish({"halted": d.cp.halted})
                return
        pending = d._pending_heights()
        if not pending:
            self.phase = "fold"
            return
        self.jobs = [pending[i:i + d.cfg.job_size]
                     for i in range(0, len(pending), d.cfg.job_size)]
        # one independent child generator per worker lane (spawn keys
        # off the parent's seed sequence, so a seeded DASer stays
        # deterministic while lanes never share bit-generator state)
        self.rngs = list(d.rng.spawn(min(d.cfg.workers, len(pending))))
        self.phase = "jobs"

    def _job(self) -> None:
        d = self.daser
        if self._ji >= len(self.jobs) or d._stop.is_set() \
                or d._halted_evt.is_set():
            self.phase = "fold"
            return
        job = self.jobs[self._ji]
        # round-robin lane assignment: job i runs on lane i % n — at
        # workers=1 this is the threaded pool's exact FIFO order
        rng = self.rngs[self._ji % len(self.rngs)]
        self._ji += 1
        reps = d._sweep_job(job, rng)
        with d._lock:
            self.results.update(reps)
            d.reports.update(reps)
        if self._ji >= len(self.jobs):
            self.phase = "fold"

    def _fold(self) -> None:
        d = self.daser
        d._fold(self.results)
        with d._lock:
            self._finish({
                "head": d.cp.network_head,
                "sample_from": d.cp.sample_from,
                "sampled": sorted(h for h, r in self.results.items()
                                  if r["status"] in ("sampled",
                                                     "recovered")),
                "failed": sorted(d.cp.failed),
                "halted": d.cp.halted,
            })
