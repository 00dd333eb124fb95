"""DAS server plane: batched sample-proof serving from committed blocks.

The serving half of the celestia-node DASer story:
millions of light clients hammer full nodes with cell-proof requests, so
the full-node side must answer them from *cached row trees*, never by
rehashing per request. Every height's trees come from the one batched
device pass `da/proof_device.BlockProver` already runs (the level pass
through kernel K1 on the card); each served proof is then pure index
arithmetic.
Entries sit behind a bounded LRU keyed by height — the same discipline as
the DA service's square cache (service/da_service.DACore).

Routes (mounted on the validator service and the standalone SampleService;
the reference's wire format, byte for byte):

  GET  /das/head                        serving tip {"height": H}
  GET  /das/header?height=H             DAH (row+col roots) + data root
                                        (+ "pack" advertisement, §17.2)
  GET  /das/sample?height&row&col[&axis]   one cell + NMT proof
  POST /das/samples {height, cells, axis?} batched multi-cell variant
  POST /das/samples {groups: [{height, cells}...], axis?}
                                        multi-HEIGHT batched variant: one
                                        round-trip serves a whole catch-up
                                        window, entries resolved in one
                                        pass and dispatched per scheme/k
                                        bucket (§17.1)
  POST /das/headers {heights: [...]}    batched commitments docs
  GET  /das/pack?height=H               proof-pack manifest (§17.2)
  GET  /das/pack/chunk?height=H&index=I raw pack chunk bytes — static
                                        serving, no lock, no assembly
  GET  /das/availability?height=H       per-height serving record

`axis` selects which committed root the proof hangs under: "row" (the
sampler default) or "col" — orthogonal-axis proofs are exactly the
`ShareWithProof` members a bad-encoding fraud proof carries
(da/fraud.py), so an escalating sampler can assemble a BEFP from served
cells alone. Column trees are the row trees of the TRANSPOSED square
(the pkg/wrapper leaf-namespace rule is transpose-invariant: parity iff
outside Q0), so the col prover reuses the same batched device path with
zero new hashing code.

Serving-plane split: live assembly counts
``das.live_assembled``; static pack serving counts ``das.pack_hits`` /
``das.pack_misses`` — both split per height in the /das/availability
record, so operators can see how much of the fleet's demand the static
path absorbs. Pack routes never build an entry (and never extend): the
height's data root resolves from the serving cache or the block store.

Fault injection: `withhold(height, cells)` makes the server refuse those
cells — the adversarial fixture that models a withholding producer.
Note the withholding gate
models the LIVE path; a node serving static packs is the honest-server
shape (a real withholder simply does not publish packs).

Block-plane integration: heights are backed by the app's
content-addressed EDS/DAH cache (da/edscache.py). `App.commit` hands each
committed entry here via `seed_cache_entry` (registered on
`app.da_seed_listeners`) from the warmer's background thread with its
provers pre-built, so the first sample after a commit never rebuilds or
re-extends; misses single-flight through `_entry` so concurrent samplers
of a fresh height pay one build between them.

Port of celestia_app_tpu/das/server.py. Where the reference reads the
App's ``engine`` (and serves from the host when it has none), the port
builds every prover on the App's ``device``: a core over a card App
never builds on the host.
"""

from __future__ import annotations

import collections
import threading

from celestia_app_tpu_torch import cuda_build
from celestia_app_tpu_torch.da import codec as codec_mod
from celestia_app_tpu_torch.da import edscache as edscache_mod
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader, ExtendedDataSquare
from celestia_app_tpu_torch.das import packs as packs_mod
from celestia_app_tpu_torch.utils import telemetry


class SampleError(ValueError):
    """Client-side problem (bad coordinates, unknown height, withheld
    cell): transports map it to a 4xx, never a 500."""


class _Entry:
    """A served height: thin view over the block plane's EdsCacheEntry
    (da/edscache.py), which owns the EDS/DAH/roots and builds the row and
    col provers at most once — lazily under its own lock, or ahead of
    demand by the commit warmer that seeded it here."""

    def __init__(self, height: int, cache_entry: edscache_mod.EdsCacheEntry,
                 device):
        self.height = height
        self.cache_entry = cache_entry
        self.device = device
        # resolved-prover memo: per-cell proving must not pay the cache
        # entry's lock per proof (benign race — get_prover is idempotent
        # and returns the one entry-owned instance)
        self._prover_view = None
        self._col_prover_view = None

    @property
    def dah(self):
        """The scheme's commitments object (a DataAvailabilityHeader
        under rs2d-nmt, a CmtCommitments under cmt-ldpc)."""
        return self.cache_entry.dah

    @property
    def scheme(self) -> str:
        return self.cache_entry.scheme

    @property
    def width(self) -> int:
        """Extended-square width (2k) — the geometry stat availability
        records carry for every scheme."""
        return 2 * self.cache_entry.k

    @property
    def root(self) -> bytes:
        return self.cache_entry.data_root

    @property
    def prover(self):
        if self._prover_view is None:
            self._prover_view = self.cache_entry.get_prover(self.device)
        return self._prover_view

    @property
    def col_prover(self):
        if self._col_prover_view is None:
            self._col_prover_view = \
                self.cache_entry.get_col_prover(self.device)
        return self._col_prover_view


def _b64(b: bytes) -> str:
    import base64

    return base64.b64encode(b).decode()


class SampleCore:
    """Per-height sample serving over an App's committed blocks.

    Thread-safe: HTTP handler threads call `sample`/`sample_many`
    concurrently; the entry cache and availability records are guarded.
    Proof generation itself is lock-free index arithmetic on immutable
    level arrays, so concurrent samplers never serialize on hashing."""

    def __init__(self, app, cache_heights: int = 4,
                 availability_keep: int = 256, app_lock=None,
                 pack_store: packs_mod.PackStore | None = None):
        self.app = app
        # writer lock of the process hosting the app (NodeService shares
        # its service lock): square REBUILDS take it so serving never
        # races a commit mid-store; cached-entry serving stays lock-free
        self.app_lock = app_lock
        # the static proof-pack store (das/packs.py): built at warm time
        # by the app's ProverWarmer, served here as raw bytes. Defaults
        # to the app's own (<home>/packs); None on pack-less processes.
        self.pack_store = (pack_store if pack_store is not None
                           else getattr(app, "pack_store", None))
        self._cache: collections.OrderedDict[int, _Entry] = \
            collections.OrderedDict()
        self._cache_heights = cache_heights
        self._availability_keep = availability_keep
        self._lock = threading.Lock()
        # height -> build in progress (single-flight: concurrent samplers
        # of a fresh height pay ONE square build between them)
        self._inflight: dict[int, threading.Event] = {}  # guarded-by: _lock
        # height -> serving record (exposed at /das/availability)
        self._availability: dict[int, dict] = {}
        self._withheld: dict[int, set[tuple[int, int]]] = {}
        self._max_seeded = 0  # seeded entries can sit above app.height

    # -- entries ---------------------------------------------------------

    def _device(self):
        """The App's device: every prover this core builds runs there."""
        return self.app.device

    def _entry(self, height: int) -> _Entry:
        """Cached serving entry for a height; misses are single-flight.

        Two handler threads missing the same height used to both run the
        full square rebuild under the app lock; now the first registers
        an in-progress event and builds, later arrivals wait on it
        (counted ``das.entry_coalesced``) and re-read the cache. A failed
        build wakes the waiters, and whichever retries first becomes the
        next to build — an error never wedges the height."""
        while True:
            with self._lock:
                hit = self._cache.get(height)
                if hit is not None:
                    self._cache.move_to_end(height)
                    return hit
                ev = self._inflight.get(height)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[height] = ev
                    break
            telemetry.incr("das.entry_coalesced")
            ev.wait()
        try:
            return self._build_entry(height)
        finally:
            with self._lock:
                self._inflight.pop(height, None)
            ev.set()

    def _build_entry(self, height: int) -> _Entry:
        import contextlib

        from celestia_app_tpu_torch.chain.query import QueryError, \
            build_prover_entry

        t0 = telemetry.start_timer()
        guard = self.app_lock if self.app_lock is not None \
            else contextlib.nullcontext()
        try:
            with guard:
                _block, _square, cache_entry = \
                    build_prover_entry(self.app, height)
        except cuda_build.KernelError:
            raise  # a kernel wrapper's ValueError is no unservable height
        except (QueryError, FileNotFoundError, KeyError, ValueError) as e:
            raise SampleError(f"no servable square at height {height}: {e}") \
                from None
        telemetry.incr("das.square_builds")
        telemetry.measure_since("das.square_build", t0)
        entry = _Entry(height, cache_entry, self._device())
        self._remember(entry)
        return entry

    def seed_cache_entry(self, height: int,
                         cache_entry: edscache_mod.EdsCacheEntry) -> None:
        """The commit warmer's handoff (App.da_seed_listeners): serve the
        entry the lifecycle already computed — its provers are typically
        pre-built by the warmer, so the first sample after commit is pure
        index arithmetic, with no rebuild and no ``das.square_build``."""
        telemetry.incr("edscache.seeded")
        self._seed(height, cache_entry)

    def seed_entry(self, height: int,
                   eds: ExtendedDataSquare,
                   dah: DataAvailabilityHeader) -> None:
        """Serve a square already in memory (a block adopted via gossip /
        blocksync whose EDS never hit the tx store, or a test fixture) —
        bypasses the rebuild-from-txs path but NOT the proof path.
        Counted apart from the commit warmer's handoffs
        (``edscache.seeded_external`` vs ``edscache.seeded``) so /metrics
        distinguishes lifecycle seeding from gossip/fixture seeding."""
        telemetry.incr("edscache.seeded_external")
        self._seed(height, edscache_mod.EdsCacheEntry(eds, dah, dah.hash()))

    def seed_scheme_entry(self, height: int, cache_entry) -> None:
        """Scheme-generic twin of seed_entry: serve ANY codec-plane
        entry already in memory (e.g. a da/cmt.CmtEntry a test fixture
        or gossip handoff holds). Counted with the external seeds."""
        telemetry.incr("edscache.seeded_external")
        self._seed(height, cache_entry)

    def _seed(self, height: int,
              cache_entry: edscache_mod.EdsCacheEntry) -> None:
        self._remember(_Entry(height, cache_entry, self._device()))
        with self._lock:
            self._max_seeded = max(self._max_seeded, height)

    def _remember(self, entry: _Entry) -> None:
        with self._lock:
            self._cache[entry.height] = entry
            self._cache.move_to_end(entry.height)
            while len(self._cache) > self._cache_heights:
                self._cache.popitem(last=False)

    def _col_prover(self, entry: _Entry):
        """Column-axis prover (BEFP escalation serving) — owned by the
        cache entry (da/edscache.EdsCacheEntry.get_col_prover), which
        builds it at most once under its own lock; the commit warmer
        usually pre-built it already."""
        return entry.col_prover

    # -- fault injection (tests / adversarial simulation) ----------------

    def withhold(self, height: int, cells) -> None:
        """Refuse to serve the given (row, col) cells of a height — the
        withholding-producer fixture. Idempotent; cumulative per height."""
        with self._lock:
            self._withheld.setdefault(height, set()).update(
                (int(r), int(c)) for r, c in cells
            )

    # -- serving ---------------------------------------------------------

    def head(self) -> dict:
        """The serving tip: the chain's committed height, or higher when
        a seeded square (gossip/blocksync handoff) sits above it."""
        return {"height": max(self.app.height, self._max_seeded)}

    def header(self, height: int) -> dict:
        """The scheme's commitments doc (+height): the DAH shape
        (row/col roots) under rs2d-nmt, with a "scheme" member, or the
        CMT parameter/root-hash doc. Either binds to the certified data
        root."""
        entry = self._entry(height)
        codec = codec_mod.get(entry.scheme)
        doc = {"height": height,
               **codec.commitments_doc(entry.cache_entry)}
        # pack advertisement: zero-extra-round-trip discovery —
        # a sampler that just fetched commitments knows whether (and how)
        # this height is servable as static bytes. Old clients ignore it.
        pack = self._pack_advert(entry)
        if pack is not None:
            doc["pack"] = pack
        return doc

    def _one(self, entry: _Entry, row: int, col: int, axis: str) -> dict:
        if entry.scheme == codec_mod.RS2D_NAME:
            width = len(entry.dah.row_roots)
            if not (0 <= row < width and 0 <= col < width):
                raise SampleError(
                    f"cell ({row}, {col}) outside the {width}x{width} "
                    "square"
                )
        # ONE withholding/fault gate for every scheme: (row, col) is the
        # generic wire cell pair ((layer, index) for non-default codecs)
        held = self._withheld.get(entry.height)
        if held and (row, col) in held:
            self._note(entry, withheld=1)
            raise SampleError(f"cell ({row}, {col}) not served")
        # env/endpoint-armable twin of withhold(): a "drop"/"error" fault
        # at das.serve_sample makes THIS node a withholding producer for
        # matching cells without any in-process fixture access
        from celestia_app_tpu_torch import faults

        if faults.fire("das.serve_sample", height=entry.height,
                       row=row, col=col) in ("drop", "error"):
            self._note(entry, withheld=1)
            raise SampleError(f"cell ({row}, {col}) not served")
        if entry.scheme != codec_mod.RS2D_NAME:
            return self._one_codec(entry, row, col)
        if axis == "row":
            # the shared doc function (das/packs.live_cell_doc): the pack
            # assembly runs the SAME function, so pack bytes ≡ live bytes
            # by construction
            return packs_mod.live_cell_doc(
                entry.cache_entry, (row, col), prover=entry.prover)
        # transposed prover: cell (row, col) lives at (col, row) of
        # the transpose; its proof hangs under col_roots[col] and
        # covers leaf range [row, row+1)
        share, proof = self._col_prover(entry).prove_cell(col, row)
        return {
            "row": row,
            "col": col,
            "share": _b64(share),
            "proof": {
                "start": proof.start,
                "end": proof.end,
                "total": proof.total,
                "nodes": [_b64(n) for n in proof.nodes],
            },
        }

    def _one_codec(self, entry: _Entry, layer: int, index: int) -> dict:
        """Non-default-scheme cell: the wire (row, col) pair is the
        scheme's (layer, index). The withholding fixture
        and the das.serve_sample fault point already gated in _one."""
        try:
            return packs_mod.live_cell_doc(entry.cache_entry,
                                           (layer, index),
                                           device=entry.device)
        except codec_mod.CodecError as e:
            raise SampleError(str(e)) from None

    def sample(self, height: int, row: int, col: int,
               axis: str = "row") -> dict:
        out = self.sample_many(height, [(row, col)], axis=axis)
        one = out["samples"][0]
        if "error" in one:
            raise SampleError(one["error"])
        return {**out, "samples": [one]}

    def sample_many(self, height: int, cells, axis: str = "row") -> dict:
        """Batched multi-cell serving: one tree lookup, N index-arithmetic
        proofs. Per-cell failures (withheld, out of range) come back as
        {"row","col","error"} members so a partially-served batch still
        helps a reconstructing DASer."""
        cells = self._check_cells(cells, axis)
        entry = self._entry(height)
        return self._serve_group(entry, height, cells, axis)

    @staticmethod
    def _check_cells(cells, axis: str) -> list[tuple[int, int]]:
        if axis not in ("row", "col"):
            raise SampleError(f"axis must be 'row' or 'col', not {axis!r}")
        cells = [(int(r), int(c)) for r, c in cells]
        if not cells:
            raise SampleError("empty cell list")
        return cells

    def _serve_group(self, entry: _Entry, height: int,
                     cells: list[tuple[int, int]], axis: str) -> dict:
        """One height's batch against a resolved entry — THE one serving
        body behind both the single-height POST /das/samples and every
        group of the multi-height variant, so the two responses are
        byte-identical per height by construction."""
        from celestia_app_tpu_torch import obs

        # serve-side span of the DAS round-trip: the height's
        # deterministic trace id matches the sampling light node's, and
        # the incoming X-Celestia-Trace header (begin_request) makes the
        # sampler's fetch span this span's remote parent
        with obs.span(
            "das.serve_sample",
            traces=getattr(self.app, "traces", None),
            trace_id=obs.trace_id_for(
                getattr(self.app, "chain_id", ""), height
            ),
            height=height, cells=len(cells), axis=axis,
        ) as sp:
            t0 = telemetry.start_timer()
            samples = []
            served = 0
            for r, c in cells:
                try:
                    samples.append(self._one(entry, r, c, axis))
                    served += 1
                except SampleError as e:
                    samples.append({"row": r, "col": c, "error": str(e)})
            sp.set(served=served)
        telemetry.measure_since("das.sample_batch", t0)
        telemetry.incr("das.samples_served", served)
        # serving-plane accounting: these samples were
        # assembled live — the pack counters' counterpart
        telemetry.incr("das.live_assembled", served)
        telemetry.incr("das.sample_batches")
        self._note(entry, served=served, batches=1,
                   col_proofs=served if axis == "col" else 0,
                   live=served)
        return {
            "height": height,
            "data_root": entry.root.hex(),
            "scheme": entry.scheme,
            "axis": axis,
            "square_width": entry.width,
            "samples": samples,
        }

    def sample_groups(self, groups, axis: str = "row") -> dict:
        """Multi-height batched serving: one request resolves every
        group's height against the edscache in ONE pass, then serves the
        groups in (scheme, k) bucket order — heights sharing a codec
        dispatch shape run back to back, the batching the device path
        wants — while the response keeps the REQUEST order (each member
        byte-identical to the single-height response for that group).
        A height that cannot be resolved yields {"height", "error"} so
        the rest of the window still serves."""
        if not isinstance(groups, list) or not groups:
            raise SampleError("samples needs a non-empty 'groups' list")
        parsed: list[tuple[int, list[tuple[int, int]]]] = []
        for g in groups:
            try:
                height = int(g["height"])
            except (KeyError, TypeError, ValueError):
                raise SampleError(
                    "each group needs an integer 'height'") from None
            cells = g.get("cells")
            if not isinstance(cells, list):
                raise SampleError(
                    f"group for height {height} needs a 'cells' list")
            try:
                parsed.append((height, self._check_cells(cells, axis)))
            except SampleError:
                raise  # already the accurate message (empty list, axis)
            except (TypeError, ValueError):
                raise SampleError(
                    "each cell must be a [row, col] pair") from None
        # resolve every entry first (single-flight per height), bucketing
        # by (scheme, k) so same-shape heights serve consecutively
        resolved: dict[int, _Entry | SampleError] = {}
        for height, _cells in parsed:
            if height in resolved:
                continue
            try:
                resolved[height] = self._entry(height)
            except SampleError as e:
                resolved[height] = e
        order = sorted(
            range(len(parsed)),
            key=lambda i: (
                (resolved[parsed[i][0]].scheme,
                 resolved[parsed[i][0]].cache_entry.k)
                if isinstance(resolved[parsed[i][0]], _Entry)
                else ("", 0),
                i,
            ),
        )
        out: list[dict | None] = [None] * len(parsed)
        for i in order:
            height, cells = parsed[i]
            got = resolved[height]
            if isinstance(got, SampleError):
                out[i] = {"height": height, "error": str(got)}
                continue
            out[i] = self._serve_group(got, height, cells, axis)
        telemetry.incr("das.multi_height_batches")
        telemetry.incr("das.batch_heights", len(parsed))
        return {"axis": axis, "groups": out}

    def headers_many(self, heights) -> dict:
        """Batched commitments docs — the window sampler's one-round-trip
        header fetch. Per-height failures come back as {"height",
        "error"} members."""
        if not isinstance(heights, list) or not heights:
            raise SampleError("headers needs a non-empty 'heights' list")
        docs = []
        for h in heights:
            try:
                docs.append(self.header(int(h)))
            except SampleError as e:
                docs.append({"height": int(h), "error": str(e)})
            except cuda_build.KernelError:
                raise
            except (TypeError, ValueError):
                raise SampleError(
                    "each height must be an integer") from None
        return {"headers": docs}

    # -- proof packs (static serving; das/packs.py) ----------------------

    def _pack_root(self, height: int) -> bytes:
        """The height's data root WITHOUT building a square: cached
        serving entries first, then the durable block store. Raises
        SampleError when the height is unknown — pack routes must never
        trigger an extend."""
        with self._lock:
            hit = self._cache.get(height)
        if hit is not None:
            return hit.root
        db = getattr(self.app, "db", None)
        if db is not None:
            try:
                return db.load_block(height).header.data_hash
            except (OSError, KeyError, ValueError):
                pass
        # an unknown height is a pack miss too (global counter only: a
        # per-height record here would let an unauthenticated request
        # stream for arbitrary heights evict every genuine record from
        # the bounded availability map)
        telemetry.incr("das.pack_misses")
        raise SampleError(f"pack for height {height} not served")

    def pack_manifest(self, height: int) -> dict:
        """GET /das/pack: the height's pack manifest, or a 404-mapped
        refusal when no complete pack exists (counted das.pack_misses —
        the sampler falls back to live assembly)."""
        if self.pack_store is None:
            telemetry.incr("das.pack_misses")
            raise SampleError(f"pack for height {height} not served")
        m = self.pack_store.manifest(self._pack_root(height))
        if m is None:
            telemetry.incr("das.pack_misses")
            self._note_height(height, pack_misses=1)
            raise SampleError(f"pack for height {height} not served")
        return m

    def pack_chunk(self, height: int, index: int) -> bytes:
        """GET /das/pack/chunk: raw chunk bytes straight from disk — no
        lock, no assembly, no JSON; the CDN-shaped hot path. Counted
        das.pack_hits (misses das.pack_misses)."""
        if self.pack_store is None:
            telemetry.incr("das.pack_misses")
            raise SampleError(f"pack for height {height} not served")
        try:
            data = self.pack_store.chunk(self._pack_root(height), index)
        except packs_mod.PackError as e:
            telemetry.incr("das.pack_misses")
            self._note_height(height, pack_misses=1)
            raise SampleError(str(e)) from None
        telemetry.incr("das.pack_hits")
        self._note_height(height, pack_hits=1)
        return data

    def _pack_advert(self, entry: _Entry) -> dict | None:
        """The compact pack advertisement riding /das/header, or
        None when this node serves no pack for the height."""
        if self.pack_store is None:
            return None
        m = self.pack_store.manifest(entry.root)
        if m is None:
            return None
        return packs_mod.advertised(m)

    # -- availability records -------------------------------------------

    _RECORD_ZEROS = (
        "samples_served", "batches", "withheld_refusals",
        "col_proofs_served", "pack_hits", "pack_misses", "live_assembled",
    )

    def _record_locked(self, height: int, data_root: str | None,
                       width: int | None) -> dict:
        rec = self._availability.get(height)
        if rec is None:
            rec = self._availability[height] = {
                "height": height,
                "data_root": data_root,
                "square_width": width,
                # mesh plane: where the height's square bytes live
                # ("device" until a proof materializes them — see
                # da/edscache.DeviceEntry; "host" for classic entries)
                "residency": None,
                **{k: 0 for k in self._RECORD_ZEROS},
            }
        elif rec["data_root"] is None and data_root is not None:
            # a pack-only record learns its identity when live serving
            # (or a later pack route) resolves the entry
            rec["data_root"] = data_root
            rec["square_width"] = width
        return rec

    def _note(self, entry: _Entry, served: int = 0, batches: int = 0,
              withheld: int = 0, col_proofs: int = 0,
              live: int = 0) -> None:
        residency = entry.cache_entry.residency() \
            if hasattr(entry.cache_entry, "residency") else "host"
        with self._lock:
            rec = self._record_locked(entry.height, entry.root.hex(),
                                      entry.width)
            rec["residency"] = residency
            rec["samples_served"] += served
            rec["batches"] += batches
            rec["withheld_refusals"] += withheld
            rec["col_proofs_served"] += col_proofs
            rec["live_assembled"] += live
            while len(self._availability) > self._availability_keep:
                self._availability.pop(min(self._availability))

    def _note_height(self, height: int, pack_hits: int = 0,
                     pack_misses: int = 0) -> None:
        """Pack-route bookkeeping: records pack serving for heights the
        live plane may never have resolved (static chunk serving builds
        no entry on purpose)."""
        with self._lock:
            rec = self._record_locked(height, None, None)
            rec["pack_hits"] += pack_hits
            rec["pack_misses"] += pack_misses
            while len(self._availability) > self._availability_keep:
                self._availability.pop(min(self._availability))

    def availability(self, height: int) -> dict:
        with self._lock:
            rec = self._availability.get(height)
            if rec is not None:
                return dict(rec)
        # never-served height: the same record shape with null identity
        # fields so clients can read one schema
        return {"height": height, "data_root": None, "square_width": None,
                "residency": None, **{k: 0 for k in self._RECORD_ZEROS}}


# -- one router shared by every transport -----------------------------------


def route_das(core: SampleCore, method: str, path: str,
              query: dict, payload: dict | None = None):
    """Dispatch a /das/* request. `query` holds the GET params (strings);
    POST bodies arrive in `payload`. Raises SampleError for every
    malformed input (transports answer 4xx). Returns a JSON-able dict —
    or raw ``bytes`` for /das/pack/chunk, which the transports send as
    application/octet-stream (the chain/sync.route_sync convention)."""

    def _int(src: dict, key: str) -> int:
        try:
            v = src[key]
            return int(v[0] if isinstance(v, list) else v)
        except (KeyError, IndexError, TypeError, ValueError):
            raise SampleError(f"missing/invalid integer field {key!r}") \
                from None

    def _axis(src: dict) -> str:
        v = src.get("axis", "row")
        return v[0] if isinstance(v, list) else v

    if method == "GET":
        if path == "/das/head":
            return core.head()
        if path == "/das/header":
            return core.header(_int(query, "height"))
        if path == "/das/sample":
            return core.sample(_int(query, "height"), _int(query, "row"),
                               _int(query, "col"), axis=_axis(query))
        if path == "/das/availability":
            return core.availability(_int(query, "height"))
        if path == "/das/pack":
            return core.pack_manifest(_int(query, "height"))
        if path == "/das/pack/chunk":
            return core.pack_chunk(_int(query, "height"),
                                   _int(query, "index"))
    elif method == "POST" and path == "/das/samples":
        payload = payload or {}
        if "groups" in payload:
            # the multi-height window variant: the legacy
            # single-height body stays exactly as it was
            return core.sample_groups(payload["groups"],
                                      axis=_axis(payload))
        cells = payload.get("cells")
        if not isinstance(cells, list):
            raise SampleError("samples needs a 'cells' list of [row, col]")
        try:
            pairs = [(int(r), int(c)) for r, c in cells]
        except (TypeError, ValueError):
            raise SampleError("each cell must be a [row, col] pair") \
                from None
        return core.sample_many(_int(payload, "height"), pairs,
                                axis=_axis(payload))
    elif method == "POST" and path == "/das/headers":
        payload = payload or {}
        return core.headers_many(payload.get("heights"))
    raise SampleError(f"no DAS route {method} {path}")


class SampleService:
    """Standalone HTTP server for the DAS routes: point it at an App and
    it answers samplers with no consensus process attached (blocks come
    from the durable store)."""

    def __init__(self, core: SampleCore, host: str = "127.0.0.1",
                 port: int = 26660):
        import json
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )
        from urllib.parse import parse_qs, urlparse

        service = self
        self.core = core

        class Handler(BaseHTTPRequestHandler):
            # keep-alive (HTTP/1.1): samplers hold persistent
            # connections; every response sets Content-Length
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_raw(self, code: int, body: bytes) -> None:
                # /das/pack/chunk serves raw bytes (octet-stream, NOT
                # base64) — the static CDN-shaped path
                self.send_response(code)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _route(self, method: str, payload: dict | None) -> None:
                parsed = urlparse(self.path)
                try:
                    out = route_das(service.core, method, parsed.path,
                                    parse_qs(parsed.query), payload)
                    if isinstance(out, bytes):
                        self._send_raw(200, out)
                    else:
                        self._send(200, out)
                except SampleError as e:
                    self._send(404 if "not served" in str(e) else 400,
                               {"error": str(e)})
                except Exception as e:  # never kill the serving thread
                    telemetry.incr("das.server_errors")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def do_GET(self):
                self._route("GET", None)

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send(400, {"error": "body must be JSON"})
                    return
                self._route("POST", payload)

        class Server(ThreadingHTTPServer):
            # sampler fleets connect in bursts; the stdlib default
            # listen backlog of 5 resets most of a burst on arrival
            request_queue_size = 1024

        self._httpd = Server((host, port), Handler)
        self.port = self._httpd.server_address[1]
        # GIL-pressure sampler for this serving plane:
        # gil.pressure{service="das"} in /metrics
        from celestia_app_tpu_torch.obs import gil
        gil.start("das")

    def serve_background(self):
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()
