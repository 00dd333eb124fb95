"""The block cache: a content-addressed LRU of extended squares and their
lazily built provers.

Port of the rs2d-nmt core of celestia_app_tpu/da/edscache.py. A node needs
a block's extension at PrepareProposal, at ProcessProposal, and again when
light clients sample it; the cache makes that one encode per square.

- **Content addressing.** Entries are keyed by ``sha256(ODS share bytes)``,
  a pure function of the square, never of a height or of a header field a
  peer claimed: the cached value is a function of the key, so a Byzantine
  header cannot poison the cache.
- **One encode.** `compute_entry` is one `da/eds.pipeline` pass on the
  device (kernels K1 and K2) with the square, the DAH and the data root
  brought back to the host. The other codec schemes (cmt-ldpc,
  pcmt-polar) dispatch through the registry's encode hook and cache their
  own entry types under keys prefixed with the scheme's name.
- **Lazy provers.** Each entry builds its row prover and its column prover
  (a row prover over the transposed square) at most once, on demand, each
  under its own lock, so concurrent samplers of a fresh entry pay one level
  pass between them and a row-proof reader never waits on a column build.

- **Device-resident entries.** `DeviceEntry` (built by the batched
  dispatch, parallel/mesh_engine.compute_entries_batched, and by the mesh
  engine, mesh_engine.compute_entry_mesh) keeps the extended square and,
  once warmed, both orientations' NMT levels on the card; host bytes come
  down lazily, only when a proof needs them, and every such crossing
  counts (`crossings()`). `compute_entry` returns a host `EdsCacheEntry`
  on one device, as the reference's single-device path does, and a
  `DeviceEntry` when the square goes through a mesh (``mesh=``).

- **Background warmup.** `ProverWarmer` is the single coalescing worker
  thread ``App.commit`` hands each committed entry to: it builds the
  entry's provers (a device entry: its level passes, kernel K1) off the
  commit path and hands the entry to the registered listeners.
  `ProverWarmer.wait_idle` joins it, so launch counts and timings read
  after it include the warm's work and nothing later.

Telemetry (the reference's names): ``da.extend_runs``,
``edscache.{hits,misses,evictions}``, ``edscache.warm_coalesced``,
``edscache.warm_errors``, ``edscache.seed_errors``,
``edscache.host_crossings[.eds|.levels|.col_levels]`` and the scrape-time
gauge ``edscache.resident_entries{state=host|device|device+host}``. The
cache's own counts are also plain attributes of it (``hits``, ``misses``,
``evictions``): the registry is process-wide, and a process may hold a
proposer's cache and a follower's. Every host↔card copy goes through the
transfer ledger (obs/xfer.py).
"""

from __future__ import annotations

import collections
import hashlib
import threading
import weakref

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch import obs
from celestia_app_tpu_torch.da import codec as codec_mod
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.da import proof_device
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader, ExtendedDataSquare
from celestia_app_tpu_torch.obs import device_profile, xfer
from celestia_app_tpu_torch.utils import telemetry

# At k = 128 one entry holds 33.5 MB of EDS plus 24 MB of row and column
# level arrays once both provers are built; the lifecycle needs the height
# in flight and a short serving tail.
DEFAULT_MAX_ENTRIES = 4
DEFAULT_MAX_BYTES = 1 << 30

# device -> host copies of DeviceEntry arrays, in all and by what crossed
# (telemetry counters ``edscache.<name>``)
CROSSINGS = ("host_crossings", "host_crossings.eds", "host_crossings.levels", "host_crossings.col_levels")


def crossings() -> dict[str, int]:
    """The process's DeviceEntry crossings so far, by the names of CROSSINGS."""
    counts = telemetry.snapshot()["counters"]
    return {name: counts.get(f"edscache.{name}", 0) for name in CROSSINGS}


def entry_nbytes(entry) -> int:
    """Conservative byte charge of one entry: its own ``nbytes()`` where its
    type has one, else the (2k)^2 x 512 B EDS, doubled for the row and
    column level arrays a warmed entry holds."""
    own = getattr(entry, "nbytes", None)
    if callable(own):
        return int(own())
    two_k = 2 * entry.k
    return two_k * two_k * 512 * 2


def cache_key(ods: np.ndarray, scheme: str = codec_mod.RS2D_NAME) -> bytes:
    """Content address of an original data square: sha256 over its share
    bytes in row-major order. Shares are 512 B and there are k^2 of them, so
    the bytes fix the geometry: two squares collide iff they are equal. The
    other schemes prefix their name and a zero byte, so one square under
    two schemes takes two entries and the default's keys stay as they were."""
    h = hashlib.sha256()
    if scheme != codec_mod.RS2D_NAME:
        h.update(scheme.encode() + b"\x00")
    h.update(np.ascontiguousarray(ods).data)
    return h.digest()


def build_block_prover(eds: ExtendedDataSquare, dah: DataAvailabilityHeader,
                       levels=None, device=None) -> proof_device.BlockProver:
    """A BlockProver: from precomputed `levels` when given, else from one
    level pass on `device` (the card unless the caller asks for the CPU)."""
    return proof_device.BlockProver(eds, dah, levels=levels, device=device)


class EdsCacheEntry:
    """One cached extension, ``(eds, dah, data_root)``, and its lazily built
    provers. The extension fields do not change after construction."""

    scheme = codec_mod.RS2D_NAME

    def __init__(self, eds: ExtendedDataSquare | None, dah: DataAvailabilityHeader,
                 data_root: bytes):
        self._eds = eds
        self.dah = dah
        self.data_root = data_root
        # one lock per prover: the two builds are independent
        self._row_lock = threading.Lock()
        self._col_lock = threading.Lock()
        self._prover = None  # guarded-by: _row_lock
        self._col_prover = None  # guarded-by: _col_lock

    @property
    def eds(self) -> ExtendedDataSquare:
        return self._eds

    def residency(self) -> str:
        """Where the square's bytes live: "host" for this entry; a device
        entry reports "device" until a proof brings them down."""
        return "host"

    @property
    def k(self) -> int:
        return self.eds.width // 2

    def get_prover(self, device=None) -> proof_device.BlockProver:
        """The row-axis BlockProver, built once."""
        # the build-once lock EXISTS to serialize this first build (a
        # kernel build at a process's first launch included); samplers
        # queue here instead of rebuilding
        with self._row_lock:  # lint: disable=blocking-under-lock
            if self._prover is None:
                self._prover = build_block_prover(self.eds, self.dah, device=device)
            return self._prover

    def _transposed_square(self) -> tuple[ExtendedDataSquare, DataAvailabilityHeader]:
        """(eds_t, dah_t): the transposed square, whose ROW trees are this
        square's column trees. The leaf-namespace rule is transpose-invariant
        (parity iff outside Q0), so a column prover is a row prover over this
        pair. The square is a strided view, not a copy: the level pass makes
        it contiguous on the device, and proofs read single cells."""
        eds_t = ExtendedDataSquare(np.swapaxes(self.eds.squares, 0, 1))
        return eds_t, DataAvailabilityHeader(row_roots=self.dah.col_roots,
                                             col_roots=self.dah.row_roots)

    def get_col_prover(self, device=None) -> proof_device.BlockProver:
        """The column-axis prover (fraud-proof serving), built once."""
        with self._col_lock:  # lint: disable=blocking-under-lock
            if self._col_prover is None:
                eds_t, dah_t = self._transposed_square()
                self._col_prover = build_block_prover(eds_t, dah_t, device=device)
            return self._col_prover

    def warm(self, device=None) -> None:
        """Build both provers ahead of demand."""
        self.get_prover(device)
        self.get_col_prover(device)

    def warmed(self) -> bool:
        # fixed order (row, then col); nothing nests the two the other way
        with self._row_lock:
            row_ready = self._prover is not None
        with self._col_lock:
            return row_ready and self._col_prover is not None


class DeviceEntry(EdsCacheEntry):
    """An rs2d-nmt entry whose big arrays stay on the card: the port of
    celestia_app_tpu/da/edscache.py:DeviceEntry (one card).

    Construction takes the device EDS (2k, 2k, 512) and the HOST
    commitments (the axis roots and data root every protocol phase
    compares; 4k x 90 B, not worth keeping remote). Then:

    - ``warm()`` runs the row and the column level pass on the card
      (kernel K1; the column orientation is the square transposed on the
      card) and keeps both there: nothing crosses to the host.
    - ``.eds`` and the provers bring host bytes down lazily, when a proof
      needs them: the square once, and each orientation's levels once, as
      its prover is built. Each copy counts ``edscache.host_crossings``
      and ``edscache.host_crossings.<what>``.

    One lock per lazily built resource (host EDS, row levels, column
    levels), so a reader fetching the square never waits on a level pass.
    Lock order: a prover lock (inherited) may take a resource lock inside
    it; the resource locks never nest with each other."""

    def __init__(self, eds_dev: torch.Tensor, dah: DataAvailabilityHeader, data_root: bytes):
        super().__init__(None, dah, data_root)
        self._eds_dev = eds_dev
        self._eds_lock = threading.Lock()
        self._levels_lock = threading.Lock()
        self._col_levels_lock = threading.Lock()
        self._levels_dev = None  # guarded-by: _levels_lock
        self._col_levels_dev = None  # guarded-by: _col_levels_lock

    @property
    def k(self) -> int:
        return self._eds_dev.shape[0] // 2

    @property
    def device(self) -> torch.device:
        return self._eds_dev.device

    def residency(self) -> str:
        # lock-free on purpose: _eds only ever goes None -> set
        return "device+host" if self._eds is not None else "device"

    @staticmethod
    def _crossing(what: str) -> None:
        telemetry.incr("edscache.host_crossings")
        telemetry.incr(f"edscache.host_crossings.{what}")

    @property
    def eds(self) -> ExtendedDataSquare:
        """Host square bytes, brought down on first need (one counted
        crossing; later reads are free)."""
        with self._eds_lock:
            if self._eds is None:
                self._eds = ExtendedDataSquare(xfer.to_host(self._eds_dev, "edscache.eds"))
                self._crossing("eds")
            return self._eds

    def device_levels(self, col: bool = False):
        """The NMT levels of one orientation on the card, computed at most
        once under that orientation's own lock."""
        if col:
            with self._col_levels_lock:  # lint: disable=blocking-under-lock
                if self._col_levels_dev is None:
                    self._col_levels_dev = proof_device.row_levels(self._eds_dev.transpose(0, 1),
                                                                   self.device)
                return self._col_levels_dev
        with self._levels_lock:  # lint: disable=blocking-under-lock
            if self._levels_dev is None:
                self._levels_dev = proof_device.row_levels(self._eds_dev, self.device)
            return self._levels_dev

    def leaf_namespaces(self) -> torch.Tensor:
        """(k^2, 29) on the card: every Q0 share's namespace, row-major,
        read off the resident row levels' leaf ``mins`` (a leaf's min is
        its namespace). Nothing crosses."""
        k = self.k
        return self.device_levels()[0][0][:k, :k].reshape(k * k, -1)

    def _host_levels(self, col: bool):
        levels = proof_device.levels_to_host(self.device_levels(col))
        self._crossing("col_levels" if col else "levels")
        return levels

    def warm(self, device=None) -> None:
        """Both orientations' level passes on the card; provers stay lazy,
        so a warmed entry that nobody samples never crosses to the host."""
        self.device_levels(col=False)
        self.device_levels(col=True)

    def warmed(self) -> bool:
        # fixed order (row, then col), as the base class's warmed()
        with self._levels_lock:
            row_ready = self._levels_dev is not None
        with self._col_levels_lock:
            return row_ready and self._col_levels_dev is not None

    def get_prover(self, device=None) -> proof_device.BlockProver:
        """The row prover over the host square and the downloaded row
        levels: one `eds` and one `levels` crossing the first time."""
        with self._row_lock:  # lint: disable=blocking-under-lock
            if self._prover is None:
                self._prover = build_block_prover(self.eds, self.dah, levels=self._host_levels(col=False))
            return self._prover

    def get_col_prover(self, device=None) -> proof_device.BlockProver:
        with self._col_lock:  # lint: disable=blocking-under-lock
            if self._col_prover is None:
                eds_t, dah_t = self._transposed_square()
                self._col_prover = build_block_prover(eds_t, dah_t, levels=self._host_levels(col=True))
            return self._col_prover


def compute_entry(ods: np.ndarray, device=None, scheme: str = codec_mod.RS2D_NAME, mesh=None):
    """ODS -> the scheme's entry, computed on `device` (the card unless the
    caller asks for the CPU). The default scheme is one `eds.pipeline` pass,
    its outputs brought to the host; the others go through the registry's
    encode hook (CodecError for a scheme the registry does not carry) and
    ignore `mesh`.

    `mesh` (a parallel/mesh.Mesh) is the reference's ``engine="mesh"``:
    every square its devices can shard goes through the sharded pipeline
    and comes back as a `DeviceEntry`. ``mesh=None`` is the reference's
    auto rule: squares of k >= mesh_engine.DEFAULT_MESH_MIN_K on a card
    take the mesh when two or more cards are visible. A square the mesh
    cannot shard (k = 1) takes the one-device path; a mesh failure
    raises. While a profiler records, the rs2d path sits in an
    ``edscache.compute_entry`` range and the host's DAH and entry in an
    ``entry.assemble`` one (obs/spans.stage)."""
    if scheme != codec_mod.RS2D_NAME:
        codec = codec_mod.get(scheme)  # CodecError before the counter moves
        telemetry.incr("da.extend_runs")
        return codec._encode_impl(ods, device)
    telemetry.incr("da.extend_runs")
    with obs.stage("edscache.compute_entry"):
        dev = device_mod.resolve(device) if mesh is None else mesh.lead
        from celestia_app_tpu_torch.parallel import mesh_engine

        if mesh_engine.mesh_active_for(int(ods.shape[0]), mesh, dev):
            return mesh_engine.compute_entry_mesh(ods, mesh)
        eds, rows, cols, root = device_profile.instrument(
            "eds.pipeline", lambda: eds_mod.pipeline(ods, dev), key=int(ods.shape[0]), device=dev)
        eds_h, rows_h, cols_h, root_h = xfer.to_host((eds, rows, cols, root), "edscache.compute_entry")
        with obs.stage("entry.assemble"):
            dah = DataAvailabilityHeader(
                row_roots=tuple(bytes(r) for r in rows_h),
                col_roots=tuple(bytes(c) for c in cols_h),
            )
            return EdsCacheEntry(ExtendedDataSquare(eds_h), dah, bytes(root_h))


class EdsCache:
    """Bounded, thread-safe, content-addressed LRU of EdsCacheEntry.

    A second index maps ``data_root -> key``, so a commit path that holds a
    header (data_hash) rather than a square finds the entry. The data root
    is itself a function of the ODS bytes the key hashes, so two squares
    share a root only through a sha256 collision.

    Eviction runs while EITHER the entry count or the charged bytes
    (`entry_nbytes`) exceed their cap, and always keeps the newest entry,
    the height in flight, even when it alone exceeds the byte cap."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict[bytes, EdsCacheEntry] = \
            collections.OrderedDict()  # guarded-by: _lock
        self._by_root: dict[bytes, bytes] = {}  # guarded-by: _lock
        self._nbytes = 0  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        _caches.add(self)  # the residency gauge's collector walks live caches

    def get(self, key: bytes) -> EdsCacheEntry | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                telemetry.incr("edscache.misses")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            telemetry.incr("edscache.hits")
            return entry

    def put(self, key: bytes, entry: EdsCacheEntry) -> EdsCacheEntry:
        """Insert, idempotently: an earlier insert of the key wins, so every
        caller holds the SAME object and no prover is built twice. Returns
        the resident entry."""
        with self._lock:
            kept = self._entries.get(key)
            if kept is None:
                self._entries[key] = kept = entry
                self._by_root[entry.data_root] = key
                self._nbytes += entry_nbytes(entry)
            self._entries.move_to_end(key)
            while len(self._entries) > 1 and (
                    len(self._entries) > self.max_entries or self._nbytes > self.max_bytes):
                _, old = self._entries.popitem(last=False)
                self._by_root.pop(old.data_root, None)
                self._nbytes -= entry_nbytes(old)
                self.evictions += 1
                telemetry.incr("edscache.evictions")
            return kept

    def lookup_root(self, data_root: bytes) -> EdsCacheEntry | None:
        """Lookup by a header's data root. Counts no hit or miss: it is
        bookkeeping, not a serving path."""
        with self._lock:
            key = self._by_root.get(data_root)
            if key is None:
                return None
            self._entries.move_to_end(key)
            return self._entries[key]

    def get_or_compute(self, ods: np.ndarray, device=None, scheme: str = codec_mod.RS2D_NAME):
        """One encode per (scheme, square content), ever (while it stays
        resident)."""
        key = cache_key(ods, scheme)
        entry = self.get(key)
        if entry is not None:
            return entry
        return self.put(key, compute_entry(ods, device, scheme))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_root.clear()
            self._nbytes = 0

    def nbytes(self) -> int:
        """Charged bytes of the resident entries (see entry_nbytes)."""
        with self._lock:
            return self._nbytes

    def residency_counts(self) -> dict[str, int]:
        """Resident entries by ``residency()`` state: the source of the
        ``edscache.resident_entries{state=…}`` gauges."""
        with self._lock:
            entries = list(self._entries.values())
        counts = {"host": 0, "device": 0, "device+host": 0}
        for entry in entries:
            state = entry.residency() if hasattr(entry, "residency") else "host"
            counts[state] = counts.get(state, 0) + 1
        return counts

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# Scrape-time residency gauges over every live cache (weakly held: a
# dropped cache stops being counted), registered once at import.
_caches: "weakref.WeakSet[EdsCache]" = weakref.WeakSet()


def _residency_collector() -> None:
    counts = {"host": 0, "device": 0, "device+host": 0}
    for cache in list(_caches):
        for state, n in cache.residency_counts().items():
            counts[state] = counts.get(state, 0) + n
    for state, n in sorted(counts.items()):
        telemetry.gauge("edscache.resident_entries", n, labels={"state": state})


telemetry.register_collector(_residency_collector)


class ProverWarmer:
    """Single coalescing background warmup worker.

    ``schedule`` replaces the pending slot (only the NEWEST commit
    matters; a superseded slot counts ``edscache.warm_coalesced``) and
    starts a worker thread if none is running. The worker warms the
    entry on `device` and hands it to every listener, holding no caller
    lock, then builds the height's proof pack and blob pack when the App
    gave it stores (das/packs.py, das/blob_packs.py), and exits when the
    slot drains, so an idle process carries no thread. On a card the worker selects that card before it launches:
    its launches go to the same default stream as the main thread's, so
    they serialise with the next block's work and the results stay
    right, but launch counts and timings read before `wait_idle` may
    miss the warm's share."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending = None  # guarded-by: _lock
        self._worker_alive = False  # guarded-by: _lock
        self._idle = threading.Event()
        self._idle.set()

    def schedule(self, height: int, entry, listeners=(), device=None, traces=None,
                 chain_id: str = "", pack_store=None, blob_pack_store=None) -> None:
        with self._lock:
            if self._pending is not None:
                telemetry.incr("edscache.warm_coalesced")
            self._pending = (height, entry, tuple(listeners), device, traces, chain_id,
                             pack_store, blob_pack_store)
            self._idle.clear()
            if not self._worker_alive:
                self._worker_alive = True
                threading.Thread(target=self._run, daemon=True, name="edscache-warmer").start()

    def _run(self) -> None:
        while True:
            with self._lock:
                item, self._pending = self._pending, None
                if item is None:
                    self._worker_alive = False
                    self._idle.set()
                    return
            (height, entry, listeners, device, traces, chain_id,
             pack_store, blob_pack_store) = item
            log = obs.get_logger("da.edscache")
            try:
                dev = device_mod.resolve(device)
                if dev.type == "cuda":
                    torch.cuda.set_device(device_mod.concrete(dev))
                with obs.span("da.prover_warm", traces=traces,
                              trace_id=obs.trace_id_for(chain_id, height),
                              height=height, k=entry.k, device=str(dev), scheme=entry.scheme):
                    entry.warm(dev)
            except Exception as e:
                # warmup is an optimisation: never fatal, always visible
                telemetry.incr("edscache.warm_errors")
                log.error("prover warmup failed", height=height, err=e)
                continue  # an unwarmable entry is not seeded
            for listener in listeners:
                try:
                    listener(height, entry)
                except Exception as e:
                    telemetry.incr("edscache.seed_errors")
                    log.error("seed listener failed", height=height,
                              listener=getattr(listener, "__qualname__", str(listener)), err=e)
            # the static packs: the provers are built, so a pack is index
            # arithmetic + JSON + fsync. Packs are an optimisation: a
            # failure is counted and logged, and serving falls back to
            # live assembly.
            for store, name in ((pack_store, "packs"), (blob_pack_store, "blobpacks")):
                if store is None:
                    continue
                try:
                    with obs.span(f"{name}.build", traces=traces,
                                  trace_id=obs.trace_id_for(chain_id, height),
                                  height=height, scheme=entry.scheme):
                        store.build(height, entry, device=dev)
                except Exception as e:
                    telemetry.incr(f"{name}.build_errors")
                    log.error(f"{name} build failed", height=height, err=e)

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no warm work is pending or running. True when idle
        (False: `timeout` seconds passed first)."""
        return self._idle.wait(timeout)
