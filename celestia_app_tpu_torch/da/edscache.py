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

Not ported: the device-resident mesh entry, the background prover warmer
and the residency gauge. Hit, miss and eviction counts are plain attributes
of the cache.
"""

from __future__ import annotations

import collections
import hashlib
import threading

import numpy as np

from celestia_app_tpu_torch.da import codec as codec_mod
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.da import proof_device
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader, ExtendedDataSquare

# At k = 128 one entry holds 33.5 MB of EDS plus 24 MB of row and column
# level arrays once both provers are built; the lifecycle needs the height
# in flight and a short serving tail.
DEFAULT_MAX_ENTRIES = 4
DEFAULT_MAX_BYTES = 1 << 30


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

    def __init__(self, eds: ExtendedDataSquare, dah: DataAvailabilityHeader,
                 data_root: bytes):
        self.eds = eds
        self.dah = dah
        self.data_root = data_root
        # one lock per prover: the two builds are independent
        self._row_lock = threading.Lock()
        self._col_lock = threading.Lock()
        self._prover = None  # guarded-by: _row_lock
        self._col_prover = None  # guarded-by: _col_lock

    @property
    def k(self) -> int:
        return self.eds.width // 2

    def get_prover(self, device=None) -> proof_device.BlockProver:
        """The row-axis BlockProver, built once."""
        with self._row_lock:
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
        with self._col_lock:
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


def compute_entry(ods: np.ndarray, device=None, scheme: str = codec_mod.RS2D_NAME):
    """ODS -> the scheme's entry, computed on `device` (the card unless the
    caller asks for the CPU). The default scheme is one `eds.pipeline` pass,
    its outputs brought to the host; the others go through the registry's
    encode hook (CodecError for a scheme the registry does not carry)."""
    if scheme != codec_mod.RS2D_NAME:
        return codec_mod.get(scheme)._encode_impl(ods, device)
    eds, rows, cols, root = eds_mod.pipeline(ods, device)
    dah = DataAvailabilityHeader(
        row_roots=tuple(bytes(r) for r in rows.cpu().numpy()),
        col_roots=tuple(bytes(c) for c in cols.cpu().numpy()),
    )
    return EdsCacheEntry(ExtendedDataSquare(eds.cpu().numpy()), dah, bytes(root.cpu().numpy()))


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

    def get(self, key: bytes) -> EdsCacheEntry | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
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

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
