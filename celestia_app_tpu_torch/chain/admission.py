"""The admission plane: two-phase tx admission with batched verification.

Port of celestia_app_tpu/chain/admission.py. Every transaction's
secp256k1 signature is checked at CheckTx, in the PrepareProposal ante,
in ProcessProposal on every validator, at delivery, and again on WAL
replay. Phase 1 (this module, stateless) verifies a whole batch of
pending signatures on the card (`ops/secp256k1.verify_batch`, one
dispatch per `MAX_DISPATCH` lanes) and computes the share commitments of
every pending blob in one `da/commitment_device` batch (kernel K1); the
successes fill the App's `VerifiedSigCache` and `VerifiedCommitmentCache`.
Phase 2, the ante (`chain/ante.py`), consults the caches first, so a tx
admitted at CheckTx is never verified again.

The caches are sound by construction: a key is put only after its
signature verified TRUE (or its commitment was computed) over exactly the
bytes the ante would check, so a hit can only skip work that would give
the same answer. `prevalidate` never raises and never rejects: the ante
stays the authority. Its failures are counted in
`admission.prevalidate_errors`; there is no quiet fallback from the card
to the host.

`app` is duck-typed as in the JAX package: `sig_cache`,
`commitment_cache`, `app_version`, `engine` ("device" or "host", for the
commitment half), `chain_id`, `height`, `store`, `_check_state`, and
`auth.account(ctx, addr)` returning ``{"number": ...}`` or None.

Counters (`counters`, the JAX package's telemetry names):
  admission.sig_cache_hits       a check skipped a verify via the cache
  admission.sig_scalar_verified  the ante's scalar verifies (cache
                                 misses, counted by `chain/ante.py`)
  admission.batch_dispatches     device dispatches (lanes / MAX_DISPATCH)
  admission.batch_lanes          signatures sent through the device path
  admission.batch_verified       lanes that verified and were cached
  admission.batch_rejected       lanes that failed batch verification
  admission.prevalidate_below_batch  signature batches too small
  admission.prevalidate_errors   failures inside prevalidation
  admission.sig_cache_evictions  LRU evictions of the sig cache
  commitment.cache_hits          a validation consumed a cached commitment
  commitment.batch_dispatches    prevalidation commitment batches
  commitment.batch_lanes         blobs computed by prevalidation batches
  commitment.prevalidate_below_batch  commitment batches below the gate
  commitment.cache_evictions     LRU evictions of the commitment cache
"""

from __future__ import annotations

import hashlib
import logging
import threading
from collections import OrderedDict

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch.chain import blob_validation
from celestia_app_tpu_torch.chain.crypto import _N, PublicKey
from celestia_app_tpu_torch.chain.state import Context, InfiniteGasMeter
from celestia_app_tpu_torch.chain.tx import decode_tx
from celestia_app_tpu_torch.da import blob as blob_mod
from celestia_app_tpu_torch.ops import secp256k1 as fast

# Below this many uncached signatures (or blobs) the batch is not worth a
# dispatch; the ante's scalar path fills the cache instead. Tests
# monkeypatch it to force either path.
MIN_DEVICE_BATCH = 16
SIG_CACHE_MAX = 65536
COMMITMENT_CACHE_MAX = 16384

log = logging.getLogger(__name__)

counters = dict.fromkeys((
    "admission.sig_cache_hits", "admission.sig_scalar_verified",
    "admission.batch_dispatches", "admission.batch_lanes",
    "admission.batch_verified", "admission.batch_rejected",
    "admission.prevalidate_below_batch", "admission.prevalidate_errors",
    "admission.sig_cache_evictions",
    "commitment.cache_hits", "commitment.batch_dispatches",
    "commitment.batch_lanes", "commitment.prevalidate_below_batch",
    "commitment.cache_evictions",
), 0)


def sig_key(pubkey: bytes, signature: bytes, message: bytes) -> bytes:
    """The cache key: length-framed so no two distinct (pubkey, sig,
    sign-doc) triples can collide by concatenation ambiguity."""
    h = hashlib.sha256()
    for part in (pubkey, signature, message):
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    return h.digest()


class VerifiedSigCache:
    """Bounded LRU set of signature triples that verified TRUE.

    One per App, shared by CheckTx, the proposal paths and replay.
    Entries are state-independent facts (curve math over fixed bytes),
    so the cache survives rollbacks and reloads untouched."""

    def __init__(self, maxsize: int = SIG_CACHE_MAX):
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._keys: OrderedDict[bytes, None] = OrderedDict()  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock

    key = staticmethod(sig_key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    def keys(self) -> list[bytes]:
        """The cached keys, least recently used first."""
        with self._lock:
            return list(self._keys)

    def hit(self, key: bytes) -> bool:
        with self._lock:
            if key in self._keys:
                self._keys.move_to_end(key)
                counters["admission.sig_cache_hits"] += 1
                return True
            return False

    def contains(self, key: bytes) -> bool:
        """Membership probe without the hit counter or LRU refresh:
        prevalidation's dedup uses it, so `admission.sig_cache_hits`
        keeps meaning "a check skipped a verify"."""
        with self._lock:
            return key in self._keys

    def put(self, key: bytes) -> None:
        with self._lock:
            self._keys[key] = None
            self._keys.move_to_end(key)
            while len(self._keys) > self.maxsize:
                self._keys.popitem(last=False)
                self.evictions += 1
                counters["admission.sig_cache_evictions"] += 1


def commitment_key(namespace: bytes, share_version: int, data: bytes,
                   subtree_root_threshold: int) -> bytes:
    """The commitment-cache key: sha256 over the length-framed
    (namespace, share version, blob bytes, threshold) tuple, exactly the
    inputs of `da/commitment.create_commitment`. The integers encode as
    decimal bytes, total over any int, so an adversarial out-of-range
    share version gets a key instead of raising."""
    h = hashlib.sha256()
    for part in (namespace, b"%d" % share_version, data,
                 b"%d" % subtree_root_threshold):
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    return h.digest()


class VerifiedCommitmentCache:
    """Bounded LRU of blob-content keys -> their COMPUTED share commitment
    (32 bytes). Values are pure functions of the key, so a hit can only
    skip a recompute that would give identical bytes; a Byzantine
    mismatch still fails the ante's byte-compare."""

    def __init__(self, maxsize: int = COMMITMENT_CACHE_MAX):
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._map: OrderedDict[bytes, bytes] = OrderedDict()  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock

    key = staticmethod(commitment_key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def items(self) -> list[tuple[bytes, bytes]]:
        """(key, commitment) pairs, least recently used first."""
        with self._lock:
            return list(self._map.items())

    def hit(self, key: bytes) -> bytes | None:
        """The cached commitment, counting the hit, or None on a miss."""
        with self._lock:
            value = self._map.get(key)
            if value is not None:
                self._map.move_to_end(key)
                counters["commitment.cache_hits"] += 1
            return value

    def contains(self, key: bytes) -> bool:
        """Membership probe without the hit counter or LRU refresh."""
        with self._lock:
            return key in self._map

    def put(self, key: bytes, commitment: bytes) -> None:
        with self._lock:
            self._map[key] = commitment
            self._map.move_to_end(key)
            while len(self._map) > self.maxsize:
                self._map.popitem(last=False)
                self.evictions += 1
                counters["commitment.cache_evictions"] += 1


def status_block(app) -> dict:
    """The admission block of the status surfaces: the verified-sig and
    verified-commitment cache economics. Counters are process-wide, the
    cache sizes this App's. The ``txsim`` member keeps the reference's
    shape: the load generator is not ported, so its counters read 0."""
    sig_cache = getattr(app, "sig_cache", None)
    commitment_cache = getattr(app, "commitment_cache", None)
    return {
        "sig_cache_hits": counters["admission.sig_cache_hits"],
        "sig_scalar_verified": counters["admission.sig_scalar_verified"],
        "batch_verified": counters["admission.batch_verified"],
        "batch_rejected": counters["admission.batch_rejected"],
        "sig_cache_size": len(sig_cache) if sig_cache is not None else 0,
        "commitment": {
            "cache_hits": counters["commitment.cache_hits"],
            "recomputes": blob_validation.counters["commitment.recomputes"],
            "batch_dispatches": counters["commitment.batch_dispatches"],
            "batch_lanes": counters["commitment.batch_lanes"],
            "cache_size": (len(commitment_cache)
                           if commitment_cache is not None else 0),
        },
        "txsim": dict.fromkeys(("submitted", "accepted", "confirmed", "rejected",
                                "resyncs", "errors"), 0),
    }


# sentinel for a raw whose BlobTx envelope failed to parse: both phase-1
# halves skip it (the ante rejects it with its own error later)
_UNDECODABLE = object()


def _unmarshal_batch(raws) -> list:
    """One envelope parse per raw, shared by both phase-1 halves. Entries:
    a BlobTx, None (a plain tx), or _UNDECODABLE."""
    out = []
    for raw in raws:
        try:
            out.append(blob_mod.try_unmarshal_blob_tx(raw))
        except ValueError:
            out.append(_UNDECODABLE)
    return out


def extract_blob_items(raws, btxs=None):
    """Every blob of every decodable BlobTx in `raws`, in block order.
    `btxs` optionally supplies the pre-parsed envelopes."""
    if btxs is None:
        btxs = _unmarshal_batch(raws)
    blobs = []
    for btx in btxs:
        if btx is not None and btx is not _UNDECODABLE:
            blobs.extend(btx.blobs)
    return blobs


def prevalidate_commitments(app, raws, btxs=None, device=None) -> int:
    """Phase 1, commitment half: compute the share commitments of every
    pending blob not already in the App's commitment cache in ONE batch
    (`blob_validation.batch_commitments` with the App's engine: K1 on
    `device` for "device"), and cache them. Returns how many blobs were
    computed. Never raises and never rejects: a blob that skips the batch
    meets the ante's per-blob compute later, with identical bytes; a
    failed batch is counted in `admission.prevalidate_errors`."""
    cache = getattr(app, "commitment_cache", None)
    if cache is None or not raws:
        return 0
    threshold = appconsts.subtree_root_threshold(app.app_version)
    pending = []
    keys = []
    seen: set[bytes] = set()
    for blob in extract_blob_items(raws, btxs=btxs):
        try:
            # stateless per-blob gate (share version, namespace, empty
            # data): a malformed blob must not reach the batch, where it
            # would throw the whole window's honest blobs out
            blob.validate()
        except ValueError:
            continue
        key = commitment_key(blob.namespace.raw, blob.share_version,
                             blob.data, threshold)
        if key in seen or cache.contains(key):
            continue
        seen.add(key)
        pending.append(blob)
        keys.append(key)
    if not pending:
        return 0
    if len(pending) < MIN_DEVICE_BATCH:
        counters["commitment.prevalidate_below_batch"] += 1
        return 0
    try:
        commitments = blob_validation.batch_commitments(
            pending, threshold, engine=getattr(app, "engine", "device"), device=device)
    except Exception:
        # the ante's per-blob compute stays authoritative
        counters["admission.prevalidate_errors"] += 1
        log.exception("batch commitment prevalidation failed")
        return 0
    counters["commitment.batch_dispatches"] += 1
    counters["commitment.batch_lanes"] += len(pending)
    for key, commitment in zip(keys, commitments):
        cache.put(key, commitment)
    return len(pending)


def extract_sig_item(app, raw: bytes, store=None, btx=_UNDECODABLE):
    """(pubkey, signature, sign-doc bytes) for one raw tx, or None when
    the tx cannot be prevalidated: undecodable, a policy-rejected
    signature shape (not 64 bytes, or high-S, which `PublicKey.verify`
    refuses before any curve math), or a proto tx whose signer account
    does not exist yet (its sign doc needs the account number). None is
    never an error: the ante verifies those txs on its scalar path.
    `btx` optionally supplies the pre-parsed envelope; the _UNDECODABLE
    default means "parse here"."""
    try:
        if btx is _UNDECODABLE:  # standalone call: parse the envelope
            btx = blob_mod.try_unmarshal_blob_tx(raw)
        tx = decode_tx(btx.tx if btx is not None else raw)
    except ValueError:
        return None
    sig = tx.signature
    if len(sig) != 64 or int.from_bytes(sig[32:], "big") > _N // 2:
        return None
    if getattr(tx, "wire_format", "native") == "proto":
        addr = PublicKey(tx.pubkey).address()
        ctx = Context(
            store if store is not None else app.store,
            InfiniteGasMeter(), app.height, 0,
            app.chain_id, app.app_version,
        )
        acc = app.auth.account(ctx, addr)
        if acc is None:
            return None
        doc = tx.sign_doc(app.chain_id, acc["number"])
    else:
        doc = tx.sign_doc()
    return (tx.pubkey, sig, doc)


def prevalidate(app, raws, *, check_state: bool = False,
                commitments: bool = True, device=None) -> int:
    """Phase 1: verify the signatures of `raws` that are not already in
    the App's sig cache on `device` (the card unless the caller asks for
    the CPU), one dispatch per MAX_DISPATCH lanes, and cache the
    successes; and compute the share commitments of their uncached blobs
    the same way (prevalidate_commitments). Returns how many signature
    lanes verified. Never raises and never rejects: a tx that fails (or
    skips) the batch meets the ante's scalar verify later, with identical
    semantics. A failure is counted in `admission.prevalidate_errors`.

    ``commitments=False`` skips the commitment half (ProcessProposal
    resolves commitments through the cache itself; WAL replay validates
    none)."""
    if not raws:
        return 0
    btxs = _unmarshal_batch(raws)  # ONE envelope parse per raw, both halves
    # the commitment half first, in its own try: a failure of one half
    # must not cost the other
    if commitments:
        try:
            prevalidate_commitments(app, raws, btxs=btxs, device=device)
        except Exception:
            counters["admission.prevalidate_errors"] += 1
            log.exception("commitment prevalidation failed")
    cache = getattr(app, "sig_cache", None)
    if cache is None:
        return 0
    store = None
    if check_state:
        # single read: a concurrent commit nulls app._check_state, and a
        # torn two-read would hand Context a None store. A stale branch is
        # harmless: the cache only stores state-independent facts.
        store = app._check_state
        if store is None:
            store = app.store
    items: list[tuple[bytes, bytes, bytes]] = []
    keys: list[bytes] = []
    seen: set[bytes] = set()
    for raw, btx in zip(raws, btxs):
        if btx is _UNDECODABLE:
            continue  # malformed envelope: the ante rejects it itself
        try:
            item = extract_sig_item(app, raw, store=store, btx=btx)
        except Exception:
            # prevalidation never raises (callers may run it outside the
            # service lock, racing commits)
            counters["admission.prevalidate_errors"] += 1
            item = None
        if item is None:
            continue
        key = sig_key(*item)
        if key in seen or cache.contains(key):
            continue
        seen.add(key)
        items.append(item)
        keys.append(key)
    if not items:
        return 0
    if len(items) < MIN_DEVICE_BATCH:
        counters["admission.prevalidate_below_batch"] += 1
        return 0
    try:
        mask = fast.verify_batch(items, device=device)
    except Exception:
        # the ante's scalar verify stays authoritative
        counters["admission.prevalidate_errors"] += 1
        log.exception("batch signature prevalidation failed")
        return 0
    counters["admission.batch_dispatches"] += -(-len(items) // fast.MAX_DISPATCH)
    counters["admission.batch_lanes"] += len(items)
    verified = 0
    for ok, key in zip(mask, keys):
        if bool(ok):
            cache.put(key)
            verified += 1
        else:
            counters["admission.batch_rejected"] += 1
    counters["admission.batch_verified"] += verified
    return verified
