"""Stateless DA-core service: the boundary a FOREIGN node calls.

This is the SURVEY §7.1.7 shim surface — the framework's stated reason
to exist as a drop-in accelerator. A Go node (or any language) keeps its
own square builder and consensus, swaps the body of `da.ExtendShares` +
`NewDataAvailabilityHeader` (reference
``pkg/da/data_availability_header.go:44-75``, called from
``app/extend_block.go:14-26``) for one RPC here, and uses the returned
DAH verbatim:

  ExtendAndCommit  ODS shares in -> row roots + column roots + data root
                   (the erasure extension and every NMT/Merkle hash run
                   on this side — on the card, or through the kernels'
                   plain versions when the service runs on the CPU).
  ProveShares      share range in -> ShareProof against the data root
                   (``pkg/proof`` ProveShares analog), served from the
                   bounded cache of recently extended squares (keyed by
                   data root) or from a caller-supplied ODS.

Callers: the node HTTP service mounts these under ``/da/*``
(service/server.py), the standalone ``da-serve`` CLI serves them with no
chain attached (the sidecar deployment shape), the gRPC plane exposes
them as ``celestia_tpu.da.v1.DAService`` (proto/celestia_tpu/da/v1/
da.proto), ``shim/go`` holds the Go-side drop-in source, and
``native/da_client.cc`` drives the HTTP route end-to-end from C++ with
an independent local recompute (byte-identity check).

Port of celestia_app_tpu/service/da_service.py: the same routes, payloads
and errors. ``DACore(device=...)`` replaces ``engine=``: the extension and
every NMT and Merkle hash run on the device (kernels K2 and K1 on the
card, their plain versions on ``device="cpu"``); there is no host engine.
A square is also found again by its content (the ODS digest,
``edscache.cache_key``), so a repeated ExtendAndCommit of the same ODS
answers from the cache with no launch; the reference recomputes it.
"""

from __future__ import annotations

import base64
import collections
import threading

import numpy as np

from celestia_app_tpu_torch import appconsts
from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.utils import telemetry


class DAError(ValueError):
    pass


class DACore:
    """Extend/commit/prove on one device with a bounded square cache.

    `device` is where the pipeline runs (the card unless the caller asks
    for the CPU): one ``eds.pipeline`` per new square, whose results come
    to the host through the transfer ledger (``obs.xfer.ensure_host``).
    Proof construction is host-side (tree traversal, not FLOPs)."""

    def __init__(self, device=None, cache_squares: int = 4):
        self.device = device_mod.resolve(device)
        self._cache: collections.OrderedDict[str, tuple] = \
            collections.OrderedDict()
        # ODS digest -> data root hex of a cached square
        self._by_ods: dict[bytes, str] = {}  # guarded-by: _lock
        self._cache_squares = cache_squares
        self._lock = threading.Lock()

    # -- core ------------------------------------------------------------

    def _pipeline(self, ods: np.ndarray):
        """(eds_obj, dah, data_root) for an ODS array."""
        from celestia_app_tpu_torch.da import dah as dah_mod
        from celestia_app_tpu_torch.da import eds as eds_mod
        from celestia_app_tpu_torch.obs import xfer

        eds, rows, cols, root = (
            xfer.ensure_host(t, "da_service.extend_commit")
            for t in eds_mod.pipeline(ods, self.device))
        dah = dah_mod.DataAvailabilityHeader(
            row_roots=tuple(bytes(r) for r in rows),
            col_roots=tuple(bytes(r) for r in cols),
        )
        return dah_mod.ExtendedDataSquare(eds), dah, bytes(root)

    def _decode_ods(self, payload: dict) -> np.ndarray:
        from celestia_app_tpu_torch.da import dah as dah_mod

        raw = payload["ods"]
        if isinstance(raw, str):  # JSON transport; gRPC hands raw bytes
            raw = base64.b64decode(raw)
        if len(raw) % appconsts.SHARE_SIZE:
            raise DAError(
                f"ods byte length {len(raw)} is not a multiple of the "
                f"{appconsts.SHARE_SIZE}-byte share size"
            )
        n = len(raw) // appconsts.SHARE_SIZE
        k = int(n ** 0.5)
        if k * k != n or k & (k - 1) or not n:
            raise DAError(
                f"share count {n} is not a power-of-two perfect square"
            )
        # protocol cap is 128 (appconsts.square_size_upper_bound); allow
        # 2x headroom for benchmark-scale squares
        cap = 2 * appconsts.square_size_upper_bound(
            appconsts.LATEST_VERSION)
        if k > cap:
            raise DAError(f"square size {k} exceeds the service cap {cap}")
        want = payload.get("square_size")
        if want is not None and int(want) != k:
            raise DAError(
                f"square_size {want} does not match the {k}x{k} ods"
            )
        return dah_mod.shares_to_ods(
            [raw[i * appconsts.SHARE_SIZE:(i + 1) * appconsts.SHARE_SIZE]
             for i in range(n)]
        )

    def extend_and_commit(self, payload: dict) -> dict:
        """ODS in -> DAH out; the extended square is cached by data root
        so a follow-up ProveShares costs tree traversal only, and by ODS
        digest so a repeat costs no device work."""
        from celestia_app_tpu_torch.da import edscache

        ods = self._decode_ods(payload)
        digest = edscache.cache_key(ods)
        with self._lock:
            key = self._by_ods.get(digest)
            hit = self._cache.get(key) if key is not None else None
        if hit is not None:
            eds, dah, root = hit[0], hit[1], bytes.fromhex(key)
        else:
            eds, dah, root = self._pipeline(ods)
        key = root.hex()
        with self._lock:
            self._cache[key] = (eds, dah, digest)
            self._by_ods[digest] = key
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_squares:
                old_key, (_eds, _dah, old_digest) = self._cache.popitem(last=False)
                if self._by_ods.get(old_digest) == old_key:
                    del self._by_ods[old_digest]
        return {
            "square_size": int(ods.shape[0]),
            "row_roots": [r.hex() for r in dah.row_roots],
            "col_roots": [r.hex() for r in dah.col_roots],
            "data_root": key,
        }

    def prove_shares(self, payload: dict) -> dict:
        """Share-range proof. Source square: ``data_root`` (hex, from the
        cache of recent ExtendAndCommit results) or a fresh ``ods``.
        Every malformed input raises DAError (transports map it to a
        client error, never a 500)."""
        from celestia_app_tpu_torch.chain.query import _share_proof_json
        from celestia_app_tpu_torch.da import proof as proof_mod

        want_root = payload.get("data_root")
        if want_root is not None:
            with self._lock:
                hit = self._cache.get(want_root)
                if hit is not None:
                    self._cache.move_to_end(want_root)
            if hit is None:
                raise DAError(
                    f"no cached square for data root {want_root}; resend "
                    "the ods or re-run extend_commit"
                )
            eds, dah, _digest = hit
            root = bytes.fromhex(want_root)
        elif "ods" in payload:
            eds, dah, root = self._pipeline(self._decode_ods(payload))
        else:
            raise DAError("prove_shares needs data_root or ods")

        try:
            start, end = int(payload["start"]), int(payload["end"])
        except (KeyError, TypeError, ValueError):
            raise DAError("prove_shares needs integer start and end") \
                from None
        k = eds.width // 2
        if not (0 <= start < end <= k * k):
            raise DAError(
                f"invalid share range [{start}, {end}) for a {k}x{k} square"
            )
        # namespace parsing + extraction live on the read plane's shared
        # helpers (da/namespace_device.py) — one codec for every caller
        from celestia_app_tpu_torch.da import namespace_device as nsdev

        try:
            namespace = nsdev.decode_namespace(payload.get("namespace", ""))
        except ValueError:
            raise DAError("namespace must be hex") from None
        if not namespace:
            namespace = nsdev.share_namespace(eds.squares[start // k,
                                                          start % k])
        pf = proof_mod.new_share_inclusion_proof(eds, dah, start, end,
                                                 namespace)
        return {
            "proof": _share_proof_json(pf),
            "data_root": root.hex(),
        }

    # -- one dispatcher shared by every transport ------------------------

    def handle(self, path: str, payload: dict) -> dict:
        try:
            if path == "/da/extend_commit":
                return self.extend_and_commit(payload)
            if path == "/da/prove_shares":
                return self.prove_shares(payload)
        except KeyError as e:  # missing request field = client error
            raise DAError(f"missing field {e}") from None
        raise DAError(f"no DA route {path}")


class DAService:
    """Standalone HTTP server for the two DA routes — the sidecar shape:
    run it next to a foreign node, point the shim at it, no chain state
    anywhere in the process."""

    def __init__(self, core: DACore, host: str = "127.0.0.1",
                 port: int = 26659):
        import json
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )

        service = self
        self.core = core

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    out = service.core.handle(self.path, payload)
                    code = 200
                except DAError as e:
                    out, code = {"error": str(e)}, 400
                except Exception as e:  # never kill the serving thread
                    telemetry.incr("http.500")
                    out, code = {"error": f"{type(e).__name__}: {e}"}, 500
                body = json.dumps(out).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/status":
                    body = json.dumps({
                        "service": "da",
                        "device": str(service.core.device),
                    }).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]

    def serve_background(self):
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def shutdown(self):
        self._httpd.shutdown()
