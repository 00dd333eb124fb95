"""HTTP JSON service over an in-process node: the out-of-process boundary.

Reference parity: the reference node exposes gRPC + RPC endpoints (tx
broadcast, ABCI queries incl. the custom proof routes at app/app.go:393-394,
block fetch). grpcio is not available in this environment, so the service
speaks JSON over HTTP/1.1 via the stdlib ThreadingHTTPServer — same routes,
same payloads as chain/query.py. A Go (or any-language) host process can
drive ExtendAndCommit/ProveShares through these endpoints, which is the
SURVEY §7.1.7 shim boundary.

Endpoints:
  GET  /status                         chain identity + telemetry
  GET  /block/<height>                 stored block (header + b64 txs)
  POST /broadcast_tx   {"tx": b64}     CheckTx + mempool admission
  POST /simulate_tx    {"tx": b64}     dry-run gas estimation (Simulate rpc)
  POST /produce_block  {"time": t?}    devnet convenience: one round
  POST /abci_query     {"path": ..., "data": {...}}
  POST /da/extend_commit {"ods": b64}  stateless DA core: ODS -> DAH
  POST /da/prove_shares  {...}         share-range proof (§7.1.7 shim)
  GET  /das/head | /das/header | /das/sample | /das/availability
  POST /das/samples                    DAS sample serving (das/server.py)
  GET  /sync/snapshots                 state-sync manifests, newest first
  GET  /sync/chunk?height=&index=      raw snapshot chunk bytes (§15)
  GET  /faults                         fault-plane admin (armed + fired)
  POST /faults/arm|disarm|reset        arm/disarm fault points (chaos)
  GET  /metrics                        Prometheus text exposition (§10)
  GET  /trace/<table>?since=&limit=    columnar trace pull (spans incl.)
  POST /debug/profile {seconds, dir?}  on-demand torch.profiler capture
  POST /ibc/prove | /ibc/ack | /ibc/client_height | /ibc/header | /ibc/events

Every request's X-Celestia-Trace header (if any) is installed as the
incoming span context, so serve-side spans join the caller's trace
(obs/spans.py; docs/FORMATS.md §10).

Port of celestia_app_tpu/service/server.py: every route, JSON body and
status code is the reference's, so a light node or a rollup of either
package talks to either service. The DA shim (``DACore``), the DAS and
blob serving cores and the query router all run on the App's device (the
card unless the App was built for the CPU); the reference picks a host
engine when its App has no device one.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from celestia_app_tpu_torch import cuda_build, obs
from celestia_app_tpu_torch.chain.query import QueryError, QueryRouter
from celestia_app_tpu_torch.utils import telemetry


class NodeService:
    def __init__(self, node, host: str = "127.0.0.1", port: int = 26658):
        self.node = node
        self.router = QueryRouter(node.app)
        self.lock = threading.Lock()  # node state is single-writer
        # the stateless DA-core shim surface (§7.1.7): /da/extend_commit
        # + /da/prove_shares for foreign callers, on the App's device
        from celestia_app_tpu_torch.service.da_service import DACore

        self.da_core = DACore(device=node.app.device)
        # the DAS sample-serving plane (das/server.py): committed blocks
        # answered cell-by-cell with NMT proofs from cached row trees.
        # Shares this service's writer lock for square rebuilds (callers
        # that swap self.lock must swap das_core.app_lock with it).
        from celestia_app_tpu_torch.das.server import SampleCore

        self.das_core = SampleCore(node.app, app_lock=self.lock)
        # the read plane (das/blob_server.py): batched namespace reads
        # + blob-pack static serving over the SAME entry cache, so the
        # two planes share one single-flight build per height
        from celestia_app_tpu_torch.das.blob_server import BlobCore

        self.blob_core = BlobCore(self.das_core)
        # block plane: every commit hands its EDS/DAH cache entry to this
        # serving core on the warmer's background thread (App.commit ->
        # ProverWarmer -> seed_cache_entry), so the first /das/sample
        # after a commit is index arithmetic — no rebuild, no re-extend
        node.app.add_da_seed_listener(self.das_core.seed_cache_entry)
        # sync plane: serve the interval snapshots the start loop writes
        # to <home>/snapshots (chain/sync.py) — straight from disk, never
        # a capture, never under the service lock
        from celestia_app_tpu_torch.chain import sync as sync_mod

        self.sync_store = sync_mod.store_for(node)
        service = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: a thousand-sampler fleet must not pay
            # a TCP handshake per sample round (every response carries
            # Content-Length, so pipelined framing is always correct)
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_raw(self, code: int, body: bytes) -> None:
                # /sync/chunk serves raw bytes (octet-stream, NOT base64)
                self.send_response(code)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # incoming trace context (X-Celestia-Trace): spans opened
                # while serving this request join the caller's trace
                obs.begin_request(self.headers)
                try:
                    self._get()
                finally:
                    obs.end_request()

            def do_POST(self):
                obs.begin_request(self.headers)
                try:
                    self._post()
                finally:
                    obs.end_request()

            def _get(self):
                try:
                    if self.path == "/status":
                        with service.lock:
                            out = service.router.query("status", {})
                            # mempool plane: per-node CAT pool stats (the
                            # process-wide gauges also ride the telemetry
                            # snapshot / prometheus endpoint)
                            pool = getattr(service.node, "pool", None)
                            if pool is not None:
                                out["mempool"] = pool.stats()
                            # admission + traffic plane counters (the
                            # same block /consensus/status serves)
                            from celestia_app_tpu_torch.chain import (
                                admission as admission_mod,
                            )

                            out["admission"] = admission_mod.status_block(
                                service.node.app)
                            # read plane counters (blob.* / blobpacks.*)
                            from celestia_app_tpu_torch.das import (
                                blob_server as blob_server_mod,
                            )

                            out["blob"] = blob_server_mod.status_block()
                        self._send(200, out)
                    elif self.path == "/metrics":
                        # Prometheus text exposition (the reference's
                        # metrics provider endpoint, SURVEY §5.1); ONE
                        # implementation shared with the validator
                        # service (obs.serve_metrics)
                        obs.serve_metrics(self)
                    elif self.path.startswith("/trace/"):
                        # columnar trace tables (pkg/trace pull, §5.1):
                        # /trace/<table>?since=<index>&limit=<n> — ONE
                        # router shared with the validator service
                        # (obs.route_trace); TraceTables locks its own
                        # reads, so the big writer lock stays out of the
                        # poll path
                        self._send(200, obs.route_trace(
                            service.node.app.traces, self.path))
                    elif self.path.startswith("/das/"):
                        from urllib.parse import parse_qs, urlparse

                        from celestia_app_tpu_torch.das.server import (
                            SampleError,
                            route_das,
                        )

                        parsed = urlparse(self.path)
                        try:
                            out = route_das(
                                service.das_core, "GET", parsed.path,
                                parse_qs(parsed.query),
                            )
                            if isinstance(out, bytes):
                                # /das/pack/chunk: raw static bytes
                                self._send_raw(200, out)
                            else:
                                self._send(200, out)
                        except SampleError as e:
                            self._send(404 if "not served" in str(e)
                                       else 400, {"error": str(e)})
                    elif self.path.startswith("/blob/"):
                        # the read plane (das/blob_server.py): namespace
                        # reads + blob-pack static serving; BlobError is
                        # a SampleError, so one handler covers both
                        from urllib.parse import parse_qs, urlparse

                        from celestia_app_tpu_torch.das.server import SampleError
                        from celestia_app_tpu_torch.das.blob_server import (
                            route_blob,
                        )

                        parsed = urlparse(self.path)
                        try:
                            out = route_blob(
                                service.blob_core, "GET", parsed.path,
                                parse_qs(parsed.query),
                            )
                            if isinstance(out, bytes):
                                # /blob/pack/chunk: raw static bytes
                                self._send_raw(200, out)
                            else:
                                self._send(200, out)
                        except SampleError as e:
                            self._send(404 if "not served" in str(e)
                                       else 400, {"error": str(e)})
                    elif self.path.startswith("/sync/"):
                        # chunked state-sync serving (chain/sync.py):
                        # manifests + raw chunks from disk, lock-free
                        from urllib.parse import parse_qs, urlparse

                        from celestia_app_tpu_torch.chain import sync as sync_mod

                        parsed = urlparse(self.path)
                        try:
                            out = sync_mod.route_sync(
                                service.sync_store, parsed.path,
                                parse_qs(parsed.query),
                            )
                        except sync_mod.SyncError as e:
                            self._send(404 if "not served" in str(e)
                                       else 400, {"error": str(e)})
                            return
                        if isinstance(out, bytes):
                            self._send_raw(200, out)
                        else:
                            self._send(200, out)
                    elif self.path == "/faults":
                        # fault-plane admin (celestia_app_tpu/faults):
                        # armed specs + per-point fire counts
                        from celestia_app_tpu_torch.faults import route_faults

                        self._send(200, route_faults("GET", self.path))
                    elif self.path.startswith("/block/"):
                        height = int(self.path.split("/")[2])
                        blk = service.node.app.db.load_block(height)
                        self._send(200, {
                            "height": blk.header.height,
                            "data_hash": blk.header.data_hash.hex(),
                            "square_size": blk.header.square_size,
                            "app_hash": blk.header.app_hash.hex(),
                            "time_unix": blk.header.time_unix,
                            "txs": [base64.b64encode(t).decode() for t in blk.txs],
                        })
                    else:
                        self._send(404, {"error": f"no route {self.path}"})
                except cuda_build.KernelError as e:
                    # a kernel wrapper's ValueError is the node's fault
                    telemetry.incr("http.500")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                except (QueryError, ValueError) as e:
                    # GET-side ValueErrors are path/query parse failures
                    # (non-integer height, bad since=): client errors
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    telemetry.incr("http.500")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def _post(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/broadcast_tx":
                        raw = base64.b64decode(payload["tx"])
                        with service.lock:
                            res = service.node.broadcast_tx(raw)
                        self._send(200, {
                            "code": res.code, "log": res.log,
                            "gas_wanted": res.gas_wanted,
                            "gas_used": res.gas_used,
                        })
                    elif self.path == "/simulate_tx":
                        raw = base64.b64decode(payload["tx"])
                        with service.lock:
                            res = service.node.app.simulate_tx(raw)
                        self._send(200, {
                            "code": res.code, "log": res.log,
                            "gas_used": res.gas_used,
                        })
                    elif self.path == "/produce_block":
                        with service.lock:
                            blk, results = service.node.produce_block(
                                t=payload.get("time")
                            )
                        self._send(200, {
                            "height": blk.header.height,
                            "data_hash": blk.header.data_hash.hex(),
                            "app_hash": service.node.app.last_app_hash.hex(),
                            "n_txs": len(blk.txs),
                            "results": [
                                {"code": r.code, "log": r.log} for r in results
                            ],
                        })
                    elif self.path == "/abci_query":
                        with service.lock:
                            out = service.router.query(
                                payload["path"], payload.get("data", {})
                            )
                        self._send(200, out)
                    elif self.path.startswith("/da/"):
                        # stateless DA core (no node state, no service
                        # lock): foreign nodes extend/commit/prove here
                        from celestia_app_tpu_torch.service.da_service import (
                            DAError,
                        )

                        try:
                            self._send(200, service.da_core.handle(
                                self.path, payload))
                        except DAError as e:
                            self._send(400, {"error": str(e)})
                    elif self.path.startswith("/das/"):
                        from urllib.parse import urlparse

                        from celestia_app_tpu_torch.das.server import (
                            SampleError,
                            route_das,
                        )

                        try:
                            self._send(200, route_das(
                                service.das_core, "POST",
                                urlparse(self.path).path, {}, payload,
                            ))
                        except SampleError as e:
                            self._send(404 if "not served" in str(e)
                                       else 400, {"error": str(e)})
                    elif self.path.startswith("/blob/"):
                        from urllib.parse import urlparse

                        from celestia_app_tpu_torch.das.server import (
                            SampleError,
                        )
                        from celestia_app_tpu_torch.das.blob_server import (
                            route_blob,
                        )

                        try:
                            self._send(200, route_blob(
                                service.blob_core, "POST",
                                urlparse(self.path).path, {}, payload,
                            ))
                        except SampleError as e:
                            self._send(404 if "not served" in str(e)
                                       else 400, {"error": str(e)})
                    elif self.path.startswith("/faults/"):
                        # arm/disarm/reset fault points on a LIVE node —
                        # the chaos harness's runtime switchboard
                        from celestia_app_tpu_torch.faults import route_faults

                        try:
                            self._send(200, route_faults(
                                "POST", self.path, payload))
                        except (ValueError, KeyError) as e:
                            self._send(400, {"error": str(e)})
                    elif self.path == "/debug/profile":
                        # on-demand torch.profiler capture (FORMATS §10.3;
                        # obs/device_profile.py)
                        self._send(*obs.route_profile(payload))
                    elif self.path == "/ibc/prove":
                        # membership/absence proof of a raw store key: the
                        # relayer's proof source (public data — any light
                        # client could derive the same against the root)
                        key = bytes.fromhex(payload["key"])
                        try:
                            with service.lock:
                                if payload.get("absence"):
                                    proof = (service.node.app.store
                                             .prove_absence(key))
                                else:
                                    proof = service.node.app.store.prove(key)
                        except KeyError:
                            self._send(404, {"error": "no such key"})
                            return
                        self._send(200, {"proof": proof})
                    elif self.path == "/ibc/ack":
                        from celestia_app_tpu_torch.chain.state import (
                            Context, InfiniteGasMeter,
                        )

                        with service.lock:
                            app = service.node.app
                            ctx = Context(app.store, InfiniteGasMeter(),
                                          app.height, 0, app.chain_id,
                                          app.app_version)
                            ack = app.ibc.channels.get_ack(
                                ctx, payload["packet"]
                            )
                        self._send(200, {"ack": ack})
                    elif self.path == "/ibc/client_height":
                        from celestia_app_tpu_torch.chain.state import (
                            Context, InfiniteGasMeter,
                        )

                        with service.lock:
                            app = service.node.app
                            ctx = Context(app.store, InfiniteGasMeter(),
                                          app.height, 0, app.chain_id,
                                          app.app_version)
                            h = app.ibc.clients.latest_height(
                                ctx, payload["client_id"]
                            )
                        self._send(200, {"latest_height": h})
                    elif self.path == "/ibc/header":
                        # certified header + commit certificate at a
                        # height (the verifying-client update payload);
                        # 404 when this node is not consensus-backed or
                        # the height is not yet certified
                        from celestia_app_tpu_torch.chain import (
                            consensus as consensus_mod,
                        )

                        h = int(payload["height"])
                        certs = getattr(service.node, "certificates", None)
                        with service.lock:
                            db = getattr(service.node.app, "db", None)
                            if not certs or h not in certs or db is None:
                                self._send(404, {"error": "not certified"})
                                return
                            block = db.load_block(h)
                            self._send(200, {
                                "header": consensus_mod.header_to_json(
                                    block.header
                                ),
                                "cert": consensus_mod.cert_to_json(
                                    certs[h]
                                ),
                            })
                    elif self.path == "/ibc/events":
                        # committed packet events, the relayer's work list
                        # (bounded by the node's committed-index window)
                        want = payload.get("type", "send_packet")
                        with service.lock:
                            rows = [
                                {"height": h, **ev}
                                for _tx, (h, res) in sorted(
                                    service.node.committed.items(),
                                    key=lambda kv: kv[1][0],
                                )
                                if res.code == 0
                                for ev in res.events
                                if ev.get("type") == want
                            ]
                        self._send(200, {"events": rows})
                    else:
                        self._send(404, {"error": f"no route {self.path}"})
                except QueryError as e:
                    # client-side problem or policy refusal (e.g. a
                    # validator's /produce_block): 4xx, not a 5xx that
                    # trips server-health monitoring. Internal errors that
                    # surface as bare ValueError stay 500 on purpose — a
                    # failing node must look unhealthy.
                    self._send(400, {"error": str(e)})
                except Exception as e:
                    telemetry.incr("http.500")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        class Server(ThreadingHTTPServer):
            # a thousand-sampler fleet connects in one burst: the stdlib
            # default listen backlog of 5 resets most of it on arrival
            request_queue_size = 1024

        self.httpd = Server((host, port), Handler)
        self.port = self.httpd.server_address[1]
        # GIL-pressure sampler for this serving plane (no-op while spans
        # are gated off): gil.pressure{service="node"} in /metrics
        from celestia_app_tpu_torch.obs import gil
        gil.start("node")

    def serve_background(self) -> threading.Thread:
        th = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        th.start()
        return th

    def shutdown(self) -> None:
        # deregister the commit-seed hook so a replaced service's dead
        # SampleCore stops receiving (and pinning) future entries
        self.node.app.remove_da_seed_listener(
            self.das_core.seed_cache_entry)
        self.httpd.shutdown()
        self.httpd.server_close()
