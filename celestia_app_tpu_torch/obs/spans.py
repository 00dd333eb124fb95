"""Cross-node span tracing over the columnar trace plane.

Copied from celestia_app_tpu/obs/spans.py; the recording gate is
`set_enabled`, not an environment variable.

The reference measures hot paths per process (telemetry.MeasureSince) and
pulls per-node columnar tables (celestia-core pkg/trace) — but neither can
answer "where did block H spend its 400 ms between proposer and light
node?".  Spans close that gap with three deliberate choices:

- **Deterministic per-height trace ids.** The trace id for block H is
  ``sha256(chain_id + "/" + H)[:16]`` (`trace_id_for`), so the proposer,
  every follower, and every DAS light node stamp their spans with the SAME
  id without any clock sync, id exchange, or coordinator.  A merge tool
  (tools/timeline.py) only needs to group by trace_id.
- **Rows, not a protocol.** A finished span is ONE row in the existing
  ``TraceTables`` ("spans" table): trace_id / span_id / parent_id / name /
  start_unix / dur_ms / attrs.  It rides the same bounded ring buffers,
  the same ``/trace/spans`` pull route, and the same per-App isolation the
  BlockSummary rows already have.
- **Context propagation that survives sockets and threads.**  Within a
  thread, spans nest through a thread-local stack.  Across a peer call,
  the hardened transport (net/transport.py) injects an
  ``X-Celestia-Trace: <trace_id>:<span_id>`` header and the HTTP services
  install it as the *incoming* context (`begin_request`), which the next
  root span on that handler thread adopts as its remote parent.  Across
  an in-process thread hop (the reactor's sender queues), `capture()` /
  `resume()` carry the context explicitly.

Recording is on by default and gated by `set_enabled`: a disabled span
is a shared no-op object, so the hot path pays one dict lookup and one
truthiness check.

**On the device trace's clock.** A span's row is timed with the host's
clocks, which are not ``torch.profiler``'s, so while a profiler records
(``torch.autograd.profiler._is_profiler_enabled``, one attribute read) a
span also opens a ``torch.profiler.record_function`` range of its name:
it lands on the device trace as a ``user_annotation`` on the trace's own
clock, beside the kernels it launched, in a benchmark's trace and in a
``/debug/profile`` capture alike. With no profiler recording nothing
else happens.

**Stages.** `stage(name, *index)` is a range for code that only enqueues
device work. It writes no row: its duration would be enqueue time, which
reads as device time and is not. The work under a stage is what the
trace puts inside its range. Off (no profiler recording, or recording
off) it is the shared `NOOP`; the name ``name[i,j]`` of an indexed stage
is built only when the range is opened. The encode-and-commit path
carries these ranges (README.md, the port's observability plane):

- entries: ``edscache.compute_entry``, ``mesh.compute_entries_batched``,
  ``mesh.compute_entry_mesh``, and in each ``entry.assemble`` (the DAH
  and the entries built from the host roots);
- one card (``da/eds._pipeline``): ``eds.extend``, ``eds.leaves``,
  ``eds.trees``, ``eds.data_root``;
- a mesh (``parallel/sharded_eds.sharded_pipeline``): ``sharded.input``,
  ``sharded.row_pass[d,s]``, ``sharded.transpose1``,
  ``sharded.column_pass[d,s]``, ``sharded.transpose2``,
  ``sharded.row_roots[d,s]``, ``sharded.gather[d,s]``,
  ``sharded.data_root``;
- crossings (``obs/xfer``): ``xfer.h2d:<site>``, ``xfer.d2h:<site>``.

No switch and no environment variable gates them: the profiler's own
state and `set_enabled` do.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import threading
import time

import torch

from celestia_app_tpu_torch.utils import telemetry

# the wire header every peer call carries while a span is active
TRACE_HEADER = "X-Celestia-Trace"

SPAN_TABLE = "spans"

_tls = threading.local()
# span ids: per-process random prefix + counter — unique across the
# processes of a devnet without coordination, and cheap to mint
_SPAN_PREFIX = os.urandom(3).hex()
_counter = itertools.count(1)

_enabled: bool | None = None

# the module whose `_is_profiler_enabled` flag says a profiler records
_profiler = torch.autograd.profiler


def enabled() -> bool:
    """Span recording gate: on unless `set_enabled(False)` turned it off
    (the port reads no environment; the reference's CELESTIA_OBS)."""
    return _enabled is not False


def set_enabled(value: bool | None) -> None:
    """Turn span recording on or off (None restores the default, on)."""
    global _enabled
    _enabled = None if value is None else bool(value)


def trace_id_for(chain_id: str, height: int) -> str:
    """THE deterministic per-height trace id: every process that knows
    (chain_id, height) — proposer, follower, light node — derives the
    same id, so cross-node correlation needs no clock sync or handshake."""
    return hashlib.sha256(
        f"{chain_id}/{int(height)}".encode()
    ).hexdigest()[:16]


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """One in-flight span; use as a context manager. `set(**attrs)` adds
    attributes before exit; the row is written on __exit__."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "sink",
                 "attrs", "start_unix", "_t0", "_range")

    def __init__(self, name: str, trace_id: str, parent_id: str | None,
                 sink, attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = f"{_SPAN_PREFIX}{next(_counter):06x}"
        self.parent_id = parent_id
        self.sink = sink
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_unix = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # unbalanced exit (generator teardown): heal
            st.remove(self)
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        try:
            self.sink.write(
                SPAN_TABLE,
                trace_id=self.trace_id,
                span_id=self.span_id,
                parent_id=self.parent_id,
                name=self.name,
                start_unix=round(self.start_unix, 6),
                dur_ms=round(dur_ms, 3),
                **self.attrs,
            )
        except Exception:
            # must never take down the instrumented path — but count it:
            # a span plane that silently drops rows looks "quiet", not ok
            telemetry.incr("obs.span_errors")


class _NoopSpan:
    """Shared disabled span: context manager + set() that do nothing."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP = _NoopSpan()


def stage(name: str, *index, site: str | None = None):
    """A row-less range around code that enqueues device work: a
    ``torch.profiler.record_function`` range named `name`, ``name[i,j]``
    for an `index` (a shard's data and seq index) or ``name:<site>`` for
    a `site`, while a profiler records and span recording is on; else the
    shared `NOOP`, with no name built."""
    if not (_profiler._is_profiler_enabled and enabled()):
        return NOOP
    if index:
        name = f"{name}[{','.join(map(str, index))}]"
    if site is not None:
        name = f"{name}:{site}"
    return torch.profiler.record_function(name)


def span(name: str, *, traces=None, trace_id: str | None = None, **attrs):
    """Open a span. Parentage resolution, in order:

    1. an active span on this thread (nesting) — its trace id wins unless
       an explicit `trace_id` is given (same-id case in practice, since
       both derive from (chain_id, height));
    2. the incoming HTTP context installed by `begin_request` — adopted
       as a REMOTE parent when its trace id matches (or no explicit id
       was given), which is what links a served request into the caller's
       trace;
    3. a fresh root (explicit or random trace id).

    `traces` pins the sink (per-App TraceTables); otherwise the parent's
    sink, else the process-global tables."""
    if not enabled():
        return NOOP
    st = _stack()
    parent = st[-1] if st else None
    incoming = getattr(_tls, "incoming", None) if parent is None else None
    if parent is not None:
        sink = traces if traces is not None else parent.sink
        if trace_id is not None and trace_id != parent.trace_id:
            # explicit DIFFERENT trace (blocksync pulling another height
            # under a reactor.round span): a cross-trace parent edge
            # would orphan this span in per-trace merges — root it in
            # its own trace instead
            tid, pid = trace_id, None
        else:
            tid = parent.trace_id
            pid = parent.span_id
    else:
        if incoming is not None and (trace_id is None
                                     or incoming[0] == trace_id):
            tid, pid = incoming
        else:
            tid = trace_id or os.urandom(8).hex()
            pid = None
        sink = traces if traces is not None else telemetry._traces
    return Span(name, tid, pid, sink, attrs)


# -- cross-thread / cross-socket propagation --------------------------------


def capture():
    """Snapshot the current span context for another thread (the reactor
    sender queues); None when no span is active."""
    st = getattr(_tls, "stack", None)
    if not st:
        return None
    top = st[-1]
    return (top.trace_id, top.span_id, top.sink)


def resume(ctx, name: str, *, traces=None, **attrs):
    """Open a span on THIS thread parented to a `capture()`d context.
    No-op when the context is None or recording is off."""
    if ctx is None or not enabled():
        return NOOP
    tid, pid, sink = ctx
    return Span(name, tid, pid, traces if traces is not None else sink,
                attrs)


def http_header() -> str | None:
    """Outbound X-Celestia-Trace value for the current span, or None.
    Called by the peer transport on every request."""
    st = getattr(_tls, "stack", None)
    if not st or not enabled():
        return None
    top = st[-1]
    return f"{top.trace_id}:{top.span_id}"


def begin_request(headers) -> None:
    """Install the incoming trace context from request headers (HTTP
    handler entry); the next ROOT span on this thread adopts it."""
    raw = headers.get(TRACE_HEADER) if headers is not None else None
    if raw and ":" in raw:
        tid, _, sid = raw.partition(":")
        if tid and sid:
            _tls.incoming = (tid, sid)
            return
    _tls.incoming = None


def end_request() -> None:
    """Clear the incoming context (HTTP handler exit; handler threads are
    pooled, so a stale context must not leak into the next request)."""
    _tls.incoming = None


# -- shared HTTP surface (ONE implementation for every service) -------------


def serve_metrics(handler) -> None:
    """Write the Prometheus text exposition to a BaseHTTPRequestHandler —
    the /metrics route of both the node and validator services."""
    from celestia_app_tpu_torch.utils import telemetry

    body = telemetry.prometheus().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def route_profile(payload: dict) -> tuple[int, dict]:
    """The POST /debug/profile body -> (status, response) for both HTTP
    services: runs the on-demand torch.profiler capture, mapping every
    client-side problem to a 400."""
    from celestia_app_tpu_torch.obs import device_profile

    if not isinstance(payload, dict):
        return 400, {"error": "body must be a JSON object"}
    try:
        return 200, device_profile.capture_profile(
            payload.get("dir"), seconds=payload.get("seconds", 0.5)
        )
    except device_profile.ProfileError as e:
        return 400, {"error": str(e)}


# -- the /trace/* route, shared by every HTTP service -----------------------


def route_trace(traces, path: str) -> dict:
    """Serve /trace/<table>?since=<index>&limit=<n> from `traces`. Raises
    ValueError on malformed query (transports answer 400)."""
    from urllib.parse import parse_qs, urlparse

    parsed = urlparse(path)
    parts = parsed.path.split("/")
    table = parts[2] if len(parts) > 2 and parts[2] else ""
    qs = parse_qs(parsed.query)
    rows = traces.read(
        table,
        since_index=int(qs.get("since", ["0"])[0]),
        limit=int(qs.get("limit", ["1000"])[0]),
    )
    return {"table": table, "rows": rows, "tables": traces.tables()}
