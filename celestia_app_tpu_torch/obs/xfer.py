"""The host↔device transfer ledger: every boundary crossing, counted.

Port of celestia_app_tpu/obs/xfer.py onto torch. The per-block gauge
``xfer.host_bytes_crossed_per_block`` (chain/app.py, at every commit) is
the number a zero-copy block path is judged by, so every host↔card copy
on the node's path goes through two helpers:

- **Counted helpers.** `to_device(value, site, device=...)` and
  `to_host(value, site)` copy a numpy array, a tensor, or a nested
  list/tuple of them, and attribute bytes, call count and latency to the
  call-site label: ``xfer.h2d_bytes{site=…}`` / ``xfer.d2h_bytes{site=…}``
  (and the ``_calls`` twins) and the latency histograms ``xfer.h2d`` /
  ``xfer.d2h``. On ``device="cpu"`` the copy is a host memcpy, and it is
  counted all the same: the ledger counts what the helpers moved.
- **Ledger rows.** When span recording is on and a span is active, each
  transfer also writes one row to the ``xfer`` trace table of the span's
  sink, stamped with the span's trace id.
- **Ranges.** While a profiler records, the copy itself sits in a
  row-less ``xfer.h2d:<site>`` / ``xfer.d2h:<site>`` range
  (`spans.stage`), nested under whatever stage is open.
- **A pinnable residency claim.** `no_implicit_transfers()` makes any
  device→host crossing the helpers did NOT mediate an error. Torch has
  no transfer guard, so the context patches ``Tensor.cpu``,
  ``Tensor.numpy``, ``Tensor.item``, ``Tensor.tolist``, ``Tensor.to``
  (to a CPU device) and ``numpy.asarray``: on a thread inside the
  context, any of them called on a CUDA tensor outside a ledger helper
  raises `ImplicitTransferError`. Other threads are untouched (a
  thread-local flag). On a host with no card there is no boundary to
  guard: the probe is still installed, and ``obs.xfer_guard_noop`` counts
  that the claim was not exercised.
- **The per-block gauge.** The cumulative totals (`totals()`,
  `bytes_crossed()`) let chain/app.py compute a per-commit delta.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

from celestia_app_tpu_torch.obs import spans
from celestia_app_tpu_torch.utils import telemetry

XFER_TABLE = "xfer"


class ImplicitTransferError(RuntimeError):
    """An uncounted device→host crossing inside `no_implicit_transfers()`:
    a CUDA tensor was read to host memory by a path the ledger cannot see
    (a stray ``.cpu()`` instead of `to_host`)."""


_tls = threading.local()

_totals_lock = threading.Lock()
# cumulative process-wide boundary traffic: the source of the per-block
# delta gauge (chain/app.py reads bytes_crossed() at each commit)
_totals = {"h2d_bytes": 0, "d2h_bytes": 0, "h2d_calls": 0, "d2h_calls": 0}

telemetry.set_help("xfer.h2d_bytes", "host->device bytes through the transfer ledger")
telemetry.set_help("xfer.d2h_bytes", "device->host bytes through the transfer ledger")
telemetry.set_help("xfer.host_bytes_crossed_per_block",
                   "host<->device bytes crossed while committing the last block")


def nbytes_of(value) -> int:
    """Byte size of an array, tensor, buffer, or (possibly nested)
    container of them. Unknown leaves count 0 rather than raising: the
    ledger must never take down a transfer."""
    if value is None:
        return 0
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, (list, tuple)):
        return sum(nbytes_of(v) for v in value)
    if isinstance(value, dict):
        return sum(nbytes_of(v) for v in value.values())
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    n = getattr(value, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(value, (bool, int, float)):
        return 8
    return 0


def totals() -> dict:
    """Snapshot of the cumulative process-wide transfer totals."""
    with _totals_lock:
        return dict(_totals)


def bytes_crossed() -> int:
    """Cumulative h2d + d2h bytes: the monotone the per-block gauge is a
    delta of."""
    with _totals_lock:
        return _totals["h2d_bytes"] + _totals["d2h_bytes"]


@contextmanager
def _explicit():
    """Mark this thread as inside a ledger helper, so the probe lets the
    mediated copy pass."""
    d = getattr(_tls, "explicit", 0)
    _tls.explicit = d + 1
    try:
        yield
    finally:
        _tls.explicit = d


def _account(direction: str, site: str, nbytes: int, t0: float) -> None:
    """Attribute one transfer to `site`: counters, latency histogram and,
    when a span is active, one ledger row in the span's trace sink."""
    dur_s = telemetry.measure_since(f"xfer.{direction}", t0, labels={"site": site})
    telemetry.incr(f"xfer.{direction}_bytes", nbytes, labels={"site": site})
    telemetry.incr(f"xfer.{direction}_calls", labels={"site": site})
    with _totals_lock:
        _totals[f"{direction}_bytes"] += nbytes
        _totals[f"{direction}_calls"] += 1
    ctx = spans.capture() if spans.enabled() else None
    if ctx is None:
        return
    tid, sid, sink = ctx
    try:
        sink.write(
            XFER_TABLE, trace_id=tid, parent_id=sid, site=site, dir=direction,
            bytes=int(nbytes),
            # wall-clock start, display only, never hashed
            start_unix=round(time.time() - dur_s, 6),  # lint: disable=det-wallclock
            dur_ms=round(dur_s * 1e3, 3),
        )
    except Exception:
        telemetry.incr("obs.xfer_row_errors")


def _map(value, fn):
    if isinstance(value, (list, tuple)):
        return type(value)(_map(v, fn) for v in value)
    return fn(value)


def to_device(value, site: str, *, device):
    """Copy `value` (numpy arrays, tensors, or a list/tuple of them) to
    `device`, accounted to `site`. A numpy array goes over as it lies (a
    strided view stays strided, to be made contiguous on the device; a
    read-only one is copied first); on the CPU the result may share the
    caller's memory."""
    dev = torch.device(device)

    def one(a):
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)  # xfer: ledger
            a = torch.from_numpy(a if a.flags.writeable else a.copy())
        return a.to(dev)  # xfer: ledger

    t0 = telemetry.start_timer()
    with _explicit(), spans.stage("xfer.h2d", site=site):
        out = _map(value, one)
    _account("h2d", site, nbytes_of(value), t0)
    return out


def to_host(value, site: str):
    """Copy tensors (or a list/tuple of them) to host numpy arrays,
    accounted to `site`. Blocks until the producing kernels finish."""

    def one(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # xfer: ledger

    t0 = telemetry.start_timer()
    with _explicit(), spans.stage("xfer.d2h", site=site):
        out = _map(value, one)
    _account("d2h", site, nbytes_of(out), t0)
    return out


def ensure_device(value, site: str, *, device):
    """The upload twin of `ensure_host`: a host array bound for a card
    crosses through the counted copy (`to_device`, attributed to `site`);
    bound for the CPU it is wrapped as a tensor and counts nothing (no
    copy, no boundary). A tensor already on `device` passes through."""
    dev = torch.device(device)
    if isinstance(value, torch.Tensor) and value.device.type == dev.type and (
            dev.index is None or value.device.index == dev.index):
        return value
    if dev.type != "cpu" or isinstance(value, torch.Tensor):
        return to_device(value, site, device=dev)
    a = np.asarray(value)  # xfer: ledger
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def queued(direction: str, site: str, nbytes: int) -> None:
    """Count a copy that the caller queued itself (``non_blocking`` on a
    copy stream, into or out of pinned memory), attributed to `site`. The
    copy is counted when it is queued; its latency is not measured.
    `direction` is ``"h2d"`` or ``"d2h"``."""
    _account(direction, site, int(nbytes), telemetry.start_timer())


def ensure_host(value, site: str):
    """Materialize-if-device: a tensor on a device comes back through the
    counted copy (`to_host`, attributed to `site`); anything already on
    the host (a numpy array, a CPU tensor) passes through as a numpy array
    and counts nothing — the helper for boundary-normalization call sites
    whose inputs are only sometimes device-resident (a ledger row for a
    zero-copy host read would be worse than none)."""
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        return to_host(value, site)
    with _explicit():
        return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)  # xfer: ledger


# -- the residency pin -------------------------------------------------------

_probe_lock = threading.Lock()
_probe_refs = 0  # guarded-by: _probe_lock
_saved: dict = {}  # guarded-by: _probe_lock  (name -> original attribute)

_TENSOR_READS = ("cpu", "numpy", "item", "tolist")


def _armed() -> bool:
    return getattr(_tls, "guard", 0) > 0 and getattr(_tls, "explicit", 0) == 0


def _refuse(what: str):
    raise ImplicitTransferError(
        f"{what} on a CUDA tensor inside no_implicit_transfers(): route it "
        "through obs.xfer.to_host(value, site) so the ledger counts it")


def _to_cpu(args, kwargs) -> bool:
    """Whether a ``Tensor.to`` call targets the CPU."""
    target = kwargs.get("device", args[0] if args else None)
    if isinstance(target, torch.Tensor):
        target = target.device
    if isinstance(target, (str, torch.device)):
        try:
            return torch.device(target).type == "cpu"
        except RuntimeError:
            return False
    return False


def _probe_method(name: str, orig):
    def probe(self, *args, **kwargs):
        if _armed() and self.is_cuda and (name != "to" or _to_cpu(args, kwargs)):
            _refuse(f"Tensor.{name}")
        return orig(self, *args, **kwargs)

    probe.__name__ = name
    return probe


def _probe_asarray(a, *args, **kwargs):
    if _armed() and isinstance(a, torch.Tensor) and a.is_cuda:
        _refuse("numpy.asarray")
    return _saved["asarray"](a, *args, **kwargs)


def _install() -> None:
    for name in (*_TENSOR_READS, "to"):
        orig = getattr(torch.Tensor, name)
        _saved[name] = (torch.Tensor.__dict__.get(name), orig)
        setattr(torch.Tensor, name, _probe_method(name, orig))
    _saved["asarray"] = np.asarray
    np.asarray = _probe_asarray


def _uninstall() -> None:
    np.asarray = _saved.pop("asarray")
    for name in (*_TENSOR_READS, "to"):
        own, _ = _saved.pop(name)
        if own is None:
            delattr(torch.Tensor, name)
        else:
            setattr(torch.Tensor, name, own)


@contextmanager
def no_implicit_transfers():
    """Pin a device-residency claim: on this thread, any device→host read
    of a CUDA tensor that the ledger helpers did not mediate raises
    `ImplicitTransferError` inside the context. Host→device uploads are
    not guarded (the cached operands upload on first use)."""
    global _probe_refs
    if not torch.cuda.is_available():
        # no card: nothing on this host can cross; say the pin was vacuous
        telemetry.incr("obs.xfer_guard_noop")
    with _probe_lock:
        if _probe_refs == 0:
            _install()
        _probe_refs += 1
    _tls.guard = getattr(_tls, "guard", 0) + 1
    try:
        yield
    finally:
        _tls.guard -= 1
        with _probe_lock:
            _probe_refs -= 1
            if _probe_refs == 0:
                _uninstall()
