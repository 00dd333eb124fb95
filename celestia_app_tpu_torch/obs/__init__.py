"""The observability plane: spans, structured logging, device profiling.

Port of celestia_app_tpu/obs. Five sub-modules, one import surface
(``from celestia_app_tpu_torch import obs``):

- ``obs.spans`` — context-manager span API over the columnar TraceTables
  with DETERMINISTIC per-height trace ids (``trace_id_for(chain_id, h)``)
  so proposer, followers, and DAS light nodes correlate without clock
  sync; HTTP propagation via the ``X-Celestia-Trace`` header. While a
  ``torch.profiler`` records, every span also opens a
  ``record_function`` range of its name, so it lands on the device
  trace's clock; ``obs.stage(name, *index)`` is such a range with no row,
  for code that only enqueues device work (a row would time the enqueue,
  not the device): the encode-and-commit path's ``eds.*``, ``sharded.*``,
  entry, ``entry.assemble`` and ``xfer.*`` ranges.
- ``obs.log`` — the leveled structured stderr logger library modules use
  instead of calling ``print`` (lint-enforced).
- ``obs.device_profile`` — the compile-vs-execute split of the kernel
  paths (the first call of a (fn, k) pays the nvcc build or the lazy
  operand build), the ``torch.cuda`` memory gauges, and the on-demand
  ``torch.profiler`` capture.
- ``obs.xfer`` — the host↔device transfer ledger: every host↔card copy on
  the node's path routes through ``xfer.to_device``/``to_host``
  so bytes, calls, and latency are attributed per call-site label, and
  ``xfer.no_implicit_transfers()`` turns stray implicit copies into
  hard errors for tier-1 residency pins.
- ``obs.gil`` — GIL-pressure oversleep samplers per HTTP service and
  the ``process.peak_rss_bytes`` /metrics gauge (collector registers on
  import of this package).

Histograms/labels/Prometheus exposition live in utils/telemetry.py (the
metric registry predates this package and everything already imports it).
docs/DESIGN.md "The observability plane" has the span model; FORMATS §10
the wire formats.
"""

from celestia_app_tpu_torch.obs import gil  # noqa: F401  (registers the peak-RSS collector)
from celestia_app_tpu_torch.obs.log import get_logger  # noqa: F401
from celestia_app_tpu_torch.obs.spans import (  # noqa: F401
    NOOP,
    SPAN_TABLE,
    TRACE_HEADER,
    Span,
    begin_request,
    capture,
    enabled,
    end_request,
    http_header,
    resume,
    route_profile,
    route_trace,
    serve_metrics,
    set_enabled,
    span,
    stage,
    trace_id_for,
)
from celestia_app_tpu_torch.obs.xfer import (  # noqa: F401
    ImplicitTransferError,
    no_implicit_transfers,
    to_device,
    to_host,
)
