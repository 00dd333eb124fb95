"""Streaming PrepareProposal on one card: the host lays out block i+1
while the card extends and commits block i. The port of the one-card half
of celestia_app_tpu/parallel/streaming.py (`stream_blocks`,
`_stream_batches`, `_synthetic_layout`, `bench_stream`,
`bench_stream_batched`) and of its mesh half (`stream_blocks_mesh`,
`bench_stream_mesh`: the same loop over the sharded pipeline,
parallel/sharded_eds.py, the upload landing on the mesh's lead device).

jax got the overlap from asynchronous dispatch alone. Here it is built:

- each unit's ODS (a block, or a batch of blocks) is copied into one of
  two reused pinned host buffers and uploaded with ``non_blocking=True``
  on a copy stream into one of two reused device buffers; an event marks
  the upload, and the compute stream waits on it;
- the pipeline is queued on the compute stream with no host copy and no
  synchronisation (the SHA-256 padding tails, the RS operands and the
  parity namespace are cached on the card), and the data roots are copied
  into pinned host memory behind an event;
- the host fetches unit i-1's roots after laying out and queueing unit i.
  An event that has not completed at that point counts an overlap stall:
  the host outran the card.

A pageable copy, an ``.item()`` or a ``.cpu()`` inside the pipeline would
make the loop serial.

Counts in `counters`: ``streaming.overlap_stalls``,
``streaming.blocks_in_flight`` (blocks queued and not yet fetched; 0 after
a run) and its largest value ``streaming.max_blocks_in_flight``,
``streaming.fetches`` and ``streaming.fetch_s`` (host seconds spent
waiting in fetches), and the host seconds of the loop's two other parts,
``streaming.layout_s`` (the caller's layout) and ``streaming.queue_s``
(staging, upload and queueing the card work). On the CPU
(``device="cpu"``) the same loop runs serially.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.parallel import mesh as mesh_mod
from celestia_app_tpu_torch.parallel import sharded_eds

counters = {"streaming.overlap_stalls": 0, "streaming.blocks_in_flight": 0,
            "streaming.max_blocks_in_flight": 0, "streaming.fetches": 0, "streaming.fetch_s": 0.0,
            "streaming.layout_s": 0.0, "streaming.queue_s": 0.0}


def _in_flight(blocks: int) -> None:
    counters["streaming.blocks_in_flight"] = blocks
    counters["streaming.max_blocks_in_flight"] = max(counters["streaming.max_blocks_in_flight"], blocks)


def _fetch(done: torch.cuda.Event, roots: torch.Tensor) -> list[bytes]:
    """Resolve one queued unit: its data roots from pinned memory once its
    event has completed."""
    if not done.query():
        counters["streaming.overlap_stalls"] += 1
    t0 = time.perf_counter()
    done.synchronize()
    counters["streaming.fetch_s"] += time.perf_counter() - t0
    counters["streaming.fetches"] += 1
    return [bytes(r) for r in roots.numpy().reshape(-1, 32)]


def _stream(layout_fn, n_units: int, run, dev: torch.device) -> list[bytes]:
    """The one-deep overlap loop over units: `layout_fn(i)` is the host's
    (k, k, 512) or (B, k, k, 512) uint8 ODS of unit i, `run(ods)` queues
    the card work on an ODS tensor and returns its data roots ((32,) or
    (B, 32)). Returns the flat list of 32-byte data roots, in order."""
    if n_units <= 0:
        return []
    if dev.type != "cuda":
        roots: list[bytes] = []
        for i in range(n_units):
            ods = xfer.to_device(np.array(layout_fn(i), dtype=np.uint8), "streaming.dispatch", device=dev)
            roots += [bytes(r) for r in xfer.to_host(run(ods), "streaming.fetch").reshape(-1, 32)]
        return roots
    compute = torch.cuda.current_stream(dev)
    copier = torch.cuda.Stream(device=dev)
    shape = None
    host = card = roots_host = None
    uploaded, consumed = [None, None], [None, None]
    out: list[bytes] = []
    pending = None
    for i in range(n_units):
        t0 = time.perf_counter()
        ods = np.asarray(layout_fn(i), dtype=np.uint8)  # host: lay out unit i
        t1 = time.perf_counter()
        counters["streaming.layout_s"] += t1 - t0
        j = i % 2
        if ods.shape != shape:
            shape = ods.shape
            host = [torch.empty(shape, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
            card = [torch.empty(shape, dtype=torch.uint8, device=dev) for _ in range(2)]
            roots_host = [None, None]
        elif uploaded[j] is not None:
            uploaded[j].synchronize()  # the upload of unit i - 2 left host[j]
        np.copyto(host[j].numpy(), ods)
        with torch.cuda.stream(copier):
            if consumed[j] is not None:
                copier.wait_event(consumed[j])  # unit i - 2's pipeline has read card[j]
            card[j].copy_(host[j], non_blocking=True)
            xfer.queued("h2d", "streaming.dispatch", ods.nbytes)
            uploaded[j] = copier.record_event()
        compute.wait_event(uploaded[j])
        roots_dev = run(card[j])
        consumed[j] = compute.record_event()
        if roots_host[j] is None or roots_host[j].shape != roots_dev.shape:
            roots_host[j] = torch.empty(roots_dev.shape, dtype=torch.uint8, pin_memory=True)
        roots_host[j].copy_(roots_dev, non_blocking=True)
        xfer.queued("d2h", "streaming.fetch", roots_dev.numel())
        done = compute.record_event()
        counters["streaming.queue_s"] += time.perf_counter() - t1
        blocks = roots_dev.numel() // 32
        _in_flight(blocks + (pending[2] if pending else 0))
        if pending is not None:
            out += _fetch(pending[0], pending[1])  # block on unit i - 1
        pending = (done, roots_host[j], blocks)
    out += _fetch(pending[0], pending[1])
    _in_flight(0)
    return out


def stream_blocks(layout_fn, n_blocks: int, k: int, *, pipeline=None, device=None) -> list[bytes]:
    """Run `n_blocks` blocks through the card's pipeline with one-deep
    overlap: ``layout_fn(i) -> (k, k, 512) uint8 ODS`` is the host work (the
    square layout), and the card computes block i while the host lays out
    block i+1. `pipeline(ods)` returns (eds, row_roots, col_roots,
    data_root), by default `eds.pipeline` on `device` (the card unless the
    caller asks for the CPU). Returns the 32-byte data roots, in order."""
    dev = device_mod.resolve(device)
    run = pipeline if pipeline is not None else (lambda ods: eds_mod.pipeline(ods, dev))

    def unit(ods: torch.Tensor) -> torch.Tensor:
        if ods.shape != (k, k, ods.shape[-1]):
            raise ValueError(f"block layout is {tuple(ods.shape)}, not a ({k}, {k}, 512) square")
        return run(ods)[3]

    return _stream(layout_fn, n_blocks, unit, dev)


def _synthetic_layout(k: int, seed: int) -> np.ndarray:
    """Stand-in host layout: a seeded random k x k ODS, every share stamped
    with one namespace. Costs real host time (RNG and memory traffic) like
    share packing does."""
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, size=(k, k, 512), dtype=np.uint8)
    ods[..., :29] = 0
    ods[..., 28] = 7
    return ods


def _stream_batches(layout_fn, n_batches: int, run=None, device=None) -> list[bytes]:
    """The one-deep overlap loop over batches: ``layout_fn(i) -> (B, k, k,
    512)`` is batch i's host layout, `run(ods_batch)` the batched pipeline
    (by default `eds.pipeline_batched` on `device`). Returns the flat list
    of 32-byte data roots."""
    dev = device_mod.resolve(device)
    run = run if run is not None else (lambda ods: eds_mod.pipeline_batched(ods, dev))
    return _stream(layout_fn, n_batches, lambda ods: run(ods)[3], dev)


def stream_blocks_mesh(layout_fn, n_batches: int, mesh, k: int) -> list[bytes]:
    """Mesh-sharded streaming: each unit is a batch of ``data``-many squares
    (``layout_fn(i) -> (B, k, k, 512)``) through the sharded pipeline over
    `mesh` (a parallel/mesh.Mesh), rows split over ``seq`` and blocks over
    ``data``, while the host lays out batch i+1. The upload lands on the
    mesh's lead device and the shards take their slabs from there.
    Returns the flat list of 32-byte data roots."""

    def unit(ods: torch.Tensor) -> torch.Tensor:
        if tuple(ods.shape[1:3]) != (k, k):
            raise ValueError(f"batch layout is {tuple(ods.shape)}, not (B, {k}, {k}, 512) squares")
        return sharded_eds.sharded_pipeline(mesh, ods)[3]

    return _stream(layout_fn, n_batches, unit, mesh.lead)


def bench_stream_mesh(k: int | None = None, n_batches: int = 3, n_devices: int = 8,
                      devices=None) -> dict:
    """Streamed blocks/s on an n-device mesh (the reference's 256 x 256
    streaming on 8 devices). `devices` defaults to the visible cards; k
    defaults to 256 on a card and 32 elsewhere. One JSON-able dict; times
    are host seconds."""
    devices = list(mesh_mod.visible_cards() if devices is None else devices)
    if not devices:
        raise RuntimeError("no CUDA device: pass devices=[...] to stream over a mesh elsewhere")
    n_devices = min(n_devices, len(devices))
    lead = torch.device(devices[0])
    if k is None:
        k = 256 if lead.type == "cuda" else 32
    mesh = mesh_mod.make_mesh(n_devices, k=k, devices=devices[:n_devices])
    batch = mesh.shape[mesh_mod.DATA_AXIS]

    def layout(i: int) -> np.ndarray:
        return np.stack([_synthetic_layout(k, i * batch + j) for j in range(batch)])

    # first-use set-up (operands, caches) out of the timing
    xfer.to_host(sharded_eds.sharded_pipeline(mesh, layout(0))[3], "streaming.warm")
    t0 = time.perf_counter()
    roots = stream_blocks_mesh(layout, n_batches, mesh, k)
    dt = time.perf_counter() - t0
    n_blocks = n_batches * batch
    if len(roots) != n_blocks or any(len(r) != 32 for r in roots):
        raise AssertionError(f"{len(roots)} data roots for {n_blocks} blocks")
    return {
        "metric": f"stream_mesh_blocks_per_sec_k{k}",
        "value": n_blocks / dt,
        "unit": "blocks/s",
        "device": _device_name(mesh.lead),
        "devices": n_devices,
        "mesh": dict(mesh.shape),
        "blocks": n_blocks,
        "elapsed_s": dt,
    }


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_stream(k: int = 256, n_blocks: int = 6, device=None) -> dict:
    """Streamed blocks/s on `device` against the serial cost: the layouts
    alone, then each block uploaded, run and fetched in turn, then the
    overlapped loop. One JSON-able dict; times are host seconds."""
    dev = device_mod.resolve(device)
    warm = _synthetic_layout(k, 0)
    # caches and first-use set-up out of the timing
    xfer.to_host(eds_mod.pipeline(xfer.to_device(warm, "streaming.dispatch", device=dev), dev)[3],
                 "streaming.warm")
    t0 = time.perf_counter()
    layouts = [_synthetic_layout(k, i) for i in range(n_blocks)]
    host_ms = (time.perf_counter() - t0) * 1e3 / n_blocks
    _sync(dev)
    t0 = time.perf_counter()
    serial = [bytes(xfer.to_host(eds_mod.pipeline(xfer.to_device(ods, "streaming.dispatch", device=dev),
                                                  dev)[3], "streaming.fetch"))
              for ods in layouts]
    device_ms = (time.perf_counter() - t0) * 1e3 / n_blocks
    t0 = time.perf_counter()
    roots = stream_blocks(lambda i: _synthetic_layout(k, i), n_blocks, k, device=dev)
    streamed_ms = (time.perf_counter() - t0) * 1e3 / n_blocks
    if roots != serial:
        raise AssertionError("streamed data roots differ from the serial run")
    return {
        "metric": f"stream_blocks_per_sec_k{k}",
        "value": 1e3 / streamed_ms,
        "unit": "blocks/s",
        "device": _device_name(dev),
        "host_layout_ms": host_ms,
        "device_ms": device_ms,
        "serial_ms": host_ms + device_ms,
        "streamed_ms": streamed_ms,
    }


def bench_stream_batched(k: int = 128, batch: int = 4, n_batches: int = 3, device=None) -> dict:
    """Batched streaming on one card: one dispatch per batch of B squares
    (`eds.pipeline_batched`) with the host layout of batch i+1 overlapped.
    One JSON-able dict; times are host seconds."""
    dev = device_mod.resolve(device)

    def layout(i: int) -> np.ndarray:
        return np.stack([_synthetic_layout(k, i * batch + j) for j in range(batch)])

    # first-use set-up out of the timing
    xfer.to_host(eds_mod.pipeline_batched(xfer.to_device(layout(0), "streaming.dispatch", device=dev), dev)[3],
                 "streaming.warm")
    t0 = time.perf_counter()
    roots = _stream_batches(layout, n_batches, device=dev)
    dt = time.perf_counter() - t0
    n_blocks = batch * n_batches
    if len(roots) != n_blocks:
        raise AssertionError(f"{len(roots)} data roots for {n_blocks} blocks")
    return {
        "metric": f"stream_batched_blocks_per_sec_k{k}",
        "value": n_blocks / dt,
        "unit": "blocks/s",
        "device": _device_name(dev),
        "batch": batch,
        "blocks": n_blocks,
        "elapsed_s": dt,
    }
