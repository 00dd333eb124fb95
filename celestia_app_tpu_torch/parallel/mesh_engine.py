"""The mesh plane: sharded EDS production as an engine, and the batched
block dispatch. The port of celestia_app_tpu/parallel/mesh_engine.py.

- **Engine selection.** ``edscache.compute_entry(mesh=...)`` routes
  through here. A `Mesh` is the reference's ``engine="mesh"``: every
  square its devices can shard goes through the sharded pipeline
  (parallel/sharded_eds.py). ``mesh=None`` is the reference's auto rule: a
  square of ``k >= DEFAULT_MESH_MIN_K`` on a card takes the mesh when
  `mesh_for` finds two or more distinct visible cards. On one card, or on
  the CPU, nothing shards on its own, as the reference's one-device
  process does not. The reference's CELESTIA_MESH_MIN_K and
  CELESTIA_MESH_DEVICES settings are the constant `DEFAULT_MESH_MIN_K` and
  the ``mesh=`` argument; no environment variable is read.

- **No fallback.** A mesh failure raises. Only a square the mesh cannot
  shard (k = 1, or no power-of-two seq extent of two or more that divides
  k) takes the one-device path.

- **Device-resident entries.** `compute_entry_mesh` returns a
  ``da/edscache.DeviceEntry``: the sharded pipeline assembles the row
  shards of the EDS on the mesh's lead device, device to device, and only
  the axis roots and the data root come to the host (``mesh.entry_
  commitments``). Nothing else crosses until a proof needs it.

- **Batched dispatch.** `compute_entries_batched` extends B squares in one
  dispatch (over the mesh's ``data`` axis when a mesh is active for the
  size, else `da/eds.pipeline_batched` on one device) and returns one
  device-resident entry per block; chain/producer.py feeds it the produce
  loop's planned squares.

- **Batch sharding.** `maybe_shard_batch` splits a batch of axes over the
  flat device list of the mesh when the plane is active for the square
  size; `ops/rs.RepairAxes` and `ops/nmt.eds_axis_roots` run each part on
  its own device (K2 and K1 per part) and `gather` the results on the
  caller's device, so the bytes are those of one device by construction.

Telemetry (the reference's names): ``da.extend_runs``,
``mesh.batched_dispatches``, ``mesh.batched_blocks``, ``mesh.batch_shards``
and the ``mesh.batched_dispatch`` timer; transfer-ledger sites
``mesh.shard_batch``, ``mesh.sharded_dispatch``, ``mesh.batched_dispatch``,
``mesh.batched_commitments`` and ``mesh.entry_commitments``.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch import device as device_mod
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.da import edscache
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.parallel import mesh as mesh_mod
from celestia_app_tpu_torch.parallel import sharded_eds
from celestia_app_tpu_torch.utils import telemetry

# the smallest square the auto rule shards. The reference's default is 256;
# over four H100s a sharded k = 256 square is slower than one card's
# pipeline and a k = 512 square faster (PERF.md section 5)
DEFAULT_MESH_MIN_K = 512


def _devices(mesh: mesh_mod.Mesh | None = None, device=None) -> tuple[torch.device, ...]:
    """The devices the plane may use: an explicit mesh's (repeats kept);
    else every visible card when the caller works on a card; else none."""
    if mesh is not None:
        return mesh.flat
    if device is not None and torch.device(device).type != "cuda":
        return ()
    return tuple(mesh_mod.visible_cards())


def mesh_for(k: int, devices=None) -> mesh_mod.Mesh | None:
    """The mesh size-k squares run on, or None when they cannot shard over
    at least two devices (k = 1, or fewer than two devices). `devices`
    defaults to the visible cards. The device count is cut to the largest
    power of two whose seq extent divides k, so a single square lands on a
    data = 1 mesh."""
    devices = list(_devices() if devices is None else devices)
    seq = 1
    while seq * 2 <= len(devices) and k % (seq * 2) == 0:
        seq *= 2
    if seq < 2:
        return None
    return mesh_mod.make_mesh(seq, k=k, devices=devices)


def mesh_for_batch(k: int, b: int, devices=None) -> mesh_mod.Mesh | None:
    """Mesh for a B-block batched dispatch: the largest power-of-two count
    of the devices when B divides its ``data`` extent (blocks over
    ``data``, rows over ``seq``), else the single-square mesh."""
    devices = list(_devices() if devices is None else devices)
    p = 1
    while p * 2 <= len(devices):
        p *= 2
    if p >= 2:
        full = mesh_mod.make_mesh(p, k=k, devices=devices)
        if b % full.shape[mesh_mod.DATA_AXIS] == 0:
            return full
    return mesh_for(k, devices)


def card_mesh() -> mesh_mod.Mesh | None:
    """A mesh over every visible card, or None with fewer than two (the
    command line's ``--device mesh``: the reference's ``--engine mesh``,
    which on one device runs the one-device path)."""
    cards = _devices()
    return mesh_mod.make_mesh(devices=cards) if len(cards) >= 2 else None


def mesh_active_for(k: int, mesh: mesh_mod.Mesh | None = None, device=None) -> bool:
    """True iff size-k squares (and their repair and root batches) go
    through the mesh: an explicit mesh that can shard them, or, with
    ``mesh=None``, k >= DEFAULT_MESH_MIN_K on a card with two or more
    cards visible."""
    if mesh is None and k < DEFAULT_MESH_MIN_K:
        return False
    return mesh_for(k, _devices(mesh, device)) is not None


def maybe_shard_batch(batch, k: int, mesh: mesh_mod.Mesh | None = None, device=None
                      ) -> list[torch.Tensor] | None:
    """A batch of axes (numpy, or a tensor) split into equal parts, one per
    device of the flat device list, when the mesh plane is active for
    square size k and the batch divides evenly; else None (the caller runs
    its one-device dispatch). A host batch crosses through the transfer
    ledger (``mesh.shard_batch``); a tensor is sliced and copied device to
    device (a view where the part stays on its device)."""
    if not mesh_active_for(k, mesh, device):
        return None
    devices = _devices(mesh, device)
    n, n_dev = int(batch.shape[0]), len(devices)
    if n_dev < 2 or n < n_dev or n % n_dev:
        return None
    per = n // n_dev
    parts = []
    for i, dev in enumerate(devices):
        part = batch[i * per:(i + 1) * per]
        if isinstance(part, torch.Tensor):
            parts.append(part.to(dev, non_blocking=True))
        else:
            parts.append(xfer.to_device(np.ascontiguousarray(part), "mesh.shard_batch", device=dev))
    telemetry.incr("mesh.batch_shards")
    return parts


def gather(parts: list[torch.Tensor], device) -> torch.Tensor:
    """The per-device results of a sharded batch, concatenated in order on
    `device`, device to device."""
    dev = device_mod.concrete(device)
    return torch.cat([p.to(dev, non_blocking=True) for p in parts])


# ---------------------------------------------------------------------------
# entry construction: the ODS -> device-resident entry dispatch
# ---------------------------------------------------------------------------


def compute_entry_mesh(ods, mesh: mesh_mod.Mesh | None = None) -> edscache.DeviceEntry:
    """ODS -> device-resident entry through the sharded pipeline over the
    mesh `mesh_for(k)` cuts from `mesh`'s devices (default: the visible
    cards). The EDS is assembled on the lead device; the roots and the
    data root come to the host. Raises where the square cannot shard."""
    k = int(ods.shape[0])
    m = mesh_for(k, None if mesh is None else mesh.flat)
    if m is None:
        raise RuntimeError(f"the mesh engine needs a seq extent >= 2 that divides k = {k}")
    eds, rows, cols, roots = sharded_eds.sharded_pipeline(m, ods[None])
    rows_h, cols_h, root_h = xfer.to_host((rows[0], cols[0], roots[0]), "mesh.entry_commitments")
    return _device_entry(eds[0], rows_h, cols_h, root_h)


def compute_entries_batched(ods_batch, device=None, mesh: mesh_mod.Mesh | None = None
                            ) -> list[edscache.DeviceEntry]:
    """(B, k, k, 512) uint8 -> B device-resident entries from one batched
    dispatch. Each entry's data root equals one `eds.pipeline` call's.
    Counts ``da.extend_runs`` once per block and one
    ``mesh.batched_dispatches``.

    The sharded pipeline runs when a mesh is active for k: with an explicit
    `mesh` (the reference's ``engine="mesh"``), whenever its devices can
    shard the batch; with ``mesh=None``, by the auto rule (k >=
    DEFAULT_MESH_MIN_K and two or more cards). Otherwise the batch runs on
    `device` (the card unless the caller asks for the CPU), or on the
    mesh's lead device, through `da/eds.pipeline_batched`."""
    b, k = int(ods_batch.shape[0]), int(ods_batch.shape[1])
    dev = device_mod.resolve(device) if mesh is None else mesh.lead
    m = mesh_for_batch(k, b, _devices(mesh, dev))
    t0 = telemetry.start_timer()
    if m is not None and (mesh is not None or k >= DEFAULT_MESH_MIN_K):
        eds, rows, cols, roots = sharded_eds.sharded_pipeline(m, ods_batch)
    else:
        eds, rows, cols, roots = eds_mod.pipeline_batched(
            eds_mod.ods_on_device(ods_batch, dev, "mesh.batched_dispatch"), dev)
    # one host copy for the whole batch's commitments; the squares stay
    rows_h, cols_h, roots_h = xfer.to_host((rows, cols, roots), "mesh.batched_commitments")
    telemetry.incr("da.extend_runs", b)
    telemetry.incr("mesh.batched_dispatches")
    telemetry.incr("mesh.batched_blocks", b)
    telemetry.measure_since("mesh.batched_dispatch", t0)
    return [_device_entry(eds[i], rows_h[i], cols_h[i], roots_h[i]) for i in range(b)]


def _device_entry(eds_dev: torch.Tensor, rows: np.ndarray, cols: np.ndarray, root: np.ndarray
                  ) -> edscache.DeviceEntry:
    """A DeviceEntry from a device square and its host commitments."""
    dah = DataAvailabilityHeader(row_roots=tuple(bytes(r) for r in rows),
                                 col_roots=tuple(bytes(c) for c in cols))
    return edscache.DeviceEntry(eds_dev, dah, bytes(root))
