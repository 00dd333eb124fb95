"""Device meshes for the sharded DA pipeline: the port of
celestia_app_tpu/parallel/mesh.py.

Two logical axes, as in the reference:

- ``data`` — block-level data parallelism: independent squares of a batch
  land on different rows of the mesh.
- ``seq``  — the rows of one square are split across the devices of a mesh
  row; the row/column duality of the 2D RS code becomes two transposes
  over this axis (parallel/sharded_eds.py).

`make_mesh` factors the devices into (data, seq) with the reference's rule:
``seq`` is the largest power of two that divides both the device count and
the square size k, and the rest goes to ``data``.

The reference's `Mesh` is jax's, over a process's ``jax.devices()``; here a
`Mesh` is a (data, seq) grid of ``torch.device``s driven from one process.
A mesh may name one device more than once: ``[torch.device("cpu")] * 8`` is
how the tests run it, ``[cuda:0] * n`` how one card runs n shards.
"""

from __future__ import annotations

import dataclasses

import torch

from celestia_app_tpu_torch import device as device_mod

DATA_AXIS = "data"
SEQ_AXIS = "seq"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, seq) grid of devices: ``devices[d][s]`` runs seq shard s of
    the squares of data row d."""

    devices: tuple[tuple[torch.device, ...], ...]

    def __post_init__(self):
        if not self.devices or not self.devices[0] or len({len(r) for r in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), SEQ_AXIS: len(self.devices[0])}

    @property
    def flat(self) -> tuple[torch.device, ...]:
        """Every device of the grid, row by row (repeats kept)."""
        return tuple(d for row in self.devices for d in row)

    @property
    def lead(self) -> torch.device:
        """The device that gathers what the mesh gives back: devices[0][0]."""
        return self.devices[0][0]

    @property
    def size(self) -> int:
        return len(self.flat)


def _largest_pow2_divisor(n: int) -> int:
    p = 1
    while n % (2 * p) == 0:
        p *= 2
    return p


def factor(n_devices: int, k: int | None = None) -> tuple[int, int]:
    """(data, seq) of a mesh of `n_devices`: ``seq`` is the largest power
    of two that divides `n_devices` and, when given, `k`; ``data`` the
    rest."""
    seq = _largest_pow2_divisor(n_devices)
    if k is not None:
        while seq > 1 and k % seq != 0:
            seq //= 2
    return n_devices // seq, seq


def visible_cards() -> list[torch.device]:
    """Every card this process sees, each once (``cuda:0`` .. ``cuda:n-1``)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, *, k: int | None = None, devices=None) -> Mesh:
    """A (data, seq) mesh over the first `n_devices` of `devices` (default:
    every visible card; RuntimeError where there is none).

    ``seq`` takes the largest power-of-two factor of `n_devices` that still
    divides `k` (when given), so the rows of a k x k square split exactly;
    ``data`` takes the rest."""
    if devices is None:
        devices = visible_cards()
        if not devices:
            raise RuntimeError("no CUDA device: pass devices=[...] to build a mesh elsewhere")
    devices = [device_mod.concrete(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices must be in 1..{len(devices)}, got {n_devices}")
    devices = devices[:n_devices]
    data, seq = factor(n_devices, k)
    return Mesh(tuple(tuple(devices[d * seq:(d + 1) * seq]) for d in range(data)))
