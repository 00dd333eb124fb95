"""The one general traffic driver: a closed loop of calls into one entry of
the program, shaped by a mix's parameters (``traffic/<name>.json``):

  loop          "closed", the one loop the driver runs: the next call goes
                when the last one's entries are back
  entry         the program's function, dotted under its package, called
                as ``entry(ods, device)``
  batched       true: each call hands over a (batch, k, k, 512) host array
                and takes back one entry per square; false: a (k, k, 512)
                host array and one entry
  batch         squares per call
  pool          squares laid out in set-up (at least ``batch``)
  warm_calls    calls made in set-up, before the window
  trace_calls   calls in each traced segment of a ``--trace 1`` run
  check_blocks  blocks whose outputs the reference checks, drawn from the seed

An entry is anything with the rs2d entry's fields: ``eds`` (a host square
with ``squares``), ``dah`` (``row_roots``, ``col_roots``) and
``data_root``. Each square handed over carries a new stamp
(inputs/pool.py), its block's sequence number.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable

import numpy as np

from benchmark.inputs.pool import Pool

PACKAGE = "celestia_app_tpu_torch"


def resolve_entry(traffic: dict) -> Callable:
    module, fn = traffic["entry"].rsplit(".", 1)
    return getattr(importlib.import_module(f"{PACKAGE}.{module}"), fn)


class Driver:
    def __init__(self, traffic: dict, pool: Pool, device, entry: Callable | None = None):
        if traffic["loop"] != "closed":
            raise ValueError(f"mix {traffic['name']}: the driver runs closed loops, not {traffic['loop']!r}")
        self.batched = bool(traffic["batched"])
        self.batch = int(traffic["batch"])
        if len(pool) < self.batch or (not self.batched and self.batch != 1):
            raise ValueError(f"mix {traffic['name']}: pool {len(pool)}, batch {self.batch}, "
                             f"batched {self.batched}")
        self.pool = pool
        self.device = device
        self.entry = entry or resolve_entry(traffic)
        self.seq = 0  # the last block's sequence number; stamps start at 1
        self.cursor = 0  # the next pool square

    def _next(self) -> tuple[int, int]:
        self.seq += 1
        index = self.cursor
        self.cursor = (self.cursor + 1) % len(self.pool)
        self.pool.stamp(index, self.seq)
        return self.seq, index

    def call(self) -> tuple[list[tuple[int, int]], list, float]:
        """One call: stamp, hand over, wait for the entries. Returns the
        blocks as (sequence number, pool index), their entries, and the
        call's seconds from hand-over to its entries."""
        blocks = [self._next() for _ in range(self.batch)]
        if not self.batched:
            arg = self.pool.squares[blocks[0][1]]
        elif self.batch == len(self.pool):
            arg = self.pool.squares
        else:
            arg = np.stack([self.pool.squares[i] for _, i in blocks])
        t0 = time.perf_counter()
        out = self.entry(arg, self.device)
        seconds = time.perf_counter() - t0
        entries = list(out) if self.batched else [out]
        if len(entries) != len(blocks):
            raise RuntimeError(f"{len(blocks)} squares handed over, {len(entries)} entries back")
        return blocks, entries, seconds
