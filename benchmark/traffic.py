"""The one general traffic driver: a closed loop of calls into one entry of
the program, shaped by a mix's parameters (``traffic/<name>.json``):

  loop          "closed", the one loop the driver runs: the next call goes
                when the last one's entries are back
  entry         the program's function, dotted under its package, called
                as ``entry(ods, device)``, or for a withheld square as
                ``entry(symbols, present, row_roots, col_roots, device=device)``
  handover      "withheld-quadrant": each call hands over one block's
                extended square with three quadrants withheld
                (inputs/withheld.py) and takes back the repaired (2k, 2k,
                512) host square; without the key, the ODS
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
``data_root``; a repaired square is read as the entry's square beside the
commitments handed over. Each square handed over carries a new stamp
(inputs/pool.py), its block's sequence number.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable

import numpy as np
import torch

from benchmark import trace
from benchmark.inputs.pool import Pool
from benchmark.inputs.withheld import Withheld

PACKAGE = "celestia_app_tpu_torch"
MASK64 = 2**64 - 1


def resolve_entry(traffic: dict) -> Callable:
    module, fn = traffic["entry"].rsplit(".", 1)
    return getattr(importlib.import_module(f"{PACKAGE}.{module}"), fn)


class Driver:
    """`device` is what the entry is given; `devices` are the cards of the
    run (the first prepares a withheld square's hand-overs)."""

    def __init__(self, traffic: dict, pool: Pool, device, entry: Callable | None = None, seed: int = 0,
                 devices: tuple = (torch.device("cpu"),)):
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
        self.withheld = None
        handover = traffic.get("handover", "ods")
        if handover == "withheld-quadrant":
            if self.batched:
                raise ValueError(f"mix {traffic['name']}: a withheld square goes one to a call")
            self.withheld = Withheld(pool, seed, devices[0], int(traffic["warm_calls"]))
        elif handover != "ods":
            raise ValueError(f"mix {traffic['name']}: no hand-over {handover!r}")
        # a withheld square's preparation uses the card too, so the peak is
        # taken over the calls alone: reset before each, read after it
        self.cards = [d for d in devices if d.type == "cuda"] if self.withheld else []
        self.peak = 0

    def ready(self, calls: int) -> None:
        """Prepare the hand-overs of the next `calls` calls now, so that a
        traced segment holds none of that work."""
        if self.withheld is not None:
            with torch.profiler.record_function(trace.PREPARE):
                self.withheld.fill(self.seq + calls)

    def take_peak(self) -> int | None:
        """The largest card's allocated-memory peak within the calls since
        the last take, where the driver reads it (a withheld square's
        mix on cards); None where the run reads it itself."""
        if not self.cards:
            return None
        peak, self.peak = self.peak, 0
        return peak

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
        if self.withheld is not None:
            return self._call_withheld(*blocks[0])
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

    def _call_withheld(self, seq: int, index: int) -> tuple[list[tuple[int, int]], list, float]:
        with torch.profiler.record_function(trace.PREPARE):
            args, entry = self.withheld.hand_over(seq, index)
        for card in self.cards:
            torch.cuda.reset_peak_memory_stats(card)
        t0 = time.perf_counter()
        entry.eds.squares = self.entry(*args, device=self.device)
        seconds = time.perf_counter() - t0
        self.peak = max([self.peak] + [torch.cuda.max_memory_allocated(card) for card in self.cards])
        return [(seq, index)], [entry], seconds

    def altered_roots(self, seq: int, seed: int) -> list[str]:
        """Call the entry on block `seq`'s hand-over, prepared afresh, once
        with each of four roots altered in one bit: a row root and a column
        root in each half of the square, the roots and bits drawn from the
        seed. Returns what each call did: the name of what it raised, or
        "accepted" where it returned."""
        (symbols, present, *roots), _ = self.withheld.hand_over_again(seq)
        rng = np.random.default_rng([seed & MASK64, 0xA17E])
        k = self.withheld.k
        out = []
        for axis in (0, 1):
            for half in (0, 1):
                altered = [list(r) for r in roots]
                i = half * k + int(rng.integers(0, k))
                root = bytearray(altered[axis][i])
                bit = int(rng.integers(0, 8 * len(root)))
                root[bit // 8] ^= 1 << (bit % 8)
                altered[axis][i] = bytes(root)
                try:
                    self.entry(symbols, present, tuple(altered[0]), tuple(altered[1]), device=self.device)
                except Exception as e:  # the entry refused the hand-over, as it should
                    out.append(type(e).__name__)
                else:
                    out.append("accepted")
        return out
