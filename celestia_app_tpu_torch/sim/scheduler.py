"""Seeded discrete-event scheduler: the simulation's one timeline.
The port of celestia_app_tpu/sim/scheduler.py (host code, copied).

A classic event-heap simulator with one deliberate twist: *concurrent*
events (equal firing times) are ordered by a tiebreak drawn from the
scheduler's own seeded rng at schedule time, not by insertion order. Two
runs with the same seed therefore execute the identical event sequence
(byte-identical trace); two runs with different seeds explore different
interleavings of the same concurrent events — exactly the adversarial
reordering the consensus and DAS planes must be invariant to (the
fault-free cross-seed app-hash pin in tests/test_scenarios.py).

Events run to completion on the caller's thread; there is no real
concurrency anywhere in a simulation, which is what makes hundreds of
nodes deterministic in one process. Callbacks may advance the clock
further (a DASer retry backoff sleeps virtual seconds mid-event) and may
schedule new events at or after the current instant.

The execution trace (``(time, label)`` per executed event, plus any
``note()`` rows callbacks append) is the determinism witness: its sha256
is part of every scenario verdict.
"""

from __future__ import annotations

import hashlib
import heapq
import random

from celestia_app_tpu_torch.utils.clock import VirtualClock


class Scheduler:
    """One seeded event heap bound to one VirtualClock."""

    def __init__(self, seed: int, epoch: float = 1_700_000_000.0):
        self.seed = seed
        self.clock = VirtualClock(epoch=epoch)
        # seeded at construction from the scenario seed: THE one entropy
        # root of a simulation (det-rng scope pins that nothing else in
        # sim/ draws ambient randomness)
        self.rng = random.Random(seed)  # lint: disable=det-rng
        # (time, tiebreak, seq, label, fn) — seq is the last-resort
        # total-order key so equal (time, tiebreak) pairs cannot compare
        # the (uncomparable) callbacks
        self._heap: list[tuple] = []
        self._seq = 0
        self.executed = 0
        self.trace: list[tuple[float, str]] = []
        # the digest streams: every trace row folds into this running
        # sha256 at append time, so `trace` itself can be bounded
        # (trace_keep) on network-scale runs (1000+ lights emit millions
        # of rows) without weakening the determinism witness
        self._trace_hash = hashlib.sha256()
        self.trace_keep = 0  # keep only the newest N rows (0=unbounded)

    # -- scheduling ------------------------------------------------------

    def call_at(self, t: float, fn, label: str = "") -> None:
        t = max(t, self.clock.monotonic())
        heapq.heappush(
            self._heap, (t, self.rng.random(), self._seq, label, fn)
        )
        self._seq += 1

    def call_after(self, dt: float, fn, label: str = "") -> None:
        self.call_at(self.clock.monotonic() + max(dt, 0.0), fn, label)

    # -- the run loop ----------------------------------------------------

    def _trace_row(self, t: float, label: str) -> None:
        self._trace_hash.update(f"{t:.9f} {label}\n".encode())
        self.trace.append((t, label))
        if self.trace_keep > 0 and len(self.trace) > 2 * self.trace_keep:
            del self.trace[:len(self.trace) - self.trace_keep]

    def note(self, label: str) -> None:
        """Append a trace row at the current instant (scenario hooks and
        node decisions use this so verdict-relevant transitions are part
        of the determinism witness, not only event firings)."""
        self._trace_row(round(self.clock.monotonic(), 9), label)

    def run(self, until: float, max_events: int = 2_000_000) -> None:
        """Execute events in (time, tiebreak, seq) order until the heap
        drains, simulated time passes `until`, or the event bound trips
        (a runaway-feedback backstop, far above any real scenario)."""
        while self._heap and self.executed < max_events:
            t, _tie, _seq, label, fn = self._heap[0]
            if t > until:
                break
            heapq.heappop(self._heap)
            self.clock.advance_to(t)
            self.executed += 1
            if label:
                self._trace_row(round(t, 9), label)
            fn()
        if (self.executed >= max_events and self._heap
                and self._heap[0][0] <= until):
            # only a run that still HAD due work when the bound tripped
            # is a runaway; landing exactly on the bound with a drained
            # (or post-horizon) heap is a completed run
            raise RuntimeError(
                f"scheduler exceeded {max_events} events before t={until}"
            )
        self.clock.advance_to(until)

    # -- the determinism witness ----------------------------------------

    def trace_digest(self) -> str:
        """sha256 over EVERY row ever appended (streamed, so bounding
        `trace` via trace_keep never changes the digest)."""
        return self._trace_hash.copy().hexdigest()
