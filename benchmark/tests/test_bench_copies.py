"""The reader of ``metrics/host.pageable_copy_ms_per_block`` on a
hand-built plain segment: only the memcpys whose trace name says
``Pageable`` count, clipped to the window, per block."""

from __future__ import annotations

import types

import pytest

from benchmark import spec, trace
from benchmark.tests.tiny import BENCH

NAME = "host.pageable_copy_ms_per_block"

# (card, start, duration, name), in us
OPS = [(0, 100, 300, "Memcpy DtoH (Device -> Pageable)"),
       (0, 500, 40, "Memcpy DtoH (Device -> Pinned)"),
       (0, 600, 25, "Memcpy HtoD (Pageable -> Device)"),
       (0, 640, 10, "Memcpy HtoD (Pinned -> Device)"),
       (0, 700, 90, "void gf16_mix_kernel<int>(int*)"),
       (0, 800, 5, "Memset (Device)"),
       (1, 950, 100, "Memcpy DtoH (Device -> Pageable)")]  # half past the window's end


def read(ops, blocks: int = 2):
    seg = trace.Segment((0.0, 1000.0), [trace.Op(card, start, dur, name, None) for card, start, dur, name in ops])
    ctx = types.SimpleNamespace(plain=seg, plain_blocks=blocks, chips=2)
    return spec.load_reader(BENCH / "metrics" / f"{NAME}.py")(ctx)


def test_only_pageable_memcpys_count_per_block():
    assert read(OPS) == pytest.approx((300 + 25 + 50) / 1e3 / 2)


def test_pinned_copies_and_kernels_alone_read_zero():
    assert read([op for op in OPS if "Pageable" not in op[3]]) == 0.0


@pytest.mark.parametrize("ops, blocks", [([], 2), (OPS, 0)])
def test_no_device_operation_or_no_block_reads_nothing(ops, blocks):
    assert read(ops, blocks) is None
