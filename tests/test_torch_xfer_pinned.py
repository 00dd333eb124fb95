"""Pinned downloads in the port's transfer ledger (`obs.xfer.to_host`).

A CUDA tensor of `xfer.PINNED_MIN_BYTES` or more comes down into a
page-locked block from torch's caching host allocator, which the returned
array owns; everything else keeps the plain ``.cpu().numpy()`` path. The
CPU tests hold the rule and the plain path; the card tests skip without a
card and run on a machine with one as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_xfer_pinned.py

(``--noconftest``: this file imports no JAX, and the directory's conftest
does).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from celestia_app_tpu_torch.obs import xfer
from celestia_app_tpu_torch.utils import telemetry

MIB = 1 << 20


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def counter(name: str, site: str) -> int:
    return telemetry.snapshot()["counters"].get(f'{name}{{site="{site}"}}', 0)


def delta(before: dict) -> dict:
    return {key: value - before[key] for key, value in xfer.totals().items()}


# -- the rule and the plain path (CPU) ----------------------------------------


@pytest.mark.parametrize("device_type, nbytes, pinned", [
    ("cuda", MIB - 1, False), ("cuda", MIB, True), ("cuda", 512 * MIB, True),
    ("cpu", MIB - 1, False), ("cpu", MIB, False), ("cpu", 512 * MIB, False),
])
def test_the_path_rule_reads_the_device_type_and_the_size(device_type, nbytes, pinned):
    assert xfer.PINNED_MIN_BYTES == MIB
    assert xfer.pinned_download(device_type, nbytes) is pinned


def test_cpu_tensors_and_numpy_leaves_keep_the_plain_path():
    big = torch.arange(2 * MIB, dtype=torch.int32).to(torch.uint8)  # over the threshold, on the CPU
    small = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    leaf = np.arange(2 * MIB, dtype=np.uint8)
    want = (big.cpu().numpy(), small.cpu().numpy(), np.asarray(leaf))
    before = xfer.totals()
    got = xfer.to_host((big, small, leaf), "xfer_pinned.cpu")
    d = delta(before)
    assert isinstance(got, tuple) and len(got) == 3
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # as before: a CPU tensor's array shares its memory, a numpy leaf comes back itself
    assert np.shares_memory(got[0], big.numpy()) and np.shares_memory(got[1], small.numpy())
    assert got[2] is leaf
    assert d["d2h_bytes"] == 2 * MIB + 96 + 2 * MIB and d["d2h_calls"] == 1
    assert d["d2h_pinned_bytes"] == 0
    assert counter("xfer.d2h_pinned_bytes", "xfer_pinned.cpu") == 0
    assert counter("xfer.d2h_pinned_calls", "xfer_pinned.cpu") == 0


def test_totals_carry_the_pinned_bytes():
    t = xfer.totals()
    assert isinstance(t["d2h_pinned_bytes"], int) and t["d2h_pinned_bytes"] <= t["d2h_bytes"]
    # the per-block gauge's monotone is unchanged: both directions, pinned or not
    assert xfer.bytes_crossed() == t["h2d_bytes"] + t["d2h_bytes"]


# -- on the card ---------------------------------------------------------------


def random_bytes(shape, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=g)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_a_large_download_is_pinned_and_byte_equal(card, layout):
    src = random_bytes((2048, 2048), card, 1)  # 4 MiB
    if layout == "strided":
        src = src.t()
    want = src.cpu().numpy()
    before = xfer.totals()
    out = xfer.to_host(src, "xfer_pinned.one")
    assert isinstance(out, np.ndarray) and out.flags.c_contiguous
    np.testing.assert_array_equal(out, want)
    shared = torch.from_numpy(out)
    assert shared.is_pinned() and isinstance(out.base, torch.Tensor) and out.base.is_pinned()
    assert shared.data_ptr() == out.base.data_ptr()
    d = delta(before)
    assert d["d2h_pinned_bytes"] == d["d2h_bytes"] == 4 * MIB
    assert counter("xfer.d2h_pinned_calls", "xfer_pinned.one") >= 1


def test_each_array_owns_its_block(card):
    src = random_bytes((3 * MIB,), card, 2)
    first = xfer.to_host(src, "xfer_pinned.own")
    kept = first.copy()
    src.fill_(7)  # overwrite the source on the card
    torch.cuda.synchronize()
    np.testing.assert_array_equal(first, kept)
    second = xfer.to_host(src, "xfer_pinned.own")  # the same size again
    np.testing.assert_array_equal(first, kept)
    assert (second == 7).all() and not np.shares_memory(first, second)


def test_freed_blocks_are_reused(card):
    src = random_bytes((5 * MIB,), card, 3)
    xfer.to_host(src, "xfer_pinned.reuse")  # the first block of this size
    stats = getattr(torch.cuda, "host_memory_stats", None)
    allocs0 = stats().get("num_host_alloc") if stats else None
    pointers = set()
    for _ in range(20):
        out = xfer.to_host(src, "xfer_pinned.reuse")
        pointers.add(out.ctypes.data)
        del out
    assert len(pointers) <= 2
    if allocs0 is not None:
        assert stats()["num_host_alloc"] - allocs0 <= 2


def test_to_host_passes_the_residency_pin(card):
    big = random_bytes((2 * MIB,), card, 4)
    small = random_bytes((64,), card, 5)
    with xfer.no_implicit_transfers():
        got_big, got_small = xfer.to_host((big, small), "xfer_pinned.pin")
        with pytest.raises(xfer.ImplicitTransferError):
            big.cpu()
    np.testing.assert_array_equal(got_big, big.cpu().numpy())
    np.testing.assert_array_equal(got_small, small.cpu().numpy())
    assert torch.from_numpy(got_big).is_pinned() and not torch.from_numpy(got_small).is_pinned()


def test_an_entrys_tuple_pins_only_its_square(card):
    """What `edscache.compute_entry` hands over: the k = 32 EDS (2 MiB),
    its row and column roots and the data root."""
    eds = random_bytes((64, 64, 512), card, 6)
    rows, cols = random_bytes((64, 90), card, 7), random_bytes((64, 90), card, 8)
    root = random_bytes((32,), card, 9)
    before = xfer.totals()
    pinned0 = counter("xfer.d2h_pinned_bytes", "xfer_pinned.entry")
    got = xfer.to_host((eds, rows, cols, root), "xfer_pinned.entry")
    d = delta(before)
    assert isinstance(got, tuple) and len(got) == 4
    for g, t in zip(got, (eds, rows, cols, root)):
        np.testing.assert_array_equal(g, t.cpu().numpy())
    assert [torch.from_numpy(g).is_pinned() for g in got] == [True, False, False, False]
    assert d["d2h_bytes"] == 2 * MIB + 2 * 64 * 90 + 32 and d["d2h_calls"] == 1
    assert d["d2h_pinned_bytes"] == 2 * MIB
    assert counter("xfer.d2h_pinned_bytes", "xfer_pinned.entry") - pinned0 == 2 * MIB
