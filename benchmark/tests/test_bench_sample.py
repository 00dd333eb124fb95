"""The sample the check reads: drawn from the seed, and holding nothing of
the program on a card (a sampled device entry's square is copied into a
slot allocated in set-up, its commitments kept on the host)."""

from __future__ import annotations

import gc
import types
import weakref

import numpy as np
import torch

from benchmark import check, harness


class _DeviceEntry:
    def __init__(self, seq: int, k: int = 2):
        self._eds_dev = torch.full((2 * k, 2 * k, 512), seq % 251, dtype=torch.uint8)
        self.dah = types.SimpleNamespace(row_roots=(bytes([seq % 256]) * 90,) * 2 * k,
                                         col_roots=(bytes([seq % 256]) * 90,) * 2 * k)
        self.data_root = bytes([seq % 256]) * 32


def _reservoir(size: int, seed: int, n: int) -> list[int]:
    """The plain reservoir's draw of `n` items, by index."""
    rng = np.random.default_rng([seed & harness.MASK64, 0x5EED])
    items: list[int] = []
    for i in range(n):
        if len(items) < size:
            items.append(i)
        else:
            j = int(rng.integers(0, i + 1))
            if j < size:
                items[j] = i
    return items


def test_a_sampled_device_entry_leaves_only_its_squares_copy():
    seed, size, n = 2**33 + 77, 4, 60
    sample = harness.Sample(size, seed)
    sample.prepare(_DeviceEntry(0))
    assert sample.slots is not None and sample.slots.shape == (size, 4, 4, 512)
    refs = []
    for seq in range(1, n + 1):
        entry = _DeviceEntry(seq)
        refs.append(weakref.ref(entry))
        sample.offer(seq, 0, entry)
        del entry
    gc.collect()
    assert all(r() is None for r in refs)  # no entry is held
    kept = [seq for seq, _, _, _ in sample.items]
    assert kept == [i + 1 for i in _reservoir(size, seed, n)]
    for (seq, _, got) in sample.outputs(print):
        want = _DeviceEntry(seq)
        assert isinstance(got, check.Outputs)
        assert np.array_equal(got.eds, want._eds_dev.numpy()) and got.data_root == want.data_root
        assert got.row_roots == list(want.dah.row_roots)
    assert sample.slots is None and not sample.items


def test_a_host_entry_is_kept_whole_and_no_slot_is_made():
    sample = harness.Sample(2, 5)
    host = types.SimpleNamespace(eds=types.SimpleNamespace(squares=np.zeros((4, 4, 512), np.uint8)),
                                 dah=types.SimpleNamespace(row_roots=(b"r",) * 4, col_roots=(b"c",) * 4),
                                 data_root=b"d" * 32)
    sample.prepare(host)
    sample.offer(1, 0, host)
    assert sample.slots is None and sample.held == {} and sample.items[0][2] is host
