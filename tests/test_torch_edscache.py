"""The port's block cache against the JAX package (tolerance: exact): cache
keys, compute_entry's square and roots, the column prover's levels and
roots_only; and the LRU's count and byte eviction, lookup by data root,
idempotent put, and provers built once under concurrent callers."""

import sys
import threading

import numpy as np
import pytest
import torch

from celestia_app_tpu.da import edscache as jax_edscache
from celestia_app_tpu_torch.da import dah, eds, edscache
from celestia_app_tpu_torch.utils import nmt_host
from test_torch_proof import KS, seeded_block


def _ods(k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, size=(k, k, 512), dtype=np.uint8)
    ods[..., :19] = 0
    return ods


@pytest.mark.parametrize("k", KS)
def test_cache_key_matches_reference(k):
    ods = _ods(k, seed=k)
    key = edscache.cache_key(ods)
    assert key == jax_edscache.cache_key(ods)
    # read-only and strided inputs hash their row-major bytes
    frozen = dah.shares_to_ods([ods[r, c].tobytes() for r in range(k) for c in range(k)])
    assert edscache.cache_key(frozen) == key
    assert edscache.cache_key(np.asfortranarray(ods)) == key
    other = ods.copy()
    other[-1, -1, -1] ^= 1
    assert edscache.cache_key(other) != key


@pytest.mark.parametrize("k", KS)
def test_compute_entry_matches_reference(k):
    _, _, ods = seeded_block(k)
    entry = edscache.compute_entry(ods, device="cpu")
    want = jax_edscache.compute_entry(ods, engine="device")
    np.testing.assert_array_equal(entry.eds.squares, want.eds.squares)
    assert (entry.dah.row_roots, entry.dah.col_roots) == (want.dah.row_roots, want.dah.col_roots)
    assert entry.data_root == want.data_root == entry.dah.hash()
    assert entry.k == k

    col = entry.get_col_prover(device="cpu")
    want_col = want.get_col_prover(engine="device")
    for level, want_level in zip(col.levels, want_col.levels):
        for got, exp in zip(level, want_level):
            np.testing.assert_array_equal(got, np.asarray(exp))
    w = 2 * k
    for c, r in [(0, 0), (0, w - 1), (w - 1, 0), (w - 1, w - 1), (k - 1, k), (k, k - 1)]:
        share, pf = col.prove_cell(c, r)  # column c, row r
        assert share == entry.eds.squares[r, c].tobytes()
        assert share == want_col.prove_cell(c, r)[0]
        ns = share[:29] if r < k and c < k else nmt_host.PARITY
        assert pf.verify(entry.dah.col_roots[c], [(ns, share)])


@pytest.mark.parametrize("k", [1, 4, 16])
def test_roots_only_matches_pipeline(k):
    ods = _ods(k, seed=10 + k)
    _, rows, cols, root = eds.pipeline(ods, device="cpu")
    got = eds.roots_only(ods, device="cpu")
    assert len(got) == 3
    for g, w in zip(got, (rows, cols, root)):
        assert torch.equal(g, w)


def _entries(n: int, k: int = 1):
    return [edscache.compute_entry(_ods(k, seed=s), device="cpu") for s in range(n)]


def test_lru_evicts_by_count_and_counts_hits():
    cache = edscache.EdsCache(max_entries=2)
    entries = _entries(3)
    keys = [bytes([i]) * 32 for i in range(3)]
    for key, entry in zip(keys[:2], entries[:2]):
        assert cache.put(key, entry) is entry
    assert cache.get(keys[0]) is entries[0]  # now the newest
    cache.put(keys[2], entries[2])
    assert len(cache) == 2 and cache.evictions == 1
    assert cache.get(keys[1]) is None  # the least recently used went
    assert cache.get(keys[0]) is entries[0] and cache.get(keys[2]) is entries[2]
    assert (cache.hits, cache.misses) == (3, 1)
    assert cache.lookup_root(entries[1].data_root) is None
    assert cache.lookup_root(entries[2].data_root) is entries[2]
    assert (cache.hits, cache.misses) == (3, 1)  # lookup_root counts neither
    assert cache.nbytes() == 2 * edscache.entry_nbytes(entries[0])
    cache.clear()
    assert len(cache) == 0 and cache.nbytes() == 0
    assert cache.lookup_root(entries[2].data_root) is None


def test_lru_evicts_by_bytes_and_keeps_the_newest():
    small, big = _entries(1, k=1)[0], _entries(1, k=4)[0]
    assert edscache.entry_nbytes(big) == 8 * 8 * 512 * 2
    cache = edscache.EdsCache(max_entries=8, max_bytes=edscache.entry_nbytes(big) - 1)
    cache.put(b"s" * 32, small)
    cache.put(b"b" * 32, big)  # alone over the byte cap: kept, the older one goes
    assert len(cache) == 1 and cache.evictions == 1
    assert cache.lookup_root(big.data_root) is big
    assert cache.nbytes() == edscache.entry_nbytes(big)


def test_put_is_idempotent():
    cache = edscache.EdsCache()
    first, second = _entries(1)[0], edscache.compute_entry(_ods(1, seed=0), device="cpu")
    assert first is not second and first.data_root == second.data_root
    assert cache.put(b"k" * 32, first) is first
    assert cache.put(b"k" * 32, second) is first
    assert len(cache) == 1 and cache.nbytes() == edscache.entry_nbytes(first)


def test_get_or_compute_encodes_once(monkeypatch):
    cache = edscache.EdsCache()
    ods = _ods(2, seed=5)
    calls = []
    real = edscache.compute_entry

    def counting(ods, device=None, scheme="rs2d-nmt"):
        calls.append(scheme)
        return real(ods, device, scheme)

    monkeypatch.setattr(edscache, "compute_entry", counting)
    entry = cache.get_or_compute(ods, device="cpu")
    assert cache.get_or_compute(ods.copy(), device="cpu") is entry
    assert calls == ["rs2d-nmt"] and (cache.hits, cache.misses) == (1, 1)
    assert cache.lookup_root(entry.data_root) is entry
    _, _, root = dah.new_dah_from_ods(ods, device="cpu")
    assert entry.data_root == root


def test_provers_built_once_under_concurrent_callers(monkeypatch):
    entry = edscache.compute_entry(_ods(4, seed=7), device="cpu")
    builds = []
    real = edscache.build_block_prover

    def counting(*args, **kwargs):
        builds.append(threading.get_ident())
        return real(*args, **kwargs)

    monkeypatch.setattr(edscache, "build_block_prover", counting)
    n = 12
    barrier = threading.Barrier(n)
    got: list = [None] * n

    def worker(i):
        barrier.wait(timeout=60)
        got[i] = entry.get_prover(device="cpu") if i % 2 else entry.get_col_prover(device="cpu")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 2
    assert all(p is got[1] for p in got[1::2]) and all(p is got[0] for p in got[0::2])
    assert got[0] is not got[1] and entry.warmed()
    entry.warm(device="cpu")
    assert len(builds) == 2


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = edscache.EdsCache()
    with pytest.raises(RuntimeError):
        cache.get_or_compute(_ods(1))
    assert len(cache) == 0
    with pytest.raises(RuntimeError):
        eds.roots_only(_ods(1))
    d, ext, root = dah.new_dah_from_ods(_ods(1), device="cpu")
    entry = edscache.EdsCacheEntry(ext, d, root)
    with pytest.raises(RuntimeError):
        entry.get_prover()
    assert not entry.warmed()
