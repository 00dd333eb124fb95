"""The benchmark's inputs: the frozen layout against the program's, and
stamps that keep each square's layout valid and make it distinct."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark.inputs import layout, mempool, pool as pool_mod
from benchmark.tests.tiny import BENCH, TINY_MEMPOOL


def _config(file: str, **cut) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{file}.json").read_text())
    cfg.update(cut)
    return cfg


CONFIGS = [
    _config("celestia-v3-k128"),
    _config("celestia-v3-k128", name="tiny-k8", square_size=8, max_square_size=8, mempool=TINY_MEMPOOL),
    # the big-block shapes (6 blobs of 200 KB) at k = 64
    _config("e2e-bigblock-64mb-k512", name="bigblock-k64", square_size=64, max_square_size=64,
            mempool={**_config("e2e-bigblock-64mb-k512")["mempool"], "blob_bytes_total": 1_900_000}),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_frozen_layout_equals_the_programs(cfg):
    from celestia_app_tpu_torch.da import blob, namespace, square

    txs, pfbs = mempool.mempool(cfg["mempool"], cfg["max_square_size"], np.random.default_rng(3))
    ours = layout.build(txs, pfbs, cfg["max_square_size"], cfg["subtree_root_threshold"])
    port_pfbs = [square.PfbEntry(e.tx, tuple(blob.Blob(namespace.Namespace(b.namespace), b.data) for b in e.blobs))
                 for e in pfbs]
    theirs = square.build(txs, port_pfbs, cfg["max_square_size"], cfg["subtree_root_threshold"])
    assert ours.size == theirs.size == cfg["square_size"]
    assert ours.shares == theirs.share_bytes()


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_stamps_keep_the_layout_and_make_squares_distinct(cfg):
    from celestia_app_tpu_torch.da import shares

    p = pool_mod.make(cfg, 2, seed=2**40 + 9)
    k = cfg["square_size"]
    for index in range(2):
        r, c = p.sites[index]
        seen = set()
        for seq in (1, 2, 2**33 + 1):
            ods = p.stamp(index, seq)
            assert np.array_equal(ods, p.rebuild(index, seq))
            diff = np.argwhere(np.any(ods != p.pristine[index], axis=-1))
            assert diff.tolist() in ([], [[r, c]])
            share = shares.Share(ods[r, c].tobytes())
            # a continuation share of a blob: namespace and info byte as laid out
            assert ods[r, c, :30].tobytes() == p.pristine[index, r, c, :30].tobytes()
            assert not share.is_sequence_start and not share.is_compact()
            # its blob continues past it, so the stamp is blob data, not padding
            nxt = r * k + c + 1
            assert shares.Share(ods[nxt // k, nxt % k].tobytes()).namespace == share.namespace
            assert not shares.Share(ods[nxt // k, nxt % k].tobytes()).is_sequence_start
            seen.add(ods.tobytes())
        assert len(seen) == 3


def test_pool_squares_are_distinct_and_seeded():
    cfg = CONFIGS[1]
    a, b = pool_mod.make(cfg, 3, seed=5), pool_mod.make(cfg, 3, seed=5)
    assert np.array_equal(a.squares, b.squares) and a.sites == b.sites
    assert len({sq.tobytes() for sq in a.squares}) == 3
    assert not np.array_equal(a.squares, pool_mod.make(cfg, 3, seed=6).squares)
