"""Seeded mempool contents, laid out into squares of a configuration's
size: the benchmark's one input generator.

A generalisation of the port's ``chip_smoke.realistic_block``, read from
a configuration's ``mempool`` parameters: ``txs`` plain txs of
``tx_bytes`` [lo, hi) bytes; ``namespaces`` version-0 namespaces; PFBs of
``blobs_per_pfb`` [lo, hi] blobs each, blob sizes log-uniform over
``blob_bytes`` [lo, hi] (one size where lo == hi), each under a namespace
drawn from the set, with a signed tx of ``pfb_tx_bytes`` [lo, hi); PFBs
are drawn until the blob bytes reach ``blob_bytes_total``, or ``fill``
times the blob capacity of the largest square. The same parameters and
seed give the same bytes.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.inputs import layout


def _size(rng: np.random.Generator, lo: int, hi: int) -> int:
    if lo == hi:
        return lo
    return int(math.exp(rng.uniform(math.log(lo), math.log(hi))))


def mempool(params: dict, max_square: int, rng: np.random.Generator
            ) -> tuple[list[bytes], list[layout.PfbEntry]]:
    txs = [rng.bytes(int(rng.integers(*params["tx_bytes"]))) for _ in range(params["txs"])]
    namespaces = [layout.v0_namespace(rng.bytes(10)) for _ in range(params["namespaces"])]
    target = params.get("blob_bytes_total")
    if target is None:
        target = params["fill"] * max_square * max_square * layout.CONT_SPARSE
    lo_b, hi_b = params["blobs_per_pfb"]
    pfbs, total = [], 0
    while total < target:
        blobs = []
        for _ in range(int(rng.integers(lo_b, hi_b + 1))):
            size = _size(rng, *params["blob_bytes"])
            ns = namespaces[int(rng.integers(0, len(namespaces)))]
            blobs.append(layout.Blob(ns, rng.bytes(size)))
            total += size
        pfbs.append(layout.PfbEntry(rng.bytes(int(rng.integers(*params["pfb_tx_bytes"]))), tuple(blobs)))
    return txs, pfbs


def square(config: dict, rng: np.random.Generator) -> tuple[np.ndarray, layout.Square]:
    """One laid-out square of the configuration's size: ((k, k, 512) uint8
    ODS, its layout). ValueError when the mempool does not lay out to k."""
    k = config["square_size"]
    txs, pfbs = mempool(config["mempool"], config["max_square_size"], rng)
    sq = layout.build(txs, pfbs, config["max_square_size"], config["subtree_root_threshold"])
    if sq.size != k:
        raise ValueError(f"{config['name']}: the mempool laid out a k = {sq.size} square, not {k}")
    ods = np.frombuffer(b"".join(sq.shares), dtype=np.uint8).reshape(k, k, layout.SHARE_SIZE)
    return ods, sq
