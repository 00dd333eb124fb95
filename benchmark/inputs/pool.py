"""The input pool and its stamps.

Set-up lays out a few squares from the seed and holds them on the host.
Before each hand-over the harness stamps the block's sequence number into
blob bytes of a pool square, in place: 8 bytes at the end of the first
continuation share of the pool square's largest blob. That share is full
of blob data (it is neither the blob's first share nor its last), so the
stamp changes data and no layout field, and every square handed over is
distinct: no cache keyed on content can answer a block from an earlier
one. A block is (pool index, stamp), and `rebuild` gives the reference
its bytes again from the pristine copy, which the program never sees.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.inputs import layout, mempool

STAMP_BYTES = 8


@dataclasses.dataclass
class Pool:
    squares: np.ndarray  # (P, k, k, 512) uint8: handed over, stamped in place
    pristine: np.ndarray  # (P, k, k, 512) uint8: never handed over
    sites: list[tuple[int, int]]  # (row, column) of each square's stamp share

    def __len__(self) -> int:
        return self.squares.shape[0]

    def stamp(self, index: int, seq: int) -> np.ndarray:
        """Write `seq` into pool square `index` in place; returns the square."""
        write_stamp(self.squares[index], self.sites[index], seq)
        return self.squares[index]

    def rebuild(self, index: int, seq: int) -> np.ndarray:
        """A fresh copy of pool square `index` as handed over with `seq`."""
        ods = self.pristine[index].copy()
        write_stamp(ods, self.sites[index], seq)
        return ods


def stamp_site(sq: layout.Square) -> tuple[int, int]:
    """(row, column) of the first continuation share of the largest blob
    that has three shares or more."""
    best = None
    for (i, j), start in sq.blob_starts.items():
        count = sq.pfbs[i].blobs[j].share_count()
        if count >= 3 and (best is None or count > best[0]):
            best = (count, start)
    if best is None:
        raise ValueError("no blob of three shares or more to stamp")
    share = best[1] + 1
    return divmod(share, sq.size)


def write_stamp(ods: np.ndarray, site: tuple[int, int], seq: int) -> None:
    r, c = site
    ods[r, c, layout.SHARE_SIZE - STAMP_BYTES:] = np.frombuffer(
        int(seq).to_bytes(STAMP_BYTES, "little"), dtype=np.uint8)


def make(config: dict, size: int, seed: int) -> Pool:
    """`size` squares laid out from the seed, square i from the seed
    sequence (seed, i)."""
    squares, sites = [], []
    for i in range(size):
        ods, sq = mempool.square(config, np.random.default_rng([seed & (2**64 - 1), i]))
        squares.append(ods)
        sites.append(stamp_site(sq))
    stacked = np.stack(squares)
    return Pool(stacked, stacked.copy(), sites)
