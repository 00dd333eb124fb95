"""The withheld-square hand-over: a block as a node holds it after it
retrieved one quadrant of its extended square (celestia-node's retriever
takes one quadrant at random) and before it repairs the rest.

Block `seq` is pool square ``(seq - 1) mod P`` stamped with `seq`, as the
driver hands squares over. A stamp writes the byte columns ``STAMP`` of
one share (inputs/pool.py), and the code extends each byte column on its
own (in GF(2^16) each pair of columns, which the stamp's even offset keeps
whole). So a block's extended square is its pool square's pristine one
outside those columns, and inside them the extension of its stamped ODS's
(k, k, 8) columns. The reference (reference/leopard, reference/nmt, on the
first device) commits each pool square once; for each block it extends the
stamp's columns, rehashes the leaves whose shares they change (in one
stamped share, about k^2 of 4k^2: its row, its column and Q3) and reduces
the trees that hold them (2k + 2 of 4k); every other leaf and root is the
pristine square's. The present quadrant is drawn uniformly from the seed,
block by block (the warm calls' blocks take the quadrants in turn, so that
set-up meets every erasure pattern the window can bring). A hand-over
writes the present quadrant into one reused (2k, 2k, 512) host array,
after zeroing the quadrant written before, so every withheld position
holds zeros and never a byte of the block; the array and the (2k, 2k)
mask are handed over read-only.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.inputs import layout
from benchmark.inputs.pool import STAMP_BYTES, Pool, write_stamp
from benchmark.reference import leopard, nmt, sha256

MASK64 = 2**64 - 1
QUADRANTS = 4
STAMP = slice(layout.SHARE_SIZE - STAMP_BYTES, layout.SHARE_SIZE)  # the byte columns a stamp writes
BLOCKS_PER_FILL = 64  # blocks prepared by one reference call
# The reference's torch SHA-256 makes some 4,300 launches a compression
# whatever the number of messages, so a tree level of few messages costs as
# much as one of many; up to this many, the hand-over's reference hashes
# through hashlib (the same digests, sha256.digest_hashlib).
HASHLIB_UPTO = 1 << 16


def _digest(msgs: torch.Tensor) -> torch.Tensor:
    return sha256.digest_hashlib(msgs) if msgs.shape[0] <= HASHLIB_UPTO else sha256.digest(msgs)


def _trees(ns: torch.Tensor, leaves: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Roots of the row trees `rows` and column trees `cols` of B squares
    that share their (2k, 2k, 29) leaf namespaces `ns`, from their (B, 2k,
    2k, 32) leaf digests: (B, len(rows), 90) and (B, len(cols), 90)."""
    b, two_k = leaves.shape[:2]
    mins = torch.cat([ns[rows], ns[:, cols].transpose(0, 1)])
    vs = torch.cat([leaves[:, rows], leaves[:, :, cols].transpose(1, 2)], dim=1)
    roots = nmt.tree_roots(mins.expand(b, *mins.shape).reshape(-1, two_k, nmt.NS),
                           vs.reshape(-1, two_k, 32), _digest).view(b, mins.shape[0], -1)
    return roots[:, :len(rows)], roots[:, len(rows):]


@dataclasses.dataclass
class _Pristine:
    """A pool square's unstamped commitment, from which its blocks' are
    made; on the host, so that nothing of the reference stays on a card
    through the program's calls (the driver reads their memory peak)."""

    eds: torch.Tensor  # (2k, 2k, 512) uint8
    ns: torch.Tensor  # (2k, 2k, 29) leaf namespaces
    leaves: torch.Tensor  # (2k, 2k, 32) leaf digests
    row_roots: torch.Tensor  # (2k, 90)
    col_roots: torch.Tensor


@dataclasses.dataclass
class Prepared:
    """One block's hand-over, computed before its call."""

    seq: int
    index: int  # its pool square
    quadrant: int  # 0..3: (row half, column half) = divmod(quadrant, 2)
    stamped: np.ndarray  # (2k, 2k, 8) uint8: the block's extended square in the STAMP columns
    row_roots: tuple[bytes, ...]
    col_roots: tuple[bytes, ...]
    data_root: bytes


class Withheld:
    def __init__(self, pool: Pool, seed: int, device, warm_calls: int):
        self.pool = pool
        self.device = torch.device(device)
        self.warm_calls = warm_calls
        self.k = pool.squares.shape[1]
        self.rng = np.random.default_rng([seed & MASK64, 0x0D7A])
        self.queue: collections.deque[Prepared] = collections.deque()
        self.prepared_to = 0  # the last sequence number prepared
        self.quadrants: dict[int, int] = {}  # sequence number -> its present quadrant
        self.pristine: dict[int, _Pristine] = {}  # pool index -> its square's commitment
        self.symbols = np.zeros((2 * self.k, 2 * self.k, layout.SHARE_SIZE), dtype=np.uint8)
        self.written: int | None = None  # the quadrant the array holds
        self.fill_s = 0.0  # host seconds of the reference calls

    def _quadrant(self, seq: int) -> int:
        if seq <= self.warm_calls:
            return (seq - 1) % QUADRANTS
        return int(self.rng.integers(0, QUADRANTS))

    def _span(self, quadrant: int) -> tuple[slice, slice]:
        r, c = divmod(quadrant, 2)
        return slice(r * self.k, (r + 1) * self.k), slice(c * self.k, (c + 1) * self.k)

    def _pristine(self, index: int) -> _Pristine:
        if index not in self.pristine:
            eds = leopard.extend_square(torch.from_numpy(self.pool.pristine[index]).to(self.device))
            ns = nmt.leaf_namespaces(eds)
            leaves = nmt.leaf_hashes(ns.reshape(-1, nmt.NS), eds.reshape(-1, eds.shape[-1]), _digest)
            leaves = leaves.view(*eds.shape[:2], 32)
            every = torch.arange(2 * self.k, device=self.device)
            rows, cols = _trees(ns, leaves[None], every, every)
            self.pristine[index] = _Pristine(*(t.cpu() for t in (eds, ns, leaves, rows[0], cols[0])))
        return self.pristine[index]

    def _prepare(self, index: int, blocks: list[tuple[int, int]]) -> list[Prepared]:
        """The hand-overs of `blocks`, (sequence number, quadrant) pairs of
        pool square `index`, in one reference call."""
        base = self._pristine(index)
        r, c = self.pool.sites[index]
        narrow = np.repeat(self.pool.pristine[index][None, :, :, STAMP], len(blocks), axis=0)
        for b, (seq, _) in enumerate(blocks):
            share = self.pool.pristine[index, r, c][None, None].copy()
            write_stamp(share, (0, 0), seq)
            narrow[b, r, c] = share[0, 0, STAMP]
        n, k, dev = len(blocks), self.k, self.device
        cols_in = torch.from_numpy(narrow).to(dev).permute(1, 2, 0, 3).reshape(k, k, -1)
        stamped = leopard.extend_square(cols_in).view(2 * k, 2 * k, n, -1).permute(2, 0, 1, 3)
        changed = (stamped != base.eds[..., STAMP].to(dev)).any(-1).any(0)
        at = changed.nonzero(as_tuple=True)
        shares = base.eds.to(dev)[at].expand(n, -1, -1).clone()
        shares[..., STAMP] = stamped[:, at[0], at[1]]
        ns = base.ns.to(dev)
        digests = nmt.leaf_hashes(ns[at].expand(n, -1, -1).reshape(-1, nmt.NS),
                                  shares.reshape(-1, shares.shape[-1]), _digest)
        leaves = base.leaves.to(dev).expand(n, -1, -1, -1).clone()
        leaves[:, at[0], at[1]] = digests.view(n, -1, 32)
        rows, cols = changed.any(1).nonzero().squeeze(1), changed.any(0).nonzero().squeeze(1)
        row_roots = base.row_roots.to(dev).expand(n, -1, -1).clone()
        col_roots = base.col_roots.to(dev).expand(n, -1, -1).clone()
        row_roots[:, rows], col_roots[:, cols] = _trees(ns, leaves, rows, cols)
        data_roots = nmt.data_root(row_roots, col_roots, _digest).cpu().numpy()
        stamped, row_roots, col_roots = stamped.cpu().numpy(), row_roots.cpu().numpy(), col_roots.cpu().numpy()
        return [Prepared(seq, index, q, stamped[b], tuple(x.tobytes() for x in row_roots[b]),
                         tuple(x.tobytes() for x in col_roots[b]), data_roots[b].tobytes())
                for b, (seq, q) in enumerate(blocks)]

    def fill(self, upto: int) -> None:
        """Prepare every block up to sequence number `upto`, at most
        BLOCKS_PER_FILL blocks to a reference call (of each pool square
        among them)."""
        t0 = time.perf_counter()
        while self.prepared_to < upto:
            seqs = range(self.prepared_to + 1, min(upto, self.prepared_to + BLOCKS_PER_FILL) + 1)
            by_square: dict[int, list[tuple[int, int]]] = {}
            for seq in seqs:
                self.quadrants[seq] = self._quadrant(seq)
                by_square.setdefault((seq - 1) % len(self.pool), []).append((seq, self.quadrants[seq]))
            prepared = [p for index, blocks in by_square.items() for p in self._prepare(index, blocks)]
            self.queue.extend(sorted(prepared, key=lambda p: p.seq))
            self.prepared_to = seqs[-1]
        self.fill_s += time.perf_counter() - t0

    def hand_over(self, seq: int, index: int) -> tuple[tuple, SimpleNamespace]:
        """The arguments of block `seq`'s call (symbols, present, row roots,
        column roots), and the block's commitments as an entry whose square
        the call's result fills in."""
        if index != (seq - 1) % len(self.pool):
            raise ValueError(f"block {seq} is pool square {(seq - 1) % len(self.pool)}, not {index}")
        if self.prepared_to < seq:
            self.fill(seq + BLOCKS_PER_FILL - 1)
        block = self.queue.popleft()
        if block.seq != seq:
            raise RuntimeError(f"hand-over of block {block.seq} prepared, block {seq} due")
        return self._arguments(block)

    def hand_over_again(self, seq: int) -> tuple[tuple, SimpleNamespace]:
        """`hand_over` of a block handed over before, prepared afresh."""
        index = (seq - 1) % len(self.pool)
        return self._arguments(self._prepare(index, [(seq, self.quadrants[seq])])[0])

    def _arguments(self, block: Prepared) -> tuple[tuple, SimpleNamespace]:
        if self.written is not None:
            self.symbols[self._span(self.written)] = 0
        rows, cols = self._span(block.quadrant)
        self.symbols[rows, cols] = self.pristine[block.index].eds.numpy()[rows, cols]
        self.symbols[rows, cols, STAMP] = block.stamped[rows, cols]
        self.written = block.quadrant
        present = np.zeros(self.symbols.shape[:2], dtype=bool)
        present[rows, cols] = True
        symbols = self.symbols.view()
        symbols.flags.writeable = False
        present.flags.writeable = False
        entry = SimpleNamespace(eds=SimpleNamespace(squares=None),
                                dah=SimpleNamespace(row_roots=block.row_roots, col_roots=block.col_roots),
                                data_root=block.data_root)
        return (symbols, present, block.row_roots, block.col_roots), entry
