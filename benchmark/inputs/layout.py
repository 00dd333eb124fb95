"""The data-square layout, frozen for the benchmark: a copy of the port's
host layout (da/square, da/shares, da/blob, da/namespace; go-square's
``square.Build``), so that a later change to the program's layout cannot
move the benchmark's inputs.

Rules (specs/src/specs/data_square_layout.md, shares.md):

- a share is namespace(29) || info(1) || [sequence length(4), first share
  only] || [reserved(4), compact shares only] || data || zero fill;
- normal txs form one compact sequence in the TRANSACTION namespace, the
  IndexWrapper-wrapped PFB txs one in PAY_FOR_BLOB, reserved at their
  worst-case size;
- blobs are sorted by namespace (stable), each starts at a multiple of its
  subtree width, with primary-reserved, namespace and tail padding;
- `build` admits txs greedily in priority order with worst-case padding
  accounting, and the square edge k is the smallest power of two that
  fits the estimate.
"""

from __future__ import annotations

import dataclasses
import math

SHARE_SIZE = 512
NS = 29
FIRST_SPARSE = SHARE_SIZE - NS - 1 - 4  # 478
CONT_SPARSE = SHARE_SIZE - NS - 1  # 482
FIRST_COMPACT = SHARE_SIZE - NS - 1 - 4 - 4  # 474
CONT_COMPACT = SHARE_SIZE - NS - 1 - 4  # 478
SUBTREE_ROOT_THRESHOLD = 64


def _primary(last: int) -> bytes:
    return bytes(NS - 1) + bytes([last])


TX_NAMESPACE = _primary(0x01)
PAY_FOR_BLOB_NAMESPACE = _primary(0x04)
PRIMARY_RESERVED_PADDING = _primary(0xFF)
TAIL_PADDING = b"\xff" * (NS - 1) + b"\xfe"


def v0_namespace(user: bytes) -> bytes:
    """A version-0 namespace from up to 10 user bytes."""
    if len(user) > 10:
        raise ValueError("a version-0 namespace takes at most 10 user bytes")
    return b"\x00" + bytes(18) + user.rjust(10, b"\x00")


def uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


@dataclasses.dataclass(frozen=True)
class Blob:
    namespace: bytes
    data: bytes

    def share_count(self) -> int:
        return sparse_shares_needed(len(self.data))


@dataclasses.dataclass(frozen=True)
class PfbEntry:
    tx: bytes
    blobs: tuple[Blob, ...]


def sparse_shares_needed(n: int) -> int:
    if n <= FIRST_SPARSE:
        return 1
    return 1 + -(-(n - FIRST_SPARSE) // CONT_SPARSE)


def compact_shares_needed(n: int) -> int:
    if n == 0:
        return 0
    if n <= FIRST_COMPACT:
        return 1
    return 1 + -(-(n - FIRST_COMPACT) // CONT_COMPACT)


def _round_up_pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def subtree_width(share_count: int, threshold: int) -> int:
    min_square = _round_up_pow2(math.isqrt(share_count - 1) + 1 if share_count > 1 else 1)
    return min(_round_up_pow2(-(-share_count // threshold)), min_square)


def _seq_len(txs: list[bytes]) -> int:
    return sum(len(uvarint(len(t))) + len(t) for t in txs)


def index_wrapper_size_worst_case(tx_len: int, n_blobs: int, max_square: int) -> int:
    idx_bytes = n_blobs * len(uvarint(max_square * max_square))
    return 1 + len(uvarint(tx_len)) + tx_len + 1 + len(uvarint(idx_bytes)) + idx_bytes + 1 + 1 + 4


def index_wrapper(tx: bytes, share_indexes: list[int]) -> bytes:
    """Protobuf IndexWrapper: tx (1), packed share indexes (2), type_id
    "INDX" (3)."""
    packed = b"".join(uvarint(i) for i in share_indexes)
    out = b""
    if tx:
        out += b"\x0a" + uvarint(len(tx)) + tx
    if packed:
        out += b"\x12" + uvarint(len(packed)) + packed
    return out + b"\x1a\x04INDX"


def _padding(ns: bytes) -> bytes:
    body = ns + b"\x01" + bytes(4)
    return body + bytes(SHARE_SIZE - len(body))


def split_blob(b: Blob) -> list[bytes]:
    out, pos = [], 0
    while not out or pos < len(b.data):
        if not out:
            header, take = b.namespace + b"\x01" + len(b.data).to_bytes(4, "big"), FIRST_SPARSE
        else:
            header, take = b.namespace + b"\x00", CONT_SPARSE
        chunk = b.data[pos:pos + take]
        pos += take
        out.append(header + chunk + bytes(take - len(chunk)))
    return out


def split_txs(ns: bytes, txs: list[bytes]) -> list[bytes]:
    data = b"".join(uvarint(len(t)) + t for t in txs)
    starts, off = [], 0
    for t in txs:
        starts.append(off)
        off += len(uvarint(len(t))) + len(t)
    out, pos = [], 0
    while not out or pos < len(data):
        if not out:
            fixed, take = ns + b"\x01" + len(data).to_bytes(4, "big"), FIRST_COMPACT
        else:
            fixed, take = ns + b"\x00", CONT_COMPACT
        here = [u for u in starts if pos <= u < pos + take]
        reserved = (len(fixed) + 4 + here[0] - pos) if here else 0
        chunk = data[pos:pos + take]
        pos += take
        out.append(fixed + reserved.to_bytes(4, "big") + chunk + bytes(take - len(chunk)))
    return out


@dataclasses.dataclass
class Square:
    size: int
    shares: list[bytes]
    blob_starts: dict[tuple[int, int], int]  # (pfb index, blob index) -> first share
    pfbs: list[PfbEntry]


def _layout(txs: list[bytes], pfbs: list[PfbEntry], threshold: int, max_square: int) -> Square:
    wrapped = [index_wrapper_size_worst_case(len(e.tx), len(e.blobs), max_square) for e in pfbs]
    tx_shares = compact_shares_needed(_seq_len(txs))
    pfb_reserved = compact_shares_needed(sum(len(uvarint(s)) + s for s in wrapped))
    ordered = sorted(((e.blobs[j].namespace, i, j) for i, e in enumerate(pfbs)
                      for j in range(len(e.blobs))), key=lambda t: t[0])
    starts: dict[tuple[int, int], int] = {}
    cursor = tx_shares + pfb_reserved
    worst = 0
    for _, i, j in ordered:
        count = pfbs[i].blobs[j].share_count()
        width = subtree_width(count, threshold)
        start = -(-cursor // width) * width
        starts[(i, j)] = start
        cursor = start + count
        worst += count + width - 1
    k = 1
    while k * k < tx_shares + pfb_reserved + worst:
        k *= 2
    shares: list[bytes] = []
    if tx_shares:
        shares += split_txs(TX_NAMESPACE, txs)
    if pfb_reserved:
        shares += split_txs(PAY_FOR_BLOB_NAMESPACE, [
            index_wrapper(e.tx, [starts[(i, j)] for j in range(len(e.blobs))])
            for i, e in enumerate(pfbs)])
    prev = None
    for _, i, j in ordered:
        b, start = pfbs[i].blobs[j], starts[(i, j)]
        if start > len(shares):
            shares += [_padding(PRIMARY_RESERVED_PADDING if prev is None else prev)] * (start - len(shares))
        shares += split_blob(b)
        prev = b.namespace
    if len(shares) > k * k:
        raise ValueError(f"layout overflows its k = {k} square")
    shares += [_padding(TAIL_PADDING)] * (k * k - len(shares))
    return Square(k, shares, starts, pfbs)


def build(txs: list[bytes], pfbs: list[PfbEntry], max_square: int,
          threshold: int = SUBTREE_ROOT_THRESHOLD) -> Square:
    """Greedy admission in priority order with worst-case accounting, then
    one exact layout (the proposer's square.Build)."""
    cap = max_square * max_square
    kept_txs, seq = [], 0
    for t in txs:
        cand = seq + len(uvarint(len(t))) + len(t)
        if compact_shares_needed(cand) <= cap:
            kept_txs.append(t)
            seq = cand
    tx_shares = compact_shares_needed(seq)
    kept_pfbs, pfb_seq, blob_worst = [], 0, 0
    for e in pfbs:
        w = index_wrapper_size_worst_case(len(e.tx), len(e.blobs), max_square)
        cand_pfb = pfb_seq + len(uvarint(w)) + w
        cand_blob = blob_worst + sum(b.share_count() + subtree_width(b.share_count(), threshold) - 1
                                     for b in e.blobs)
        if tx_shares + compact_shares_needed(cand_pfb) + cand_blob <= cap:
            kept_pfbs.append(e)
            pfb_seq, blob_worst = cand_pfb, cand_blob
    return _layout(kept_txs, kept_pfbs, threshold, max_square)
