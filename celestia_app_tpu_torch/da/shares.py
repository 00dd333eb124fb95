"""Share codec: the 512-byte atomic units of the data square.

Copied from celestia_app_tpu/da/shares.py (the encoding half that
``square.build`` needs, and the share properties and sparse-share parse
that the blob follower needs). Byte-exact implementation of
specs/src/specs/shares.md (reference implementation: go-square/shares):

  share := namespace(29) || info(1) || [sequence_len(4, BE, first share only)]
           || [reserved(4, BE, compact shares only)] || data || zero-fill
  info  := share_version(7 bits) << 1 | sequence_start(1 bit)

Sparse shares carry blob data (one blob = one sequence). Compact shares carry
the length-delimited (uvarint-prefixed) transactions of a reserved namespace
as a single sequence, with 4 reserved bytes holding the in-share offset of the
first unit that starts in the share (0 if none). Padding shares
(namespace/primary-reserved/tail) have sequence_start=1, sequence_len=0 and a
zero body.
"""

from __future__ import annotations

import dataclasses

from celestia_app_tpu_torch import appconsts as c
from celestia_app_tpu_torch.da import namespace as ns_mod
from celestia_app_tpu_torch.da.namespace import Namespace


def uvarint(n: int) -> bytes:
    """Protobuf unsigned varint encoding."""
    if n < 0:
        raise ValueError("uvarint of negative value")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(data: bytes, offset: int) -> tuple[int, int]:
    """Decode a uvarint at `offset`; returns (value, next_offset)."""
    result = 0
    shift = 0
    while True:
        if offset >= len(data):
            raise ValueError("truncated uvarint")
        b = data[offset]
        offset += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, offset
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflow")


@dataclasses.dataclass(frozen=True)
class Share:
    raw: bytes

    def __post_init__(self):
        if len(self.raw) != c.SHARE_SIZE:
            raise ValueError(f"share must be {c.SHARE_SIZE} bytes, got {len(self.raw)}")

    @property
    def namespace(self) -> Namespace:
        return Namespace(self.raw[: c.NAMESPACE_SIZE])

    @property
    def info_byte(self) -> int:
        return self.raw[c.NAMESPACE_SIZE]

    @property
    def version(self) -> int:
        return self.info_byte >> 1

    @property
    def is_sequence_start(self) -> bool:
        return bool(self.info_byte & 1)

    def sequence_len(self) -> int:
        if not self.is_sequence_start:
            raise ValueError("sequence_len only present on the first share")
        off = c.NAMESPACE_SIZE + c.SHARE_INFO_BYTES
        return int.from_bytes(self.raw[off : off + c.SEQUENCE_LEN_BYTES], "big")

    def is_compact(self) -> bool:
        return self.namespace in (ns_mod.TX_NAMESPACE, ns_mod.PAY_FOR_BLOB_NAMESPACE)

    def is_padding(self) -> bool:
        return self.is_sequence_start and not self.is_compact() and self.sequence_len() == 0

    def content(self) -> bytes:
        """Data region (after header fields; includes any zero fill)."""
        off = c.NAMESPACE_SIZE + c.SHARE_INFO_BYTES
        if self.is_sequence_start:
            off += c.SEQUENCE_LEN_BYTES
        if self.is_compact():
            off += c.SHARE_RESERVED_BYTES
        return self.raw[off:]


def _info_byte(version: int, sequence_start: bool) -> int:
    if version not in c.SUPPORTED_SHARE_VERSIONS:
        raise ValueError(f"unsupported share version {version}")
    return (version << 1) | int(sequence_start)


# ---------------------------------------------------------------------------
# Sparse (blob) shares
# ---------------------------------------------------------------------------


def sparse_shares_needed(blob_len: int) -> int:
    """Number of shares a blob of `blob_len` bytes occupies."""
    if blob_len <= c.FIRST_SPARSE_SHARE_CONTENT_SIZE:
        return 1
    rest = blob_len - c.FIRST_SPARSE_SHARE_CONTENT_SIZE
    return 1 + -(-rest // c.CONTINUATION_SPARSE_SHARE_CONTENT_SIZE)


def split_blob(ns: Namespace, data: bytes, share_version: int = 0) -> list[Share]:
    """Share-split a blob (shares.md "Share Splitting")."""
    shares: list[Share] = []
    first = True
    pos = 0
    while first or pos < len(data):
        if first:
            header = ns.raw + bytes([_info_byte(share_version, True)]) + len(data).to_bytes(4, "big")
            take = c.FIRST_SPARSE_SHARE_CONTENT_SIZE
        else:
            header = ns.raw + bytes([_info_byte(share_version, False)])
            take = c.CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
        chunk = data[pos : pos + take]
        pos += take
        shares.append(Share(header + chunk + b"\x00" * (take - len(chunk))))
        first = False
    return shares


def parse_sparse_shares(shares: list[Share]) -> bytes:
    """Reassemble one blob from its share sequence."""
    if not shares or not shares[0].is_sequence_start:
        raise ValueError("sequence must begin with a start share")
    total = shares[0].sequence_len()
    data = b"".join(s.content() for s in shares)
    if len(data) < total:
        raise ValueError("share sequence shorter than sequence_len")
    return data[:total]


# ---------------------------------------------------------------------------
# Compact (transaction) shares
# ---------------------------------------------------------------------------


def split_txs(ns: Namespace, txs: list[bytes]) -> list[Share]:
    """Encode txs as one compact-share sequence in `ns` (shares.md
    "Transaction Shares"). Each tx is uvarint-length-prefixed; reserved bytes
    point at the in-share offset of the first unit starting in each share."""
    blob = b"".join(uvarint(len(tx)) + tx for tx in txs)
    # Unit start offsets within the concatenated sequence data.
    unit_starts = []
    off = 0
    for tx in txs:
        unit_starts.append(off)
        off += len(uvarint(len(tx))) + len(tx)

    shares: list[Share] = []
    pos = 0
    first = True
    while first or pos < len(blob):
        if first:
            fixed = ns.raw + bytes([_info_byte(0, True)]) + len(blob).to_bytes(4, "big")
            take = c.FIRST_COMPACT_SHARE_CONTENT_SIZE
        else:
            fixed = ns.raw + bytes([_info_byte(0, False)])
            take = c.CONTINUATION_COMPACT_SHARE_CONTENT_SIZE
        content_abs_off = len(fixed) + c.SHARE_RESERVED_BYTES
        starts_here = [u for u in unit_starts if pos <= u < pos + take]
        reserved = (content_abs_off + starts_here[0] - pos) if starts_here else 0
        chunk = blob[pos : pos + take]
        pos += take
        share = fixed + reserved.to_bytes(4, "big") + chunk + b"\x00" * (take - len(chunk))
        shares.append(Share(share))
        first = False
    return shares


# ---------------------------------------------------------------------------
# Padding shares
# ---------------------------------------------------------------------------


def _padding_share(ns: Namespace) -> bytes:
    body = ns.raw + bytes([_info_byte(0, True)]) + (0).to_bytes(4, "big")
    return body + b"\x00" * (c.SHARE_SIZE - len(body))


def namespace_padding_share(ns: Namespace) -> Share:
    return Share(_padding_share(ns))


def reserved_padding_share() -> Share:
    return Share(_padding_share(ns_mod.PRIMARY_RESERVED_PADDING_NAMESPACE))


def tail_padding_share() -> bytes:
    return _padding_share(ns_mod.TAIL_PADDING_NAMESPACE)


def tail_padding_shares(n: int) -> list[Share]:
    return [Share(tail_padding_share()) for _ in range(n)]
