"""Internal key format and comparators (copied from
toplingdb_tpu/db/dbformat.py, trimmed to the three comparators a job may
name: bytewise, reverse bytewise and bytewise with a u64 timestamp).

An internal key is `user_key + packed(seqno, type)` where the trailer is 8
bytes: `(seqno << 8) | type`, stored little-endian fixed64. Ordering: user
keys ascending, then (seqno, type) DESCENDING, so the newest version of a
key sorts first. kMaxSequenceNumber is 2^56-1; seqno 0 means "visible to
everyone" (keys compacted to the bottommost level with no snapshot in the
way).
"""

from __future__ import annotations

import enum
import struct

from toplingdb_tpu_torch.utils.status import Corruption

_U64 = struct.Struct("<Q")

MAX_SEQUENCE_NUMBER = (1 << 56) - 1


class ValueType(enum.IntEnum):
    """Record types in the keyspace."""

    DELETION = 0x0
    VALUE = 0x1
    MERGE = 0x2
    LOG_DATA = 0x3
    SINGLE_DELETION = 0x7
    RANGE_DELETION = 0xF
    BLOB_INDEX = 0x11
    WIDE_COLUMN_ENTITY = 0x16
    MAX = 0x7F


# Highest type value used when constructing "seek" keys.
VALUE_TYPE_FOR_SEEK = ValueType.MAX


def pack_seq_type(seq: int, t: ValueType | int) -> int:
    assert 0 <= seq <= MAX_SEQUENCE_NUMBER, seq
    return (seq << 8) | int(t)


def unpack_seq_type(packed: int) -> tuple[int, int]:
    return packed >> 8, packed & 0xFF


def make_internal_key(user_key: bytes, seq: int, t: ValueType | int) -> bytes:
    return user_key + _U64.pack(pack_seq_type(seq, t))


def split_internal_key(ikey: bytes) -> tuple[bytes, int, int]:
    """Returns (user_key, seqno, value_type)."""
    if len(ikey) < 8:
        raise Corruption(f"internal key too short: {len(ikey)}")
    seq, t = unpack_seq_type(_U64.unpack_from(ikey, len(ikey) - 8)[0])
    return ikey[:-8], seq, t


def extract_user_key(ikey: bytes) -> bytes:
    if len(ikey) < 8:
        raise Corruption(f"internal key too short: {len(ikey)}")
    return ikey[:-8]


def extract_seqno(ikey: bytes) -> int:
    return _U64.unpack_from(ikey, len(ikey) - 8)[0] >> 8


def extract_value_type(ikey: bytes) -> int:
    # The trailer is little-endian fixed64 of (seqno << 8 | type): the type
    # is its first byte.
    if len(ikey) < 8:
        raise Corruption(f"internal key too short: {len(ikey)}")
    return ikey[-8]


# User-defined timestamps: a key's stored suffix is the bitwise-inverted
# big-endian u64, so ascending byte order is descending timestamp.
MAX_TIMESTAMP = (1 << 64) - 1


def encode_ts(ts: int) -> bytes:
    return (ts ^ MAX_TIMESTAMP).to_bytes(8, "big")


def decode_ts(suffix: bytes) -> int:
    return int.from_bytes(suffix[-8:], "big") ^ MAX_TIMESTAMP


_TS_TERM = b"\x00\x00"


def encode_ts_key(user_key: bytes, ts: int) -> bytes:
    """(key, ts) → stored key: the key made prefix-free by an
    order-preserving escape (0x00 → 0x00 0xFF, terminated by 0x00 0x00),
    then the inverted-ts suffix; bytewise(stored_a, stored_b) orders
    (key asc, ts desc)."""
    return user_key.replace(b"\x00", b"\x00\xff") + _TS_TERM + encode_ts(ts)


def strip_ts(stored: bytes) -> bytes:
    """Stored key → the user key (escape removed). ValueError when the
    key carries no timestamp suffix."""
    esc = stored[:-8]
    if not esc.endswith(_TS_TERM):
        raise ValueError(f"not a timestamped key: {stored!r}")
    return esc[:-2].replace(b"\x00\xff", b"\x00")


class Comparator:
    """Bytewise user-key comparator; find_shortest_separator and
    find_short_successor shorten index-block keys."""

    #: bytes of user-defined timestamp suffixed to every user key.
    timestamp_size = 0

    def name(self) -> str:
        return "tpulsm.BytewiseComparator"

    def compare(self, a: bytes, b: bytes) -> int:
        return (a > b) - (a < b)

    def find_shortest_separator(self, start: bytes, limit: bytes) -> bytes:
        """Returns a key k with start <= k < limit, as short as possible."""
        n = min(len(start), len(limit))
        i = 0
        while i < n and start[i] == limit[i]:
            i += 1
        if i >= n:
            return start  # one is a prefix of the other
        b = start[i]
        if b < 0xFF and b + 1 < limit[i]:
            return start[: i] + bytes([b + 1])
        return start

    def find_short_successor(self, key: bytes) -> bytes:
        """Returns a short key k >= key."""
        for i, b in enumerate(key):
            if b != 0xFF:
                return key[: i] + bytes([b + 1])
        return key


class ReverseBytewiseComparator(Comparator):
    def name(self) -> str:
        return "tpulsm.ReverseBytewiseComparator"

    def compare(self, a: bytes, b: bytes) -> int:
        return (a < b) - (a > b)

    def find_shortest_separator(self, start: bytes, limit: bytes) -> bytes:
        return start

    def find_short_successor(self, key: bytes) -> bytes:
        return key


class U64TsBytewiseComparator(Comparator):
    """Bytewise comparator over keys with a u64 user-defined timestamp: the
    stored key is the escaped user key followed by the bitwise-inverted
    timestamp, so plain bytewise order over the stored bytes is (key asc,
    ts desc) and the comparison is bytewise."""

    timestamp_size = 8

    def name(self) -> str:
        return "tpulsm.BytewiseComparator.u64ts"

    def find_shortest_separator(self, start: bytes, limit: bytes) -> bytes:
        return start  # never synthesize keys across a ts boundary

    def find_short_successor(self, key: bytes) -> bytes:
        return key


BYTEWISE = Comparator()
REVERSE_BYTEWISE = ReverseBytewiseComparator()
U64_TS_BYTEWISE = U64TsBytewiseComparator()


class _OrderedKey:
    """Wrapper making a comparator usable as a sort key function."""

    __slots__ = ("cmp", "k")

    def __init__(self, cmp, k):
        self.cmp = cmp
        self.k = k

    def __lt__(self, other):
        return self.cmp(self.k, other.k) < 0

    def __eq__(self, other):
        return self.cmp(self.k, other.k) == 0


class InternalKeyComparator:
    """Orders internal keys: user key asc, then (seqno, type) desc."""

    def __init__(self, user_cmp: Comparator = BYTEWISE):
        self.user_comparator = user_cmp

    def sort_key(self, k: bytes) -> "_OrderedKey":
        """For use as `key=` in sorted()/min()/max() over internal keys."""
        return _OrderedKey(self.compare, k)

    def name(self) -> str:
        return "tpulsm.InternalKeyComparator:" + self.user_comparator.name()

    def compare(self, a: bytes, b: bytes) -> int:
        r = self.user_comparator.compare(a[:-8], b[:-8])
        if r != 0:
            return r
        anum = _U64.unpack_from(a, len(a) - 8)[0]
        bnum = _U64.unpack_from(b, len(b) - 8)[0]
        return (anum < bnum) - (anum > bnum)

    def find_shortest_separator(self, start: bytes, limit: bytes) -> bytes:
        su, lu = start[:-8], limit[:-8]
        tmp = self.user_comparator.find_shortest_separator(su, lu)
        if len(tmp) < len(su) and self.user_comparator.compare(su, tmp) < 0:
            # Shorter physically but larger logically: tag with the earliest
            # possible (seqno, type) so it still sorts before limit.
            return tmp + _U64.pack(
                pack_seq_type(MAX_SEQUENCE_NUMBER, VALUE_TYPE_FOR_SEEK))
        return start

    def find_short_successor(self, key: bytes) -> bytes:
        uk = key[:-8]
        tmp = self.user_comparator.find_short_successor(uk)
        if len(tmp) < len(uk) and self.user_comparator.compare(uk, tmp) < 0:
            return tmp + _U64.pack(
                pack_seq_type(MAX_SEQUENCE_NUMBER, VALUE_TYPE_FOR_SEEK))
        return key
