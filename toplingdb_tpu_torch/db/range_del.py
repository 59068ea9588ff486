"""Range-deletion tombstones: fragmenting and aggregation (copied from
toplingdb_tpu/db/range_del.py, trimmed to what compaction needs).

A tombstone is (seq, begin_user_key inclusive, end_user_key exclusive). The
aggregator collects a compaction's tombstones; `fragment_tombstones` splits
them into the non-overlapping fragments that output SSTs store.
"""

from __future__ import annotations

from dataclasses import dataclass

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.dbformat import ValueType


@dataclass(frozen=True)
class RangeTombstone:
    seq: int
    begin: bytes  # user key, inclusive
    end: bytes    # user key, exclusive

    def to_table_entry(self) -> tuple[bytes, bytes]:
        """(internal begin key, end user key) as stored in SST meta blocks."""
        return (
            dbformat.make_internal_key(self.begin, self.seq,
                                       ValueType.RANGE_DELETION),
            self.end,
        )

    @staticmethod
    def from_table_entry(begin_ikey: bytes,
                         end_user_key: bytes) -> "RangeTombstone":
        uk, seq, t = dbformat.split_internal_key(begin_ikey)
        assert t == ValueType.RANGE_DELETION, t
        return RangeTombstone(seq, uk, end_user_key)


def fragment_tombstones(tombstones: list[RangeTombstone],
                        ucmp) -> list[RangeTombstone]:
    """Split overlapping tombstones into non-overlapping fragments, keeping
    for each fragment every distinct seqno whose original tombstone covers
    it. Output sorted by (begin, -seq); empty input gives empty output."""
    if not tombstones:
        return []
    points = sorted(
        {t.begin for t in tombstones} | {t.end for t in tombstones},
        key=lambda k: _CmpKey(ucmp, k),
    )
    out: list[RangeTombstone] = []
    for a, b in zip(points, points[1:]):
        seqs = sorted(
            {
                t.seq
                for t in tombstones
                if ucmp.compare(t.begin, a) <= 0
                and ucmp.compare(b, t.end) <= 0
            },
            reverse=True,
        )
        for s in seqs:
            out.append(RangeTombstone(s, a, b))
    return out


class _CmpKey:
    __slots__ = ("ucmp", "k")

    def __init__(self, ucmp, k):
        self.ucmp = ucmp
        self.k = k

    def __lt__(self, other):
        return self.ucmp.compare(self.k, other.k) < 0


class RangeDelAggregator:
    """Collects tombstones from all sources of one compaction."""

    def __init__(self, ucmp):
        self._ucmp = ucmp
        self._tombstones: list[RangeTombstone] = []

    def add(self, t: RangeTombstone) -> None:
        self._tombstones.append(t)

    def empty(self) -> bool:
        return not self._tombstones

    def max_covering_seq(self, user_key: bytes, snapshot_seq: int) -> int:
        """Max tombstone seqno <= snapshot covering user_key (0 = none)."""
        best = 0
        for t in self._tombstones:
            if (t.seq <= snapshot_seq and t.seq > best
                    and self._ucmp.compare(t.begin, user_key) <= 0
                    and self._ucmp.compare(user_key, t.end) < 0):
                best = t.seq
        return best

    def fragments(self) -> list[RangeTombstone]:
        return fragment_tombstones(self._tombstones, self._ucmp)

    def tombstones(self) -> list[RangeTombstone]:
        return list(self._tombstones)
