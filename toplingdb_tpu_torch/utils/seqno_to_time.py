"""Seqno <-> wall-time mapping (copied from
toplingdb_tpu/utils/seqno_to_time.py).

The role of RocksDB's SeqnoToTimeMapping (db/seqno_to_time_mapping.cc): a
sorted list of (seqno, time) pairs sampled as writes happen, used to answer
"roughly when was this sequence number written", the basis of
preclude_last_level_data_seconds. Capacity-bounded: when full, every other
pair is dropped (halving the sampling resolution, like RocksDB's enforced
max_capacity)."""

from __future__ import annotations

import bisect
from toplingdb_tpu_torch.utils import concurrency as ccy


class SeqnoToTimeMapping:
    def __init__(self, max_capacity: int = 100):
        self._pairs: list[tuple[int, int]] = []  # (seqno, unix_time) ascending
        self._max = max(2, max_capacity)
        self._mu = ccy.Lock("seqno_to_time.SeqnoToTimeMapping._mu")

    def append(self, seqno: int, time_: int) -> None:
        """Record seqno existed at time_; out-of-order appends are ignored
        (the mapping must stay monotonic in both axes)."""
        with self._mu:
            if self._pairs:
                ls, lt = self._pairs[-1]
                if seqno <= ls or time_ < lt:
                    return
            self._pairs.append((seqno, time_))
            if len(self._pairs) > self._max:
                self._pairs = self._pairs[::2] + [self._pairs[-1]] \
                    if len(self._pairs) % 2 == 0 else self._pairs[::2]

    def get_proximal_time(self, seqno: int) -> int | None:
        """The time of the greatest recorded seqno <= seqno (None if seqno
        predates the mapping): RocksDB's GetProximalTimeBeforeSeqno."""
        with self._mu:
            i = bisect.bisect_right([s for s, _ in self._pairs], seqno)
            if i == 0:
                return None
            return self._pairs[i - 1][1]

    def get_proximal_seqno(self, time_: int) -> int | None:
        """Greatest recorded seqno written at/before time_ (RocksDB's
        GetProximalSeqnoBeforeTime); None if time_ predates the mapping."""
        with self._mu:
            i = bisect.bisect_right([t for _, t in self._pairs], time_)
            if i == 0:
                return None
            return self._pairs[i - 1][0]

    def __len__(self) -> int:
        with self._mu:
            return len(self._pairs)

    def to_list(self) -> list:
        with self._mu:
            return [list(p) for p in self._pairs]

    def load(self, pairs) -> None:
        """Replace contents from a persisted list (monotonic enforcement
        re-applied)."""
        with self._mu:
            self._pairs = []
        for seqno, t in pairs:
            self.append(int(seqno), int(t))
