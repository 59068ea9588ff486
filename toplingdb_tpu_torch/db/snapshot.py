"""Seqno-based MVCC snapshots (copied from toplingdb_tpu/db/snapshot.py;
RocksDB's db/snapshot_impl.h), with the WritePrepared exclusion ranges."""

from __future__ import annotations

from toplingdb_tpu_torch.utils import concurrency as ccy


class Snapshot:
    __slots__ = ("sequence", "excluded_ranges", "_list")

    def __init__(self, sequence: int, slist: "SnapshotList",
                 excluded_ranges: tuple = ()):
        self.sequence = sequence
        self._list = slist
        # Seqno ranges INVISIBLE to this snapshot despite being <= sequence:
        # data written to the DB by prepared but undecided transactions
        # when the snapshot was taken (the WritePrepared policy; RocksDB's
        # SnapshotChecker / old_commit_map role). Such a transaction that
        # later commits gets a commit point after this snapshot, so the
        # exclusion holds for this snapshot's whole life.
        self.excluded_ranges = excluded_ranges

    def release(self) -> None:
        self._list.release(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class SnapshotList:
    def __init__(self):
        self._lock = ccy.Lock("snapshot.SnapshotList._lock")
        self._snapshots: list[Snapshot] = []

    def new_snapshot(self, sequence: int,
                     excluded_ranges: tuple = ()) -> Snapshot:
        s = Snapshot(sequence, self, excluded_ranges)
        with self._lock:
            self._snapshots.append(s)
        return s

    def release(self, s: Snapshot) -> None:
        with self._lock:
            try:
                self._snapshots.remove(s)
            except ValueError:
                pass

    def empty(self) -> bool:
        with self._lock:
            return not self._snapshots

    def sequences(self) -> list[int]:
        """Sorted live snapshot seqnos — the visibility stripes compaction
        must preserve (the CompactionIterator's snapshot list)."""
        with self._lock:
            return sorted({s.sequence for s in self._snapshots})

    def num_live(self) -> int:
        """Live snapshots (the tpulsm.num-snapshots property)."""
        with self._lock:
            return len(self._snapshots)

    def any_excluding(self, lo: int, hi: int) -> bool:
        """Does a live snapshot still exclude a seqno range overlapping
        [lo, hi]? (The WritePrepared compaction guard below an undecided
        range must outlive every snapshot that captured its exclusion.)"""
        with self._lock:
            for s in self._snapshots:
                for el, eh in s.excluded_ranges:
                    if el <= hi and lo <= eh:
                        return True
        return False
