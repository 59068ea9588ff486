"""Seqno-based MVCC snapshots (copied from toplingdb_tpu/db/snapshot.py,
without the WritePrepared exclusion ranges; RocksDB's
db/snapshot_impl.h)."""

from __future__ import annotations

from toplingdb_tpu_torch.utils import concurrency as ccy


class Snapshot:
    __slots__ = ("sequence", "_list")

    def __init__(self, sequence: int, slist: "SnapshotList"):
        self.sequence = sequence
        self._list = slist

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

    def new_snapshot(self, sequence: int) -> Snapshot:
        s = Snapshot(sequence, self)
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
