"""LevelIterator: concatenation over one sorted level's files (copied from
toplingdb_tpu/db/level_iterator.py; RocksDB's LevelIterator inside
db/version_set.cc)."""

from __future__ import annotations

from toplingdb_tpu_torch.db.version_edit import FileMetaData


class LevelIterator:
    def __init__(self, table_cache, files: list[FileMetaData], icmp,
                 readahead_size: int = 0, aio_ring=None):
        self._tc = table_cache
        self._files = files
        self._icmp = icmp
        self._file_idx = -1
        self._iter = None
        # ReadOptions.readahead_size: fixed per-file-iterator prefetch
        # window (0 = the buffer's auto-scaling default). `aio_ring`
        # moves each file iterator's readahead windows onto a reader
        # ring thread (async read plane, env/async_reads.py).
        self._ra = readahead_size
        self._aio = aio_ring
        self._pf_hits = 0    # readahead counts of already-closed file iters
        self._pf_misses = 0

    def _open(self, idx: int) -> None:
        self._bank_prefetch()
        self._file_idx = idx
        if 0 <= idx < len(self._files):
            reader = self._tc.get_reader(self._files[idx].number)
            if (self._ra or self._aio is not None) \
                    and hasattr(reader, "new_index_iterator"):
                self._iter = reader.new_iterator(readahead_size=self._ra,
                                                 aio_ring=self._aio)
            else:
                self._iter = reader.new_iterator()
        else:
            self._iter = None

    def _bank_prefetch(self) -> None:
        pc = getattr(self._iter, "prefetch_counts", None)
        if pc is not None:
            h, m = pc()
            self._pf_hits += h
            self._pf_misses += m

    def prefetch_counts(self) -> tuple[int, int]:
        """(hits, misses) of every file iterator's FilePrefetchBuffer so
        far — the compaction input scan exports these as tickers."""
        h, m = self._pf_hits, self._pf_misses
        pc = getattr(self._iter, "prefetch_counts", None)
        if pc is not None:
            ch, cm = pc()
            h += ch
            m += cm
        return h, m

    def valid(self) -> bool:
        return self._iter is not None and self._iter.valid()

    def key(self):
        return self._iter.key()

    def value(self):
        return self._iter.value()

    def seek_to_first(self) -> None:
        self._open(0)
        if self._iter is not None:
            self._iter.seek_to_first()
            self._skip_forward()

    def seek_to_last(self) -> None:
        self._open(len(self._files) - 1)
        if self._iter is not None:
            self._iter.seek_to_last()
            self._skip_backward()

    def seek(self, target) -> None:
        # Binary search for first file whose largest >= target.
        lo, hi = 0, len(self._files) - 1
        pick = len(self._files)
        while lo <= hi:
            mid = (lo + hi) // 2
            if self._icmp.compare(self._files[mid].largest, target) >= 0:
                pick = mid
                hi = mid - 1
            else:
                lo = mid + 1
        self._open(pick)
        if self._iter is not None:
            self._iter.seek(target)
            self._skip_forward()

    def seek_for_prev(self, target) -> None:
        self.seek(target)
        if not self.valid():
            self.seek_to_last()
            return
        if self._icmp.compare(self.key(), target) > 0:
            self.prev()

    def next(self) -> None:
        assert self.valid()
        self._iter.next()
        self._skip_forward()

    def prev(self) -> None:
        assert self.valid()
        self._iter.prev()
        self._skip_backward()

    def _skip_forward(self) -> None:
        while self._iter is not None and not self._iter.valid():
            if self._file_idx + 1 >= len(self._files):
                self._iter = None
                return
            self._open(self._file_idx + 1)
            self._iter.seek_to_first()

    def _skip_backward(self) -> None:
        while self._iter is not None and not self._iter.valid():
            if self._file_idx - 1 < 0:
                self._iter = None
                return
            self._open(self._file_idx - 1)
            self._iter.seek_to_last()
