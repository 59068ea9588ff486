"""WriteBufferManager (copied from toplingdb_tpu/utils/rate_limiter.py,
trimmed to the write buffer manager; the rate limiter, write controller
and SST file manager are not in the port): RocksDB's
memtable/write_buffer_manager.cc role."""

from __future__ import annotations

import threading


class WriteBufferManager:
    """Memtable memory budget shared by DB instances (RocksDB's
    write_buffer_manager.h:37): each DB charges its memtables' memory here
    (db.py _sync_wbm), and when the sum over all DBs reaches the budget,
    the next write of any of them flushes."""

    def __init__(self, buffer_size: int):
        self.buffer_size = buffer_size
        self._usage = 0
        self._mu = threading.Lock()

    def reserve(self, n: int) -> None:
        with self._mu:
            self._usage += n

    def free(self, n: int) -> None:
        with self._mu:
            self._usage = max(0, self._usage - n)

    def memory_usage(self) -> int:
        return self._usage

    def should_flush(self) -> bool:
        return self.buffer_size > 0 and self._usage >= self.buffer_size
