"""TableCache: open table readers keyed by file number (copied from
toplingdb_tpu/db/table_cache.py; RocksDB's db/table_cache.cc:92). At most
`capacity` readers stay open, least recently used dropped first. With a
Statistics sink (`stats`, set by the DB) every open ticks NO_FILE_OPENS and
TABLE_OPEN_IO_MICROS, a failed one NO_FILE_ERRORS. Files open through
`table.factory.open_table`, so every table format reads; block-format
readers share `block_cache`, their keys prefixed by this open's session and
the file number."""

from __future__ import annotations

import time
import uuid
from collections import OrderedDict

from toplingdb_tpu_torch.db import filename
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.table.builder import TableOptions
from toplingdb_tpu_torch.table.factory import open_table
from toplingdb_tpu_torch.utils import concurrency as ccy


class TableCache:
    def __init__(self, env, dbname: str, icmp: InternalKeyComparator,
                 table_options: TableOptions | None = None,
                 capacity: int = 512, block_cache=None):
        self._env = env
        self._dbname = dbname
        self._icmp = icmp
        self._topts = table_options or TableOptions()
        self._capacity = capacity
        self._block_cache = block_cache
        # Per-open uniquifier (RocksDB's cache-key session id): a shared
        # block cache must never serve one DB's blocks to another DB whose
        # file numbers collide.
        self._cache_session = uuid.uuid4().bytes[:8]
        self._readers: OrderedDict = OrderedDict()
        self._lock = ccy.Lock("table_cache.TableCache._lock")
        self.stats = None  # optional Statistics sink (set by the DB)

    def get_reader(self, file_number: int):
        with self._lock:
            r = self._readers.get(file_number)
            if r is not None:
                self._readers.move_to_end(file_number)
                return r
        path = filename.table_file_name(self._dbname, file_number)
        t0 = time.perf_counter() if self.stats is not None else None
        try:
            r = open_table(
                self._env.new_random_access_file(path), self._icmp,
                self._topts, block_cache=self._block_cache,
                cache_key_prefix=self._cache_session
                + file_number.to_bytes(8, "little"))
        except Exception:
            if self.stats is not None:
                from toplingdb_tpu_torch.utils import statistics as st

                self.stats.record_tick(st.NO_FILE_ERRORS)
            raise
        if t0 is not None:
            from toplingdb_tpu_torch.utils import statistics as st

            self.stats.record_tick(st.NO_FILE_OPENS)
            self.stats.record_in_histogram(
                st.TABLE_OPEN_IO_MICROS, (time.perf_counter() - t0) * 1e6)
        with self._lock:
            existing = self._readers.get(file_number)
            if existing is None:
                self._readers[file_number] = r
                while len(self._readers) > self._capacity:
                    # Drop the reference only: live iterators may still
                    # hold the reader; its file closes when the last
                    # reference dies.
                    self._readers.popitem(last=False)
                return r
        r.close()
        return existing

    def evict(self, file_number: int) -> None:
        """Close and forget one file's reader (its file became obsolete)."""
        with self._lock:
            r = self._readers.pop(file_number, None)
        if r is not None:
            r.close()

    def close(self) -> None:
        with self._lock:
            for r in self._readers.values():
                r.close()
            self._readers.clear()
