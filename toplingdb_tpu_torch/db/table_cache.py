"""TableCache: open table readers keyed by file number (copied from
toplingdb_tpu/db/table_cache.py, trimmed: no capacity bound, no block
cache). With a Statistics sink (`stats`, set by the DB) every open ticks
NO_FILE_OPENS and TABLE_OPEN_IO_MICROS, a failed one NO_FILE_ERRORS. Files open through `table.factory.open_table`, so every
table format reads."""

from __future__ import annotations

import threading
import time

from toplingdb_tpu_torch.db import filename
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.table.builder import TableOptions
from toplingdb_tpu_torch.table.factory import open_table


class TableCache:
    def __init__(self, env, dbname: str, icmp: InternalKeyComparator,
                 table_options: TableOptions | None = None):
        self._env = env
        self._dbname = dbname
        self._icmp = icmp
        self._topts = table_options or TableOptions()
        self._readers: dict = {}
        self._lock = threading.Lock()
        self.stats = None  # optional Statistics sink (set by the DB)

    def get_reader(self, file_number: int):
        with self._lock:
            r = self._readers.get(file_number)
            if r is not None:
                return r
        path = filename.table_file_name(self._dbname, file_number)
        t0 = time.perf_counter() if self.stats is not None else None
        try:
            r = open_table(self._env.new_random_access_file(path),
                           self._icmp, self._topts)
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
            existing = self._readers.setdefault(file_number, r)
        if existing is not r:
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
