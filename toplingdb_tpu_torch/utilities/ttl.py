"""TTL DB: per-record expiry (copied from toplingdb_tpu/utilities/ttl.py;
RocksDB's utilities/ttl/).

Values carry a 4-byte little-endian unix write-timestamp suffix; reads
strip it and hide expired records; a compaction filter drops them. The
clock is injectable. A TtlDB's jobs carry a compaction filter, so on the
port's device executor they take the per-entry route
(`device_gc_entries`: one gc_rows launch a job on the card).
"""

from __future__ import annotations

import struct
import time

from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.options import FlushOptions, Options, ReadOptions, WriteOptions
from toplingdb_tpu_torch.utils.compaction_filter import CompactionFilter, Decision
from toplingdb_tpu_torch.utils.status import Corruption

_TS = struct.Struct("<I")


class TtlCompactionFilter(CompactionFilter):
    def __init__(self, ttl: int, clock=time.time, user_filter=None):
        self.ttl = ttl
        self.clock = clock
        self.user_filter = user_filter

    def name(self) -> str:
        return f"TtlCompactionFilter:{self.ttl}"

    def filter(self, level, key, value):
        if len(value) < 4:
            return Decision.KEEP, None
        ts = _TS.unpack_from(value, len(value) - 4)[0]
        if self.ttl > 0 and ts + self.ttl <= int(self.clock()):
            return Decision.REMOVE, None
        if self.user_filter is not None:
            d, nv = self.user_filter.filter(level, key, value[:-4])
            if d == Decision.CHANGE_VALUE:
                return d, (nv or b"") + value[-4:]
            return d, None
        return Decision.KEEP, None


class TtlDB:
    """StackableDB-style wrapper (RocksDB's DBWithTTLImpl)."""

    def __init__(self, db: DB, ttl: int, clock=time.time):
        self._db = db
        self.ttl = ttl
        self._clock = clock

    @staticmethod
    def open(path: str, ttl: int, options: Options | None = None,
             clock=time.time) -> "TtlDB":
        options = options or Options()
        options.compaction_filter = TtlCompactionFilter(
            ttl, clock, options.compaction_filter
        )
        return TtlDB(DB.open(path, options), ttl, clock)

    def put(self, key: bytes, value: bytes,
            opts: WriteOptions = WriteOptions()) -> None:
        ts = _TS.pack(int(self._clock()) & 0xFFFFFFFF)
        self._db.put(key, value + ts, opts)

    def get(self, key: bytes, opts: ReadOptions = ReadOptions()) -> bytes | None:
        v = self._db.get(key, opts)
        if v is None:
            return None
        if len(v) < 4:
            raise Corruption("TTL value missing timestamp suffix")
        ts = _TS.unpack_from(v, len(v) - 4)[0]
        if self.ttl > 0 and ts + self.ttl <= int(self._clock()):
            return None  # logically expired but not yet compacted away
        return v[:-4]

    def delete(self, key: bytes, opts: WriteOptions = WriteOptions()) -> None:
        self._db.delete(key, opts)

    def compact_range(self, *a, **kw) -> None:
        self._db.compact_range(*a, **kw)

    def flush(self, fopts: FlushOptions = FlushOptions()) -> None:
        self._db.flush(fopts)

    def close(self) -> None:
        self._db.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def db(self) -> DB:
        return self._db
