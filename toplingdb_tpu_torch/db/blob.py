"""Integrated blob files: key-value separation for large values (copied
from toplingdb_tpu/db/blob.py; RocksDB's db/blob/).

Values >= min_blob_size are written to .blob files at flush; the LSM keeps
a BLOB_INDEX entry pointing at (file, offset, size). Each SST's FileMetaData carries the
set of blob files it references (blob_refs), and compaction-time blob GC
(BlobGarbageCollector) rewrites survivors out of the oldest referenced blob
files.

Blob file format:
  header:  magic "TPULSMBL" (8B)
  record:  varint32 key_len | varint32 val_len | key | value |
           fixed32 masked_crc32c(value)
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.utils import coding, crc32c
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.cache import LRUCache
from toplingdb_tpu_torch.utils.status import Corruption, NotFound
from toplingdb_tpu_torch.utils import concurrency as ccy

MAGIC = b"TPULSMBL"


def blob_file_name(dbname: str, number: int) -> str:
    return os.path.join(dbname, f"{number:06d}.blob")


def encode_blob_index(file_number: int, offset: int, size: int) -> bytes:
    return (coding.encode_varint64(file_number)
            + coding.encode_varint64(offset)
            + coding.encode_varint64(size))


def decode_blob_index(data: bytes) -> tuple[int, int, int]:
    fn, off = coding.decode_varint64(data, 0)
    offset, off = coding.decode_varint64(data, off)
    size, off = coding.decode_varint64(data, off)
    return fn, offset, size


class BlobFileBuilder:
    """Writes one blob file; returns a BLOB_INDEX payload per value."""

    def __init__(self, env, dbname: str, file_number: int):
        self.file_number = file_number
        self._path = blob_file_name(dbname, file_number)
        self._f = env.new_writable_file(self._path)
        self._f.append(MAGIC)
        self.num_values = 0

    def add(self, key: bytes, value: bytes) -> bytes:
        offset = self._f.file_size()
        rec = bytearray()
        rec += coding.encode_varint32(len(key))
        rec += coding.encode_varint32(len(value))
        rec += key
        rec += value
        rec += coding.encode_fixed32(crc32c.mask(crc32c.value(value)))
        self._f.append(bytes(rec))
        self.num_values += 1
        return encode_blob_index(
            self.file_number, offset, self._f.file_size() - offset
        )

    def finish(self) -> int:
        """Sync + close; returns number of values (0 = caller may delete)."""
        if self.num_values:
            self._f.sync()
        self._f.close()
        return self.num_values


class BlobFileReader:
    def __init__(self, env, dbname: str, file_number: int):
        self._f = env.new_random_access_file(
            blob_file_name(dbname, file_number))
        if self._f.read(0, len(MAGIC)) != MAGIC:
            raise Corruption(f"bad blob file magic in {file_number}")

    def get(self, offset: int, size: int, verify: bool = True) -> bytes:
        rec = self._f.read(offset, size)
        if len(rec) != size:
            raise Corruption("truncated blob record")
        klen, off = coding.decode_varint32(rec, 0)
        vlen, off = coding.decode_varint32(rec, off)
        off += klen
        value = bytes(rec[off: off + vlen])
        if verify:
            stored = crc32c.unmask(coding.decode_fixed32(rec, off + vlen))
            if crc32c.value(value) != stored:
                raise Corruption("blob value checksum mismatch")
        return value

    def close(self) -> None:
        self._f.close()


class BlobSource:
    """The blob read tier (RocksDB's db/blob/blob_source.{h,cc} and
    blob_file_cache.cc): an LRU-capped set of open blob readers plus an
    optional shared value cache, so hot blob workloads stop re-reading
    files on every get. Thread-safe. `get(blob_index)` is the
    `blob_resolver` a compaction takes. `blob_cache`: an int capacity in
    bytes (an LRUCache is built; 0 = none) or a cache instance. Statistics:
    BLOB_DB_CACHE_HIT / _MISS / _BYTES_READ / _BYTES_WRITE,
    BLOB_DB_BYTES_READ, BLOB_DB_BLOB_FILE_BYTES_READ and
    BLOB_DB_NUM_KEYS_READ."""

    def __init__(self, env, dbname: str, blob_cache=None,
                 open_limit: int = 256, statistics=None):
        self._env = env
        self._dbname = dbname
        self._readers: OrderedDict[int, BlobFileReader] = OrderedDict()
        self._open_limit = max(1, int(open_limit))
        self._mu = ccy.Lock("blob.BlobSource._mu")
        self.stats = statistics
        if isinstance(blob_cache, int):
            blob_cache = LRUCache(blob_cache) if blob_cache > 0 else None
        self._cache = blob_cache

    def _reader(self, fn: int) -> BlobFileReader:
        with self._mu:
            r = self._readers.get(fn)
            if r is not None:
                self._readers.move_to_end(fn)
                return r
        r = BlobFileReader(self._env, self._dbname, fn)
        with self._mu:
            existing = self._readers.get(fn)
            if existing is not None:
                r.close()  # lost the open race; ours was never shared
                return existing
            self._readers[fn] = r
            while len(self._readers) > self._open_limit:
                # Drop the evicted reader without closing: another thread
                # may be mid-read on it. The file closes with its last
                # reference.
                self._readers.popitem(last=False)
        return r

    def get(self, blob_index: bytes, verify: bool = True) -> bytes:
        fn, offset, size = decode_blob_index(blob_index)
        s = self.stats
        if s is not None:
            s.record_tick(st.BLOB_DB_NUM_KEYS_READ)
        cache = self._cache
        if cache is not None:
            ck = blob_index if isinstance(blob_index, bytes) \
                else bytes(blob_index)
            v = cache.lookup(ck)
            if v is not None:
                if s is not None:
                    s.record_ticks(((st.BLOB_DB_CACHE_HIT, 1),
                                    (st.BLOB_DB_CACHE_BYTES_READ, len(v)),
                                    (st.BLOB_DB_BYTES_READ, len(v))))
                return v
            if s is not None:
                s.record_tick(st.BLOB_DB_CACHE_MISS)
        value = self._reader(fn).get(offset, size, verify)
        if s is not None:
            s.record_ticks(((st.BLOB_DB_BLOB_FILE_BYTES_READ, size),
                            (st.BLOB_DB_BYTES_READ, len(value))))
        if cache is not None:
            cache.insert(ck, value, len(value))
            if s is not None:
                s.record_tick(st.BLOB_DB_CACHE_BYTES_WRITE, len(value))
        return value

    def evict(self, file_number: int) -> None:
        with self._mu:
            r = self._readers.pop(file_number, None)
        if r is not None:
            r.close()

    def close(self) -> None:
        with self._mu:
            readers = list(self._readers.values())
            self._readers.clear()
        for r in readers:
            r.close()


class BlobGarbageCollector:
    """Compaction-time blob GC (RocksDB's
    blob_garbage_collection_age_cutoff): given the blob files referenced by
    the compaction's inputs, the oldest `age_cutoff` fraction are GC
    targets. Surviving entries pointing into a target file have their
    values resolved and rewritten — into a fresh blob file when still
    >= min_blob_size, inline otherwise — so the old file's reference count
    drains."""

    def __init__(self, env, dbname: str, input_blob_refs: list[int],
                 age_cutoff: float, min_blob_size: int, blob_resolver,
                 new_file_number):
        refs = sorted(set(input_blob_refs))
        n_gc = min(len(refs), math.ceil(len(refs) * age_cutoff))
        self.gc_files = set(refs[:n_gc])  # oldest fraction by file number
        self._env = env
        self._dbname = dbname
        self._min_blob_size = min_blob_size
        self._resolver = blob_resolver
        self._new_file_number = new_file_number
        self._builder: BlobFileBuilder | None = None
        self.new_blob_file: int | None = None
        self.rewritten = 0
        self.inlined = 0

    @property
    def active(self) -> bool:
        return bool(self.gc_files)

    def rewrite(self, stream):
        """Map a survivor (internal_key, value) stream, rewriting blob
        indexes that point into GC-target files."""
        bi = dbformat.ValueType.BLOB_INDEX
        for ikey, value in stream:
            if ikey[-8] == bi:
                fn, _, _ = decode_blob_index(value)
                if fn in self.gc_files:
                    uk, seq, _ = dbformat.split_internal_key(ikey)
                    raw = self._resolver(value)
                    if len(raw) >= self._min_blob_size:
                        if self._builder is None:
                            self.new_blob_file = self._new_file_number()
                            self._builder = BlobFileBuilder(
                                self._env, self._dbname, self.new_blob_file
                            )
                        value = self._builder.add(uk, raw)
                        self.rewritten += 1
                    else:
                        ikey = dbformat.make_internal_key(
                            uk, seq, dbformat.ValueType.VALUE
                        )
                        value = raw
                        self.inlined += 1
            yield ikey, value

    def _delete_new_file(self) -> None:
        try:
            self._env.delete_file(
                blob_file_name(self._dbname, self.new_blob_file))
        except (NotFound, OSError):
            pass  # best-effort cleanup; the job's own error propagates
        self.new_blob_file = None

    def finish(self) -> None:
        """Close the output blob file (delete it if nothing was written)."""
        if self._builder is None:
            return
        if self._builder.finish() == 0:
            self._delete_new_file()
        self._builder = None

    def abort(self) -> None:
        """Failed compaction: close and delete the half-written output blob
        file (its pointers were never installed in any SST)."""
        if self._builder is None:
            return
        self._builder.finish()
        self._delete_new_file()
        self._builder = None


def maybe_new_blob_gc(db, compaction, new_file_number):
    """Shared constructor for the compaction-time collector (used by the
    local scheduler AND the device executor so the eligibility policy can't
    diverge): None unless GC is enabled and the inputs reference blob
    files."""
    opts = db.options
    if not opts.enable_blob_garbage_collection:
        return None
    refs = [fn for _, f in compaction.all_inputs() for fn in f.blob_refs]
    if not refs:
        return None
    return BlobGarbageCollector(
        db.env, db.dbname, refs, opts.blob_garbage_collection_age_cutoff,
        opts.min_blob_size, db.blob_source.get, new_file_number,
    )
