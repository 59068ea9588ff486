"""Persistent (on-disk) block cache tier (copied from
toplingdb_tpu/utils/persistent_cache.py; the files are the same, so either
package recovers a directory the other wrote).

Analogue of RocksDB's persistent cache (utilities/persistent_cache/
block_cache_tier.{h,cc}, plus the compressed secondary cache role of
cache/compressed_secondary_cache.cc): blocks evicted from
the in-memory LRU spill to local cache files through a WRITE-BEHIND queue
(RocksDB's insert_ops_ writeback thread), lookups that miss memory
are served from disk (optionally decompressed) and promoted back by the
primary's chain, and the index is rebuilt on open by scanning the cache
files (CRC-checked records; torn tails ignored) — the tier survives
process restarts.

Layout: `cache-NNNNNN.data` files of records
    varint32 klen | varint32 plen | 1B flags | key | payload |
    fixed32 masked_crc(payload)
flags bit0 = snappy-compressed payload. Files roll at `file_size` bytes;
eviction drops whole LEAST-RECENTLY-ACCESSED files once total size
exceeds `capacity` (RocksDB's block_cache_tier also stores and reclaims
at file granularity).
"""

from __future__ import annotations

import os

from toplingdb_tpu_torch.utils import coding, crc32c
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils import concurrency as ccy

_F_SNAPPY = 0x1


class PersistentCache:
    def __init__(self, path: str, capacity_bytes: int = 256 << 20,
                 file_size: int = 4 << 20, compress: bool = True,
                 write_behind: bool = True, queue_bytes: int = 8 << 20):
        from toplingdb_tpu_torch.utils import codecs

        self._dir = path
        self._cap = capacity_bytes
        self._file_size = max(4096, file_size)
        # key -> (file, payload_off, plen, flags)
        self._index: dict[bytes, tuple[int, int, int, int]] = {}
        self._files: list[int] = []       # file numbers, oldest first
        self._sizes: dict[int, int] = {}
        self._atime: dict[int, int] = {}  # file -> last-access tick
        self._tick = 0
        self._cur: int | None = None
        self._cur_f = None
        self._mu = ccy.Lock("persistent_cache.PersistentCache._mu")
        self._compress = compress and codecs.available("snappy")
        # -- stats (RocksDB's PersistentCache::Stats role) --------------
        self.hits = 0
        self.misses = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.inserts = 0
        self.insert_dropped = 0
        os.makedirs(path, exist_ok=True)
        self._recover()
        # -- write-behind queue (RocksDB's block_cache_tier insert_ops_
        # writeback thread): inserts enqueue; a background writer encodes,
        # compresses, and appends outside every reader's path.
        self._pending: dict[bytes, bytes] = {}
        self._inflight: dict[bytes, bytes] = {}  # taken by the writer,
        self._pending_bytes = 0                  # not yet appended
        self._queue_cap = max(1 << 16, queue_bytes)
        self._closed = False
        self._wake = ccy.Condition(lock=self._mu)
        self._writer = None
        if write_behind:
            self._writer = ccy.spawn("tpt-pcache-writeback",
                                     self._writeback_loop, owner=self,
                                     stop=self.close)

    # -- layout helpers -------------------------------------------------

    def _fname(self, num: int) -> str:
        return os.path.join(self._dir, f"cache-{num:06d}.data")

    def _recover(self) -> None:
        nums = sorted(
            int(n[len("cache-"):-len(".data")])
            for n in os.listdir(self._dir)
            if n.startswith("cache-") and n.endswith(".data")
        )
        for num in nums:
            path = self._fname(num)
            try:
                data = open(path, "rb").read()
            except OSError:
                continue
            off = 0
            while off < len(data):
                try:
                    klen, o = coding.decode_varint32(data, off)
                    plen, o = coding.decode_varint32(data, o)
                    flags = data[o]
                    o += 1
                    key = bytes(data[o : o + klen])
                    po = o + klen
                    payload = data[po : po + plen]
                    stored = coding.decode_fixed32(data, po + plen)
                    if len(payload) != plen or crc32c.unmask(stored) != \
                            crc32c.value(payload):
                        break  # torn/corrupt tail: ignore the rest
                    self._index[key] = (num, po, plen, flags)
                    off = po + plen + 4
                except Exception as e:
                    _errors.swallow(reason="cache-index-scan-stop", exc=e)
                    break
            self._files.append(num)
            self._sizes[num] = off
            self._atime[num] = self._tick
            self._tick += 1
        self._enforce_capacity()

    # -- cache interface ------------------------------------------------

    def lookup(self, key: bytes) -> bytes | None:
        with self._mu:
            pending = self._pending.get(key)
            if pending is None:
                pending = self._inflight.get(key)
            if pending is not None:
                self.hits += 1
                return pending
            loc = self._index.get(key)
            if loc is not None:
                self._tick += 1
                self._atime[loc[0]] = self._tick
            else:
                self.misses += 1
        if loc is None:
            return None
        num, off, plen, flags = loc
        try:
            with open(self._fname(num), "rb") as f:
                f.seek(off)
                payload = f.read(plen)
        except OSError:
            return None
        if len(payload) != plen:
            return None
        if flags & _F_SNAPPY:
            from toplingdb_tpu_torch.utils import codecs

            try:
                payload = codecs.snappy_decompress(payload)
            except Exception as e:
                _errors.swallow(reason="cache-snappy-corrupt", exc=e)
                return None
        with self._mu:
            self.hits += 1
            self.bytes_read += len(payload)
        return payload

    def insert(self, key: bytes, value: bytes) -> None:
        if not isinstance(value, (bytes, bytearray)):
            return  # only raw blocks spill to disk
        value = bytes(value)
        with self._mu:
            if self._closed:
                return  # writes must not resurrect a shut-down tier
            if (key in self._index or key in self._pending
                    or key in self._inflight):
                return
            self.inserts += 1
            if self._writer is not None and not self._closed:
                if self._pending_bytes + len(value) > self._queue_cap:
                    self.insert_dropped += 1  # backpressure: drop, a cache
                    return
                self._pending[key] = value
                self._pending_bytes += len(value)
                self._wake.notify()
                return
        self._write_record(key, value)

    def _encode(self, key: bytes, value: bytes):
        """(record_bytes, payload_offset_in_record, plen, flags)."""
        payload = value
        flags = 0
        if self._compress and len(value) >= 64:
            from toplingdb_tpu_torch.utils import codecs

            c = codecs.snappy_compress(value)
            if len(c) < len(value):
                payload = c
                flags = _F_SNAPPY
        rec = bytearray()
        rec += coding.encode_varint32(len(key))
        rec += coding.encode_varint32(len(payload))
        rec.append(flags)
        rec += key
        poff = len(rec)
        rec += payload
        rec += coding.encode_fixed32(crc32c.mask(crc32c.value(payload)))
        return bytes(rec), poff, len(payload), flags

    def _write_record(self, key: bytes, value: bytes) -> None:
        rec, poff, plen, flags = self._encode(key, value)
        with self._mu:
            if self._closed and self._cur_f is None:
                # Fully shut down (close() already closed the data file):
                # appending would silently roll a FRESH cache file. The
                # `_cur_f is not None` window keeps close()'s own final
                # flush of queued inserts working.
                return
            self._append_locked(key, rec, poff, plen, flags)

    def _append_locked(self, key, rec, poff, plen, flags) -> None:
        if self._cur_f is None or \
                self._sizes.get(self._cur, 0) >= self._file_size:
            self._roll_locked()
        base = self._sizes[self._cur]
        self._cur_f.write(rec)
        self._cur_f.flush()
        self._index[key] = (self._cur, base + poff, plen, flags)
        self._sizes[self._cur] = base + len(rec)
        self.bytes_written += len(rec)
        self._tick += 1
        self._atime[self._cur] = self._tick
        self._enforce_capacity()

    def _writeback_loop(self) -> None:
        while True:
            with self._mu:
                while not self._pending and not self._closed:
                    self._wake.wait(timeout=0.5)
                if self._closed and not self._pending:
                    return
                # Move the batch to _inflight so it stays VISIBLE to
                # lookups, flush() waits for it, and erase() can veto an
                # entry while we encode outside the lock.
                batch = list(self._pending.items())
                self._inflight.update(self._pending)
                self._pending.clear()
                self._pending_bytes = 0
            # Encode/compress OUTSIDE the lock; append under it.
            encoded = [(k, self._encode(k, v)) for k, v in batch]
            with self._mu:
                for k, (rec, poff, plen, flags) in encoded:
                    # An erase() during encoding removed the key from
                    # _inflight — appending it anyway would resurrect a
                    # deleted block.
                    if k in self._inflight and k not in self._index:
                        self._append_locked(k, rec, poff, plen, flags)
                    self._inflight.pop(k, None)
                self._wake.notify_all()  # flush() waiters

    def _roll_locked(self) -> None:
        if self._cur_f is not None:
            self._cur_f.close()
        num = (self._files[-1] + 1) if self._files else 0
        self._cur = num
        self._files.append(num)
        self._sizes[num] = 0
        self._atime[num] = self._tick
        self._cur_f = open(self._fname(num), "ab")

    def _enforce_capacity(self) -> None:
        while sum(self._sizes.values()) > self._cap and len(self._files) > 1:
            # Least-recently-ACCESSED file goes first (never the one being
            # written); lookups bump their file's atime.
            victims = [f for f in self._files if f != self._cur]
            if not victims:
                break
            old = min(victims, key=lambda f: self._atime.get(f, 0))
            self._files.remove(old)
            self._index = {
                k: loc for k, loc in self._index.items() if loc[0] != old
            }
            self._sizes.pop(old, None)
            self._atime.pop(old, None)
            try:
                os.remove(self._fname(old))
            except OSError:
                pass

    def erase(self, key: bytes) -> None:
        """Drop the index entry (the record's bytes are reclaimed when its
        file ages out — file-granularity storage, key-granularity delete)."""
        with self._mu:
            self._index.pop(key, None)
            self._inflight.pop(key, None)  # vetoes an in-flight append
            if key in self._pending:
                self._pending_bytes -= len(self._pending.pop(key))

    def flush(self) -> None:
        """Drain the write-behind queue INCLUDING the in-flight batch
        (tests / clean shutdown)."""
        import time as _t

        while True:
            with self._mu:
                if not self._pending and not self._inflight:
                    return
                if self._writer is None or not self._writer.is_alive():
                    batch = list(self._pending.items()) + \
                        list(self._inflight.items())
                    self._pending.clear()
                    self._inflight.clear()
                    self._pending_bytes = 0
                else:
                    batch = None
                    self._wake.notify_all()
            if batch is not None:
                for k, v in batch:
                    self._write_record(k, v)
                return
            _t.sleep(0.005)

    def close(self) -> None:
        with self._mu:
            self._closed = True
            self._wake.notify_all()
        if self._writer is not None:
            self._writer.join(timeout=5)
        self.flush()
        with self._mu:
            if self._cur_f is not None:
                self._cur_f.close()
                self._cur_f = None

    def prune(self) -> int:
        """Drop every sealed cache file (disk-pressure reclaim: everything
        here is a clean copy of a store object, so dropping costs only
        refetch latency). Returns bytes freed. The file being written
        stays — its writer handle is live."""
        freed = 0
        with self._mu:
            victims = [f for f in self._files if f != self._cur]
            for old in victims:
                self._files.remove(old)
                self._index = {
                    k: loc for k, loc in self._index.items()
                    if loc[0] != old
                }
                freed += self._sizes.pop(old, 0)
                self._atime.pop(old, None)
                try:
                    os.remove(self._fname(old))
                except OSError:
                    pass
        return freed

    def usage(self) -> int:
        with self._mu:
            return sum(self._sizes.values())

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        """Counter snapshot (RocksDB's PersistentCache::Stats / the
        block_cache_tier stats surface)."""
        with self._mu:
            return {
                "hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hit_rate(), 4),
                "bytes_written": self.bytes_written,
                "bytes_read": self.bytes_read,
                "inserts": self.inserts,
                "insert_dropped": self.insert_dropped,
                "files": len(self._files),
                "usage": sum(self._sizes.values()),
                "pending_bytes": self._pending_bytes,
                "compressed": self._compress,
            }
