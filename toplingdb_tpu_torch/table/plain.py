"""PlainTable: flat all-in-RAM format with a PREFIX hash index (copied from
toplingdb_tpu/table/plain.py).

The role of RocksDB's PlainTable: a no-block format where point lookups
hash the key's PREFIX (Options.prefix_extractor) to a bucket holding the
start of that prefix's entry group, then binary-search inside the group. Reuses the single_fast
flat region/offset-array machinery (table/single_fast.py) — the difference
is purely the index discipline:

- single_fast: optional whole-key open-addressed index, one slot per user key;
- plain: prefix-bucket index, one slot per DISTINCT PREFIX (smaller index,
  natural fit for prefix-scan workloads), out-of-domain keys fall back to
  total-order binary search.

RocksDB's restrictions kept: the bytewise comparator and a prefix
extractor are required (the format is hash-based).
"""

from __future__ import annotations

import numpy as np

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.single_fast import (
    SingleFastTableBuilder,
    SingleFastTableReader,
)
from toplingdb_tpu_torch.utils import crc32c
from toplingdb_tpu_torch.utils.status import Corruption, InvalidArgument

METAINDEX_PREFIX_INDEX = b"tpulsm.pt.prefix_index"


class PlainTableBuilder(SingleFastTableBuilder):
    """Flat region + prefix-bucket hash index."""

    FOOTER_MAGIC = fmt.PLAIN_MAGIC

    def __init__(self, wfile, icmp: InternalKeyComparator, options=None,
                 **kw):
        super().__init__(wfile, icmp, options, **kw)
        if getattr(self.opts, "prefix_extractor", None) is None:
            raise InvalidArgument(
                "plain table format requires TableOptions.prefix_extractor"
            )
        if icmp.user_comparator.name() != dbformat.BYTEWISE.name():
            raise InvalidArgument(
                "plain table format requires the bytewise comparator "
                "(prefix groups must be byte-contiguous)"
            )

    def _hash_index_block(self) -> tuple[bytes, bytes] | None:
        # One bucket per distinct prefix: 1 + ordinal of the FIRST entry of
        # the prefix group (the newest version of the group's smallest key).
        # Out-of-domain keys are indexed nowhere; lookups for them fall back
        # to binary search.
        n = len(self._offsets)
        if n == 0:
            return None
        pe = self.opts.prefix_extractor
        firsts: list[tuple[bytes, int]] = []  # (prefix, first ordinal)
        prev = None
        for i in range(n):
            uk = self._entry_user_key(i)
            if not pe.in_domain(uk):
                continue
            p = pe.transform(uk)
            if p != prev:
                firsts.append((p, i))
                prev = p
        if not firsts:
            return None
        nb = 1
        while nb < (len(firsts) * 10) // 7 + 1:
            nb <<= 1
        buckets = np.zeros(nb, dtype="<u4")
        mask = nb - 1
        for p, i in firsts:
            h = crc32c.xxh64(p) & mask
            while buckets[h]:
                h = (h + 1) & mask
            buckets[h] = i + 1
        return METAINDEX_PREFIX_INDEX, buckets.tobytes()


class PlainTableReader(SingleFastTableReader):
    FOOTER_MAGIC = fmt.PLAIN_MAGIC

    def _load_hash_index(self) -> None:
        self._hash_buckets = None
        hh = self._meta_handles.get(METAINDEX_PREFIX_INDEX)
        if hh is not None:
            self._hash_buckets = np.frombuffer(
                fmt.read_block(_mem(self._data), hh,
                               self.opts.verify_checksums),
                dtype="<u4",
            )
        self._pe = self._resolved_pe  # resolved by SingleFastTableReader
        # has_hash_index drives the DB Get fast path; the fallback inside
        # hash_probe keeps the contract for out-of-domain keys.
        self.has_hash_index = True

    def _newest_ordinal(self, user_key: bytes, lo: int = 0) -> int | None:
        """Ordinal of the newest version of user_key at or after `lo`, or
        None when absent."""
        i = self._lower_bound_from(
            dbformat.make_internal_key(
                user_key, dbformat.MAX_SEQUENCE_NUMBER,
                dbformat.VALUE_TYPE_FOR_SEEK,
            ),
            lo,
        )
        if i < self.n and self._entry(i)[0][:-8] == user_key:
            return i
        return None

    def _lower_bound_from(self, target: bytes, lo: int) -> int:
        hi = self.n
        cmp = self._icmp.compare
        while lo < hi:
            mid = (lo + hi) // 2
            if cmp(self._entry(mid)[0], target) < 0:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def hash_probe(self, user_key: bytes) -> int | None:
        if self._pe is None or not self._pe.in_domain(user_key):
            return self._newest_ordinal(user_key)
        if self._hash_buckets is None:
            return self._newest_ordinal(user_key)
        prefix = self._pe.transform(user_key)
        buckets = self._hash_buckets
        mask = len(buckets) - 1
        h = crc32c.xxh64(prefix) & mask
        for _ in range(len(buckets)):  # bounded: corrupt blocks can't hang
            v = int(buckets[h])
            if v == 0:
                return None  # no such prefix group → key absent
            start = v - 1
            if start >= self.n:
                raise Corruption("plain table prefix bucket out of range")
            uk = self._entry(start)[0][:-8]
            if self._pe.in_domain(uk) and self._pe.transform(uk) == prefix:
                return self._newest_ordinal(user_key, start)
            h = (h + 1) & mask
        raise Corruption("plain table prefix index has no empty buckets")

    def prefix_seek_start(self, prefix: bytes) -> int | None:
        """Ordinal of the first entry whose key has `prefix`, or None when
        no such group exists (prefix-scan entry point)."""
        if self._hash_buckets is None:
            return None
        buckets = self._hash_buckets
        mask = len(buckets) - 1
        h = crc32c.xxh64(prefix) & mask
        for _ in range(len(buckets)):
            v = int(buckets[h])
            if v == 0:
                return None
            start = v - 1
            if start >= self.n:
                raise Corruption("plain table prefix bucket out of range")
            uk = self._entry(start)[0][:-8]
            if (self._pe is not None and self._pe.in_domain(uk)
                    and self._pe.transform(uk) == prefix):
                return start
            h = (h + 1) & mask
        raise Corruption("plain table prefix index has no empty buckets")


def _mem(data: bytes):
    from toplingdb_tpu_torch.table.single_fast import _Mem

    return _Mem(data)
