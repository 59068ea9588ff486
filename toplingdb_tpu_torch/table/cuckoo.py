"""CuckooTable: hash-table SST for point-lookup-dominated workloads (copied
from toplingdb_tpu/table/cuckoo.py).

The role of RocksDB's CuckooTable: every user key lives in
one of exactly TWO buckets, so a point lookup is at most two entry
comparisons — O(1) worst case, unlike the open-addressed single_fast index
whose probe chains grow with load. Buckets are placed by cuckoo
displacement at build time (kick the resident, re-place it in its
alternate bucket, bounded walk, grow + rebuild on failure).

Unlike RocksDB's hash-ordered buckets, the data region stays the SORTED
flat [varint klen | varint vlen | ikey | value] region of the single_fast
format, so ordered iteration comes for free and only the index block
differs; both hash values derive from one xxh64 (low/high halves).
Restrictions as in RocksDB: unique user keys (one version per key —
last-level files) and no range deletions;
violations raise NotSupported, which fails the surrounding job cleanly
(build_outputs deletes partial and completed outputs on any mid-stream
error) — choose this format only for workloads meeting the restrictions.
"""

from __future__ import annotations

import numpy as np

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.single_fast import (
    SingleFastTableBuilder,
    SingleFastTableReader,
    _Mem,
)
from toplingdb_tpu_torch.utils import crc32c
from toplingdb_tpu_torch.utils.status import Corruption, NotSupported

METAINDEX_CUCKOO_INDEX = b"tpulsm.cuckoo.index"

# Bounded displacement walk; beyond this the table grows and rebuilds.
_MAX_KICKS = 500


def _bucket_pair_from_hash(h: int, mask: int) -> tuple[int, int]:
    """Two bucket candidates from one xxh64 (low/high halves). When both
    halves collide onto one bucket the alternate is the adjacent one so
    displacement always has somewhere to go."""
    b1 = h & mask
    b2 = (h >> 32) & mask
    if b2 == b1:
        b2 = (b1 + 1) & mask
    return b1, b2


def _bucket_pair(user_key: bytes, mask: int) -> tuple[int, int]:
    return _bucket_pair_from_hash(crc32c.xxh64(user_key), mask)


class CuckooTableBuilder(SingleFastTableBuilder):
    """Same surface as TableBuilder; data region identical to single_fast,
    index block replaced by the cuckoo bucket array."""

    FOOTER_MAGIC = fmt.CUCKOO_MAGIC

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # Fail fast, before any bytes are written: hash equality must
        # coincide with comparator equality.
        if self._icmp.user_comparator.name() != dbformat.BYTEWISE.name():
            raise NotSupported(
                "cuckoo tables require the bytewise comparator"
            )

    def _add_sorted(self, ikey: bytes, value: bytes) -> None:
        if self._last_key is not None:
            prev_uk = self._last_key[:-8]
            if prev_uk == ikey[:-8]:
                raise NotSupported(
                    "cuckoo tables require unique user keys (one version "
                    "per key); use single_fast or the block format"
                )
        super()._add_sorted(ikey, value)

    def add_tombstone(self, begin_ikey: bytes, end_user_key: bytes) -> None:
        raise NotSupported("cuckoo tables do not support range deletions")

    def _hash_index_block(self) -> tuple[bytes, bytes] | None:
        if not self._offsets:
            return None
        n = len(self._offsets)
        # Hash each key ONCE; displacement kicks and grow retries then cost
        # two mask ops per step instead of a fresh xxh64.
        hashes = [
            crc32c.xxh64(self._entry_user_key(i)) for i in range(n)
        ]
        # 2-choice single-slot cuckoo hashing is only reliably placeable
        # below ~0.5 load; sizing at >= 2n skips doomed placement passes.
        nb = 4
        while nb < 2 * n:
            nb <<= 1
        while True:
            buckets = self._try_place(hashes, nb)
            if buckets is not None:
                return METAINDEX_CUCKOO_INDEX, buckets.tobytes()
            nb <<= 1

    @staticmethod
    def _try_place(hashes: list[int], nb: int) -> np.ndarray | None:
        mask = nb - 1
        buckets = np.zeros(nb, dtype="<u4")  # ordinal + 1; 0 = empty
        for i, h in enumerate(hashes):
            cur = i
            b1, b2 = _bucket_pair_from_hash(h, mask)
            pos = b1 if not buckets[b1] else b2
            for _ in range(_MAX_KICKS):
                if not buckets[pos]:
                    buckets[pos] = cur + 1
                    break
                victim = int(buckets[pos]) - 1
                buckets[pos] = cur + 1
                cur = victim
                v1, v2 = _bucket_pair_from_hash(hashes[cur], mask)
                pos = v2 if pos == v1 else v1
            else:
                return None  # displacement cycle: grow
        return buckets


class CuckooTableReader(SingleFastTableReader):
    """Same surface as TableReader/SingleFastTableReader; point lookups
    probe at most two buckets."""

    FOOTER_MAGIC = fmt.CUCKOO_MAGIC

    def _load_hash_index(self) -> None:
        hh = self._meta_handles.get(METAINDEX_CUCKOO_INDEX)
        if hh is None:
            if self.n == 0:
                # Tombstone-only / empty file: a valid empty index.
                self._buckets = np.zeros(0, dtype="<u4")
                self.has_hash_index = True
                return
            raise Corruption("cuckoo table missing its index block")
        self._buckets = np.frombuffer(
            fmt.read_block(_Mem(self._data), hh, self.opts.verify_checksums),
            dtype="<u4",
        )
        if len(self._buckets) & (len(self._buckets) - 1):
            raise Corruption("cuckoo index size is not a power of two")
        self.has_hash_index = True

    def hash_probe(self, user_key: bytes) -> int | None:
        if not len(self._buckets):
            return None
        mask = len(self._buckets) - 1
        for b in _bucket_pair(user_key, mask):
            v = int(self._buckets[b])
            if not v:
                continue
            i = v - 1
            if i >= self.n:
                raise Corruption("cuckoo index bucket out of range")
            k = self._entry(i)[0]
            if k[:-8] == user_key:
                return i
        return None
