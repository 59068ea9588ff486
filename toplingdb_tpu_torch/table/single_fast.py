"""SingleFastTable: the flat, all-in-RAM SST format for hot levels (copied
from toplingdb_tpu/table/single_fast.py).

The role of ToplingDB's SingleFastTable (the L0/L1 format) and of RocksDB's
PlainTable: no blocks, no prefix compression — entries are
a flat [varint klen | varint vlen | ikey | value] region, the index is a raw
fixed32 offset array, and the reader holds the whole file in memory, so a
point lookup is a pure binary search (no per-block linear scan) and a scan
is a linear decode. Shares the bloom filter / properties / range-del meta
blocks and the footer shape with the block format; dispatched by footer
magic (table/factory.py — the adaptive-table mechanism).
"""

from __future__ import annotations

import numpy as np

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator, ValueType
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.block import BlockBuilder, BlockIter
from toplingdb_tpu_torch.table.builder import (
    METAINDEX_FILTER,
    METAINDEX_PROPERTIES,
    METAINDEX_RANGE_DEL,
    TableOptions,
)
from toplingdb_tpu_torch.table.filter import (
    filter_from_keys,
    filter_policy_from_name,
)
from toplingdb_tpu_torch.table.properties import TableProperties
from toplingdb_tpu_torch.utils import coding, crc32c
from toplingdb_tpu_torch.utils.status import Corruption

METAINDEX_DATA_CRC = b"tpulsm.sf.data_crc"
METAINDEX_HASH_INDEX = b"tpulsm.sf.hash_index"


class SingleFastTableBuilder:
    """Same surface as TableBuilder (build_outputs/flush compatible)."""

    FOOTER_MAGIC = fmt.SINGLE_FAST_MAGIC

    def __init__(self, wfile, icmp: InternalKeyComparator,
                 options: TableOptions | None = None,
                 column_family_id: int = 0, column_family_name: str = "",
                 creation_time: int = 0):
        self.opts = options or TableOptions()
        self._w = wfile
        self._icmp = icmp
        self._buf = bytearray()
        self._offsets: list[int] = []
        self._filter_keys: list[bytes] = []
        self._range_del_block = BlockBuilder(restart_interval=1)
        self.props = TableProperties(
            comparator_name=icmp.user_comparator.name(),
            filter_policy_name=(
                self.opts.filter_policy.name() if self.opts.filter_policy else ""
            ),
            compression_name="single_fast",
            prefix_extractor_name=(
                self.opts.prefix_extractor.name()
                if getattr(self.opts, "prefix_extractor", None) else ""
            ),
            column_family_id=column_family_id,
            column_family_name=column_family_name,
            creation_time=creation_time,
            smallest_seqno=dbformat.MAX_SEQUENCE_NUMBER,
            whole_key_filtering=1 if self.opts.whole_key_filtering else 0,
        )
        self._last_key: bytes | None = None
        self._smallest: bytes | None = None
        self._largest: bytes | None = None
        self._finished = False
        self._last_filter_prefix: bytes | None = None
        self._collectors = [
            f.create() for f in self.opts.properties_collector_factories
        ]
        self.need_compaction = False
        self._unsorted: list[tuple[bytes, bytes]] = []  # auto_sort buffer
        self._unsorted_bytes = 0

    @property
    def num_entries(self) -> int:
        return self.props.num_entries + self.props.num_range_deletions

    def file_size(self) -> int:
        # _unsorted_bytes: output-cutting must see buffered auto_sort adds.
        return self._w.file_size() + len(self._buf) + self._unsorted_bytes

    @property
    def smallest_key(self) -> bytes | None:
        return self._smallest

    @property
    def largest_key(self) -> bytes | None:
        return self._largest

    def _track_bounds(self, ikey: bytes) -> None:
        if self._smallest is None or self._icmp.compare(ikey, self._smallest) < 0:
            self._smallest = ikey
        if self._largest is None or self._icmp.compare(ikey, self._largest) > 0:
            self._largest = ikey
        seq = dbformat.extract_seqno(ikey)
        self.props.smallest_seqno = min(self.props.smallest_seqno, seq)
        self.props.largest_seqno = max(self.props.largest_seqno, seq)

    def add(self, ikey: bytes, value: bytes) -> None:
        assert not self._finished
        if self.opts.auto_sort:
            # VecAutoSortTable mode: buffer now, sort at finish.
            self._unsorted.append((ikey, value))
            self._unsorted_bytes += len(ikey) + len(value) + 10
            return
        self._add_sorted(ikey, value)

    def _add_sorted(self, ikey: bytes, value: bytes) -> None:
        if self._last_key is not None:
            assert self._icmp.compare(self._last_key, ikey) < 0
        if len(self._buf) + len(ikey) + len(value) + 10 > 0xFFFFFF00:
            # Offsets are fixed32: refuse before appending (no torn region)
            # rather than overflow into a corrupt index at finish().
            from toplingdb_tpu_torch.utils.status import NotSupported

            raise NotSupported(
                "single_fast table data region exceeds 4GiB; use the block "
                "format or a smaller max_output_file_size"
            )
        self._offsets.append(len(self._buf))
        self._buf += coding.encode_varint32(len(ikey))
        self._buf += coding.encode_varint32(len(value))
        self._buf += ikey
        self._buf += value
        self._last_key = ikey
        self._track_bounds(ikey)
        uk, seq_, t = dbformat.split_internal_key(ikey)
        if self.opts.filter_policy:
            if self.opts.whole_key_filtering:
                self._filter_keys.append(uk)
            pe = getattr(self.opts, "prefix_extractor", None)
            if pe is not None and pe.in_domain(uk):
                p = pe.transform(uk)
                if p != self._last_filter_prefix:
                    self._filter_keys.append(p)
                    self._last_filter_prefix = p
        for c in self._collectors:
            c.add_user_key(uk, value, t, seq_, len(self._buf))
        self.props.num_entries += 1
        self.props.raw_key_size += len(ikey)
        self.props.raw_value_size += len(value)
        if t in (ValueType.DELETION, ValueType.SINGLE_DELETION):
            self.props.num_deletions += 1
        elif t == ValueType.MERGE:
            self.props.num_merge_operands += 1

    def add_tombstone(self, begin_ikey: bytes, end_user_key: bytes) -> None:
        assert not self._finished
        self._range_del_block.add(begin_ikey, end_user_key)
        self.props.num_range_deletions += 1
        self._track_bounds(begin_ikey)
        end_ikey = dbformat.make_internal_key(
            end_user_key, dbformat.MAX_SEQUENCE_NUMBER,
            dbformat.VALUE_TYPE_FOR_SEEK,
        )
        if self._largest is None or self._icmp.compare(end_ikey, self._largest) > 0:
            self._largest = end_ikey

    def _entry_user_key(self, i: int) -> bytes:
        off = self._offsets[i]
        klen, o = coding.decode_varint32(self._buf, off)
        _, o = coding.decode_varint32(self._buf, o)
        return bytes(self._buf[o: o + klen - 8])

    def _hash_index_block(self) -> tuple[bytes, bytes] | None:
        """(metaindex name, raw block bytes) of the point-lookup index, or
        None. Subclass hook — the cuckoo format swaps in its own table."""
        if not (self.opts.hash_index and self._offsets
                and self._icmp.user_comparator.name()
                == dbformat.BYTEWISE.name()):
            # Bytewise comparator only: the hash dedups/matches by BYTE
            # equality, which must coincide with comparator equality.
            return None
        # O(1) point-lookup bucket array (the PlainTable prefix-hash
        # role): open-addressed xxh64 buckets at <=0.7
        # load, each holding 1 + the ordinal of the NEWEST version of one
        # user key.
        n = len(self._offsets)
        nb = 1
        while nb < (n * 10) // 7 + 1:
            nb <<= 1
        buckets = np.zeros(nb, dtype="<u4")
        mask = nb - 1
        prev_uk = None
        for i in range(n):
            uk = self._entry_user_key(i)
            if uk == prev_uk:
                continue  # hash maps to the first (newest) version
            prev_uk = uk
            h = crc32c.xxh64(uk) & mask
            while buckets[h]:
                h = (h + 1) & mask
            buckets[h] = i + 1
        return METAINDEX_HASH_INDEX, buckets.tobytes()

    def finish(self) -> TableProperties:
        assert not self._finished
        if self.opts.auto_sort and self._unsorted:
            # Reverse + STABLE sort: among exact-duplicate internal keys the
            # latest add comes first, so dedup keeps last-write-wins.
            ents = sorted(reversed(self._unsorted),
                          key=lambda kv: self._icmp.sort_key(kv[0]))
            self._unsorted = []
            self._unsorted_bytes = 0
            prev = None
            for k, v in ents:
                if prev is not None and self._icmp.compare(prev, k) == 0:
                    continue  # older duplicate
                self._add_sorted(k, v)
                prev = k
        for c in self._collectors:
            self.props.user_collected.update(c.finish())
            if c.need_compact():
                self.need_compaction = True
        data = bytes(self._buf)
        self._w.append(data)  # flat data region at offset 0, unframed
        self.props.data_size = len(data)
        self.props.num_data_blocks = 1

        metaindex = BlockBuilder(restart_interval=1)
        meta_entries = []
        # Whole-region checksum (entries have no per-block trailers).
        crc = crc32c.mask(crc32c.value(data))
        ch = fmt.write_block(self._w, coding.encode_fixed32(crc),
                             fmt.NO_COMPRESSION)
        meta_entries.append((METAINDEX_DATA_CRC, ch))

        if self.opts.filter_policy and self._filter_keys:
            fdata = filter_from_keys(self.opts.filter_policy,
                                     self._filter_keys)
            fh = fmt.write_block(self._w, fdata, fmt.NO_COMPRESSION)
            self.props.filter_size = len(fdata)
            meta_entries.append((METAINDEX_FILTER, fh))
        hash_block = self._hash_index_block()
        if hash_block is not None:
            name, hdata = hash_block
            hh = fmt.write_block(self._w, hdata, fmt.NO_COMPRESSION)
            meta_entries.append((name, hh))
        if not self._range_del_block.empty():
            rh = fmt.write_block(self._w, self._range_del_block.finish(),
                                 fmt.NO_COMPRESSION)
            meta_entries.append((METAINDEX_RANGE_DEL, rh))

        # Raw fixed32 offset array as the "index block".
        iraw = np.asarray(self._offsets, dtype="<u4").tobytes()
        self.props.index_size = len(iraw)

        pblock = self.props.encode_block()
        ph = fmt.write_block(self._w, pblock, fmt.NO_COMPRESSION)
        meta_entries.append((METAINDEX_PROPERTIES, ph))
        for name, handle in sorted(meta_entries):
            metaindex.add(name, handle.encode())
        mih = fmt.write_block(self._w, metaindex.finish(), fmt.NO_COMPRESSION)
        ih = fmt.write_block(self._w, iraw, fmt.NO_COMPRESSION)
        self._w.append(fmt.Footer(mih, ih, magic=self.FOOTER_MAGIC).encode())
        self._w.flush()
        self._finished = True
        return self.props


class SingleFastTableReader:
    """Same surface as TableReader. The whole file is resident in memory."""

    FOOTER_MAGIC = fmt.SINGLE_FAST_MAGIC

    def __init__(self, rfile, icmp: InternalKeyComparator,
                 options: TableOptions | None = None, block_cache=None,
                 cache_key_prefix: bytes = b""):
        self.opts = options or TableOptions()
        self._icmp = icmp
        size = rfile.size()
        self._data = rfile.read(0, size)
        rfile.close()
        self.footer = fmt.Footer.decode(self._data, self.FOOTER_MAGIC)
        iraw = fmt.read_block(_Mem(self._data), self.footer.index_handle,
                              self.opts.verify_checksums)
        self._offsets = np.frombuffer(iraw, dtype="<u4")
        meta = fmt.read_block(_Mem(self._data), self.footer.metaindex_handle,
                              self.opts.verify_checksums)
        mit = BlockIter(meta, dbformat.BYTEWISE.compare)
        mit.seek_to_first()
        self._meta_handles = {
            k: fmt.BlockHandle.decode_exact(v) for k, v in mit.entries()
        }
        self.properties = TableProperties()
        ph = self._meta_handles.get(METAINDEX_PROPERTIES)
        if ph is not None:
            self.properties = TableProperties.decode_block(
                fmt.read_block(_Mem(self._data), ph, self.opts.verify_checksums)
            )
        if self.opts.verify_checksums:
            ch = self._meta_handles.get(METAINDEX_DATA_CRC)
            if ch is not None:
                stored = crc32c.unmask(coding.decode_fixed32(
                    fmt.read_block(_Mem(self._data), ch, True), 0
                ))
                data_len = self.properties.data_size
                if crc32c.value(self._data[:data_len]) != stored:
                    raise Corruption("single_fast data region checksum mismatch")
        self._filter_data = None
        self._filter_policy = None
        fh = self._meta_handles.get(METAINDEX_FILTER)
        if fh is not None:
            self._filter_data = fmt.read_block(
                _Mem(self._data), fh, self.opts.verify_checksums
            )
            self._filter_policy = filter_policy_from_name(
                self.properties.filter_policy_name
            )
        self._range_del_cache = None
        rh = self._meta_handles.get(METAINDEX_RANGE_DEL)
        self._range_del_data = (
            fmt.read_block(_Mem(self._data), rh, self.opts.verify_checksums)
            if rh is not None else None
        )
        self.n = len(self._offsets)
        from toplingdb_tpu_torch.utils.slice_transform import resolve_file_extractor

        # Resolved once: the hot probe path must not rebuild the extractor.
        self._resolved_pe = resolve_file_extractor(
            getattr(self.opts, "prefix_extractor", None),
            self.properties.prefix_extractor_name,
        )
        self._load_hash_index()

    def _load_hash_index(self) -> None:
        self._hash_buckets = None
        hh = self._meta_handles.get(METAINDEX_HASH_INDEX)
        if hh is not None:
            self._hash_buckets = np.frombuffer(
                fmt.read_block(_Mem(self._data), hh,
                               self.opts.verify_checksums),
                dtype="<u4",
            )
        self.has_hash_index = self._hash_buckets is not None

    # -- entry decode ---------------------------------------------------

    def _entry(self, i: int) -> tuple[bytes, bytes]:
        off = int(self._offsets[i])
        klen, off = coding.decode_varint32(self._data, off)
        vlen, off = coding.decode_varint32(self._data, off)
        k = self._data[off : off + klen]
        v = self._data[off + klen : off + klen + vlen]
        return k, v

    def _lower_bound(self, target: bytes) -> int:
        lo, hi = 0, self.n
        cmp = self._icmp.compare
        while lo < hi:
            mid = (lo + hi) // 2
            if cmp(self._entry(mid)[0], target) < 0:
                lo = mid + 1
            else:
                hi = mid
        return lo

    # -- TableReader surface -------------------------------------------

    def close(self) -> None:
        pass

    def key_may_match(self, user_key: bytes) -> bool:
        from toplingdb_tpu_torch.table.filter import filter_probe

        return filter_probe(
            self._filter_policy, self._filter_data,
            bool(self.properties.whole_key_filtering),
            self._resolved_pe, user_key,
        )

    def hash_probe(self, user_key: bytes) -> int | None:
        """O(1) lookup: ordinal of the NEWEST version of user_key, or None
        when the key is definitively absent from this file. Only meaningful
        when has_hash_index (bytewise-comparator files only)."""
        buckets = self._hash_buckets
        if buckets is None:
            return None
        mask = len(buckets) - 1
        h = crc32c.xxh64(user_key) & mask
        for _ in range(len(buckets)):  # bounded: corrupt blocks can't hang
            v = int(buckets[h])
            if v == 0:
                return None
            i = v - 1
            if i >= self.n:
                raise Corruption("single_fast hash index bucket out of range")
            k = self._entry(i)[0]
            if k[:-8] == user_key:
                return i
            h = (h + 1) & mask
        raise Corruption("single_fast hash index has no empty buckets")

    def new_iterator(self) -> "SingleFastIterator":
        return SingleFastIterator(self)

    def range_del_entries(self):
        if self._range_del_data is None:
            return []
        if self._range_del_cache is None:
            it = BlockIter(self._range_del_data, self._icmp.compare)
            it.seek_to_first()
            self._range_del_cache = list(it.entries())
        return self._range_del_cache

    def approximate_offset_of(self, ikey: bytes) -> int:
        i = self._lower_bound(ikey)
        return int(self._offsets[i]) if i < self.n else self.properties.data_size

    def anchors(self, max_anchors: int = 32):
        if self.n == 0:
            return []
        step = max(1, self.n // max_anchors)
        return [self._entry(i)[0] for i in range(0, self.n, step)][:max_anchors]


class _Mem:
    """RandomAccessFile view over an in-memory bytes object."""

    def __init__(self, data: bytes):
        self._d = data

    def read(self, offset: int, n: int) -> bytes:
        return self._d[offset : offset + n]

    def size(self) -> int:
        return len(self._d)


class SingleFastIterator:
    def __init__(self, r: SingleFastTableReader):
        self._r = r
        self._i = r.n  # invalid

    def valid(self) -> bool:
        return 0 <= self._i < self._r.n

    def key(self) -> bytes:
        return self._r._entry(self._i)[0]

    def value(self) -> bytes:
        return self._r._entry(self._i)[1]

    def seek_to_first(self) -> None:
        self._i = 0

    def seek_to_last(self) -> None:
        self._i = self._r.n - 1

    def seek(self, target: bytes) -> None:
        self._i = self._r._lower_bound(target)

    def seek_ordinal(self, i: int) -> None:
        """Position directly at entry ordinal i (hash_probe fast path)."""
        self._i = i

    def seek_for_prev(self, target: bytes) -> None:
        i = self._r._lower_bound(target)
        if i < self._r.n and self._r._icmp.compare(
            self._r._entry(i)[0], target
        ) == 0:
            self._i = i
        else:
            self._i = i - 1

    def next(self) -> None:
        assert self.valid()
        self._i += 1

    def prev(self) -> None:
        assert self.valid()
        self._i -= 1

    def entries(self):
        while self.valid():
            yield self.key(), self.value()
            self.next()
