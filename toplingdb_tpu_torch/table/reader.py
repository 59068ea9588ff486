"""SST reader (copied from toplingdb_tpu/table/reader.py).

Opens a block-based SST: footer → metaindex → {filter or filter-partition
top index, properties, range-del, compression-dictionary} blocks and the
index held in memory — the whole index, or for a two-level index its top
level, whose partitions load as an iterator reaches them. Data blocks are
read (and inflated, with the file's ZSTD dictionary where it has one) per
iterator step through the iterator's own readahead buffer
(`table/prefetch.py`), or through the async read plane's prefetched spans
(`env/async_reads.py`), and cached in the DB's block cache where it has
one, under `cache_key_prefix` + the block handle. The columnar compaction
scan goes through the native whole-file decoder (`ops/columnar_io.py`),
which uses the reader for the file handle, the index, the properties and
the dictionary; the per-entry route iterates. `native_get_handle` hands the DB's native
point-read chain (db/db.py `_native_get`) this table's index, filter and
a dup of its file descriptor.
"""

from __future__ import annotations

import itertools

from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.block import BlockIter
from toplingdb_tpu_torch.table.builder import (
    METAINDEX_COMPRESSION_DICT,
    METAINDEX_FILTER,
    METAINDEX_FILTER_PARTS,
    METAINDEX_PROPERTIES,
    METAINDEX_RANGE_DEL,
    TableOptions,
)
from toplingdb_tpu_torch.table.filter import (
    filter_policy_from_name,
    filter_probe,
)
from toplingdb_tpu_torch.table.properties import TableProperties
from toplingdb_tpu_torch.utils.slice_transform import resolve_file_extractor

# Process-global cache-namespace allocator of the native point-read chain:
# its block cache is process-wide and two DBs' file numbers collide, so
# every table handle gets a fresh id.
_NGET_ID = itertools.count(1)


class TableReader:
    def __init__(self, rfile, icmp: InternalKeyComparator,
                 options: TableOptions | None = None,
                 block_cache=None, cache_key_prefix: bytes = b""):
        self.opts = options or TableOptions()
        self._cache = block_cache
        self._cache_prefix = cache_key_prefix
        self._f = rfile
        self._icmp = icmp
        size = rfile.size()
        footer_buf = rfile.read(max(0, size - fmt.FOOTER_LEN), fmt.FOOTER_LEN)
        self.footer = fmt.Footer.decode(footer_buf)
        verify = self.opts.verify_checksums
        self._index_data = fmt.read_block(
            rfile, self.footer.index_handle, verify)
        meta = fmt.read_block(rfile, self.footer.metaindex_handle, verify)
        self._meta_handles: dict[bytes, fmt.BlockHandle] = {}
        mit = BlockIter(meta)
        mit.seek_to_first()
        for k, v in mit.entries():
            self._meta_handles[k] = fmt.BlockHandle.decode_exact(v)

        self.properties = TableProperties()
        ph = self._meta_handles.get(METAINDEX_PROPERTIES)
        if ph is not None:
            self.properties = TableProperties.decode_block(
                fmt.read_block(rfile, ph, verify))

        self._filter_data: bytes | None = None
        self._filter_policy = None
        fh = self._meta_handles.get(METAINDEX_FILTER)
        if fh is not None:
            self._filter_data = fmt.read_block(rfile, fh, verify)
            self._filter_policy = filter_policy_from_name(
                self.properties.filter_policy_name)
        # Partitioned filter: the top index (last user key → partition
        # handle) loads now, a partition on its first probe.
        self._filter_top: bytes | None = None
        self._filter_part_memo: dict[int, bytes] = {}
        th = self._meta_handles.get(METAINDEX_FILTER_PARTS)
        if th is not None:
            self._filter_top = fmt.read_block(rfile, th, verify)
            self._filter_policy = filter_policy_from_name(
                self.properties.filter_policy_name)
        # The extractor this file's prefix filter keys were built with.
        self._resolved_pe = resolve_file_extractor(
            self.opts.prefix_extractor,
            self.properties.prefix_extractor_name)

        self._range_del_data: bytes | None = None
        rh = self._meta_handles.get(METAINDEX_RANGE_DEL)
        if rh is not None:
            self._range_del_data = fmt.read_block(rfile, rh, verify)

        # The ZSTD dictionary the data blocks were compressed with.
        self._compression_dict = b""
        dh = self._meta_handles.get(METAINDEX_COMPRESSION_DICT)
        if dh is not None:
            self._compression_dict = fmt.read_block(rfile, dh, verify)
        # Two-level index: _index_data is the top level.
        self._partitioned_index = self.properties.index_type == "two_level"

    def native_get_handle(self, smallest_uk: bytes, largest_uk: bytes):
        """Handle for the native point-read chain (tpulsm_db_get), built
        lazily and owned by this reader (freed at GC; the native side dups
        the fd, so closing the reader does not invalidate it). Ineligible
        tables (partitioned index or filter, range tombstones, dictionary
        compression, no posix file, a comparator that is not bytewise) get
        an eligible=0 handle: the chain walk returns FALLBACK on contact,
        and the Python chain serves the lookup. None when the native
        library is unavailable."""
        h = getattr(self, "_nget_handle", False)
        if h is not False:
            return h
        import ctypes
        import weakref

        from toplingdb_tpu_torch import native

        cl = native.lib()
        if cl is None:
            self._nget_handle = None
            return None
        try:
            fd = self._f._f.fileno()  # posix random-access file only
        except AttributeError:
            fd = -1
        eligible = (
            fd >= 0
            and not self._partitioned_index
            and self._filter_top is None
            and self._range_del_data is None
            and not self._compression_dict
            and self._icmp.user_comparator.name()
            == "tpulsm.BytewiseComparator"
        )
        filt = b""
        filter_kind = 0
        fname = str(self.properties.filter_policy_name)
        if (eligible and self._filter_data is not None
                and self.properties.whole_key_filtering):
            if fname.startswith("tpulsm.BloomFilter"):
                filt = self._filter_data
            elif fname.startswith("tpulsm.BlockedBloom"):
                filt = self._filter_data
                filter_kind = 1
        idx = self._index_data if eligible else b""
        u8 = ctypes.POINTER(ctypes.c_uint8)

        def buf(b):
            return ctypes.cast(ctypes.c_char_p(bytes(b)), u8)

        h = cl.tpulsm_table_handle_new(
            fd if eligible else -1,
            next(_NGET_ID),
            (1 | (filter_kind << 1)) if eligible else 0,
            buf(idx), len(idx), buf(filt), len(filt),
            buf(smallest_uk), len(smallest_uk),
            buf(largest_uk), len(largest_uk),
        )
        h = h or None
        self._nget_handle = h
        if h:
            weakref.finalize(self, cl.tpulsm_table_handle_free, h)
        return h

    def plan_block_reads(self, seek_ikeys) -> list[tuple[int, int]]:
        """The async read plane's planner: the (offset, length) byte ranges
        of the data blocks that seeking each internal key lands on,
        deduplicated, in first-seen order, block-cache-resident handles
        skipped. The length covers the block trailer, exactly what
        `fmt.read_block` consumes, so a prefetched range serves
        `_read_data_block` byte for byte."""
        idx = self.new_index_iterator()
        seen: set[int] = set()
        out: list[tuple[int, int]] = []
        for ik in seek_ikeys:
            idx.seek(ik)
            if not idx.valid():
                continue
            h = fmt.BlockHandle.decode_exact(idx.value())
            if h.offset in seen:
                continue
            seen.add(h.offset)
            if self._cache is not None and self._cache.lookup(
                    self._cache_prefix + h.encode()) is not None:
                continue  # resident: the probe will hit the cache
            out.append((h.offset, h.size + fmt.BLOCK_TRAILER_SIZE))
        return out

    def close(self) -> None:
        self._f.close()

    def key_may_match(self, user_key: bytes) -> bool:
        """Filter probe (whole key, or prefix for a prefix-only filter);
        fails open without a usable filter."""
        if self._filter_top is not None:
            return self._partitioned_filter_probe(user_key)
        return filter_probe(
            self._filter_policy, self._filter_data,
            bool(self.properties.whole_key_filtering), self._resolved_pe,
            user_key)

    def _partitioned_filter_probe(self, user_key: bytes) -> bool:
        """Seek the filter top index, load (once per reader) the one
        partition that may hold the key, probe it. Fails open when the
        policy cannot be rebuilt from its recorded name."""
        if self._filter_policy is None:
            return True
        it = BlockIter(self._filter_top)
        it.seek(user_key)  # first partition whose last key >= user_key
        if not it.valid():
            return False  # past every partition: absent
        handle = fmt.BlockHandle.decode_exact(it.value())
        if self._cache is not None:
            fdata = self._read_data_block(handle, kind="filter")
        else:
            fdata = self._filter_part_memo.get(handle.offset)
            if fdata is None:
                fdata = self._read_data_block(handle, kind="filter")
                self._filter_part_memo[handle.offset] = fdata
        return self._filter_policy.key_may_match(user_key, fdata)

    def prefix_may_match(self, prefix: bytes) -> bool:
        """Probe the filter with an already-extracted prefix (files built
        with a prefix extractor only)."""
        if (self._filter_policy is None or self._filter_data is None
                or not self.properties.prefix_extractor_name):
            return True
        return self._filter_policy.key_may_match(prefix, self._filter_data)

    def _read_data_block(self, handle: fmt.BlockHandle, pf=None,
                         kind: str = "") -> bytes:
        """One block (index partition, filter partition or data block),
        through the block cache where the reader has one, read through
        `pf` (an iterator's readahead buffer or the async read plane's
        prefetched spans) when given. `kind`: "filter" / "index" routes
        the PerfContext cache counters to the typed fields; "" counts as
        a data block."""
        from toplingdb_tpu_torch.utils import statistics as st

        cache = self._cache
        if cache is not None:
            ckey = self._cache_prefix + handle.encode()
            data = cache.lookup(ckey)
            if data is not None:
                if st.perf_level:
                    ctx = st.perf_context()
                    if kind == "filter":
                        ctx.block_cache_filter_hit_count += 1
                    elif kind == "index":
                        ctx.block_cache_index_hit_count += 1
                    else:
                        ctx.block_cache_hit_count += 1
                return data
        data = fmt.read_block(pf if pf is not None else self._f, handle,
                              self.opts.verify_checksums,
                              self._compression_dict)
        if cache is not None:
            cache.insert(ckey, data, len(data))
        if st.perf_level:
            ctx = st.perf_context()
            if cache is not None and not kind:
                ctx.block_cache_miss_count += 1
            ctx.block_read_count += 1
            ctx.block_read_byte += len(data)
        return data

    def new_index_iterator(self):
        """Iterator over (separator_key, data BlockHandle bytes), flat or
        hopping across the partitions of a two-level index."""
        if self._partitioned_index:
            return _PartitionedIndexIter(self)
        return BlockIter(self._index_data, self._icmp.compare)

    def new_iterator(self, readahead_size: int = 0, preread=None,
                     aio_ring=None) -> "TableIterator":
        """`readahead_size`: ReadOptions.readahead_size, a fixed window
        armed at once for this iterator; 0 keeps the auto-scaling ramp.
        `preread`: a PrereadSpans overlay (env/async_reads.py) replacing
        the prefetch buffer, so the async read plane's batched block
        fetches serve this iterator's loads. `aio_ring`: an AsyncIORing
        for the prefetch buffer's readahead windows (they become ring
        tasks instead of inline preads)."""
        return TableIterator(self, readahead_size=readahead_size,
                             preread=preread, aio_ring=aio_ring)

    def approximate_offset_of(self, ikey: bytes) -> int:
        """Approximate file offset of ikey (RocksDB's TableReader::
        ApproximateOffsetOf): the offset of the data block whose index
        entry is the first at or past ikey, else the metaindex's."""
        idx = self.new_index_iterator()
        idx.seek(ikey)
        if idx.valid():
            return fmt.BlockHandle.decode_exact(idx.value()).offset
        return self.footer.metaindex_handle.offset

    def range_del_entries(self) -> list[tuple[bytes, bytes]]:
        """Raw (begin_internal_key, end_user_key) tombstones in this file."""
        if self._range_del_data is None:
            return []
        it = BlockIter(self._range_del_data, self._icmp.compare)
        it.seek_to_first()
        return list(it.entries())


class _PartitionedIndexIter:
    """BlockIter-shaped view over a two-level index: the top block maps
    each partition's last separator to its handle; partitions load on
    demand."""

    def __init__(self, reader: TableReader):
        self._r = reader
        self._cmp = reader._icmp.compare
        self._top = BlockIter(reader._index_data, self._cmp)
        self._sub: BlockIter | None = None

    def _load(self) -> None:
        if not self._top.valid():
            self._sub = None
            return
        h = fmt.BlockHandle.decode_exact(self._top.value())
        self._sub = BlockIter(self._r._read_data_block(h, kind="index"),
                              self._cmp)

    def valid(self) -> bool:
        return self._sub is not None and self._sub.valid()

    def key(self) -> bytes:
        return self._sub.key()

    def value(self) -> bytes:
        return self._sub.value()

    def seek_to_first(self) -> None:
        self._top.seek_to_first()
        self._load()
        if self._sub is not None:
            self._sub.seek_to_first()

    def seek_to_last(self) -> None:
        self._top.seek_to_last()
        self._load()
        if self._sub is not None:
            self._sub.seek_to_last()

    def seek(self, target: bytes) -> None:
        self._top.seek(target)
        self._load()
        if self._sub is not None:
            # Each top key is its partition's last separator, so the
            # landed partition holds a separator >= target.
            self._sub.seek(target)

    def next(self) -> None:
        self._sub.next()
        if not self._sub.valid():
            self._top.next()
            self._load()
            if self._sub is not None:
                self._sub.seek_to_first()

    def prev(self) -> None:
        self._sub.prev()
        if not self._sub.valid():
            self._top.prev()
            self._load()
            if self._sub is not None:
                self._sub.seek_to_last()

    def entries(self):
        while self.valid():
            yield self.key(), self.value()
            self.next()


class TableIterator:
    """Two-level iterator: index → data block. Sequential block loads go
    through a FilePrefetchBuffer (windowed readahead)."""

    def __init__(self, reader: TableReader, readahead_size: int = 0,
                 preread=None, aio_ring=None):
        from toplingdb_tpu_torch.table.prefetch import FilePrefetchBuffer

        self._r = reader
        self._cmp = reader._icmp.compare
        self._idx = reader.new_index_iterator()
        self._data: BlockIter | None = None
        # Sequential block loads escalate to windowed preads; random seeks
        # pass through. A nonzero readahead_size pins a window armed at
        # once instead of the ramp; a `preread` overlay replaces the
        # buffer outright; an `aio_ring` moves the windows onto a ring.
        if preread is not None:
            self._pf = preread
        elif readahead_size > 0:
            self._pf = FilePrefetchBuffer(
                reader._f, max_readahead=readahead_size,
                initial_readahead=readahead_size, arm_immediately=True,
                aio_ring=aio_ring)
        else:
            self._pf = FilePrefetchBuffer(reader._f, aio_ring=aio_ring)

    def prefetch_counts(self) -> tuple[int, int]:
        """(hits, misses) of this iterator's readahead buffer."""
        return self._pf.hits, self._pf.misses

    def _load_data_block(self) -> None:
        if not self._idx.valid():
            self._data = None
            return
        handle = fmt.BlockHandle.decode_exact(self._idx.value())
        self._data = BlockIter(self._r._read_data_block(handle, pf=self._pf),
                               self._cmp)

    def valid(self) -> bool:
        return self._data is not None and self._data.valid()

    def key(self) -> bytes:
        return self._data.key()

    def value(self) -> bytes:
        return self._data.value()

    def seek_to_first(self) -> None:
        self._idx.seek_to_first()
        self._load_data_block()
        if self._data is not None:
            self._data.seek_to_first()
            self._skip_forward_empty()

    def seek_to_last(self) -> None:
        self._idx.seek_to_last()
        self._load_data_block()
        if self._data is not None:
            self._data.seek_to_last()
            self._skip_backward_empty()

    def seek(self, target: bytes) -> None:
        self._idx.seek(target)
        self._load_data_block()
        if self._data is not None:
            self._data.seek(target)
            self._skip_forward_empty()

    def seek_for_prev(self, target: bytes) -> None:
        self.seek(target)
        if not self.valid():
            self.seek_to_last()
            return
        if self._cmp(self.key(), target) > 0:
            self.prev()

    def next(self) -> None:
        assert self.valid()
        self._data.next()
        self._skip_forward_empty()

    def prev(self) -> None:
        assert self.valid()
        self._data.prev()
        self._skip_backward_empty()

    def _skip_forward_empty(self) -> None:
        while self._data is not None and not self._data.valid():
            self._idx.next()
            self._load_data_block()
            if self._data is not None:
                self._data.seek_to_first()

    def _skip_backward_empty(self) -> None:
        while self._data is not None and not self._data.valid():
            self._idx.prev()
            self._load_data_block()
            if self._data is not None:
                self._data.seek_to_last()

    def entries(self):
        while self.valid():
            yield self.key(), self.value()
            self.next()
