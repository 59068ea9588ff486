"""SST reader (copied from toplingdb_tpu/table/reader.py, trimmed).

Opens a block-based SST: footer → metaindex → {filter, properties,
range-del, compression-dictionary} blocks and the single-level index held
in memory; data blocks are read (and inflated, with the file's ZSTD
dictionary where it has one) per iterator step through the iterator's own
readahead buffer (`table/prefetch.py`). The columnar compaction scan goes
through the native whole-file decoder (`ops/columnar_io.py`), which uses
the reader for the file handle, the index, the properties and the
dictionary; the per-entry route iterates. Partitioned indexes and filters
and block caches come with later slices.
"""

from __future__ import annotations

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
from toplingdb_tpu_torch.table.filter import filter_policy_from_name
from toplingdb_tpu_torch.table.properties import TableProperties
from toplingdb_tpu_torch.utils.status import NotSupported


class TableReader:
    def __init__(self, rfile, icmp: InternalKeyComparator,
                 options: TableOptions | None = None):
        self.opts = options or TableOptions()
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
        if METAINDEX_FILTER_PARTS in self._meta_handles:
            raise NotSupported("partitioned filters are not ported yet")

        self.properties = TableProperties()
        ph = self._meta_handles.get(METAINDEX_PROPERTIES)
        if ph is not None:
            self.properties = TableProperties.decode_block(
                fmt.read_block(rfile, ph, verify))
        if self.properties.index_type != "binary":
            raise NotSupported(
                f"index type {self.properties.index_type!r} is not ported "
                "yet")

        self._filter_data: bytes | None = None
        self._filter_policy = None
        fh = self._meta_handles.get(METAINDEX_FILTER)
        if fh is not None:
            self._filter_data = fmt.read_block(rfile, fh, verify)
            self._filter_policy = filter_policy_from_name(
                self.properties.filter_policy_name)

        self._range_del_data: bytes | None = None
        rh = self._meta_handles.get(METAINDEX_RANGE_DEL)
        if rh is not None:
            self._range_del_data = fmt.read_block(rfile, rh, verify)

        # The ZSTD dictionary the data blocks were compressed with.
        self._compression_dict = b""
        dh = self._meta_handles.get(METAINDEX_COMPRESSION_DICT)
        if dh is not None:
            self._compression_dict = fmt.read_block(rfile, dh, verify)

    def close(self) -> None:
        self._f.close()

    def key_may_match(self, user_key: bytes) -> bool:
        """Whole-key filter probe; fails open without a usable filter."""
        if (self._filter_policy is None or self._filter_data is None
                or not self.properties.whole_key_filtering):
            return True
        return self._filter_policy.key_may_match(user_key, self._filter_data)

    def new_index_iterator(self) -> BlockIter:
        """Iterator over (separator_key, data BlockHandle bytes)."""
        return BlockIter(self._index_data)

    def new_iterator(self) -> "TableIterator":
        return TableIterator(self)

    def range_del_entries(self) -> list[tuple[bytes, bytes]]:
        """Raw (begin_internal_key, end_user_key) tombstones in this file."""
        if self._range_del_data is None:
            return []
        it = BlockIter(self._range_del_data)
        it.seek_to_first()
        return list(it.entries())


class TableIterator:
    """Two-level iterator: index → data block. Sequential block loads go
    through a FilePrefetchBuffer (windowed readahead)."""

    def __init__(self, reader: TableReader):
        from toplingdb_tpu_torch.table.prefetch import FilePrefetchBuffer

        self._r = reader
        self._idx = reader.new_index_iterator()
        self._data: BlockIter | None = None
        self._pf = FilePrefetchBuffer(reader._f)

    def prefetch_counts(self) -> tuple[int, int]:
        """(hits, misses) of this iterator's readahead buffer."""
        return self._pf.hits, self._pf.misses

    def _load_data_block(self) -> None:
        if not self._idx.valid():
            self._data = None
            return
        handle = fmt.BlockHandle.decode_exact(self._idx.value())
        self._data = BlockIter(
            fmt.read_block(self._pf, handle, self._r.opts.verify_checksums,
                           self._r._compression_dict))

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

    def next(self) -> None:
        assert self.valid()
        self._data.next()
        self._skip_forward_empty()

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
