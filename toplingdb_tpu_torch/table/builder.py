"""Block-based SST builder: table options, meta-block names and the
per-entry TableBuilder (copied from toplingdb_tpu/table/builder.py, trimmed
to uncompressed tables with a single-level index and a whole-key filter: no
compression dictionary, no parallel compression, no prefix extractor, no
property collectors).

`TableOptions` keeps every scalar field of the reference's options so that a
job's options carry across (`toplingdb_tpu_torch.interop`); the writers and
the compaction entry point refuse the values this port does not support
(`unsupported_options`).

TableBuilder is structured like RocksDB's BlockBasedTableBuilder: data
blocks cut at `block_size`, a single-level index of shortest separators, a
whole-file bloom filter over user keys, a range-deletion meta block, a
properties meta block, a metaindex, and the fixed footer. Keys added must be
internal keys in InternalKeyComparator order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator, ValueType
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.block import BlockBuilder
from toplingdb_tpu_torch.table.filter import (
    BlockedBloomFilterPolicy,
    FilterPolicy,
    build_filter_block_native,
)
from toplingdb_tpu_torch.table.properties import TableProperties

METAINDEX_FILTER = b"filter.fullfilter"
METAINDEX_FILTER_PARTS = b"filter.partitioned"
METAINDEX_PROPERTIES = b"tpulsm.properties"
METAINDEX_RANGE_DEL = b"tpulsm.range_del"
METAINDEX_COMPRESSION_DICT = b"tpulsm.compression_dict"


@dataclass
class TableOptions:
    format: str = "block"
    block_size: int = 4096
    restart_interval: int = 16
    index_restart_interval: int = 1
    index_type: str = "binary"
    metadata_block_size: int = 4096
    partition_filters: bool = False
    hash_index: bool = False
    auto_sort: bool = False
    compression_parallel_threads: int = 1
    compression: int = fmt.NO_COMPRESSION
    # Blocked (cache-line) bloom by default, as in the reference.
    filter_policy: FilterPolicy | None = field(
        default_factory=lambda: BlockedBloomFilterPolicy())
    whole_key_filtering: bool = True
    verify_checksums: bool = True
    protection_bytes_per_key: int = 0


def unsupported_options(options: TableOptions) -> list[str]:
    """What in `options` this slice of the port cannot write (empty when
    the columnar writer takes them as they are)."""
    out = []
    if options.format != "block":
        out.append(f"table format {options.format!r}")
    if options.index_type != "binary":
        out.append(f"index type {options.index_type!r}")
    if options.partition_filters:
        out.append("partitioned filters")
    if options.compression != fmt.NO_COMPRESSION:
        out.append(f"compression type {options.compression}")
    if options.protection_bytes_per_key:
        out.append("per-entry protection")
    return out


class TableBuilder:
    """Per-entry block-table writer. Writes the bytes the reference's
    TableBuilder writes for the same entries and options."""

    def __init__(self, wfile, icmp: InternalKeyComparator,
                 options: TableOptions | None = None,
                 column_family_id: int = 0, column_family_name: str = "",
                 creation_time: int = 0):
        self.opts = options or TableOptions()
        bad = unsupported_options(self.opts)
        if bad:
            from toplingdb_tpu_torch.utils.status import NotSupported

            raise NotSupported("table builder: " + ", ".join(bad))
        self._w = wfile
        self._icmp = icmp
        self._data_block = BlockBuilder(self.opts.restart_interval)
        self._index_block = BlockBuilder(self.opts.index_restart_interval)
        # Whole user keys for the filter, gathered into one buffer.
        self._filter_buf = bytearray()
        self._filter_offs: list[int] = []
        self._range_del_block = BlockBuilder(restart_interval=1)
        self.props = TableProperties(
            comparator_name=icmp.user_comparator.name(),
            filter_policy_name=(
                self.opts.filter_policy.name() if self.opts.filter_policy
                else ""),
            compression_name=str(self.opts.compression),
            column_family_id=column_family_id,
            column_family_name=column_family_name,
            creation_time=creation_time,
            smallest_seqno=dbformat.MAX_SEQUENCE_NUMBER,
            whole_key_filtering=1 if self.opts.whole_key_filtering else 0,
        )
        self._last_key: bytes | None = None
        self._pending_index_entry = False
        self._pending_handle: fmt.BlockHandle | None = None
        self._smallest: bytes | None = None
        self._largest: bytes | None = None
        self._finished = False
        self.need_compaction = False

    @property
    def num_entries(self) -> int:
        return self.props.num_entries + self.props.num_range_deletions

    def file_size(self) -> int:
        return self._w.file_size()

    @property
    def smallest_key(self) -> bytes | None:
        return self._smallest

    @property
    def largest_key(self) -> bytes | None:
        return self._largest

    def _track_bounds(self, ikey: bytes) -> None:
        if (self._smallest is None
                or self._icmp.compare(ikey, self._smallest) < 0):
            self._smallest = ikey
        if (self._largest is None
                or self._icmp.compare(ikey, self._largest) > 0):
            self._largest = ikey
        seq = dbformat.extract_seqno(ikey)
        self.props.smallest_seqno = min(self.props.smallest_seqno, seq)
        self.props.largest_seqno = max(self.props.largest_seqno, seq)

    def add(self, ikey: bytes, value: bytes) -> None:
        assert not self._finished
        if self._last_key is not None:
            assert self._icmp.compare(self._last_key, ikey) < 0, (
                f"keys out of order: {self._last_key!r} >= {ikey!r}"
            )
        if self._pending_index_entry:
            sep = self._icmp.find_shortest_separator(self._last_key, ikey)
            self._index_block.add(sep, self._pending_handle.encode())
            self._pending_index_entry = False
        t = ikey[-8]
        if self.opts.filter_policy and self.opts.whole_key_filtering:
            self._filter_offs.append(len(self._filter_buf))
            self._filter_buf += ikey[:-8]
        self._data_block.add(ikey, value)
        self._last_key = ikey
        self._track_bounds(ikey)
        self.props.num_entries += 1
        self.props.raw_key_size += len(ikey)
        self.props.raw_value_size += len(value)
        if t in (ValueType.DELETION, ValueType.SINGLE_DELETION):
            self.props.num_deletions += 1
        elif t == ValueType.MERGE:
            self.props.num_merge_operands += 1
        if self._data_block.current_size_estimate() >= self.opts.block_size:
            self._flush_data_block()

    def add_tombstone(self, begin_ikey: bytes, end_user_key: bytes) -> None:
        """Range tombstone: begin internal key (type RANGE_DELETION) → end
        user key (exclusive)."""
        assert not self._finished
        self._range_del_block.add(begin_ikey, end_user_key)
        self.props.num_range_deletions += 1
        self._track_bounds(begin_ikey)
        # The tombstone covers up to end_user_key exclusive; widen largest.
        end_ikey = dbformat.make_internal_key(
            end_user_key, dbformat.MAX_SEQUENCE_NUMBER,
            dbformat.VALUE_TYPE_FOR_SEEK)
        if (self._largest is None
                or self._icmp.compare(end_ikey, self._largest) > 0):
            self._largest = end_ikey

    def _flush_data_block(self) -> None:
        if self._data_block.empty():
            return
        raw = self._data_block.finish()
        self._pending_handle = fmt.write_block(self._w, raw)
        self._pending_index_entry = True
        self.props.data_size += len(raw)
        self.props.num_data_blocks += 1
        self._data_block.reset()

    def _filter_data(self) -> bytes:
        """The filter block over every added user key: the native builder
        when the host library is there, the policy itself otherwise (the
        same bytes either way)."""
        import numpy as np

        from toplingdb_tpu_torch import native

        n = len(self._filter_offs)
        buf = np.frombuffer(bytes(self._filter_buf), dtype=np.uint8)
        offs = np.asarray(self._filter_offs + [len(buf)], dtype=np.int64)
        return build_filter_block_native(
            native.lib(), self.opts.filter_policy, buf, offs[:-1],
            np.diff(offs), n)

    def finish(self) -> TableProperties:
        assert not self._finished
        self._flush_data_block()
        if self._pending_index_entry:
            succ = self._icmp.find_short_successor(self._last_key)
            self._index_block.add(succ, self._pending_handle.encode())
            self._pending_index_entry = False

        metaindex = BlockBuilder(restart_interval=1)
        meta_entries: list[tuple[bytes, fmt.BlockHandle]] = []
        if self.opts.filter_policy and self._filter_offs:
            fdata = self._filter_data()
            fh = fmt.write_block(self._w, fdata)
            self.props.filter_size = len(fdata)
            meta_entries.append((METAINDEX_FILTER, fh))
        if not self._range_del_block.empty():
            rh = fmt.write_block(self._w, self._range_del_block.finish())
            meta_entries.append((METAINDEX_RANGE_DEL, rh))
        iraw = self._index_block.finish()
        self.props.index_type = "binary"
        self.props.index_size = len(iraw)
        ph = fmt.write_block(self._w, self.props.encode_block())
        meta_entries.append((METAINDEX_PROPERTIES, ph))
        for name, handle in sorted(meta_entries):
            metaindex.add(name, handle.encode())
        mih = fmt.write_block(self._w, metaindex.finish())
        ih = fmt.write_block(self._w, iraw)
        self._w.append(fmt.Footer(mih, ih).encode())
        self._w.flush()
        self._finished = True
        return self.props
