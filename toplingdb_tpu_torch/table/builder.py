"""Block-based SST builder: table options, meta-block names and the
per-entry TableBuilder (copied from toplingdb_tpu/table/builder.py, trimmed
to a single-level index and a whole-key filter: no prefix extractor, no
property collectors). Compression comes with it: every codec of
`table/format.py`, the parallel compression pool and the ZSTD dictionary.

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
class CompressionOptions:
    """Per-codec tuning (the reference's CompressionOptions): `level` feeds
    the codec, `max_dict_bytes` > 0 enables ZSTD dictionary compression
    (the dictionary is trained from the file's first
    `zstd_max_train_bytes` of raw blocks, default 100x the dictionary size,
    stored in a metaindex block and applied to every data block)."""

    level: int | None = None
    max_dict_bytes: int = 0
    zstd_max_train_bytes: int = 0

    def train_budget(self) -> int:
        return self.zstd_max_train_bytes or self.max_dict_bytes * 100


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
    # > 1: data blocks compress on that many worker threads and are
    # written in order (the bytes do not change).
    compression_parallel_threads: int = 1
    compression: int = fmt.NO_COMPRESSION
    compression_opts: CompressionOptions = field(
        default_factory=CompressionOptions)
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
    if options.protection_bytes_per_key:
        out.append("per-entry protection")
    return out


class TableBuilder:
    """Per-entry block-table writer. Writes the bytes the reference's
    TableBuilder writes for the same entries and options.

    Uncompressed and dictionary-less serial writes index each block as it
    is written. With `compression_parallel_threads > 1` or a ZSTD
    dictionary, data blocks are emitted deferred (compressed on the pool,
    or after the dictionary is trained) and the index is assembled at
    finish from the recorded block boundaries, with the same separators."""

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
        # Deferred emission: (future, first_key, last_key, raw_len) queued
        # on the pool; (first_key, last_key, handle) once written.
        self._block_first_key: bytes | None = None
        self._par_pool = None
        self._par_blocks: list = []
        self._par_meta: list = []
        if (self.opts.compression != fmt.NO_COMPRESSION
                and self.opts.compression_parallel_threads > 1):
            from concurrent.futures import ThreadPoolExecutor

            self._par_pool = ThreadPoolExecutor(
                max_workers=self.opts.compression_parallel_threads)
        # ZSTD dictionary: None = off, b"" = training pending (raw blocks
        # buffer in _dict_samples up to the train budget), non-empty =
        # trained and applied to every later data block.
        copts = self.opts.compression_opts
        self._dict: bytes | None = (
            b"" if (self.opts.compression == fmt.ZSTD_COMPRESSION
                    and copts.max_dict_bytes > 0) else None)
        self._dict_samples: list = []   # (raw, first_key, last_key)
        self._dict_sample_bytes = 0
        self._force_deferred = False    # set when dictionary training fails

    @property
    def num_entries(self) -> int:
        return self.props.num_entries + self.props.num_range_deletions

    def file_size(self) -> int:
        """Written bytes plus the raw bytes still queued for compression or
        held for dictionary training, so output cutting does not lag."""
        size = self._w.file_size()
        if self._par_blocks:
            size += sum(b[3] for b in self._par_blocks)
        return size + self._dict_sample_bytes

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
        if self._data_block.empty():
            self._block_first_key = ikey
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
        if self._dict == b"":
            self._dict_samples.append(
                (raw, self._block_first_key, self._last_key))
            self._dict_sample_bytes += len(raw)
            if (self._dict_sample_bytes
                    >= self.opts.compression_opts.train_budget()):
                self._train_dict_and_flush()
        elif (self._par_pool is not None or self._dict is not None
                or self._force_deferred):
            self._emit_deferred(raw, self._block_first_key, self._last_key)
        else:
            self._pending_handle = fmt.write_block(
                self._w, raw, self.opts.compression,
                self.opts.compression_opts.level)
            self._pending_index_entry = True
            self.props.data_size += len(raw)
            self.props.num_data_blocks += 1
        self._data_block.reset()

    def _emit_deferred(self, raw: bytes, first: bytes, last: bytes) -> None:
        """Deferred-index emission: compressed on the pool or inline; the
        index is assembled at finish from the recorded boundaries."""
        copts = self.opts.compression_opts
        if self._par_pool is not None:
            fut = self._par_pool.submit(
                fmt.compress_for_block, raw, self.opts.compression,
                copts.level, self._dict or b"")
            self._par_blocks.append((fut, first, last, len(raw)))
            self._drain_parallel(wait=False)
        else:
            payload, out_type = fmt.compress_for_block(
                raw, self.opts.compression, copts.level, self._dict or b"")
            h = fmt.write_compressed_block(self._w, payload, out_type)
            self._par_meta.append((first, last, h))
            self.props.data_size += len(raw)
            self.props.num_data_blocks += 1

    def _train_dict_and_flush(self) -> None:
        from toplingdb_tpu_torch.utils import codecs

        self._dict = codecs.zstd_train_dictionary(
            [r for r, _, _ in self._dict_samples],
            self.opts.compression_opts.max_dict_bytes)
        if self._dict == b"":
            # Training failed: the dictionary is off (b"" is the pending
            # sentinel, so it must not stay), and emission stays deferred
            # so the index entries keep file order with the replay below.
            self._dict = None
            self._force_deferred = True
        for raw, first, last in self._dict_samples:
            self._emit_deferred(raw, first, last)
        self._dict_samples = []
        self._dict_sample_bytes = 0

    def _drain_parallel(self, wait: bool) -> None:
        """Write finished compressed blocks in submission order (`wait`
        drains everything at finish)."""
        while self._par_blocks and (wait or self._par_blocks[0][0].done()):
            fut, first, last, raw_len = self._par_blocks.pop(0)
            payload, out_type = fut.result()
            h = fmt.write_compressed_block(self._w, payload, out_type)
            self._par_meta.append((first, last, h))
            self.props.data_size += raw_len
            self.props.num_data_blocks += 1

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
        if self._dict == b"":
            self._train_dict_and_flush()  # small file: train from the lot
        if self._par_pool is not None:
            try:
                self._drain_parallel(wait=True)
            finally:
                self._par_pool.shutdown()
        for i, (first, last, h) in enumerate(self._par_meta):
            if i + 1 < len(self._par_meta):
                sep = self._icmp.find_shortest_separator(
                    last, self._par_meta[i + 1][0])
            else:
                sep = self._icmp.find_short_successor(last)
            self._index_block.add(sep, h.encode())
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
        if self._dict:
            dh = fmt.write_block(self._w, self._dict)
            meta_entries.append((METAINDEX_COMPRESSION_DICT, dh))
        iraw = self._index_block.finish()
        self.props.index_type = "binary"
        self.props.index_size = len(iraw)
        ph = fmt.write_block(self._w, self.props.encode_block())
        meta_entries.append((METAINDEX_PROPERTIES, ph))
        for name, handle in sorted(meta_entries):
            metaindex.add(name, handle.encode())
        mih = fmt.write_block(self._w, metaindex.finish())
        ih = fmt.write_block(self._w, iraw, self.opts.compression)
        self._w.append(fmt.Footer(mih, ih).encode())
        self._w.flush()
        self._finished = True
        return self.props
