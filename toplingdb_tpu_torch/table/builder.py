"""Block-based SST builder: table options, meta-block names and the
per-entry TableBuilder (copied from toplingdb_tpu/table/builder.py).
Compression comes with it: every codec of `table/format.py`, the parallel
compression pool and the ZSTD dictionary.

`TableOptions` carries every field of the reference's options, so a job's
options cross over as they are (`toplingdb_tpu_torch.interop`); `format`
picks the builder (`table/factory.py`).

TableBuilder is structured like RocksDB's BlockBasedTableBuilder: data
blocks cut at `block_size`; a single-level index of shortest separators,
or with `index_type="two_level"` index partitions of `metadata_block_size`
behind a small top index; a bloom filter over user keys (and, with a
`prefix_extractor`, their prefixes), whole-file or with
`partition_filters` cut into partitions behind a top index; a
range-deletion meta block; a properties meta block with what the
`properties_collector_factories` collected; a metaindex; and the fixed
footer. Keys added must be internal keys in InternalKeyComparator order.
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
    filter_from_keys,
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
    # 'block' | 'single_fast' | 'cuckoo' | 'plain' | 'zip' (table/factory.py)
    format: str = "block"
    block_size: int = 4096
    restart_interval: int = 16
    index_restart_interval: int = 1
    # 'binary' = one index block; 'two_level' = index entries split into
    # metadata_block_size partitions behind a small top index.
    index_type: str = "binary"
    metadata_block_size: int = 4096
    # The bloom split into ~metadata_block_size partitions behind a top
    # index (whole-key filtering only).
    partition_filters: bool = False
    # single_fast only: also write an open-addressed hash bucket index.
    hash_index: bool = False
    # single_fast only: accept unsorted adds and sort at finish (exact
    # duplicate internal keys dedup last-write-wins).
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
    # SliceTransform (utils/slice_transform.py) or None: key prefixes also
    # go into the bloom filter, and the 'plain' format builds its prefix
    # hash index from it.
    prefix_extractor: object | None = None
    verify_checksums: bool = True
    # TablePropertiesCollectorFactory list; a fresh collector per SST.
    properties_collector_factories: list = field(default_factory=list)
    # Per-entry protection (Options.protection_bytes_per_key): every
    # compaction output is re-read and checked against the entries meant
    # for it. 0 = off.
    protection_bytes_per_key: int = 0


class TableBuilder:
    """Per-entry block-table writer. Writes the bytes the reference's
    TableBuilder writes for the same entries and options.

    Index entries are added as blocks are written, to the index block or,
    for a two-level index, to a list cut into partitions at finish. Filter
    keys are gathered per partition when filters are partitioned (a cut
    at the first data-block boundary after a partition's estimated size
    reaches metadata_block_size).

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
        self._w = wfile
        self._icmp = icmp
        self._data_block = BlockBuilder(self.opts.restart_interval)
        self._two_level_index = self.opts.index_type == "two_level"
        self._index_block = (
            None if self._two_level_index
            else BlockBuilder(self.opts.index_restart_interval))
        self._index_entries: list[tuple[bytes, bytes]] = []  # two-level
        self._filter_keys: list[bytes] = []
        self._last_filter_prefix: bytes | None = None
        self._filter_parts: list[tuple[bytes, list[bytes]]] = []
        self._partition_filters = bool(
            self.opts.partition_filters
            and self.opts.filter_policy is not None)
        if self._partition_filters and self.opts.prefix_extractor is not None:
            from toplingdb_tpu_torch.utils.status import InvalidArgument

            raise InvalidArgument(
                "partition_filters supports whole-key filtering only "
                "(prefix probes could span filter partitions)")
        self._range_del_block = BlockBuilder(restart_interval=1)
        self.props = TableProperties(
            comparator_name=icmp.user_comparator.name(),
            filter_policy_name=(
                self.opts.filter_policy.name() if self.opts.filter_policy
                else ""),
            compression_name=str(self.opts.compression),
            prefix_extractor_name=(
                self.opts.prefix_extractor.name()
                if self.opts.prefix_extractor else ""),
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
        self._collectors = [
            f.create() for f in self.opts.properties_collector_factories]
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
            self._index_add(sep, self._pending_handle.encode())
            self._pending_index_entry = False
        if self._data_block.empty():
            self._block_first_key = ikey
        uk = ikey[:-8]
        t = ikey[-8]
        if self.opts.filter_policy:
            if self.opts.whole_key_filtering:
                self._filter_keys.append(uk)
            pe = self.opts.prefix_extractor
            if pe is not None and pe.in_domain(uk):
                p = pe.transform(uk)
                if p != self._last_filter_prefix:
                    self._filter_keys.append(p)
                    self._last_filter_prefix = p
        if self._collectors:
            seq = int.from_bytes(ikey[-8:], "little") >> 8
            for c in self._collectors:
                c.add_user_key(uk, value, t, seq, self._w.file_size())
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
            if self._partition_filters and self._filter_keys:
                est = (len(self._filter_keys)
                       * getattr(self.opts.filter_policy, "bits_per_key",
                                 10.0) / 8)
                if est >= self.opts.metadata_block_size:
                    # Cut at the data-block boundary: sibling partitions'
                    # key ranges meet at most in the boundary key.
                    self._filter_parts.append((uk, self._filter_keys))
                    self._filter_keys = []

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

    def _index_add(self, key: bytes, handle_bytes: bytes) -> None:
        if self._index_block is not None:
            self._index_block.add(key, handle_bytes)
        else:
            self._index_entries.append((key, handle_bytes))

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

    def finish(self) -> TableProperties:
        assert not self._finished
        for c in self._collectors:
            self.props.user_collected.update(c.finish())
            if c.need_compact():
                self.need_compaction = True
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
            self._index_add(sep, h.encode())
        if self._pending_index_entry:
            succ = self._icmp.find_short_successor(self._last_key)
            self._index_add(succ, self._pending_handle.encode())
            self._pending_index_entry = False

        metaindex = BlockBuilder(restart_interval=1)
        meta_entries: list[tuple[bytes, fmt.BlockHandle]] = []
        if self._partition_filters and (self._filter_parts
                                        or self._filter_keys):
            if self._filter_keys:
                last_uk = self._last_key[:-8] if self._last_key else b""
                self._filter_parts.append((last_uk, self._filter_keys))
                self._filter_keys = []
            top = BlockBuilder(restart_interval=1)
            total = 0
            for last_uk, keys in self._filter_parts:
                fdata = filter_from_keys(self.opts.filter_policy, keys)
                fh = fmt.write_block(self._w, fdata)
                top.add(last_uk, fh.encode())
                total += len(fdata)
            th = fmt.write_block(self._w, top.finish())
            self.props.filter_size = total
            meta_entries.append((METAINDEX_FILTER_PARTS, th))
        elif self.opts.filter_policy and self._filter_keys:
            fdata = filter_from_keys(self.opts.filter_policy,
                                     self._filter_keys)
            fh = fmt.write_block(self._w, fdata)
            self.props.filter_size = len(fdata)
            meta_entries.append((METAINDEX_FILTER, fh))
        if not self._range_del_block.empty():
            rh = fmt.write_block(self._w, self._range_del_block.finish())
            meta_entries.append((METAINDEX_RANGE_DEL, rh))
        if self._dict:
            dh = fmt.write_block(self._w, self._dict)
            meta_entries.append((METAINDEX_COMPRESSION_DICT, dh))
        iraw = self._index_raw()
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

    def _index_raw(self) -> bytes:
        """The footer's index block. Two-level: the partition blocks are
        written now and the returned top index points at them; with 0-1
        index entries the index stays flat."""
        if self._index_block is not None:
            iraw = self._index_block.finish()
            self.props.index_type = "binary"
            self.props.index_size = len(iraw)
            return iraw
        ri = self.opts.index_restart_interval
        if len(self._index_entries) <= 1:
            flat = BlockBuilder(ri)
            for k, v in self._index_entries:
                flat.add(k, v)
            iraw = flat.finish()
            self.props.index_type = "binary"
            self.props.index_size = len(iraw)
            return iraw
        self.props.index_type = "two_level"
        top = BlockBuilder(ri)
        part = BlockBuilder(ri)
        part_size = 0
        last_key = None
        total = 0
        for k, v in self._index_entries:
            part.add(k, v)
            part_size += len(k) + len(v) + 8
            last_key = k
            if part_size >= self.opts.metadata_block_size:
                raw = part.finish()
                ph = fmt.write_block(self._w, raw, self.opts.compression)
                top.add(last_key, ph.encode())
                total += len(raw)
                part = BlockBuilder(ri)
                part_size = 0
        if part_size:
            raw = part.finish()
            ph = fmt.write_block(self._w, raw, self.opts.compression)
            top.add(last_key, ph.encode())
            total += len(raw)
        iraw = top.finish()
        self.props.index_size = total + len(iraw)
        return iraw
