"""FlushJob: memtable → L0 SST (copied from toplingdb_tpu/db/flush_job.py,
without per-entry protection; RocksDB's db/flush_job.cc
`WriteLevel0Table`), with blob separation into a sibling blob file."""

from __future__ import annotations

from toplingdb_tpu_torch.db import dbformat, filename
from toplingdb_tpu_torch.db.blob import BlobFileBuilder, blob_file_name
from toplingdb_tpu_torch.db.memtable import MemTable
from toplingdb_tpu_torch.db.range_del import RangeTombstone, fragment_tombstones
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.table.factory import new_table_builder
from toplingdb_tpu_torch.table.merging_iterator import MergingIterator
from toplingdb_tpu_torch.utils import errors as _errors


def _flush_columnar(env, dbname, file_number, icmp, mem, table_options,
                    tombstones, creation_time, column_family):
    """Single-memtable columnar flush: ONE native export of the whole rep +
    the native block-building SST writer — no per-entry Python. Returns the
    FileMetaData, or None when ineligible (caller uses the iterator path).
    Without it, flushing a full memtable walks ~10^5 Python iterations
    while the write group waits (RocksDB's FlushJob::WriteLevel0Table is
    a tight C++ scan)."""
    if (getattr(table_options, "format", "block") != "block"
            or getattr(table_options, "index_type", "binary") != "binary"
            or getattr(table_options, "properties_collector_factories", None)
            or getattr(table_options, "prefix_extractor", None) is not None
            or getattr(table_options, "partition_filters", False)
            or icmp.user_comparator.name() != dbformat.BYTEWISE.name()):
        return None
    exported = mem.export_columnar()
    if exported is None:
        return None
    kv, seqs, vtypes = exported
    if kv.n == 0:
        # Tombstone-only table: the columnar writer's n==0 seqno accounting
        # differs from TableBuilder's — the iterator path stays bit-true.
        return None
    import numpy as np

    from toplingdb_tpu_torch.ops.columnar_io import write_tables_columnar
    from toplingdb_tpu_torch.utils.status import NotSupported

    frags = list(fragment_tombstones(tombstones, icmp.user_comparator))
    numbers = iter([file_number])

    def alloc():
        return next(numbers)  # one output only (max size unbounded)

    try:
        files = write_tables_columnar(
            env, dbname, alloc, icmp, table_options, kv,
            np.arange(kv.n, dtype=np.int32),
            np.full(kv.n, -1, dtype=np.int64), vtypes, seqs,
            creation_time, column_family=column_family, tombstones=frags,
        )
    except NotSupported:
        return None  # oversized keys etc. — iterator path handles them
    if not files:
        return None
    fnum, path, props, smallest, largest, _sel = files[0]
    return FileMetaData(
        number=fnum,
        file_size=env.get_file_size(path),
        smallest=smallest,
        largest=largest,
        smallest_seqno=props.smallest_seqno,
        largest_seqno=props.largest_seqno,
        num_entries=props.num_entries,
        num_deletions=props.num_deletions,
        num_range_deletions=props.num_range_deletions,
    )


def flush_memtable_to_table(env, dbname: str, file_number: int, icmp,
                            memtables: list[MemTable], table_options,
                            creation_time: int = 0,
                            blob_file_number: int | None = None,
                            min_blob_size: int = 0,
                            column_family: tuple[int, str] = (0, "default"),
                            ) -> FileMetaData | None:
    """Write one or more memtables (newest first) to a single L0 SST via a
    k-way merge of their already-sorted iterators. Returns None if there was
    nothing to write. With blob_file_number set, values >= min_blob_size go
    to a sibling blob file and the SST stores BLOB_INDEX pointers (RocksDB's
    BlobFileBuilder in the flush); an empty blob file is deleted."""
    tombstones: list[RangeTombstone] = []
    total = 0
    for mem in memtables:
        total += len(mem._rep)
        for seq, begin, end in mem.range_del_entries():
            tombstones.append(RangeTombstone(seq, begin, end))
    if total == 0 and not tombstones:
        return None

    if len(memtables) == 1 and blob_file_number is None:
        meta = _flush_columnar(env, dbname, file_number, icmp, memtables[0],
                               table_options, tombstones, creation_time,
                               column_family)
        if meta is not None:
            return meta

    # min_blob_size == 0 separates every value (RocksDB's semantics); the
    # enable flag, by way of blob_file_number, gates separation.
    blob_builder = (BlobFileBuilder(env, dbname, blob_file_number)
                    if blob_file_number is not None else None)
    path = filename.table_file_name(dbname, file_number)
    w = env.new_writable_file(path)
    try:
        builder = new_table_builder(
            w, icmp, table_options, creation_time=creation_time,
            column_family_id=column_family[0],
            column_family_name=column_family[1],
        )
        merger = MergingIterator(
            icmp.compare, [m.new_iterator() for m in memtables]
        )
        merger.seek_to_first()
        last_ikey = None
        for ikey, val in merger.entries():
            # Exact duplicate internal keys across memtables (WAL replay):
            # the newer source (lower child index) surfaced first; skip dups.
            if last_ikey is not None and icmp.compare(last_ikey, ikey) == 0:
                continue
            last_ikey = ikey
            if (blob_builder is not None
                    and ikey[-8] == dbformat.ValueType.VALUE
                    and len(val) >= min_blob_size):
                uk, seq, _ = dbformat.split_internal_key(ikey)
                idx = blob_builder.add(uk, val)
                builder.add(dbformat.make_internal_key(
                    uk, seq, dbformat.ValueType.BLOB_INDEX), idx)
                continue
            builder.add(ikey, val)
        for frag in fragment_tombstones(tombstones, icmp.user_comparator):
            begin_ikey, end_uk = frag.to_table_entry()
            builder.add_tombstone(begin_ikey, end_uk)
        if builder.num_entries == 0:
            # A boundless empty table must NEVER reach the MANIFEST.
            w.close()
            env.delete_file(path)
            return None
        props = builder.finish()
        w.sync()
    finally:
        w.close()
        if blob_builder is not None and blob_builder.finish() == 0:
            try:
                env.delete_file(blob_file_name(dbname, blob_file_number))
            except Exception as e:  # noqa: BLE001 - counted, not raised
                _errors.swallow(reason="blob-empty-file-delete", exc=e)

    return FileMetaData(
        number=file_number,
        file_size=env.get_file_size(path),
        smallest=builder.smallest_key,
        largest=builder.largest_key,
        smallest_seqno=props.smallest_seqno,
        largest_seqno=props.largest_seqno,
        num_entries=props.num_entries,
        num_deletions=props.num_deletions,
        num_range_deletions=props.num_range_deletions,
        blob_refs=(
            [blob_file_number]
            if blob_builder is not None and blob_builder.num_values else []
        ),
        marked_for_compaction=builder.need_compaction,
    )
