"""SstFileWriter / SstFileReader and external file ingestion (copied from
toplingdb_tpu/utilities/sst_file_writer.py; RocksDB's
table/sst_file_writer.cc, sst_file_reader.cc and
db/external_sst_file_ingestion_job.cc): build SSTs outside a DB, then
ingest them atomically at the lowest level that does not overlap. The
ingested file is rewritten under one global sequence number, through the
DB's Env, and installed with the DB's read view published
(`DB._install_edit`); listeners get `on_external_file_ingested`.
"""

from __future__ import annotations

import os

from toplingdb_tpu_torch.db import dbformat, filename
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator, ValueType
from toplingdb_tpu_torch.db.version_edit import FileMetaData, VersionEdit
from toplingdb_tpu_torch.env import default_env
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.table.factory import new_table_builder, open_table
from toplingdb_tpu_torch.utils.status import InvalidArgument


class SstFileWriter:
    """Build a standalone SST with ascending user keys; entries get seqno 0
    (rewritten at ingestion via the global seqno the same way RocksDB
    assigns the ingested file a single seqno)."""

    def __init__(self, options: Options | None = None):
        self.options = options or Options()
        self.icmp = InternalKeyComparator(self.options.comparator)
        self._builder = None
        self._wfile = None
        self._path = None
        self._last_user_key: bytes | None = None

    def open(self, path: str) -> None:
        self._path = path
        self._wfile = default_env().new_writable_file(path)
        self._builder = new_table_builder(
            self._wfile, self.icmp, self.options.table_options
        )

    def _add(self, user_key: bytes, value: bytes, t: ValueType) -> None:
        if self._builder is None:
            raise InvalidArgument("writer not open")
        if (self._last_user_key is not None
                and self.icmp.user_comparator.compare(
                    self._last_user_key, user_key) >= 0):
            raise InvalidArgument("keys must be added in strictly ascending order")
        self._builder.add(dbformat.make_internal_key(user_key, 0, t), value)
        self._last_user_key = user_key

    def put(self, user_key: bytes, value: bytes) -> None:
        self._add(user_key, value, ValueType.VALUE)

    def merge(self, user_key: bytes, value: bytes) -> None:
        self._add(user_key, value, ValueType.MERGE)

    def delete(self, user_key: bytes) -> None:
        self._add(user_key, b"", ValueType.DELETION)

    def delete_range(self, begin: bytes, end: bytes) -> None:
        self._builder.add_tombstone(
            dbformat.make_internal_key(begin, 0, ValueType.RANGE_DELETION), end
        )

    def finish(self):
        props = self._builder.finish()
        self._wfile.sync()
        self._wfile.close()
        smallest, largest = self._builder.smallest_key, self._builder.largest_key
        self._builder = None
        return props, smallest, largest


class SstFileReader:
    """Read a standalone SST (RocksDB's table/sst_file_reader.cc)."""

    def __init__(self, path: str, options: Options | None = None):
        self.options = options or Options()
        icmp = InternalKeyComparator(self.options.comparator)
        self._reader = open_table(
            default_env().new_random_access_file(path), icmp,
            self.options.table_options,
        )
        self.properties = self._reader.properties

    def iterate(self):
        it = self._reader.new_iterator()
        it.seek_to_first()
        for ikey, v in it.entries():
            uk, seq, t = dbformat.split_internal_key(ikey)
            yield uk, seq, t, v

    def verify_checksums(self) -> None:
        for _ in self.iterate():
            pass


def ingest_external_file(db, external_path: str, move: bool = False) -> int:
    """Ingest an SstFileWriter-produced file into the DB at the lowest level
    with no overlap (RocksDB's ExternalSstFileIngestionJob). Returns the
    level. The file's entries must not overlap the memtable (flushed first
    if they do)."""
    opts = db.options
    reader = open_table(
        db.env.new_random_access_file(external_path), db.icmp,
        opts.table_options,
    )
    it = reader.new_iterator()
    it.seek_to_first()
    if not it.valid() and not reader.range_del_entries():
        raise InvalidArgument("cannot ingest an empty file")
    with db._mutex:
        # Assign one global seqno to the whole file and REWRITE entries with
        # it, so snapshots taken before the ingestion don't see them (the
        # RocksDB patches a global_seqno field in place; we rebuild —
        # correctness first, zero-rewrite is a later optimization).
        seq = db.versions.last_sequence + 1
        db.versions.last_sequence = seq
        db.flush()
        fnum = db.versions.new_file_number()
        dst = filename.table_file_name(db.dbname, fnum)
        w = db.env.new_writable_file(dst)
        b = new_table_builder(w, db.icmp, opts.table_options)
        it.seek_to_first()
        for ikey, v in it.entries():
            uk, _, t = dbformat.split_internal_key(ikey)
            b.add(dbformat.make_internal_key(uk, seq, t), v)
        for bk, e in reader.range_del_entries():
            uk, _, t = dbformat.split_internal_key(bk)
            b.add_tombstone(
                dbformat.make_internal_key(uk, seq, ValueType.RANGE_DELETION), e
            )
        props = b.finish()
        w.sync()
        w.close()
        smallest, largest = b.smallest_key, b.largest_key
        su = dbformat.extract_user_key(smallest)
        lu = dbformat.extract_user_key(largest)
        # Lowest level with no overlap at-or-above it.
        version = db.versions.current
        target = 0
        for lvl in range(1, version.num_levels):
            if version.overlapping_files(lvl, su, lu):
                break
            if any(version.overlapping_files(l2, su, lu) for l2 in range(lvl)):
                break
            target = lvl
        meta = FileMetaData(
            number=fnum,
            file_size=db.env.get_file_size(dst),
            smallest=smallest, largest=largest,
            smallest_seqno=seq, largest_seqno=seq,
            num_entries=props.num_entries,
            num_deletions=props.num_deletions,
            num_range_deletions=props.num_range_deletions,
        )
        edit = VersionEdit()
        edit.add_file(target, meta)
        db._install_edit(edit)
        if move:
            os.remove(external_path)
    from toplingdb_tpu_torch.utils.listener import IngestionInfo, notify

    notify(opts.listeners, "on_external_file_ingested", db, IngestionInfo(
        db_name=db.dbname, external_file_path=external_path,
        internal_file_number=fnum, level=target,
    ))
    return target
