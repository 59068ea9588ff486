"""Read-only and secondary DB access (copied from
toplingdb_tpu/db/db_readonly.py; RocksDB's db/db_impl/db_impl_readonly.cc
and db_impl_secondary.cc).

ReadOnlyDB: a DB opened without taking ownership of the directory: its
MANIFEST is read without the roll, its WALs are replayed into memtables
only, and no WAL, LOG, OPTIONS file, compaction scheduler or background
thread is started; writes raise NotSupported. SecondaryDB also follows a
live primary: try_catch_up_with_primary() re-reads CURRENT / MANIFEST and
tails the WALs into fresh memtables.

A secondary pins none of the primary's files: a table the primary's
compaction deletes after a catch-up can vanish under a read that has not
opened it yet (NotFound), as in toplingdb_tpu. A reader that must not see
that pauses the primary's background work around its catch-up and reads
(DB.pause_background_work / continue_background_work).
"""

from __future__ import annotations

import dataclasses

from toplingdb_tpu_torch.db import filename
from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.db.log import LogReader
from toplingdb_tpu_torch.db.version_set import VersionSet
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.env import default_env
from toplingdb_tpu_torch.ops.scan_plane import DEFAULT_CHUNK
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils.status import NotFound, NotSupported


class ReadOnlyDB(DB):
    @classmethod
    def open(cls, dbname: str, options: Options | None = None, env=None, *,
             iter_chunk_rows: int = DEFAULT_CHUNK,
             async_reads: bool = False) -> "ReadOnlyDB":
        """Open `dbname` read-only. `options` is copied with read_only,
        disable_auto_compactions and no create_if_missing set;
        `iter_chunk_rows` and `async_reads` are DB.open's."""
        options = dataclasses.replace(
            options or Options(), create_if_missing=False,
            disable_auto_compactions=True, read_only=True)
        DB._check_open_args(options, False, iter_chunk_rows, async_reads)
        env = env or default_env()
        db = cls(dbname, options, env, write_plane=False,
                 iter_chunk_rows=iter_chunk_rows, async_reads=async_reads)
        db.versions.recover(readonly=True)
        db._replay_wals_into_mem()
        db._compaction_scheduler = None
        return db

    def _replay_wals_into_mem(self) -> None:
        self._materialize_cfs()
        mems = {cf_id: cfd.mem for cf_id, cfd in self._cfs.items()}
        wal_numbers = sorted(
            num for child in self.env.get_children(self.dbname)
            for ftype, num in [filename.parse_file_name(child)]
            if ftype == filename.FileType.WAL
            and num >= self.versions.log_number)
        for num in wal_numbers:
            try:
                reader = LogReader(self.env.new_sequential_file(
                    filename.log_file_name(self.dbname, num)),
                    log_number=num)
            except NotFound:
                # The primary flushed and deleted this WAL between the
                # listing and the open: its contents are in tables the next
                # catch-up sees.
                continue
            try:
                for rec in reader.records():
                    batch = WriteBatch(
                        rec, protection_bytes_per_key=self._protection)
                    batch.insert_into(mems)
                    end = batch.sequence() + batch.count() - 1
                    if end > self.versions.last_sequence:
                        self.versions.last_sequence = end
            except Exception as e:  # noqa: BLE001 - a WAL being appended
                # The primary may be appending: read what is durable.
                _errors.swallow(reason="catch-up-tail-race", exc=e)

    def write(self, batch, opts=None) -> None:
        raise NotSupported("DB is open read-only")

    def flush(self, fopts=None) -> None:
        raise NotSupported("DB is open read-only")

    def compact_range(self, begin=None, end=None) -> None:
        raise NotSupported("DB is open read-only")

    def close(self) -> None:
        self._stop_read_plane()
        if self._sfm is not None and self._sfm_owned:
            self._sfm.close()
        with self._mutex:
            if self._closed:
                return
            self.table_cache.close()
            self.blob_source.close()
            self._closed = True


class SecondaryDB(ReadOnlyDB):
    """Follows a live primary (RocksDB's DBImplSecondary)."""

    def try_catch_up_with_primary(self) -> None:
        """Re-read CURRENT → MANIFEST and the WAL tails (RocksDB's
        TryCatchUpWithPrimary). Column families the primary created or
        dropped since appear or vanish; a WAL the primary deleted meanwhile
        is skipped."""
        with self._mutex:
            self._reload_manifest_view()
            self._replay_wals_into_mem()

    def _reload_manifest_view(self) -> None:
        """Swap in the primary's current MANIFEST state: a fresh
        VersionSet, and the per-CF memtables rebuilt to match (created CFs
        appear, dropped ones vanish with their memtable entries; surviving
        CFs get EMPTY memtables, so history flushed and compacted since
        cannot linger at newer sequence numbers than the tables). The
        caller holds _mutex."""
        vs = VersionSet(self.env, self.dbname, self.icmp,
                        self.options.num_levels)
        vs.recover(readonly=True)
        self.versions = vs
        live = set(vs.column_families)
        for cf_id in list(self._cfs):
            if cf_id not in live:
                del self._cfs[cf_id]  # dropped by the primary
        for cfd in self._cfs.values():
            cfd.mem = self._fresh_memtable()
            cfd.imm = []
        self._materialize_cfs()  # CFs the primary created since
