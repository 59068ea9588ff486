"""Export / import a column family between DBs (copied from
toplingdb_tpu/db/import_column_family_job.py).

The roles of RocksDB's Checkpoint::ExportColumnFamily
(utilities/checkpoint/checkpoint_impl.cc) and
DB::CreateColumnFamilyWithImport / ImportColumnFamilyJob
(db/import_column_family_job.cc): export hard-links one CF's SSTs plus a
metadata manifest into a directory; import creates a new CF in another DB
and installs those files at their original levels under fresh file
numbers. The metadata file is toplingdb_tpu's, so either package imports
the other's export.
"""

from __future__ import annotations

import dataclasses
import json
import os

from toplingdb_tpu_torch.db import filename
from toplingdb_tpu_torch.db.version_edit import FileMetaData, VersionEdit
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils.status import (
    Corruption,
    InvalidArgument,
    NotSupported,
)

METADATA_FILE = "export_metadata.json"


def _link_or_copy(env, src: str, dst: str) -> None:
    """Hard-link on the real file system; copy through the Env otherwise
    (MemEnv and fault-injection wrappers stay in the loop)."""
    from toplingdb_tpu_torch.env.env import PosixEnv

    if type(env) is PosixEnv:
        try:
            os.link(src, dst)
            return
        except OSError:
            pass
    env.write_file(dst, env.read_file(src), sync=True)


@dataclasses.dataclass
class ExportedFile:
    """One SST in an export (a subset of RocksDB's LiveFileMetaData)."""

    name: str          # file name relative to the export dir
    level: int
    file_size: int
    smallest: bytes    # internal keys
    largest: bytes
    smallest_seqno: int
    largest_seqno: int
    num_entries: int
    num_deletions: int
    num_range_deletions: int
    # Whole-file checksum carried from the source DB's MANIFEST (hex in
    # JSON); import re-verifies the copy against it. Empty = unrecorded.
    file_checksum: str = ""
    file_checksum_func_name: str = ""

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["smallest"] = self.smallest.hex()
        d["largest"] = self.largest.hex()
        return d

    @staticmethod
    def from_json(d: dict) -> "ExportedFile":
        d = dict(d)
        d["smallest"] = bytes.fromhex(d["smallest"])
        d["largest"] = bytes.fromhex(d["largest"])
        return ExportedFile(**d)


@dataclasses.dataclass
class ExportImportFilesMetaData:
    """What export_column_family returns and
    create_column_family_with_import consumes (RocksDB's
    include/rocksdb/metadata.h)."""

    db_comparator_name: str
    files: list[ExportedFile]

    def save(self, export_dir: str, env) -> None:
        env.write_file(
            os.path.join(export_dir, METADATA_FILE),
            json.dumps({
                "db_comparator_name": self.db_comparator_name,
                "files": [f.to_json() for f in self.files],
            }, indent=1).encode(),
            sync=True,
        )

    @staticmethod
    def load(export_dir: str, env) -> "ExportImportFilesMetaData":
        try:
            raw = env.read_file(os.path.join(export_dir, METADATA_FILE))
        except Exception as e:
            raise InvalidArgument(
                f"no {METADATA_FILE} in {export_dir}: not an exported CF?"
            ) from e
        d = json.loads(raw)
        return ExportImportFilesMetaData(
            db_comparator_name=d["db_comparator_name"],
            files=[ExportedFile.from_json(f) for f in d["files"]],
        )


def export_column_family(db, cf, export_dir: str) -> ExportImportFilesMetaData:
    """Hard-link (or copy) every SST of `cf` (a ColumnFamilyHandle, None
    for the default CF) into `export_dir` and write the metadata manifest.
    The DB is flushed first so the export is complete."""
    env = db.env
    if env.file_exists(export_dir) and env.get_children(export_dir):
        raise InvalidArgument(f"export dir {export_dir} exists and is not empty")
    if not env.file_exists(export_dir):
        env.create_dir(export_dir)
    db.disable_file_deletions()
    try:
        # Only the file-list snapshot needs the mutex; the deletion pin
        # keeps every listed file alive while the linking or copying runs
        # unlocked, so concurrent reads and writes are not stalled.
        with db._mutex:
            db.flush()
            cf_id = cf.id if cf is not None else 0
            st = db.versions.column_families[cf_id]
            snapshot = list(st.current.all_files())
        files: list[ExportedFile] = []
        for lvl, f in snapshot:
            if f.blob_refs:
                raise NotSupported(
                    "cannot export a CF with blob references; disable "
                    "blob separation or compact the blobs away first"
                )
            src = filename.table_file_name(db.dbname, f.number)
            name = os.path.basename(src)
            _link_or_copy(env, src, os.path.join(export_dir, name))
            files.append(ExportedFile(
                name=name, level=lvl, file_size=f.file_size,
                smallest=f.smallest, largest=f.largest,
                smallest_seqno=f.smallest_seqno,
                largest_seqno=f.largest_seqno,
                num_entries=f.num_entries,
                num_deletions=f.num_deletions,
                num_range_deletions=f.num_range_deletions,
                file_checksum=f.file_checksum.hex(),
                file_checksum_func_name=f.file_checksum_func_name,
            ))
        meta = ExportImportFilesMetaData(
            db_comparator_name=db.icmp.user_comparator.name(),
            files=files,
        )
        meta.save(export_dir, env)
        return meta
    finally:
        db.enable_file_deletions()


def import_column_family(db, name: str, source_dir: str,
                         metadata: ExportImportFilesMetaData | None = None,
                         move_files: bool = False):
    """Create CF `name` in `db` populated with the exported files (RocksDB's
    DB::CreateColumnFamilyWithImport + ImportColumnFamilyJob). Files land at
    their ORIGINAL levels under fresh file numbers; the DB's last_sequence
    advances past the imported files' seqnos so every imported entry is
    visible. Returns the new ColumnFamilyHandle."""
    env = db.env
    if metadata is None:
        metadata = ExportImportFilesMetaData.load(source_dir, env)
    if metadata.db_comparator_name != db.icmp.user_comparator.name():
        raise InvalidArgument(
            f"comparator mismatch: exported with "
            f"{metadata.db_comparator_name!r}, DB uses "
            f"{db.icmp.user_comparator.name()!r}"
        )
    # Copy and verify every file OUTSIDE the DB mutex (a large import must
    # not stall concurrent reads and writes); only the CF creation and the
    # version install take the lock. Fresh file numbers are race-free (the
    # VersionSet allocates under its own lock) and nothing references the
    # copies until log_and_apply.
    edit_files: list[tuple[int, FileMetaData]] = []
    max_seqno = 0
    copied: list[str] = []
    try:
        for ef in metadata.files:
            src = os.path.join(source_dir, ef.name)
            if not env.file_exists(src):
                raise Corruption(f"exported file missing: {src}")
            num = db.versions.new_file_number()
            dst = filename.table_file_name(db.dbname, num)
            _link_or_copy(env, src, dst)
            copied.append(dst)
            # The table must open and match the manifest's claims.
            reader = db.table_cache.get_reader(num)
            if reader.properties.num_entries != ef.num_entries:
                raise Corruption(
                    f"{src}: entry count {reader.properties.num_entries} "
                    f"!= exported metadata {ef.num_entries}"
                )
            meta = FileMetaData(
                number=num, file_size=ef.file_size,
                smallest=ef.smallest, largest=ef.largest,
                smallest_seqno=ef.smallest_seqno,
                largest_seqno=ef.largest_seqno,
                num_entries=ef.num_entries,
                num_deletions=ef.num_deletions,
                num_range_deletions=ef.num_range_deletions,
                file_checksum=bytes.fromhex(ef.file_checksum),
                file_checksum_func_name=ef.file_checksum_func_name,
            )
            if meta.file_checksum:
                # The exported checksum rode from the source DB's
                # MANIFEST: the copy must still match it bit for bit.
                from toplingdb_tpu_torch.utils.file_checksum import (
                    verify_recorded_checksum,
                )

                verify_recorded_checksum(env, dst, meta)
            else:
                db._stamp_file_checksums([meta])
            edit_files.append((ef.level, meta))
            max_seqno = max(max_seqno, ef.largest_seqno)
    except Exception:
        for p in copied:
            try:
                env.delete_file(p)
            except Exception as e:  # noqa: BLE001 - best-effort cleanup
                _errors.swallow(reason="import-cleanup-delete", exc=e)
        raise
    with db._mutex:
        handle = db.create_column_family(name)
        try:
            edit = VersionEdit(column_family=handle.id)
            for lvl, meta in edit_files:
                edit.add_file(lvl, meta)
            # Imported seqnos must be visible in THIS DB.
            if max_seqno > db.versions.last_sequence:
                edit.last_sequence = max_seqno
                db.versions.last_sequence = max_seqno
            db._install_edit(edit)
        except Exception:
            # Roll the half-created CF back.
            for p in copied:
                try:
                    env.delete_file(p)
                except Exception as e:  # noqa: BLE001 - best-effort cleanup
                    _errors.swallow(reason="import-rollback-delete", exc=e)
            db.drop_column_family(handle)
            raise
    if move_files:
        for ef in metadata.files:
            try:
                env.delete_file(os.path.join(source_dir, ef.name))
            except Exception as e:  # noqa: BLE001 - the import already landed
                _errors.swallow(reason="import-move-source-delete", exc=e)
    return handle
