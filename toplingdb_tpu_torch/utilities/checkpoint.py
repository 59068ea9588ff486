"""Checkpoint: a consistent, openable copy of a live DB in a new directory
(copied from toplingdb_tpu/utilities/checkpoint.py; RocksDB's
utilities/checkpoint/checkpoint_impl.cc): flush first, so no WAL tail is
needed, hard-link the SSTs and blob files where the Env is the real posix
one (`type(env) is PosixEnv`, as db/import_column_family_job.py decides)
and copy them through the Env otherwise, then write a fresh MANIFEST, the
IDENTITY and OPTIONS files, and CURRENT.

CURRENT is written LAST: a directory without CURRENT is not a checkpoint,
so a crash mid-copy can never leave a half snapshot that opens. Every
copied SST is checked against its MANIFEST-recorded checksum, so a
checkpoint never propagates corruption.

Reference mode: on a SharedSstEnv (storage/shared_env.py) a checkpoint
holds each checksum-stamped SST as a reference to its store address (the
directory's refs table), so it copies no SST bytes; `restore_to` restores
the references and starts a background warm of the cache (`warm_refs`).
A store that fails while a checkpoint is taken degrades that file to the
byte copy, as in toplingdb_tpu, and the fallback is counted
(utils/errors.swallow)."""

from __future__ import annotations

import os

from toplingdb_tpu_torch.db import filename
from toplingdb_tpu_torch.db.import_column_family_job import (  # noqa: F401
    ExportImportFilesMetaData,
    export_column_family,
)
from toplingdb_tpu_torch.db.log import LogWriter
from toplingdb_tpu_torch.db.version_edit import VersionEdit
from toplingdb_tpu_torch.utils.status import InvalidArgument
from toplingdb_tpu_torch.utils import errors as _errors


def _untapped(env):
    """The DB's Env without its checksum tap (utils/file_checksum.
    ChecksumTapEnv digests the tables the DB itself writes; a checkpoint's
    files are not the DB's)."""
    from toplingdb_tpu_torch.utils.file_checksum import ChecksumTapEnv

    return env.base if isinstance(env, ChecksumTapEnv) else env


def create_checkpoint(db, dest: str) -> None:
    env = _untapped(db.env)
    if env.file_exists(dest):
        try:
            if env.get_children(dest):
                raise InvalidArgument(
                    f"checkpoint dir {dest} exists and is not empty"
                )
        except InvalidArgument:
            raise
        except Exception as e:
            _errors.swallow(reason="checkpoint-dest-probe", exc=e)
    env.create_dir(dest)
    # Pin the file set (RocksDB's DisableFileDeletions during checkpoint);
    # the mutex already excludes GC, but the pin also protects any future
    # restructuring that copies outside the lock.
    db.disable_file_deletions()
    try:
        _checkpoint_locked(db, env, dest)
    finally:
        db.enable_file_deletions()


def _checkpoint_locked(db, env, dest: str) -> None:
    with db._mutex:
        db.flush()
        last_seq = db.versions.last_sequence
        # EVERY column family's files (a checkpoint is a whole-DB snapshot).
        cf_files: dict[int, list] = {}
        files = []
        for cf_id, st in sorted(db.versions.column_families.items()):
            cur = [(lvl, f) for lvl, f in st.current.all_files()]
            cf_files[cf_id] = cur
            files.extend(cur)
        # Hard-link when the env is the real posix FS; copy through the Env
        # otherwise (MemEnv / fault injection stay in the loop).
        from toplingdb_tpu_torch.env.env import PosixEnv

        def link_or_copy(src: str, dst: str) -> None:
            if type(env) is PosixEnv:
                try:
                    os.link(src, dst)
                    return
                except OSError:
                    pass
            env.write_file(dst, env.read_file(src), sync=True)

        from toplingdb_tpu_torch.utils.file_checksum import (
            verify_recorded_checksum,
        )

        # Reference mode: publish (idempotent; the install already did)
        # and adopt, no bytes. Unstamped files (file_checksum off) copy.
        ref_env = hasattr(env, "publish_sst") and hasattr(env, "adopt")
        for _, f in files:
            src = filename.table_file_name(db.dbname, f.number)
            dst = filename.table_file_name(dest, f.number)
            if ref_env and f.file_checksum:
                from toplingdb_tpu_torch.storage.object_store import (
                    address_of_meta,
                )

                try:
                    addr = address_of_meta(f)
                    if not env.store.contains(addr):
                        env.publish_sst(src, f)  # a table from before
                    if env.store.contains(addr):
                        env.adopt(dst, addr)
                        continue  # self-verifying: checked at first fetch
                except Exception as e:  # noqa: BLE001 - a store outage
                    # A flaky or unreachable store must not abort the
                    # checkpoint: this file takes the byte path.
                    _errors.swallow(reason="checkpoint-ref-fallback", exc=e)
            link_or_copy(src, dst)
            # A checkpoint must not propagate corruption: the copy is
            # re-read and compared against the MANIFEST-recorded checksum
            # (no-op for pre-upgrade files without one).
            verify_recorded_checksum(env, dst, f)
        # Blob files too: all present ones (deletions are excluded for the
        # duration, so every LIVE blob is here; extra not-yet-GC'd ones are
        # harmless dead weight in the snapshot).
        for child in env.get_children(db.dbname):
            if child.endswith(".blob"):
                link_or_copy(f"{db.dbname}/{child}", f"{dest}/{child}")
        # Fresh MANIFEST snapshot: one edit per column family.
        manifest_number = 1
        w = LogWriter(env.new_writable_file(
            filename.manifest_file_name(dest, manifest_number)
        ))
        for cf_id in sorted(cf_files):
            st = db.versions.column_families[cf_id]
            edit = VersionEdit(
                column_family=cf_id,
                column_family_add=st.name,
                max_column_family=db.versions.max_column_family,
            )
            if cf_id == 0:
                edit.comparator = db.icmp.user_comparator.name()
                edit.log_number = 0
                edit.next_file_number = db.versions.next_file_number
                edit.last_sequence = last_seq
            for lvl, f in cf_files[cf_id]:
                edit.add_file(lvl, f)
            w.add_record(edit.encode())
        w.sync()
        w.close()
        env.write_file(
            filename.identity_file_name(dest), db.identity.encode()
        )
        # OPTIONS ride in the snapshot (RocksDB's checkpoints link the
        # OPTIONS file): a restored DB / follower bootstrap reopens with
        # the same comparator/merge-operator/table config it was built
        # with instead of whatever the caller defaults to.
        try:
            from toplingdb_tpu_torch.utils.config import options_to_config

            import json as _json

            env.write_file(
                filename.options_file_name(dest, manifest_number + 1),
                _json.dumps(options_to_config(db.options), indent=1).encode(),
                sync=True,
            )
        except Exception as e:
            # unregistered custom plugin objects: OPTIONS best-effort
            _errors.swallow(reason="options-manifest-best-effort", exc=e)
        # CURRENT last — this write is what MAKES dest a checkpoint.
        filename.set_current_file(env, dest, manifest_number)


class Checkpoint:
    """Handle on a checkpoint directory. `Checkpoint.create(db, dest)`
    snapshots a live DB; `Checkpoint(path, env).restore_to(dest)` copies a
    checkpoint into a fresh directory (the follower-bootstrap path in
    replication/follower.py) after verifying it is complete."""

    def __init__(self, path: str, env=None):
        if env is None:
            from toplingdb_tpu_torch.env import default_env

            env = default_env()
        self.path = path
        self.env = env

    @staticmethod
    def create(db, dest: str) -> "Checkpoint":
        create_checkpoint(db, dest)
        return Checkpoint(dest, _untapped(db.env))

    def verify(self) -> None:
        """A complete checkpoint has CURRENT pointing at a present MANIFEST
        (CURRENT was written last, so its presence implies the rest)."""
        env = self.env
        cur = filename.current_file_name(self.path)
        if not env.file_exists(cur):
            raise InvalidArgument(
                f"{self.path} is not a checkpoint (no CURRENT — "
                f"an interrupted create never writes one)"
            )
        name = env.read_file(cur).decode().strip()
        if not env.file_exists(f"{self.path}/{name}"):
            raise InvalidArgument(
                f"{self.path}: CURRENT points at missing {name}"
            )

    def restore_to(self, dest: str) -> str:
        """Copy this checkpoint into `dest` (must not exist or be empty) and
        return dest, openable as a DB. CURRENT again lands last so an
        interrupted restore is never mistaken for a database."""
        env = self.env
        self.verify()
        if env.file_exists(dest):
            try:
                if env.get_children(dest):
                    raise InvalidArgument(
                        f"restore target {dest} exists and is not empty"
                    )
            except InvalidArgument:
                raise
            except Exception as e:
                _errors.swallow(reason="restore-dest-probe", exc=e)
        env.create_dir(dest)
        # Reference mode: SSTs the checkpoint holds by reference restore as
        # references. The bootstrap is a metadata swap; the bytes arrive
        # through the cache tier on first read, or by warm_refs below.
        refs = dict(env.refs_of(self.path)) if hasattr(env, "refs_of") \
            else {}
        for name, addr in sorted(refs.items()):
            env.adopt(f"{dest}/{name}", addr)
        children = [c for c in env.get_children(self.path)
                    if c != "CURRENT" and c not in refs]
        # Hard-link fast path: same-filesystem restore of a real posix
        # tree links instead of copying (EXDEV or any link failure falls
        # back to the byte copy, so cross-device restores still work). A
        # wrapper Env never links: its reads (faults, decryption) stay in
        # the loop; only the shared-store env unwraps to its base.
        from toplingdb_tpu_torch.env.env import PosixEnv
        base = env.base if hasattr(env, "refs_of") else env
        can_link = type(base) is PosixEnv
        for child in children:
            if can_link:
                try:
                    os.link(f"{self.path}/{child}", f"{dest}/{child}")
                    continue
                except OSError:
                    pass
            try:
                data = env.read_file(f"{self.path}/{child}")
            except (OSError, IsADirectoryError):
                continue  # stray subdirectory: checkpoints hold only files
            env.write_file(f"{dest}/{child}", data, sync=True)
        env.write_file(f"{dest}/CURRENT",
                       env.read_file(f"{self.path}/CURRENT"), sync=True)
        # Deep integrity check on the restored copy (the replication
        # follower's bootstrap path rides through here): every
        # MANIFEST-recorded SST checksum is recomputed on the copy, so a
        # truncated or bit-rotted restore fails HERE, not hours later.
        # Referenced SSTs are exempt: their address is the checksum and the
        # cache tier verifies every fetch, so recomputing here would force
        # the full download the reference mode exists to avoid.
        if not refs:
            from toplingdb_tpu_torch.utils.file_checksum import (
                verify_dir_file_checksums,
            )

            verify_dir_file_checksums(dest, env)
        elif hasattr(env, "warm_refs"):
            env.warm_refs(dest)  # fire-and-forget cache warm
        return dest
