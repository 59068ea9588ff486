"""BackupEngine: incremental backups with shared-file dedup (copied from
toplingdb_tpu/utilities/backup_engine.py; RocksDB's
utilities/backup/backup_engine.cc).

Layout under backup_dir:
  shared/<file_size>_<crc32c>_<name>.sst    content-addressed SSTs
  meta/<backup_id>.json                     manifest of one backup
  private/<backup_id>/                      per-backup MANIFEST/CURRENT copy
Restore rebuilds a DB dir from a backup id. Each backup is taken from a
checkpoint (utilities/checkpoint.py), so its file list and its MANIFEST
come from one consistent view.
"""

from __future__ import annotations

import json
import os
import shutil

from toplingdb_tpu_torch.db import filename
from toplingdb_tpu_torch.utils import crc32c
from toplingdb_tpu_torch.utils.status import NotFound


class BackupEngine:
    def __init__(self, backup_dir: str):
        from toplingdb_tpu_torch.utils import concurrency as ccy

        self.dir = backup_dir
        # Serializes create/delete/purge/GC: shared files and private dirs
        # land BEFORE their meta json, so an unsynchronized GC could sweep
        # a half-created backup's files as unreferenced garbage.
        self._mu = ccy.Lock("backup_engine.BackupEngine._mu")
        os.makedirs(os.path.join(backup_dir, "shared"), exist_ok=True)
        os.makedirs(os.path.join(backup_dir, "meta"), exist_ok=True)
        os.makedirs(os.path.join(backup_dir, "private"), exist_ok=True)

    # ------------------------------------------------------------------

    def _next_backup_id(self) -> int:
        ids = [int(f.split(".")[0]) for f in os.listdir(os.path.join(self.dir, "meta"))
               if f.split(".")[0].isdigit()]
        return max(ids, default=0) + 1

    def create_backup(self, db, app_metadata: str | None = None) -> int:
        """Snapshot the DB (checkpoint = atomic consistent view), then dedup
        its SSTs into shared/ — the file list and the MANIFEST come from the
        SAME checkpoint, so concurrent compactions can't skew them.
        app_metadata: RocksDB's CreateNewBackupWithMetadata."""
        from toplingdb_tpu_torch.utilities.checkpoint import create_checkpoint

        with self._mu:
            return self._create_backup_locked(db, app_metadata,
                                              create_checkpoint)

    def _create_backup_locked(self, db, app_metadata, create_checkpoint):
        backup_id = self._next_backup_id()
        private = os.path.join(self.dir, "private", str(backup_id))
        os.makedirs(private, exist_ok=True)
        tmp_ckpt = private + ".ckpt"
        if os.path.exists(tmp_ckpt):
            shutil.rmtree(tmp_ckpt)
        create_checkpoint(db, tmp_ckpt)
        files = []
        for name in sorted(os.listdir(tmp_ckpt)):
            ftype, num = filename.parse_file_name(name)
            path = os.path.join(tmp_ckpt, name)
            if ftype != filename.FileType.TABLE:
                shutil.copy2(path, os.path.join(private, name))
                continue
            with open(path, "rb") as s:
                data = s.read()
            crc = crc32c.value(data)
            shared_name = f"{len(data)}_{crc:08x}_{num:06d}.sst"
            shared_path = os.path.join(self.dir, "shared", shared_name)
            if not os.path.exists(shared_path):
                with open(shared_path + ".tmp", "wb") as d:
                    d.write(data)
                os.replace(shared_path + ".tmp", shared_path)
            files.append({
                "number": num, "shared": shared_name,
                "size": len(data), "crc32c": crc,
            })
        shutil.rmtree(tmp_ckpt)
        import time as _time

        meta = {"backup_id": backup_id, "files": files,
                "timestamp": int(_time.time()),
                "app_metadata": app_metadata}
        meta_path = os.path.join(self.dir, "meta", f"{backup_id}.json")
        with open(meta_path + ".tmp", "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(meta_path + ".tmp", meta_path)
        return backup_id

    def get_backup_info(self) -> list[dict]:
        out = []
        meta_dir = os.path.join(self.dir, "meta")
        ids = sorted(
            int(name[:-5]) for name in os.listdir(meta_dir)
            if name.endswith(".json") and name[:-5].isdigit()
        )
        for bid in ids:  # numeric order: purge must drop OLDEST first
            with open(os.path.join(meta_dir, f"{bid}.json")) as f:
                m = json.load(f)
            out.append({
                "backup_id": m["backup_id"],
                "num_files": len(m["files"]),
                "size": sum(f["size"] for f in m["files"]),
                "timestamp": m.get("timestamp", 0),
                "app_metadata": m.get("app_metadata"),
            })
        return out

    def delete_backup(self, backup_id: int) -> None:
        """Drop ONE backup (RocksDB's DeleteBackup); shared files still
        referenced by other backups survive."""
        with self._mu:
            meta_path = os.path.join(self.dir, "meta", f"{backup_id}.json")
            if not os.path.exists(meta_path):
                raise NotFound(f"backup {backup_id}")
            os.remove(meta_path)
            shutil.rmtree(os.path.join(self.dir, "private", str(backup_id)),
                          ignore_errors=True)
            self._garbage_collect_locked()

    def verify_backup(self, backup_id: int) -> None:
        """Check every file of one backup exists with the recorded size +
        crc32c (RocksDB's VerifyBackup with verify_with_checksum=true);
        raises Corruption/NotFound on any divergence."""
        from toplingdb_tpu_torch.utils.status import Corruption

        meta_path = os.path.join(self.dir, "meta", f"{backup_id}.json")
        if not os.path.exists(meta_path):
            raise NotFound(f"backup {backup_id}")
        with open(meta_path) as f:
            meta = json.load(f)
        for fi in meta["files"]:
            path = os.path.join(self.dir, "shared", fi["shared"])
            if not os.path.exists(path):
                raise Corruption(f"backup {backup_id}: missing {fi['shared']}")
            with open(path, "rb") as s_:
                data = s_.read()
            if len(data) != fi["size"]:
                raise Corruption(
                    f"backup {backup_id}: size mismatch {fi['shared']}")
            if crc32c.value(data) != fi["crc32c"]:
                raise Corruption(
                    f"backup {backup_id}: checksum mismatch {fi['shared']}")
        private = os.path.join(self.dir, "private", str(backup_id))
        if not os.path.isdir(private):
            raise Corruption(f"backup {backup_id}: private dir missing")

    def garbage_collect(self) -> int:
        """Remove shared files and private dirs no live backup references
        (RocksDB's BackupEngine::GarbageCollect — cleanup after aborted
        or deleted backups). Returns the number of entries removed."""
        with self._mu:
            return self._garbage_collect_locked()

    def _garbage_collect_locked(self) -> int:
        live = set()
        meta_dir = os.path.join(self.dir, "meta")
        ids = set()
        for name in os.listdir(meta_dir):
            if name.endswith(".json") and name[:-5].isdigit():
                ids.add(int(name[:-5]))
                with open(os.path.join(meta_dir, name)) as f:
                    for fi in json.load(f)["files"]:
                        live.add(fi["shared"])
        removed = 0
        for name in os.listdir(os.path.join(self.dir, "shared")):
            if name not in live:
                os.remove(os.path.join(self.dir, "shared", name))
                removed += 1
        for name in os.listdir(os.path.join(self.dir, "private")):
            if name.isdigit() and int(name) not in ids:
                shutil.rmtree(os.path.join(self.dir, "private", name),
                              ignore_errors=True)
                removed += 1
        return removed

    def restore_db_from_backup(self, backup_id: int, db_dir: str) -> None:
        meta_path = os.path.join(self.dir, "meta", f"{backup_id}.json")
        if not os.path.exists(meta_path):
            raise NotFound(f"backup {backup_id}")
        with open(meta_path) as f:
            meta = json.load(f)
        os.makedirs(db_dir, exist_ok=True)
        for f in meta["files"]:
            src = os.path.join(self.dir, "shared", f["shared"])
            with open(src, "rb") as s:
                data = s.read()
            if crc32c.value(data) != f["crc32c"]:
                from toplingdb_tpu_torch.utils.status import Corruption

                raise Corruption(f"backup file {f['shared']} checksum mismatch")
            dst = filename.table_file_name(db_dir, f["number"])
            with open(dst, "wb") as d:
                d.write(data)
        private = os.path.join(self.dir, "private", str(backup_id))
        for name in os.listdir(private):
            shutil.copy2(os.path.join(private, name), os.path.join(db_dir, name))

    def purge_old_backups(self, num_to_keep: int) -> None:
        with self._mu:
            infos = self.get_backup_info()
            for info in infos[: max(0, len(infos) - num_to_keep)]:
                bid = info["backup_id"]
                os.remove(os.path.join(self.dir, "meta", f"{bid}.json"))
                shutil.rmtree(os.path.join(self.dir, "private", str(bid)),
                              ignore_errors=True)
            self._garbage_collect_locked()
