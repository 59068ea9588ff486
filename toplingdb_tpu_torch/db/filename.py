"""DB directory file naming (copied from toplingdb_tpu/db/filename.py).

  NNNNNN.log      WAL
  NNNNNN.sst      table file
  MANIFEST-NNNNNN version-edit log
  CURRENT         points at the live MANIFEST
  IDENTITY        db uuid
  LOCK            advisory lock
  OPTIONS-NNNNNN  persisted options
"""

from __future__ import annotations

import enum
import os


class FileType(enum.Enum):
    WAL = "log"
    TABLE = "sst"
    MANIFEST = "manifest"
    CURRENT = "current"
    IDENTITY = "identity"
    LOCK = "lock"
    OPTIONS = "options"
    TEMP = "dbtmp"
    BLOB = "blob"
    UNKNOWN = "unknown"


def log_file_name(dbname: str, number: int) -> str:
    return os.path.join(dbname, f"{number:06d}.log")


def table_file_name(dbname: str, number: int) -> str:
    return os.path.join(dbname, f"{number:06d}.sst")


def manifest_file_name(dbname: str, number: int) -> str:
    return os.path.join(dbname, f"MANIFEST-{number:06d}")


def current_file_name(dbname: str) -> str:
    return os.path.join(dbname, "CURRENT")


def identity_file_name(dbname: str) -> str:
    return os.path.join(dbname, "IDENTITY")


def lock_file_name(dbname: str) -> str:
    return os.path.join(dbname, "LOCK")


def options_file_name(dbname: str, number: int) -> str:
    return os.path.join(dbname, f"OPTIONS-{number:06d}")


def temp_file_name(dbname: str, number: int) -> str:
    return os.path.join(dbname, f"{number:06d}.dbtmp")


def parse_file_name(fname: str) -> tuple[FileType, int]:
    """Classify a basename; returns (type, number) with number=0 when N/A."""
    if fname == "CURRENT":
        return FileType.CURRENT, 0
    if fname == "IDENTITY":
        return FileType.IDENTITY, 0
    if fname == "LOCK":
        return FileType.LOCK, 0
    if fname.startswith("MANIFEST-"):
        tail = fname[len("MANIFEST-"):]
        if tail.isdigit():
            return FileType.MANIFEST, int(tail)
        return FileType.UNKNOWN, 0
    if fname.startswith("OPTIONS-"):
        tail = fname[len("OPTIONS-"):]
        if tail.isdigit():
            return FileType.OPTIONS, int(tail)
        return FileType.UNKNOWN, 0
    stem, _, ext = fname.partition(".")
    if stem.isdigit():
        if ext == "log":
            return FileType.WAL, int(stem)
        if ext == "sst":
            return FileType.TABLE, int(stem)
        if ext == "dbtmp":
            return FileType.TEMP, int(stem)
        if ext == "blob":
            return FileType.BLOB, int(stem)
    return FileType.UNKNOWN, 0


def set_current_file(env, dbname: str, manifest_number: int) -> None:
    """Atomically point CURRENT at MANIFEST-N (write temp + rename)."""
    tmp = temp_file_name(dbname, manifest_number)
    env.write_file(tmp, f"MANIFEST-{manifest_number:06d}\n".encode(), sync=True)
    env.rename_file(tmp, current_file_name(dbname))
