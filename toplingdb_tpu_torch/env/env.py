"""Posix filesystem access (copied from toplingdb_tpu/env/env.py, trimmed to
the file operations the compaction data plane and the DB use: no
statistics, no async IO rings, no WAL recycling, no in-memory env)."""

from __future__ import annotations

import os

from toplingdb_tpu_torch.utils.status import IOError_, NotFound


class _PosixWritable:
    def __init__(self, path: str):
        try:
            self._f = open(path, "wb")
        except OSError as e:
            raise IOError_(f"open {path}: {e}") from e
        self._size = 0

    def append(self, data) -> None:
        self._f.write(data)
        self._size += len(data)

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def file_size(self) -> int:
        return self._size


class _PosixRandomAccess:
    def __init__(self, path: str):
        try:
            self._f = open(path, "rb")
        except FileNotFoundError as e:
            raise NotFound(f"{path}") from e
        except OSError as e:
            raise IOError_(f"open {path}: {e}") from e
        self._size = os.fstat(self._f.fileno()).st_size

    def read(self, offset: int, n: int) -> bytes:
        return os.pread(self._f.fileno(), n, offset)

    def size(self) -> int:
        return self._size

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class _PosixSequential:
    def __init__(self, path: str):
        try:
            self._f = open(path, "rb")
        except FileNotFoundError as e:
            raise NotFound(f"{path}") from e
        except OSError as e:
            raise IOError_(f"open {path}: {e}") from e

    def read(self, n: int) -> bytes:
        return self._f.read(n)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class PosixEnv:
    def new_writable_file(self, path: str) -> _PosixWritable:
        return _PosixWritable(path)

    def new_random_access_file(self, path: str) -> _PosixRandomAccess:
        return _PosixRandomAccess(path)

    def get_file_size(self, path: str) -> int:
        try:
            return os.path.getsize(path)
        except FileNotFoundError as e:
            raise NotFound(path) from e

    def delete_file(self, path: str) -> None:
        try:
            os.remove(path)
        except FileNotFoundError as e:
            raise NotFound(path) from e

    def new_sequential_file(self, path: str) -> _PosixSequential:
        return _PosixSequential(path)

    def file_exists(self, path: str) -> bool:
        return os.path.exists(path)

    def rename_file(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def create_dir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def get_children(self, path: str) -> list[str]:
        try:
            return sorted(os.listdir(path))
        except FileNotFoundError as e:
            raise NotFound(path) from e

    def read_file(self, path: str) -> bytes:
        f = self.new_random_access_file(path)
        try:
            return f.read(0, f.size())
        finally:
            f.close()

    def write_file(self, path: str, data: bytes, sync: bool = False) -> None:
        f = self.new_writable_file(path)
        try:
            f.append(data)
            if sync:
                f.sync()
        finally:
            f.close()


def default_env() -> PosixEnv:
    return PosixEnv()
