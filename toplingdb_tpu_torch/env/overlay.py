"""OverlayEnv: a writable overlay on top of a read-only base Env (copied
from toplingdb_tpu/env/overlay.py).

The role of ToplingDB's CatFileSystem (env/fs_cat.cc), which concatenates
a local overlay over a read-only base filesystem: how dcompact workers
mount the DB dir. Input SSTs are read from the (shared, read-only) base;
all new files land in the overlay. Deletes of base files are masked with
in-memory whiteouts (the worker never really deletes primary data).
"""

from __future__ import annotations

import os

from toplingdb_tpu_torch.utils import concurrency as ccy

from toplingdb_tpu_torch.env.env import Env
from toplingdb_tpu_torch.utils.status import NotFound


class OverlayEnv(Env):
    def __init__(self, base: Env, overlay: Env):
        self.base = base
        self.overlay = overlay
        self._whiteouts: set[str] = set()
        self._mu = ccy.Lock("overlay.OverlayEnv._mu")

    def _hidden(self, path: str) -> bool:
        with self._mu:
            return path in self._whiteouts

    def _unhide(self, path: str) -> None:
        with self._mu:
            self._whiteouts.discard(path)

    def get_free_space(self, path: str) -> int:
        # New bytes land in the overlay; its filesystem is the one filling.
        return self.overlay.get_free_space(path)

    # -- reads: overlay first, then base --------------------------------

    def new_random_access_file(self, path: str):
        if self.overlay.file_exists(path):
            return self.overlay.new_random_access_file(path)
        if self._hidden(path):
            raise NotFound(path)
        return self.base.new_random_access_file(path)

    def new_sequential_file(self, path: str):
        if self.overlay.file_exists(path):
            return self.overlay.new_sequential_file(path)
        if self._hidden(path):
            raise NotFound(path)
        return self.base.new_sequential_file(path)

    def read_file(self, path: str) -> bytes:
        if self.overlay.file_exists(path):
            return self.overlay.read_file(path)
        if self._hidden(path):
            raise NotFound(path)
        return self.base.read_file(path)

    def file_exists(self, path: str) -> bool:
        if self.overlay.file_exists(path):
            return True
        return not self._hidden(path) and self.base.file_exists(path)

    def get_file_size(self, path: str) -> int:
        if self.overlay.file_exists(path):
            return self.overlay.get_file_size(path)
        if self._hidden(path):
            raise NotFound(path)
        return self.base.get_file_size(path)

    def get_children(self, path: str) -> list[str]:
        out = set()
        try:
            out.update(self.overlay.get_children(path))
        except NotFound:
            pass
        try:
            for child in self.base.get_children(path):
                if not self._hidden(os.path.join(path, child)):
                    out.add(child)
        except NotFound:
            pass
        return sorted(out)

    # -- writes: overlay only -------------------------------------------

    def new_writable_file(self, path: str):
        self._unhide(path)
        return self.overlay.new_writable_file(path)

    def write_file(self, path: str, data: bytes, sync: bool = False) -> None:
        self._unhide(path)
        self.overlay.write_file(path, data, sync=sync)

    def create_dir(self, path: str) -> None:
        self.overlay.create_dir(path)

    def delete_file(self, path: str) -> None:
        deleted = False
        if self.overlay.file_exists(path):
            self.overlay.delete_file(path)
            deleted = True
        if self.base.file_exists(path):
            with self._mu:
                self._whiteouts.add(path)  # mask, never touch the base
            deleted = True
        if not deleted:
            raise NotFound(path)

    def rename_file(self, src: str, dst: str) -> None:
        if self.overlay.file_exists(src):
            self._unhide(dst)
            self.overlay.rename_file(src, dst)
            return
        if not self._hidden(src) and self.base.file_exists(src):
            # Copy-up: materialize the base file into the overlay under the
            # new name; whiteout the source.
            self._unhide(dst)
            self.overlay.write_file(dst, self.base.read_file(src))
            with self._mu:
                self._whiteouts.add(src)
            return
        raise NotFound(src)
