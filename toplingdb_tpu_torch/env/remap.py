"""RemapEnv: path-prefix remapping over a base Env (copied from
toplingdb_tpu/env/remap.py).

The role of RocksDB's fs_remap (env/fs_remap.cc): a dcompact worker sees
the DB's canonical paths (as serialized in CompactionParams) even when
the shared storage is mounted somewhere else, e.g. the DB records
`/data/db` but the worker mounts it at `/mnt/nfs/db`. Every Env call
translates the longest matching source prefix before delegating; paths
outside every mapping pass through unchanged.
"""

from __future__ import annotations

from toplingdb_tpu_torch.env.env import Env


class RemapEnv(Env):
    def __init__(self, base: Env, mappings: dict[str, str]):
        """mappings: {source_prefix: target_prefix}, longest prefix wins."""
        self.base = base
        # Normalize: no trailing slash, longest first for greedy matching.
        self._maps = sorted(
            ((src.rstrip("/"), dst.rstrip("/"))
             for src, dst in mappings.items()),
            key=lambda p: -len(p[0]),
        )

    def remap(self, path: str) -> str:
        for src, dst in self._maps:
            if path == src or path.startswith(src + "/"):
                return dst + path[len(src):]
        return path

    # -- delegation ------------------------------------------------------

    def new_writable_file(self, path: str):
        return self.base.new_writable_file(self.remap(path))

    def new_random_access_file(self, path: str):
        return self.base.new_random_access_file(self.remap(path))

    def new_sequential_file(self, path: str):
        return self.base.new_sequential_file(self.remap(path))

    def file_exists(self, path: str) -> bool:
        return self.base.file_exists(self.remap(path))

    def get_file_size(self, path: str) -> int:
        return self.base.get_file_size(self.remap(path))

    def get_free_space(self, path: str) -> int:
        return self.base.get_free_space(self.remap(path))

    def delete_file(self, path: str) -> None:
        self.base.delete_file(self.remap(path))

    def rename_file(self, src: str, dst: str) -> None:
        self.base.rename_file(self.remap(src), self.remap(dst))

    def create_dir(self, path: str) -> None:
        self.base.create_dir(self.remap(path))

    def get_children(self, path: str) -> list[str]:
        return self.base.get_children(self.remap(path))

    def now_micros(self) -> int:
        return self.base.now_micros()

    def read_file(self, path: str) -> bytes:
        return self.base.read_file(self.remap(path))

    def write_file(self, path: str, data: bytes, sync: bool = False) -> None:
        self.base.write_file(self.remap(path), data, sync=sync)
