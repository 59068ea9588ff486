"""Whole-file checksums recorded per SST in the MANIFEST (copied from
toplingdb_tpu/utils/file_checksum.py, trimmed to the two generators, the
name-keyed factory and `stamp_file_checksum`; verification passes, the
scrubber's pacing and the async read ring come with later slices).

`crc32c` streams crc32c.extend over the file; `xxh64` chains per-chunk
xxh64 digests through the seed and folds in the total length.
"""

from __future__ import annotations

from toplingdb_tpu_torch.utils import crc32c
from toplingdb_tpu_torch.utils.status import Corruption, InvalidArgument

DEFAULT_CHECKSUM_NAME = "crc32c"
_CHUNK = 1 << 20


class Crc32cFileChecksumGen:
    name = "crc32c"

    def __init__(self):
        self._crc = 0

    def update(self, data: bytes) -> None:
        self._crc = crc32c.extend(self._crc, data)

    def finalize(self) -> bytes:
        return self._crc.to_bytes(4, "little")


class Xxh64FileChecksumGen:
    name = "xxh64"

    def __init__(self):
        self._h = 0
        self._len = 0

    def update(self, data: bytes) -> None:
        self._h = crc32c.xxh64(bytes(data), seed=self._h)
        self._len += len(data)

    def finalize(self) -> bytes:
        return crc32c.xxh64(self._len.to_bytes(8, "little"),
                            seed=self._h).to_bytes(8, "little")


class FileChecksumGenFactory:
    _GENS = {
        "crc32c": Crc32cFileChecksumGen,
        "xxh64": Xxh64FileChecksumGen,
    }

    def __init__(self, default: str = DEFAULT_CHECKSUM_NAME):
        if default not in self._GENS:
            raise InvalidArgument(
                f"unknown file checksum function {default!r}; "
                f"known: {sorted(self._GENS)}"
            )
        self.default_name = default

    def create(self, name: str | None = None):
        return self._GENS[name or self.default_name]()


def factory_for(options) -> FileChecksumGenFactory | None:
    """The effective factory for an Options: `file_checksum` names the
    generator; None/''/'off' disables whole-file checksums."""
    name = getattr(options, "file_checksum", DEFAULT_CHECKSUM_NAME)
    if not name or name == "off":
        return None
    return FileChecksumGenFactory(name)


def compute_file_checksum(env, path: str, gen) -> bytes:
    f = env.new_random_access_file(path)
    try:
        size = f.size()
        off = 0
        while off < size:
            data = f.read(off, min(_CHUNK, size - off))
            if not data:
                raise Corruption(f"{path}: short read at {off}/{size}")
            gen.update(data)
            off += len(data)
    finally:
        f.close()
    return gen.finalize()


def stamp_file_checksum(env, path: str, meta, factory) -> None:
    """Compute and record the file checksum on one FileMetaData (no-op when
    disabled or already stamped)."""
    if factory is None or meta.file_checksum:
        return
    gen = factory.create()
    meta.file_checksum = compute_file_checksum(env, path, gen)
    meta.file_checksum_func_name = gen.name


def verify_recorded_checksum(env, path: str, meta) -> int:
    """Recompute and compare one file's recorded checksum; returns the
    bytes verified (0 when the meta carries none). Raises Corruption on a
    mismatch."""
    if not meta.file_checksum:
        return 0
    gen = FileChecksumGenFactory(meta.file_checksum_func_name
                                 or DEFAULT_CHECKSUM_NAME).create()
    actual = compute_file_checksum(env, path, gen)
    if actual != meta.file_checksum:
        raise Corruption(
            f"file checksum mismatch on {path}: recorded "
            f"{meta.file_checksum.hex()} ({meta.file_checksum_func_name}), "
            f"recomputed {actual.hex()}"
        )
    return env.get_file_size(path)
