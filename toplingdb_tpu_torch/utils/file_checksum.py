"""Whole-file checksums recorded per SST in the MANIFEST (copied from
toplingdb_tpu/utils/file_checksum.py, trimmed to the two generators, the
name-keyed factory, stamping, verification with the scrubber's pacing,
and the offline MANIFEST sweep; the async read ring comes with a later
slice).

`crc32c` streams crc32c.extend over the file; `xxh64` chains per-chunk
xxh64 digests through the seed and folds in the total length. A DB with
checksums on writes its tables through `ChecksumTapEnv`, which digests
each table as it is written; other tables are digested by reading them
back.
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


def compute_file_checksum(env, path: str, gen, pacer=None) -> bytes:
    """Digest the whole file through the Env in chunks. `pacer`, when
    given, is called with each chunk's size (the scrubber's rate
    limiter)."""
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
            if pacer is not None:
                pacer(len(data))
    finally:
        f.close()
    return gen.finalize()


class _TappedWritable:
    """A writable file whose appended bytes feed a checksum generator in
    the _CHUNK framing compute_file_checksum reads with, so the digest is
    the one a clean read-back gives; `close` hands it to `done`."""

    def __init__(self, base, gen, done):
        self._base = base
        self._gen = gen
        self._buf = bytearray()
        self._size = 0
        self._done = done

    def append(self, data) -> None:
        self._base.append(data)
        self._size += len(data)
        buf = self._buf
        buf += data
        if len(buf) >= _CHUNK:
            whole = len(buf) - len(buf) % _CHUNK
            for off in range(0, whole, _CHUNK):
                self._gen.update(bytes(buf[off:off + _CHUNK]))
            del buf[:whole]

    def flush(self) -> None:
        self._base.flush()

    def sync(self) -> None:
        self._base.sync()

    def file_size(self) -> int:
        return self._base.file_size()

    def close(self) -> None:
        self._base.close()
        done, self._done = self._done, None
        if done is not None:
            if self._buf:
                self._gen.update(bytes(self._buf))
                self._buf = bytearray()
            done(self._size, self._gen.finalize())


class ChecksumTapEnv:
    """The DB's view of its Env when file checksums are on: every table
    file it writes is digested as its bytes are appended (RocksDB computes
    file checksums in the file writer), so `stamp_file_checksum` records
    the digest of the bytes written, not of a read-back that a faulty read
    path could have damaged. Every other call passes through to `base`."""

    def __init__(self, base, factory: "FileChecksumGenFactory"):
        self.base = base
        self._factory = factory
        self._digests: dict[str, tuple[str, int, bytes]] = {}

    def __getattr__(self, name):
        return getattr(self.base, name)

    def new_writable_file(self, path: str):
        f = self.base.new_writable_file(path)
        if not path.endswith(".sst"):
            return f
        self._digests.pop(path, None)
        gen = self._factory.create()

        def done(size, digest, path=path, name=gen.name):
            self._digests[path] = (name, size, digest)

        return _TappedWritable(f, gen, done)

    def delete_file(self, path: str) -> None:
        self._digests.pop(path, None)
        self.base.delete_file(path)

    def take_digest(self, path: str):
        """(function name, bytes written, digest) of a table file this env
        wrote and closed, or None; the entry is consumed."""
        return self._digests.pop(path, None)


def stamp_file_checksum(env, path: str, meta, factory) -> None:
    """Compute and record the file checksum on one FileMetaData (no-op when
    disabled or already stamped)."""
    if factory is None or meta.file_checksum:
        return
    take = getattr(env, "take_digest", None)
    tapped = take(path) if take is not None else None
    if (tapped is not None and tapped[0] == factory.default_name
            and tapped[1] == env.get_file_size(path)):
        meta.file_checksum, meta.file_checksum_func_name = tapped[2], \
            tapped[0]
        return
    gen = factory.create()
    meta.file_checksum = compute_file_checksum(env, path, gen)
    meta.file_checksum_func_name = gen.name


def verify_recorded_checksum(env, path: str, meta, pacer=None) -> int:
    """Recompute and compare one file's recorded checksum; returns the
    bytes verified (0 when the meta carries none). Raises Corruption on a
    mismatch."""
    if not meta.file_checksum:
        return 0
    gen = FileChecksumGenFactory(meta.file_checksum_func_name
                                 or DEFAULT_CHECKSUM_NAME).create()
    actual = compute_file_checksum(env, path, gen, pacer=pacer)
    if actual != meta.file_checksum:
        raise Corruption(
            f"file checksum mismatch on {path}: recorded "
            f"{meta.file_checksum.hex()} ({meta.file_checksum_func_name}), "
            f"recomputed {actual.hex()}"
        )
    return env.get_file_size(path)


def manifest_file_checksums(dbdir: str,
                            env=None) -> dict[int, tuple[str, bytes]]:
    """file_number -> (func_name, digest) from a DB directory's
    CURRENT+MANIFEST, without opening a DB (the offline check)."""
    from toplingdb_tpu_torch.db import filename
    from toplingdb_tpu_torch.db.log import LogReader
    from toplingdb_tpu_torch.db.version_edit import VersionEdit

    if env is None:
        from toplingdb_tpu_torch.env import default_env

        env = default_env()
    cur = env.read_file(filename.current_file_name(dbdir)).decode().strip()
    path = f"{dbdir}/{cur}"
    out: dict[int, tuple[str, bytes]] = {}
    live: set[int] = set()
    for rec in LogReader(env.new_sequential_file(path)).records():
        e = VersionEdit.decode(rec)
        for _lvl, num in e.deleted_files:
            live.discard(num)
        for _lvl, meta in e.new_files:
            live.add(meta.number)
            if meta.file_checksum:
                out[meta.number] = (meta.file_checksum_func_name,
                                    meta.file_checksum)
    return {n: v for n, v in out.items() if n in live}


def verify_dir_file_checksums(dbdir: str, env=None) -> dict:
    """Verify every MANIFEST-recorded SST checksum in a directory without
    opening a DB. Returns
    {'files_verified': n, 'bytes_verified': n, 'files_skipped': n}."""
    from toplingdb_tpu_torch.db import filename

    if env is None:
        from toplingdb_tpu_torch.env import default_env

        env = default_env()
    recorded = manifest_file_checksums(dbdir, env)
    verified = bytes_v = skipped = 0
    for num, (fname, digest) in sorted(recorded.items()):
        path = filename.table_file_name(dbdir, num)
        if not env.file_exists(path):
            raise Corruption(f"{dbdir}: MANIFEST references missing {path}")
        gen = FileChecksumGenFactory(fname or DEFAULT_CHECKSUM_NAME).create()
        actual = compute_file_checksum(env, path, gen)
        if actual != digest:
            raise Corruption(
                f"file checksum mismatch on {path}: recorded "
                f"{digest.hex()} ({fname}), recomputed {actual.hex()}"
            )
        verified += 1
        bytes_v += env.get_file_size(path)
    # Live SSTs without a recorded checksum (pre-upgrade files) are
    # counted so callers can see partial coverage.
    for child in env.get_children(dbdir):
        t, num = filename.parse_file_name(child)
        if t == filename.FileType.TABLE and num not in recorded:
            skipped += 1
    return {"files_verified": verified, "bytes_verified": bytes_v,
            "files_skipped": skipped}
