"""Content-addressed SST object store (copied from
toplingdb_tpu/storage/object_store.py): the disaggregated-storage plane's
ground truth.

ToplingDB's dcompact reads and writes SSTs through shared storage instead
of shipping bytes per job. This store keys every object by the whole-file
checksum the integrity plane already stamps into FileMetaData and the
MANIFEST (utils/file_checksum.py), so a table the port writes gets the
address toplingdb_tpu gives the same bytes:

    address = "<func>-<digest_hex>-<file_size>"   e.g. crc32c-9f01ab34-40960

The address IS the content checksum, so a fetched payload verifies against
its own name (`verify_payload`), dedup is free (same bytes -> same address),
and an adopted compaction output gets its MANIFEST checksum stamped without
re-reading a byte. `LocalObjectStore` is the directory backend (hardlink
publish when source and store share a posix filesystem); `StoreClient`
(storage/store_server.py) speaks the same interface over HTTP.

Deletion safety: objects are only removed by the mark-sweep GC
(storage/gc.py) against live manifests + the pin table kept here. Pins are
leases with a TTL — a publisher pins its outputs for the window between
publish and manifest install so a concurrent sweep can't reap an object
that is about to become live.
"""

from __future__ import annotations

import os
import uuid

import json
import time

from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils.file_checksum import (
    DEFAULT_CHECKSUM_NAME,
    FileChecksumGenFactory,
    compute_file_checksum,
)
from toplingdb_tpu_torch.utils.status import (
    Corruption,
    InvalidArgument,
    NotFound,
)


# ---------------------------------------------------------------------------
# Addresses
# ---------------------------------------------------------------------------


def object_address(func_name: str, digest: bytes, file_size: int) -> str:
    """The canonical store key for one SST's content."""
    if not digest:
        raise InvalidArgument("cannot address an object without a digest")
    return f"{func_name or DEFAULT_CHECKSUM_NAME}-{digest.hex()}-{file_size}"


def parse_address(addr: str) -> tuple[str, bytes, int]:
    """address -> (func_name, digest, file_size); raises InvalidArgument
    on anything that was not produced by object_address."""
    try:
        func, digest_hex, size = addr.rsplit("-", 2)
        return func, bytes.fromhex(digest_hex), int(size)
    except (ValueError, AttributeError) as e:
        raise InvalidArgument(f"bad object address {addr!r}") from e


def address_of_meta(meta) -> str | None:
    """Address for a FileMetaData, or None when the integrity plane never
    stamped it (file_checksum='off' / pre-upgrade files)."""
    if not getattr(meta, "file_checksum", None):
        return None
    return object_address(meta.file_checksum_func_name,
                          meta.file_checksum, meta.file_size)


def address_size(addr: str) -> int:
    return parse_address(addr)[2]


def verify_payload(addr: str, payload: bytes) -> None:
    """Self-verification: recompute the address's digest over the payload.
    Raises Corruption on any mismatch (wrong bytes, truncation, bitrot)."""
    func, digest, size = parse_address(addr)
    if len(payload) != size:
        raise Corruption(
            f"store object {addr}: payload is {len(payload)}B, "
            f"address says {size}B")
    gen = FileChecksumGenFactory(func).create()
    gen.update(payload)
    actual = gen.finalize()
    if actual != digest:
        raise Corruption(
            f"store object {addr}: digest mismatch "
            f"(recomputed {actual.hex()})")


def compute_address(env, path: str, func_name: str = DEFAULT_CHECKSUM_NAME,
                    ) -> str:
    """Address of an on-disk file (publish path for unstamped files)."""
    gen = FileChecksumGenFactory(func_name).create()
    digest = compute_file_checksum(env, path, gen)
    return object_address(func_name, digest, env.get_file_size(path))


# ---------------------------------------------------------------------------
# Local directory backend
# ---------------------------------------------------------------------------


class LocalObjectStore:
    """Directory-backed object store:

        <root>/objects/<digest_hex[:2]>/<addr>     immutable payloads
        <root>/pins/<addr>.pin                     JSON {holder, expires}

    Publishes are idempotent and safe under concurrent publishers: the
    payload lands under a unique temp name and is renamed into place, so
    two racers both succeed and the loser's rename atomically replaces
    identical bytes. Objects are immutable once present (content-addressed:
    a different payload would be a different address)."""

    DEFAULT_PIN_TTL = 300.0

    def __init__(self, root: str, env=None):
        if env is None:
            from toplingdb_tpu_torch.env import default_env

            env = default_env()
        self.root = root
        self.env = env
        self._mu = ccy.Lock("object_store.LocalObjectStore._mu")
        env.create_dir(root)
        env.create_dir(f"{root}/objects")
        env.create_dir(f"{root}/pins")

    # -- layout --------------------------------------------------------

    def _obj_path(self, addr: str) -> str:
        _func, digest, _size = parse_address(addr)
        shard = digest.hex()[:2] or "00"
        return f"{self.root}/objects/{shard}/{addr}"

    def _pin_path(self, addr: str) -> str:
        return f"{self.root}/pins/{addr}.pin"

    # -- objects -------------------------------------------------------

    def contains(self, addr: str) -> bool:
        return self.env.file_exists(self._obj_path(addr))

    def fetch(self, addr: str) -> bytes:
        """Raw payload bytes (callers verify via verify_payload — the
        cache tier does, so a corrupt object can never be installed)."""
        path = self._obj_path(addr)
        if not self.env.file_exists(path):
            raise NotFound(f"store object {addr} not present")
        return self.env.read_file(path)

    def put(self, addr: str, payload: bytes) -> bool:
        """Store a payload under its address; returns False when the
        object was already present (dedup). The payload is verified
        BEFORE it becomes visible — a store never holds a lie."""
        if self.contains(addr):
            return False
        verify_payload(addr, payload)
        final = self._obj_path(addr)
        self._ensure_shard_dir(final)
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        self.env.write_file(tmp, payload, sync=True)
        self.env.rename_file(tmp, final)
        return True

    def publish_file(self, src_path: str, addr: str, src_env=None) -> bool:
        """Publish a local file under `addr`; returns False on dedup.
        Hardlinks when the source and the store share a real posix
        filesystem (zero-copy publish); byte-copy otherwise."""
        if self.contains(addr):
            return False
        src_env = src_env or self.env
        final = self._obj_path(addr)
        self._ensure_shard_dir(final)
        from toplingdb_tpu_torch.env.env import PosixEnv

        if type(self.env) is PosixEnv and type(src_env) is PosixEnv:
            tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
            try:
                os.link(src_path, tmp)
                os.replace(tmp, final)
                return True
            except OSError:
                pass  # cross-device / FS without links: fall through
        return self.put(addr, src_env.read_file(src_path))

    def delete(self, addr: str) -> bool:
        path = self._obj_path(addr)
        if not self.env.file_exists(path):
            return False
        self.env.delete_file(path)
        return True

    def object_mtime(self, addr: str) -> float | None:
        try:
            return self.env.get_file_mtime(self._obj_path(addr))
        except (OSError, NotFound):
            return None

    def list_addresses(self) -> list[str]:
        out = []
        try:
            shards = self.env.get_children(f"{self.root}/objects")
        except (OSError, NotFound):
            return out
        for shard in shards:
            try:
                names = self.env.get_children(
                    f"{self.root}/objects/{shard}")
            except (OSError, NotFound):
                continue  # a file where a shard dir should be: skip
            out.extend(n for n in names if ".tmp-" not in n)
        return sorted(out)

    def _ensure_shard_dir(self, obj_path: str) -> None:
        self.env.create_dir(obj_path.rsplit("/", 1)[0])

    # -- pins (sweep safety for not-yet-live objects) ------------------

    def pin(self, addr: str, holder: str, ttl: float | None = None) -> None:
        """Shield `addr` from the GC for `ttl` seconds (the publish ->
        manifest-install window). Re-pinning extends the lease."""
        ttl = self.DEFAULT_PIN_TTL if ttl is None else float(ttl)
        doc = {"holder": holder, "expires": time.time() + ttl}
        with self._mu:
            self.env.write_file(self._pin_path(addr),
                                json.dumps(doc).encode(), sync=True)

    def unpin(self, addr: str, holder: str | None = None) -> None:
        with self._mu:
            try:
                self.env.delete_file(self._pin_path(addr))
            except (OSError, NotFound):
                pass

    def pinned(self) -> set[str]:
        """Unexpired pinned addresses (expired pin files are reaped)."""
        now = time.time()
        out: set[str] = set()
        try:
            names = self.env.get_children(f"{self.root}/pins")
        except (OSError, NotFound):
            return out
        for name in names:
            if not name.endswith(".pin"):
                continue
            addr = name[:-4]
            path = self._pin_path(addr)
            try:
                doc = json.loads(self.env.read_file(path).decode())
                if float(doc.get("expires", 0)) >= now:
                    out.add(addr)
                    continue
            except (OSError, ValueError, NotFound):
                pass  # torn pin write: treat as expired
            with self._mu:
                try:
                    self.env.delete_file(path)
                except (OSError, NotFound):
                    pass
        return out

    # -- introspection -------------------------------------------------

    def status(self) -> dict:
        addrs = self.list_addresses()
        return {
            "backend": "local",
            "root": self.root,
            "objects": len(addrs),
            "bytes": sum(address_size(a) for a in addrs),
            "pinned": sorted(self.pinned()),
        }
