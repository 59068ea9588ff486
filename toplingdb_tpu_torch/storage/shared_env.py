"""SharedSstEnv: the disaggregated-storage Env seam (copied from
toplingdb_tpu/storage/shared_env.py).

Wraps a base Env (the same seam overlay.py / encrypted.py /
fault_injection.py interpose on) so a DB directory can hold SSTs *by
reference*: a hidden per-directory table `STORE_REFS.json` maps SST file
names to content addresses in a shared object store
(storage/object_store.py). Locally-written files behave exactly as before;
a referenced-but-absent file materializes on first open through the local
cache tier, after which every read is a plain local read.

The cache tier (`StoreCacheTier`) fronts the store with
utils/persistent_cache.py (a CRC-checked disk tier keyed by address, shared
across every directory this env serves) and an AsyncIORing for background
prefetch (`warm_refs` — the lazy cache warm after a reference-mode
checkpoint restore). Every cold fetch is verified against its own address
before it is installed anywhere — a corrupt or truncated store response is
retried from the store, never materialized.

The DB layer never sees the plumbing: `get_children` merges referenced
names (and hides the refs table), `delete_file` of a referenced name drops
the reference, `get_file_size` answers from the address (which encodes the
size) without a fetch. `DB._delete_obsolete_files`, checkpoint restore,
table-cache opens and the dcompact worker all work unchanged on top.
"""

from __future__ import annotations

import json
import time
import uuid

from toplingdb_tpu_torch.env.env import Env
from toplingdb_tpu_torch.storage.object_store import (
    address_of_meta,
    address_size,
    verify_payload,
)
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils import statistics as stats_mod
from toplingdb_tpu_torch.utils import telemetry as _tm
from toplingdb_tpu_torch.utils.status import Corruption, IOError_, NotFound

REFS_NAME = "STORE_REFS.json"


class StoreCacheTier:
    """Verified fetch path: store -> (verify) -> persistent cache ->
    materialized file. `fetch` never returns unverified bytes; transport
    failures and corrupt payloads are retried with backoff (`attempts`),
    so a faulty store degrades to latency, not to corruption."""

    def __init__(self, store, cache_dir: str | None = None,
                 cache_bytes: int = 256 << 20, stats=None,
                 attempts: int = 6, backoff_base: float = 0.01):
        self.store = store
        self.stats = stats
        self.attempts = max(1, attempts)
        self.backoff_base = backoff_base
        self._pcache = None
        self._cache_dir = cache_dir
        self._cache_bytes = cache_bytes
        self._ring = None
        self._mu = ccy.Lock("shared_env.StoreCacheTier._mu")

    # -- lazily built internals ---------------------------------------

    def _cache(self):
        with self._mu:
            if self._pcache is None and self._cache_dir is not None:
                from toplingdb_tpu_torch.utils.persistent_cache import (
                    PersistentCache,
                )

                self._pcache = PersistentCache(
                    self._cache_dir, capacity_bytes=self._cache_bytes)
            return self._pcache

    def _warm_ring(self):
        with self._mu:
            if self._ring is None:
                from toplingdb_tpu_torch.env.env import AsyncIORing

                self._ring = AsyncIORing(name="tpt-store-warm")
            return self._ring

    def _tick(self, name: str, count: int = 1) -> None:
        if self.stats is not None:
            self.stats.record_tick(name, count)

    # -- the fetch path ------------------------------------------------

    def fetch(self, addr: str) -> bytes:
        """Verified payload for `addr`: persistent-cache hit, else a cold
        store fetch (verified, retried, recorded in the fetch-latency
        histogram). NotFound is an answer and is never retried."""
        pc = self._cache()
        key = addr.encode()
        if pc is not None:
            payload = pc.lookup(key)
            if payload is not None:
                self._tick(stats_mod.STORE_HITS)
                return payload
        t0 = time.monotonic()
        last: Exception | None = None
        with _tm.span("store.fetch", addr=addr):
            for attempt in range(1, self.attempts + 1):
                if attempt > 1:
                    self._tick(stats_mod.STORE_FETCH_RETRIES)
                    time.sleep(self.backoff_base * (2 ** (attempt - 2)))
                try:
                    payload = self.store.fetch(addr)
                    verify_payload(addr, payload)
                    break
                except NotFound:
                    raise
                except (Corruption, IOError_, OSError) as e:
                    last = e
            else:
                raise IOError_(
                    f"store object {addr} unfetchable after "
                    f"{self.attempts} attempts: {last}") from last
        self._tick(stats_mod.STORE_MISSES)
        self._tick(stats_mod.STORE_BYTES_FETCHED, len(payload))
        if self.stats is not None:
            self.stats.record_in_histogram(
                stats_mod.STORE_FETCH_MICROS,
                int((time.monotonic() - t0) * 1e6))
        if pc is not None:
            pc.insert(key, payload)
        return payload

    def warm(self, fetch_fns) -> int:
        """Fire-and-forget prefetch: each callable runs on the warm ring;
        failures are swallowed (warming is an optimization — the
        synchronous path re-fetches with its own retries)."""
        ring = self._warm_ring()
        n = 0
        for fn in fetch_fns:
            def task(fn=fn):
                try:
                    fn()
                except Exception as e:  # noqa: BLE001
                    _errors.swallow(reason="store-warm-prefetch", exc=e)
            try:
                ring.submit_task(task)
                n += 1
            except IOError_:
                break  # ring closed mid-shutdown: warming is best-effort
        return n

    def drain(self) -> None:
        with self._mu:
            ring = self._ring
        if ring is not None:
            ring.drain()

    def close(self) -> None:
        with self._mu:
            ring, self._ring = self._ring, None
            pc, self._pcache = self._pcache, None
        if ring is not None:
            ring.close()
        if pc is not None:
            pc.close()

    def cache_stats(self) -> dict:
        with self._mu:
            pc = self._pcache
        return pc.stats() if pc is not None else {}

    def prune(self) -> int:
        """Disk-pressure reclaim: drop the clean cached objects (they
        refetch from the store on demand). Returns bytes freed."""
        with self._mu:
            pc = self._pcache
        return pc.prune() if pc is not None else 0


class SharedSstEnv(Env):
    """Env wrapper that resolves referenced SSTs from a content-addressed
    store. Construction is cheap; the cache tier spins up lazily. The
    owner must close() it (DB.close does when DB.open built the wrapper
    from Options.shared_store)."""

    def __init__(self, base: Env, store, cache_dir: str | None = None,
                 cache_bytes: int = 256 << 20, stats=None):
        self._base = base
        self.store = store
        self.tier = StoreCacheTier(store, cache_dir=cache_dir,
                                   cache_bytes=cache_bytes, stats=stats)
        self._mu = ccy.Lock("shared_env.SharedSstEnv._mu")
        self._refs: dict[str, dict[str, str]] = {}  # dir -> {name: addr}
        self._attached = 0  # DBs sharing this env (retain/release)

    @property
    def stats(self):
        return self.tier.stats

    @stats.setter
    def stats(self, value) -> None:
        self.tier.stats = value

    @property
    def base(self) -> Env:
        return self._base

    def get_free_space(self, path: str) -> int:
        return self._base.get_free_space(path)

    def close(self) -> None:
        self.tier.close()

    # -- shared ownership ------------------------------------------------
    # One SharedSstEnv serves many DBs over its lifetime (a migration's
    # destination reuses the source's env; checkpoint restores reopen on
    # it). Each DB.open on the env retains; each DB.close releases; the
    # last release closes the tier's cache/prefetch threads.

    def retain(self) -> "SharedSstEnv":
        with self._mu:
            self._attached += 1
        return self

    def release(self) -> None:
        with self._mu:
            self._attached -= 1
            last = self._attached <= 0
        if last:
            self.close()

    # -- reference table -----------------------------------------------

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        d, _, name = path.rpartition("/")
        return d, name

    def _load_refs(self, d: str) -> dict[str, str]:
        """In-memory refs for directory `d`, loaded from its refs table on
        first touch. Callers must hold no lock; the brief _mu section only
        guards the map."""
        with self._mu:
            cached = self._refs.get(d)
        if cached is not None:
            return cached
        table: dict[str, str] = {}
        try:
            raw = self._base.read_file(f"{d}/{REFS_NAME}")
            table = {str(k): str(v)
                     for k, v in json.loads(raw.decode()).items()}
        except (OSError, NotFound, ValueError):
            table = {}
        with self._mu:
            # First loader wins; a concurrent mutator already installed.
            return self._refs.setdefault(d, table)

    def _persist_refs(self, d: str) -> None:
        with self._mu:
            table = dict(self._refs.get(d) or {})
        final = f"{d}/{REFS_NAME}"
        if not table:
            try:
                self._base.delete_file(final)
            except (OSError, NotFound):
                pass
            return
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        self._base.write_file(
            tmp, json.dumps(table, indent=1, sort_keys=True).encode(),
            sync=True)
        self._base.rename_file(tmp, final)

    def _ref_addr(self, path: str) -> str | None:
        d, name = self._split(path)
        return self._load_refs(d).get(name)

    def refs_of(self, d: str) -> dict[str, str]:
        """Copy of the directory's name -> address table."""
        return dict(self._load_refs(d))

    def adopt(self, path: str, addr: str) -> None:
        """Record that `path` is backed by store object `addr` (reference
        checkpoint restore, dcompact output adoption). Metadata-only: no
        bytes move until the file is first read."""
        d, name = self._split(path)
        self._load_refs(d)
        with self._mu:
            self._refs.setdefault(d, {})[name] = addr
        self._persist_refs(d)

    def drop_ref(self, path: str) -> bool:
        d, name = self._split(path)
        self._load_refs(d)
        with self._mu:
            dropped = (self._refs.get(d) or {}).pop(name, None) is not None
        if dropped:
            self._persist_refs(d)
        return dropped

    def invalidate_refs(self, d: str) -> None:
        """Forget the in-memory table (another process rewrote the refs
        file); the next touch reloads from disk."""
        with self._mu:
            self._refs.pop(d, None)

    # -- publish / adopt / warm ----------------------------------------

    def publish_sst(self, path: str, meta) -> str | None:
        """Publish an installed SST to the store under its checksum
        address (DB._stamp_file_checksums calls this at flush/compaction/
        import install). Returns the address, or None when the meta is
        unstamped or the file has no local bytes to publish."""
        addr = address_of_meta(meta)
        if addr is None or not self._base.file_exists(path):
            return None
        with _tm.span("store.publish", addr=addr):
            self.store.publish_file(path, addr, src_env=self._base)
        if self.stats is not None:
            self.stats.record_tick(stats_mod.STORE_PUBLISHES)
        return addr

    def warm_refs(self, d: str) -> int:
        """Background-prefetch every referenced object of directory `d`
        into local bytes (the lazy cache warm after a reference-mode
        bootstrap). Returns the number of prefetches queued."""
        pairs = [(f"{d}/{name}", addr)
                 for name, addr in self._load_refs(d).items()]
        return self.tier.warm(
            (lambda p=p, a=a: self._materialize(p, a)) for p, a in pairs)

    # -- materialization -----------------------------------------------

    def _materialize(self, path: str, addr: str) -> None:
        """Turn a reference into local bytes (idempotent; concurrent
        materializers race benignly through an atomic rename)."""
        if self._base.file_exists(path):
            return
        payload = self.tier.fetch(addr)
        tmp = f"{path}.materialize-{uuid.uuid4().hex[:8]}"
        self._base.write_file(tmp, payload, sync=True)
        self._base.rename_file(tmp, path)

    def _ensure_local(self, path: str) -> None:
        if self._base.file_exists(path):
            return
        addr = self._ref_addr(path)
        if addr is not None:
            self._materialize(path, addr)

    # -- Env surface ---------------------------------------------------

    def new_writable_file(self, path: str):
        self.drop_ref(path)  # an overwrite supersedes any old reference
        return self._base.new_writable_file(path)

    def new_random_access_file(self, path: str):
        self._ensure_local(path)
        return self._base.new_random_access_file(path)

    def new_sequential_file(self, path: str):
        self._ensure_local(path)
        return self._base.new_sequential_file(path)

    def file_exists(self, path: str) -> bool:
        return self._base.file_exists(path) \
            or self._ref_addr(path) is not None

    def get_file_size(self, path: str) -> int:
        if self._base.file_exists(path):
            return self._base.get_file_size(path)
        addr = self._ref_addr(path)
        if addr is not None:
            return address_size(addr)  # the address encodes the size
        return self._base.get_file_size(path)  # raise the base's error

    def delete_file(self, path: str) -> None:
        dropped = self.drop_ref(path)
        try:
            self._base.delete_file(path)
        except (OSError, NotFound):
            if not dropped:
                raise  # neither local bytes nor a reference existed

    def rename_file(self, src: str, dst: str) -> None:
        addr = self._ref_addr(src)
        if addr is not None:
            self.drop_ref(src)
            self.adopt(dst, addr)
        if self._base.file_exists(src):
            self._base.rename_file(src, dst)
        elif addr is None:
            self._base.rename_file(src, dst)  # raise the base's error

    def reuse_writable_file(self, old_path: str, new_path: str):
        self.drop_ref(old_path)
        self.drop_ref(new_path)
        return self._base.reuse_writable_file(old_path, new_path)

    def get_file_mtime(self, path: str) -> float | None:
        if self._base.file_exists(path):
            return self._base.get_file_mtime(path)
        return None  # a pure reference has no local mtime

    def create_dir(self, path: str) -> None:
        self._base.create_dir(path)

    def get_children(self, path: str) -> list[str]:
        try:
            names = [c for c in self._base.get_children(path)
                     if c != REFS_NAME and not c.startswith(REFS_NAME + ".")]
        except (OSError, NotFound):
            names = []
            if not self._load_refs(path):
                raise
        merged = set(names) | set(self._load_refs(path))
        return sorted(merged)

    def read_file(self, path: str) -> bytes:
        self._ensure_local(path)
        return self._base.read_file(path)

    def write_file(self, path: str, data: bytes, sync: bool = False) -> None:
        self.drop_ref(path)
        self._base.write_file(path, data, sync=sync)

    def now_micros(self) -> int:
        return self._base.now_micros()

    def status(self) -> dict:
        with self._mu:
            ref_dirs = {d: len(t) for d, t in self._refs.items() if t}
        doc = {"referenced": ref_dirs,
               "cache": self.tier.cache_stats()}
        if hasattr(self.store, "status"):
            try:
                doc["store"] = self.store.status()
            except Exception as e:  # noqa: BLE001
                _errors.swallow(reason="store-status-probe", exc=e)
                doc["store"] = {"error": repr(e)[:120]}
        return doc
