"""Filesystem access (copied from toplingdb_tpu/env/env.py, trimmed to the
file operations the compaction data plane and the DB use, to the submit
ring of the async WAL writer and the async read plane, to WAL recycling's
reuse and archiving's mtime, and to the free-space probe of the
storage-pressure plane: no statistics). PosixEnv is the DB's env; MemEnv
is the in-memory one, with a simulated capacity, for the SstFileManager
and FaultInjectionEnv on their own."""

from __future__ import annotations

import os
import threading

from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils.status import IOError_, NotFound
from toplingdb_tpu_torch.utils import concurrency as ccy


# ---------------------------------------------------------------------------
# Async batched I/O (the Env-level submit ring)
# ---------------------------------------------------------------------------


class AioToken:
    """Completion handle for one submitted ring operation. wait() blocks
    until the writer thread settled it and re-raises any error; `result`
    carries a task submission's return value."""

    __slots__ = ("_ev", "error", "result")

    def __init__(self):
        self._ev = threading.Event()
        self.error: BaseException | None = None
        self.result = None

    def done(self, err: BaseException | None = None, result=None) -> None:
        self.error = err
        self.result = result
        self._ev.set()

    def ready(self) -> bool:
        return self._ev.is_set()

    def wait(self):
        self._ev.wait()
        if self.error is not None:
            raise self.error
        return self.result


class AsyncIORing:
    """Bounded submit ring with ONE dedicated I/O thread. Producers submit
    appends, fsync barriers, per-file append barriers, generic read tasks
    (prefetch windows, the async read plane's block reads) and drain
    barriers;
    submission is cheap and non-blocking until the ring is full.

    The write-plane property is FSYNC COALESCING: the worker drains the
    queue in batches, executes every pending append in submit order, then
    performs ONE fsync per file that has >= 1 pending sync request and
    completes every such sync token — concurrent group-commit leaders'
    sync=True barriers merge into shared fsyncs. This is sound because a
    sync token only promises durability of the bytes submitted BEFORE it,
    and the shared fsync covers a superset.

    Error propagation: an append failure settles its own token AND parks
    per-file; the file's next sync / append-barrier waiter receives it
    (durability unknown past a failed append) and the park clears — a
    clean resume, not a poisoned ring. `fault_hook(kind, nbytes)` is the
    seeded injection seam (env/fault_injection.py WalWriterFaultInjector).
    """

    def __init__(self, capacity: int = 256, coalesce_cb=None,
                 fault_hook=None, name: str = "tpt-aio",
                 task_capacity: int | None = None):
        self._cap = max(1, int(capacity))
        # Reads (submit_task) get their OWN cap: a miss storm must not fill
        # the shared queue and starve WAL appends of their capacity slots,
        # and appends must not let tasks pile up unbounded.
        self._task_cap = max(1, int(task_capacity if task_capacity is not None
                                    else capacity))
        self._q: list = []
        self._n_task = 0
        self._cv = ccy.Condition("env.AsyncIORing._cv")
        self._closed = False
        self.coalesce_cb = coalesce_cb     # callable(n_merged_fsyncs)
        self.fault_hook = fault_hook       # callable(kind, nbytes) -> None
        self.appends = 0
        self.syncs = 0
        self.fsyncs = 0
        self.fsyncs_coalesced = 0
        self._pending_err: dict[int, BaseException] = {}
        self._thread = ccy.spawn(name, self._run, owner=self,
                                 stop=self.close)

    # -- submission ----------------------------------------------------

    def _submit(self, kind: str, f, data) -> AioToken:
        tok = AioToken()
        with self._cv:
            if self._closed:
                raise IOError_("async IO ring is closed")
            while not self._closed and (
                    (kind == "append" and len(self._q) >= self._cap)
                    or (kind == "task" and self._n_task >= self._task_cap)):
                self._cv.wait()  # bounded: back-pressure the producer
            if self._closed:
                raise IOError_("async IO ring is closed")
            if kind == "task":
                self._n_task += 1
            self._q.append((kind, f, data, tok))
            self._cv.notify_all()
        return tok

    def submit_append(self, wfile, data) -> AioToken:
        return self._submit("append", wfile, data)

    def submit_sync(self, wfile) -> AioToken:
        return self._submit("sync", wfile, None)

    def submit_barrier(self, wfile) -> AioToken:
        """Completes when every append for `wfile` submitted before it has
        been written (and the file flushed); carries any parked error."""
        return self._submit("fbarrier", wfile, None)

    def submit_task(self, fn) -> AioToken:
        """Generic async work on the I/O thread (prefetch window reads,
        the read plane's block reads); token.wait() returns fn()'s
        result."""
        return self._submit("task", None, fn)

    def drain(self) -> None:
        """Global barrier: every previously submitted op is settled."""
        self._submit("barrier", None, None).wait()

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
        self.drain()
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)

    # -- the worker ----------------------------------------------------

    def _exec(self, kind: str, fn, nbytes: int):
        try:
            if self.fault_hook is not None:
                self.fault_hook(kind, nbytes)
            return fn()
        except BaseException as e:  # noqa: BLE001
            return _AIO_ERR, e

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q and self._closed:
                    return
                batch = self._q
                self._q = []
                self._n_task = 0
                self._cv.notify_all()
            per_file: dict[int, list] = {}  # id -> [f, appended, syncs, fbars]
            global_bars: list[AioToken] = []

            def state(f):
                st = per_file.get(id(f))
                if st is None:
                    st = per_file[id(f)] = [f, False, [], []]
                return st

            for kind, f, data, tok in batch:
                if kind == "append":
                    r = self._exec("append", lambda: f.append(data), len(data))
                    if type(r) is tuple and r and r[0] is _AIO_ERR:
                        self._pending_err.setdefault(id(f), r[1])
                        tok.done(r[1])
                    else:
                        self.appends += 1
                        state(f)[1] = True
                        tok.done()
                elif kind == "task":
                    r = self._exec("task", data, 0)
                    if type(r) is tuple and r and r[0] is _AIO_ERR:
                        tok.done(r[1])
                    else:
                        tok.done(result=r)
                elif kind == "sync":
                    self.syncs += 1
                    state(f)[2].append(tok)
                elif kind == "fbarrier":
                    state(f)[3].append(tok)
                else:  # barrier
                    global_bars.append(tok)
            for f, appended, sync_toks, fbar_toks in per_file.values():
                err = self._pending_err.pop(id(f), None)
                if sync_toks and err is None:
                    r = self._exec("sync", f.sync, 0)
                    if type(r) is tuple and r and r[0] is _AIO_ERR:
                        err = r[1]
                    else:
                        self.fsyncs += 1
                        if len(sync_toks) > 1:
                            merged = len(sync_toks) - 1
                            self.fsyncs_coalesced += merged
                            if self.coalesce_cb is not None:
                                with _errors.guard(
                                        listener=self.coalesce_cb):
                                    self.coalesce_cb(merged)
                elif appended and err is None:
                    # No fsync requested: hand the bytes to the OS so a
                    # process crash behaves like the inline write path.
                    r = self._exec("flush", f.flush, 0)
                    if type(r) is tuple and r and r[0] is _AIO_ERR:
                        err = r[1]
                waiters = sync_toks + fbar_toks
                for tok in waiters:
                    tok.done(err)
                if err is not None and not waiters:
                    # Nobody to tell yet: park for the file's next barrier.
                    self._pending_err[id(f)] = err
            for tok in global_bars:
                tok.done()


_AIO_ERR = object()  # sentinel tag for _exec error returns


class AsyncWritableFile:
    """Write-behind writable file: append() submits to an AsyncIORing and
    returns immediately; sync() is a blocking coalesced-fsync barrier;
    sync_async() / append_barrier() return AioTokens so a group-commit
    leader can overlap WAL durability with its memtable phase and wait
    outside the commit critical section (db.py _group_wal_durability)."""

    def __init__(self, base, ring: AsyncIORing):
        self._base = base
        self._ring = ring
        self._size = base.file_size()

    def append(self, data) -> None:
        self._size += len(data)
        self._ring.submit_append(self._base, data)

    def flush(self) -> None:
        pass  # the ring flushes after each drained append run

    def sync(self) -> None:
        self.sync_async().wait()

    def sync_async(self) -> AioToken:
        return self._ring.submit_sync(self._base)

    def append_barrier(self) -> AioToken:
        return self._ring.submit_barrier(self._base)

    def close(self) -> None:
        self.append_barrier().wait()  # surface parked errors before close
        self._base.close()

    def file_size(self) -> int:
        return self._size


class _PosixWritable:
    def __init__(self, path: str, reuse: bool = False):
        try:
            # reuse: overwrite in place from offset 0 without truncating
            # (the recycled file's preallocated blocks are rewritten).
            self._f = open(path, "r+b" if reuse else "wb")
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

    def get_free_space(self, path: str) -> int:
        """Free bytes on the filesystem holding `path`; a path that does
        not exist yet walks up to its closest existing parent."""
        p = path
        while p and not os.path.exists(p):
            parent = os.path.dirname(p)
            if parent == p:
                break
            p = parent
        try:
            st = os.statvfs(p or "/")
        except OSError as e:
            raise IOError_(f"statvfs {path}: {e}") from e
        return st.f_bavail * st.f_frsize

    def reuse_writable_file(self, old_path: str,
                            new_path: str) -> _PosixWritable:
        """Rename old_path to new_path and open it for OVERWRITE from
        offset 0 WITHOUT truncating (WAL recycling, RocksDB's
        Env::ReuseWritableFile: the already-allocated blocks are rewritten
        in place; the recyclable log format makes the stale tail safe)."""
        os.replace(old_path, new_path)
        return _PosixWritable(new_path, reuse=True)

    def get_file_mtime(self, path: str) -> float:
        """Last-modification time (RocksDB's
        Env::GetFileModificationTime)."""
        try:
            return os.path.getmtime(path)
        except FileNotFoundError as e:
            raise NotFound(path) from e

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


# ---------------------------------------------------------------------------
# In-memory (RocksDB's env/mock_env.cc role)
# ---------------------------------------------------------------------------


class _MemFileState:
    __slots__ = ("data", "synced_len", "mtime")

    def __init__(self):
        import time

        self.data = bytearray()
        self.synced_len = 0
        self.mtime = time.time()


class _MemWritable:
    def __init__(self, st: _MemFileState):
        self._st = st

    def append(self, data) -> None:
        self._st.data += data

    def flush(self) -> None:
        pass

    def sync(self) -> None:
        self._st.synced_len = len(self._st.data)

    def close(self) -> None:
        pass

    def file_size(self) -> int:
        return len(self._st.data)


class _MemRandomAccess:
    def __init__(self, st: _MemFileState):
        self._st = st

    def read(self, offset: int, n: int) -> bytes:
        return bytes(self._st.data[offset: offset + n])

    def size(self) -> int:
        return len(self._st.data)

    def close(self) -> None:
        pass


class _MemSequential:
    def __init__(self, st: _MemFileState):
        import io

        self._buf = io.BytesIO(bytes(st.data))

    def read(self, n: int) -> bytes:
        return self._buf.read(n)

    def close(self) -> None:
        pass


class MemEnv:
    """In-memory env. `set_capacity` simulates a filesystem of that size:
    get_free_space is the capacity less the bytes stored (unlimited, 2^62,
    until a capacity is set)."""

    def __init__(self):
        self._files: dict[str, _MemFileState] = {}
        self._dirs: set[str] = {"/"}
        self._lock = ccy.Lock("env.MemEnv._lock")
        self._capacity = 0  # 0 = unlimited

    @staticmethod
    def _norm(path: str) -> str:
        return os.path.normpath(path)

    def _state(self, path: str) -> _MemFileState:
        st = self._files.get(self._norm(path))
        if st is None:
            raise NotFound(path)
        return st

    def new_writable_file(self, path: str) -> _MemWritable:
        with self._lock:
            st = _MemFileState()
            self._files[self._norm(path)] = st
            return _MemWritable(st)

    def get_file_mtime(self, path: str) -> float:
        with self._lock:
            return self._state(path).mtime

    def new_random_access_file(self, path: str) -> _MemRandomAccess:
        with self._lock:
            return _MemRandomAccess(self._state(path))

    def new_sequential_file(self, path: str) -> _MemSequential:
        with self._lock:
            return _MemSequential(self._state(path))

    def file_exists(self, path: str) -> bool:
        p = self._norm(path)
        return p in self._files or p in self._dirs

    def get_file_size(self, path: str) -> int:
        return len(self._state(path).data)

    def delete_file(self, path: str) -> None:
        with self._lock:
            if self._files.pop(self._norm(path), None) is None:
                raise NotFound(path)

    def rename_file(self, src: str, dst: str) -> None:
        with self._lock:
            st = self._files.pop(self._norm(src), None)
            if st is None:
                raise NotFound(src)
            self._files[self._norm(dst)] = st

    def create_dir(self, path: str) -> None:
        self._dirs.add(self._norm(path))

    def get_children(self, path: str) -> list[str]:
        p = self._norm(path)
        return sorted({os.path.basename(f)
                       for f in self._files.keys() | self._dirs
                       if f != p and os.path.dirname(f) == p})

    def read_file(self, path: str) -> bytes:
        with self._lock:
            return bytes(self._state(path).data)

    def write_file(self, path: str, data: bytes, sync: bool = False) -> None:
        f = self.new_writable_file(path)
        f.append(data)
        if sync:
            f.sync()

    def set_capacity(self, nbytes: int) -> None:
        """Simulated filesystem size; get_free_space = capacity - stored."""
        with self._lock:
            self._capacity = int(nbytes)

    def get_free_space(self, path: str) -> int:
        with self._lock:
            if self._capacity <= 0:
                return 1 << 62
            used = sum(len(st.data) for st in self._files.values())
            return max(0, self._capacity - used)


def default_env() -> PosixEnv:
    return PosixEnv()
