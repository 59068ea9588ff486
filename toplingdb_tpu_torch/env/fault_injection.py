"""Fault injection (copied from toplingdb_tpu/env/fault_injection.py):
FaultInjectionEnv wraps any Env (the role of RocksDB's
utilities/fault_injection_fs.h FaultInjectionTestFS). It counts every file
operation (`io_counts`), fails chosen operation kinds (`fail_ops`) or every
operation after the Nth (`fail_after_ops`), and simulates a crash:
`drop_unsynced_and_deactivate` fails all further IO, and
`reactivate_and_truncate` brings the filesystem back with every file it
opened for writing cut to its last synced length. Its `corrupt_reads`
damages the bytes its random-access and sequential reads return, while
the files on disk stay intact, and its `set_disk_budget` caps the bytes
writable to matching files: past the budget a write lands its affordable
prefix (a torn short write) and raises a genuine OSError(ENOSPC);
DelayedReadEnv sleeps before every random-access read;
WalWriterFaultInjector fails or delays the async WAL writer's ring ops,
ReadFaultInjector the async read plane's reader-ring tasks;
ShipFaultInjector drops, delays or truncates the replication plane's
shipped frames, PartitionGate cuts an HTTP client off, and
StoreFaultInjector drops, delays, corrupts or truncates a shared SST
store's data verbs. Every injector is seeded."""

from __future__ import annotations


from toplingdb_tpu_torch.utils.status import IOError_
from toplingdb_tpu_torch.utils import concurrency as ccy


class FaultInjectionEnv:
    def __init__(self, base):
        self.base = base
        self._mu = ccy.Lock("fault_injection.FaultInjectionEnv._mu")
        self._unsynced: dict[str, int] = {}   # path -> synced length
        self.fail_after_ops: int | None = None
        self.fail_ops: set[str] = set()       # e.g. {"append", "sync", "read"}
        self.op_count = 0
        self.io_counts: dict[str, int] = {}
        self._filesystem_active = True
        self._corrupt_rules: list[dict] = []
        self._corrupt_tick = 0  # transient-mode read counter
        self.corruptions_injected: list[tuple[str, int, int]] = []
        # Disk-full injection (set_disk_budget): fnmatch pattern ->
        # remaining writable bytes. Appends charge the first matching
        # budget; exhaustion writes the affordable PREFIX (a torn short
        # write, as a real disk does) then raises OSError(ENOSPC).
        # delete_file refunds the deleted size, so trash deletion
        # genuinely restores headroom.
        self._disk_budgets: dict[str, int] = {}
        self.enospc_injected = 0

    def __getattr__(self, name):
        return getattr(self.base, name)

    # -- read-side corruption injection (`corrupt_read` kind) ----------

    def corrupt_reads(self, pattern: str = "*", rate: float = 1e-5,
                      seed: int = 0,
                      kinds: tuple = ("bitflip", "byteswap"),
                      transient: bool = False) -> None:
        """Inject seeded read-side corruption: every read whose file's
        BASENAME matches `pattern` (fnmatch; e.g. '*.sst', '000012.*')
        has each returned byte independently damaged with probability
        `rate`. Deterministic in (seed, basename, offset, length) — the
        same read corrupts the same way every time, so integrity soaks
        reproduce from a seed without hand-editing files. `kinds`:
        'bitflip' XORs one random bit, 'byteswap' swaps adjacent bytes.
        `transient=True` additionally mixes a running read counter into
        the seed (still seeded, but a RETRY of the same read draws fresh
        randomness — models transient bus/DMA flips, so detect-and-retry
        paths like compaction can eventually make progress)."""
        with self._mu:
            self._corrupt_rules.append({
                "pattern": pattern, "rate": float(rate), "seed": int(seed),
                "kinds": tuple(kinds), "transient": bool(transient),
            })

    def clear_corrupt_reads(self) -> None:
        with self._mu:
            self._corrupt_rules = []

    def _maybe_corrupt(self, path: str, offset: int, data: bytes) -> bytes:
        if not self._corrupt_rules or not data:
            return data
        import fnmatch
        import hashlib
        import math
        import random

        name = path.rsplit("/", 1)[-1]
        out = None
        for rule in self._corrupt_rules:
            if not fnmatch.fnmatch(name, rule["pattern"]):
                continue
            rate = rule["rate"]
            if rate <= 0:
                continue
            # Stable digest seed (not hash(): per-process salt would break
            # cross-process reproducibility of a corruption scenario).
            tick = ""
            if rule.get("transient"):
                with self._mu:
                    self._corrupt_tick += 1
                    tick = f"|{self._corrupt_tick}"
            material = (f"{rule['seed']}|{name}|{offset}|{len(data)}{tick}"
                        .encode())
            rng = random.Random(int.from_bytes(
                hashlib.blake2s(material, digest_size=8).digest(),
                "little"))
            buf = bytearray(data if out is None else out)
            n_hit = 0
            # Geometric gap sampling: O(corrupted bytes), not O(length).
            log1m = math.log1p(-rate) if rate < 1.0 else None
            pos = 0
            while True:
                if log1m is None:
                    gap = 0
                else:
                    gap = int(math.log(max(rng.random(), 1e-300)) / log1m)
                pos += gap
                if pos >= len(buf):
                    break
                kind = rule["kinds"][rng.randrange(len(rule["kinds"]))] \
                    if rule["kinds"] else "bitflip"
                if kind == "byteswap" and pos + 1 < len(buf):
                    buf[pos], buf[pos + 1] = buf[pos + 1], buf[pos]
                else:
                    buf[pos] ^= 1 << rng.randrange(8)
                n_hit += 1
                pos += 1
                if log1m is None:
                    break
            if n_hit:
                out = bytes(buf)
                with self._mu:
                    self.corruptions_injected.append((name, offset, n_hit))
        return data if out is None else out

    # -- disk-full injection (`set_disk_budget` kind) ------------------

    def set_disk_budget(self, pattern: str, budget_bytes: int) -> None:
        """Cap the bytes writable to files matching `pattern` (fnmatch
        against the full path OR the basename: '*' for a whole-disk
        budget, '*.sst' to starve only table writes). Writing past the
        budget injects a torn short write + OSError(ENOSPC); deleting a
        matching file refunds its size. get_free_space() reports the
        remaining budget, so the SstFileManager's poller sees the same
        full disk the writers hit."""
        with self._mu:
            self._disk_budgets[pattern] = int(budget_bytes)

    def add_disk_budget(self, pattern: str, delta: int) -> None:
        """Grow (or shrink) an existing budget: 'the operator freed
        space'."""
        with self._mu:
            if pattern in self._disk_budgets:
                self._disk_budgets[pattern] += int(delta)

    def clear_disk_budgets(self) -> None:
        with self._mu:
            self._disk_budgets.clear()

    def disk_budget_remaining(self, pattern: str = "*") -> int | None:
        with self._mu:
            return self._disk_budgets.get(pattern)

    @staticmethod
    def _disk_match(path: str, pattern: str) -> bool:
        import fnmatch

        return (fnmatch.fnmatch(path, pattern)
                or fnmatch.fnmatch(path.rsplit("/", 1)[-1], pattern))

    def _charge_disk(self, path: str, nbytes: int) -> int:
        """Charge `nbytes` against the first matching budget; returns the
        affordable byte count (nbytes when no budget matches)."""
        if nbytes <= 0:
            return nbytes
        with self._mu:
            for pat, rem in self._disk_budgets.items():
                if self._disk_match(path, pat):
                    afford = max(0, min(nbytes, rem))
                    self._disk_budgets[pat] = rem - afford
                    if afford < nbytes:
                        self.enospc_injected += 1
                    return afford
        return nbytes

    def _refund_disk(self, path: str, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._mu:
            for pat in self._disk_budgets:
                if self._disk_match(path, pat):
                    self._disk_budgets[pat] += nbytes
                    return

    def _disk_exhausted(self, path: str) -> bool:
        with self._mu:
            for pat, rem in self._disk_budgets.items():
                if self._disk_match(path, pat):
                    return rem <= 0
        return False

    def _op(self, kind: str) -> None:
        with self._mu:
            self.op_count += 1
            self.io_counts[kind] = self.io_counts.get(kind, 0) + 1
            if not self._filesystem_active:
                raise IOError_(f"injected: filesystem inactive ({kind})")
            if kind in self.fail_ops:
                raise IOError_(f"injected {kind} error")
            if (self.fail_after_ops is not None
                    and self.op_count > self.fail_after_ops):
                raise IOError_(
                    f"injected error after {self.fail_after_ops} ops")

    def drop_unsynced_and_deactivate(self) -> None:
        """Simulate a crash: all further IO fails until
        reactivate_and_truncate(); unsynced data of the tracked writables
        is lost there."""
        with self._mu:
            self._filesystem_active = False

    def reactivate_and_truncate(self) -> None:
        """Come back from the crash: every file opened for writing is cut
        to its synced length."""
        with self._mu:
            self._filesystem_active = True
            for path, synced in self._unsynced.items():
                try:
                    with open(path, "rb+") as f:
                        f.truncate(synced)
                except OSError:
                    pass
            self._unsynced.clear()

    # -- Env interface --------------------------------------------------

    def new_writable_file(self, path: str):
        self._op("open_w")
        f = _FIWritable(self, path, self.base.new_writable_file(path))
        with self._mu:
            self._unsynced[path] = 0
        return f

    def reuse_writable_file(self, old_path: str, new_path: str):
        self._op("rename")
        self._op("open_w")
        f = _FIWritable(self, new_path,
                        self.base.reuse_writable_file(old_path, new_path))
        with self._mu:
            self._unsynced.pop(old_path, None)
            self._unsynced[new_path] = 0
        return f

    def write_file(self, path: str, data: bytes, sync: bool = False) -> None:
        f = self.new_writable_file(path)
        try:
            f.append(data)
            if sync:
                f.sync()
        finally:
            f.close()

    def delete_file(self, path: str) -> None:
        self._op("delete")
        freed = 0
        if self._disk_budgets:
            try:
                freed = self.base.get_file_size(path)
            except Exception as e:  # noqa: BLE001 - the delete decides
                from toplingdb_tpu_torch.utils import errors as _errors

                _errors.swallow(reason="fi-delete-size-probe", exc=e)
        self.base.delete_file(path)
        self._refund_disk(path, freed)

    def rename_file(self, src: str, dst: str) -> None:
        self._op("rename")
        self.base.rename_file(src, dst)

    def get_free_space(self, path: str) -> int:
        free = self.base.get_free_space(path)
        with self._mu:
            for pat, rem in self._disk_budgets.items():
                if self._disk_match(path, pat):
                    return min(free, max(0, rem))
        return free

    def new_random_access_file(self, path: str):
        self._op("open_r")
        return _FIRandom(self, self.base.new_random_access_file(path), path)

    def new_sequential_file(self, path: str):
        self._op("open_s")
        return _FISequential(self, self.base.new_sequential_file(path), path)

    def read_file(self, path: str) -> bytes:
        f = self.new_random_access_file(path)
        try:
            return f.read(0, f.size())
        finally:
            f.close()


class _FIWritable:
    def __init__(self, env: FaultInjectionEnv, path: str, base):
        self._env = env
        self._path = path
        self._base = base

    def _enospc(self):
        import errno
        import os

        return OSError(errno.ENOSPC, os.strerror(errno.ENOSPC), self._path)

    def append(self, data) -> None:
        self._env._op("append")
        afford = self._env._charge_disk(self._path, len(data))
        if afford < len(data):
            if afford > 0:
                # Torn short write: a real disk persists the prefix that
                # fit before failing the call.
                self._base.append(bytes(data[:afford]))
            raise self._enospc()
        self._base.append(data)

    def flush(self) -> None:
        self._base.flush()

    def sync(self) -> None:
        self._env._op("sync")
        if self._env._disk_exhausted(self._path):
            # fsync on a full filesystem fails too (dirty pages cannot
            # land); it succeeds again once something refunds the budget.
            raise self._enospc()
        self._base.sync()
        with self._env._mu:
            self._env._unsynced[self._path] = self._base.file_size()

    def close(self) -> None:
        self._base.close()

    def file_size(self) -> int:
        return self._base.file_size()


class _FIRandom:
    def __init__(self, env, base, path: str = ""):
        self._env = env
        self._base = base
        self._path = path

    def read(self, offset, n):
        self._env._op("read")
        data = self._base.read(offset, n)
        return self._env._maybe_corrupt(self._path, offset, data)

    def size(self):
        return self._base.size()

    def close(self):
        self._base.close()


class _FISequential:
    def __init__(self, env, base, path: str = ""):
        self._env = env
        self._base = base
        self._path = path
        self._off = 0  # running offset: deterministic corruption keying

    def read(self, n):
        self._env._op("read")
        data = self._base.read(n)
        off = self._off
        self._off += len(data)
        return self._env._maybe_corrupt(self._path, off, data)

    def close(self):
        self._base.close()


class DelayedReadEnv:
    """Env wrapper whose random-access reads sleep `delay_sec` first.

    Models device read latency on a page-cache-warm box, where real
    preads return in microseconds and I/O overlap is unmeasurable: the
    cold-cache twins run the async read plane (env/async_reads.py) on
    and off on this env, so the ratio isolates ring fan-out and
    coalescing. Wrapped file handles also make the native get / multiget
    chains ineligible (no raw fd), which keeps the two twins on the same
    Python walk — the comparison never mixes native-vs-Python with
    sync-vs-async.
    """

    def __init__(self, base, delay_sec: float = 0.0002):
        self.base = base
        self.delay_sec = delay_sec
        self.delayed_reads = 0  # benign race: diagnostic counter only

    def new_random_access_file(self, path: str):
        return _DelayedRandom(self, self.base.new_random_access_file(path))

    def __getattr__(self, name):
        return getattr(self.base, name)


class _DelayedRandom:
    def __init__(self, env: DelayedReadEnv, base):
        self._env = env
        self._base = base

    def read(self, offset, n):
        import time as _t

        _t.sleep(self._env.delay_sec)
        self._env.delayed_reads += 1
        return self._base.read(offset, n)

    def size(self):
        return self._base.size()

    def close(self):
        self._base.close()


class WalWriterFaultInjector:
    """Seeded fault points for the async WAL writer's submit ring
    (env/env.py AsyncIORing.fault_hook; a DB picks it up from its Env's
    `wal_writer_fault` attribute): each executed ring entry draws a plan
    decided by (seed, op ordinal), so a chaos soak reproduces the exact
    same WAL-writer-thread failures from a seed.

      "fail"   the entry raises IOError_ — the group whose durability
               barrier covers it receives the error (clean resume after)
      "delay"  the writer thread sleeps `delay_sec` first — widens the
               fsync-coalescing window and the publish/durability overlap

    `schedule` pins a plan to a specific executed-op ordinal (0-based);
    `rate` injects pseudo-randomly with plan weights `plans`. `ops`
    restricts injection to those ring op kinds (default: append + sync)."""

    def __init__(self, schedule: dict | None = None, rate: float = 0.0,
                 plans: tuple = ("fail", "delay"), seed: int = 0,
                 delay_sec: float = 0.005,
                 ops: tuple = ("append", "sync")):
        import random

        self.schedule = dict(schedule or {})
        self.rate = rate
        self.plans = tuple(plans)
        self.delay_sec = delay_sec
        self.ops = tuple(ops)
        self._rng = random.Random(seed)
        self._mu = ccy.Lock("fault_injection.WalWriterFaultInjector._mu")
        self._ordinal = 0
        self.injected: list[tuple[int, str, str]] = []  # (ordinal, kind, plan)

    def __call__(self, kind: str, nbytes: int) -> None:
        if kind not in self.ops:
            return
        with self._mu:
            ordinal = self._ordinal
            self._ordinal += 1
            p = self.schedule.get(ordinal)
            if p is None and self.rate > 0 and self.plans:
                if self._rng.random() < self.rate:
                    p = self.plans[self._rng.randrange(len(self.plans))]
            if p:
                self.injected.append((ordinal, kind, p))
        if p == "delay":
            import time as _t

            _t.sleep(self.delay_sec)
        elif p == "fail":
            raise IOError_(
                f"injected WAL-writer {kind} failure at op {ordinal}")

    def injected_counts(self) -> dict:
        with self._mu:
            out: dict[str, int] = {}
            for _o, _k, p in self.injected:
                out[p] = out.get(p, 0) + 1
            return out


class ReadFaultInjector:
    """Seeded fault points for the async read plane's reader rings
    (env/async_reads.py AsyncReadBatcher, plugged in as each ring's
    `fault_hook`): every executed ring entry draws a plan decided by
    (seed, executed-op ordinal), so a read-path chaos soak reproduces
    the exact same ring-thread failures from a seed.

      "fail"   the ring task raises IOError_ — the waiter of THAT block's
               token receives it (error propagation), the ring itself is
               not poisoned, and the next batch runs clean (resume)
      "delay"  the ring thread sleeps `delay_sec` first — models device
               read latency, which is also what the cold-cache bench uses
               to make I/O overlap measurable on a page-cache-warm box

    `schedule` pins a plan to a specific executed-op ordinal (0-based);
    `rate` injects pseudo-randomly with plan weights `plans`. `ops`
    defaults to ("task",) — block reads ride the ring as task entries."""

    def __init__(self, schedule: dict | None = None, rate: float = 0.0,
                 plans: tuple = ("fail", "delay"), seed: int = 0,
                 delay_sec: float = 0.0002, ops: tuple = ("task",)):
        import random

        self.schedule = dict(schedule or {})
        self.rate = rate
        self.plans = tuple(plans)
        self.delay_sec = delay_sec
        self.ops = tuple(ops)
        self._rng = random.Random(seed)
        self._mu = ccy.Lock("fault_injection.ReadFaultInjector._mu")
        self._ordinal = 0
        self.injected: list[tuple[int, str, str]] = []  # (ordinal, kind, plan)

    def __call__(self, kind: str, nbytes: int) -> None:
        if kind not in self.ops:
            return
        with self._mu:
            ordinal = self._ordinal
            self._ordinal += 1
            p = self.schedule.get(ordinal)
            if p is None and self.rate > 0 and self.plans:
                if self._rng.random() < self.rate:
                    p = self.plans[self._rng.randrange(len(self.plans))]
            if p:
                self.injected.append((ordinal, kind, p))
        if p == "delay":
            import time as _t

            _t.sleep(self.delay_sec)
        elif p == "fail":
            raise IOError_(
                f"injected reader-ring {kind} failure at op {ordinal}")

    def injected_counts(self) -> dict:
        with self._mu:
            out: dict[str, int] = {}
            for _o, _k, p in self.injected:
                out[p] = out.get(p, 0) + 1
            return out


class ShipFaultInjector:
    """Deterministic fault points for the replication ship transport
    (replication/log_shipper.py FaultyTransport), mirroring
    DcompactFaultInjector's shape so replication chaos soaks are
    reproducible from a seed. Plans, decided per pull ordinal:

      "drop"      the pulled frames never arrive (follower sees no progress)
      "delay"     the frames arrive after `delay_sec`
      "truncate"  a frame's encoded bytes are cut mid-payload (the follower
                  must detect the bad CRC/short frame and re-pull, never
                  apply a half batch)

    `rate` injects pseudo-randomly from `seed` with plan weights `plans`;
    `schedule` pins a plan to a specific pull ordinal (0-based)."""

    def __init__(self, schedule: dict | None = None, rate: float = 0.0,
                 plans: tuple = ("drop", "delay", "truncate"),
                 seed: int = 0, delay_sec: float = 0.01):
        import random

        self.schedule = dict(schedule or {})
        self.rate = rate
        self.plans = tuple(plans)
        self.delay_sec = delay_sec
        self._rng = random.Random(seed)
        self._mu = ccy.Lock("fault_injection.ShipFaultInjector._mu")
        self._ordinal = 0
        self.injected: list[tuple[int, str]] = []  # (ordinal, plan)

    def plan(self) -> str | None:
        with self._mu:
            ordinal = self._ordinal
            self._ordinal += 1
            p = self.schedule.get(ordinal)
            if p is None and self.rate > 0 and self.plans:
                if self._rng.random() < self.rate:
                    p = self.plans[self._rng.randrange(len(self.plans))]
            if p:
                self.injected.append((ordinal, p))
            return p

    def injected_counts(self) -> dict:
        with self._mu:
            out: dict[str, int] = {}
            for _o, p in self.injected:
                out[p] = out.get(p, 0) + 1
            return out

    def truncate_bytes(self, data: bytes) -> bytes:
        """Cut an encoded frame roughly in half — past the header when
        possible, so the follower exercises the CRC check rather than the
        short-header check every time."""
        if len(data) <= 2:
            return data[:1]
        return data[: max(1, len(data) // 2)]


class PartitionGate:
    """Network-partition switch for HTTP clients (fleet chaos soak): an
    engaged gate makes every guarded call fail fast with IOError_, as a
    dropped route would — the caller sees unreachability, not hangs.
    Thread-safe; `blocked` counts the calls the partition ate."""

    def __init__(self):
        self._mu = ccy.Lock("fault_injection.PartitionGate._mu")
        self._engaged = False
        self.blocked = 0

    def engage(self) -> None:
        with self._mu:
            self._engaged = True

    def heal(self) -> None:
        with self._mu:
            self._engaged = False

    @property
    def engaged(self) -> bool:
        with self._mu:
            return self._engaged

    def check(self, what: str = "call") -> None:
        """Raise IOError_ if the partition is engaged."""
        with self._mu:
            if self._engaged:
                self.blocked += 1
                raise IOError_(f"partitioned: {what}")


class StoreFaultInjector:
    """Seeded fault wrapper for a shared SST object store
    (storage/object_store.py LocalObjectStore or storage/store_server.py
    StoreClient): interposes on the data-plane verbs so storage chaos
    soaks reproduce exactly from a seed. Plans, decided per data op
    ordinal (fetch/put/publish_file):

      "drop"      the op raises IOError_ (an unreachable/refusing store)
      "delay"     the op completes after `delay_sec`
      "corrupt"   a fetch returns payload bytes with one flipped bit —
                  the cache tier's address verification must catch it and
                  re-fetch; a corrupt object must NEVER materialize
      "truncate"  a fetch returns a prefix of the payload (same contract)

    Writes only ever see "drop"/"delay": the store itself verifies
    payloads before making them visible, so a corrupted upload is the
    uploader's bug, not a transport fault. Control verbs (contains, pins,
    list, delete, status) pass through untouched."""

    def __init__(self, store, schedule: dict | None = None,
                 rate: float = 0.0,
                 plans: tuple = ("drop", "delay", "corrupt", "truncate"),
                 seed: int = 0, delay_sec: float = 0.002):
        import random

        self._store = store
        self.schedule = dict(schedule or {})
        self.rate = rate
        self.plans = tuple(plans)
        self.delay_sec = delay_sec
        self._rng = random.Random(seed)
        self._mu = ccy.Lock("fault_injection.StoreFaultInjector._mu")
        self._ordinal = 0
        self.injected: list[tuple[int, str, str]] = []  # (ordinal, op, plan)

    def _plan(self, op: str) -> str | None:
        with self._mu:
            ordinal = self._ordinal
            self._ordinal += 1
            p = self.schedule.get(ordinal)
            if p is None and self.rate > 0 and self.plans:
                if self._rng.random() < self.rate:
                    p = self.plans[self._rng.randrange(len(self.plans))]
            if p and op != "fetch" and p in ("corrupt", "truncate"):
                p = "drop"  # writes can't lie (the store verifies): drop
            if p:
                self.injected.append((ordinal, op, p))
            return p

    def _apply(self, op: str):
        p = self._plan(op)
        if p == "delay":
            import time as _t

            _t.sleep(self.delay_sec)
        elif p == "drop":
            raise IOError_(f"injected: store {op} dropped")
        return p

    # -- data-plane verbs (faulted) ------------------------------------

    def fetch(self, addr: str) -> bytes:
        p = self._apply("fetch")
        data = self._store.fetch(addr)
        if p == "corrupt" and data:
            i = self._rng.randrange(len(data))
            return data[:i] + bytes([data[i] ^ 0x40]) + data[i + 1:]
        if p == "truncate":
            return data[: len(data) // 2]
        return data

    def put(self, addr: str, payload: bytes) -> bool:
        self._apply("put")
        return self._store.put(addr, payload)

    def publish_file(self, src_path: str, addr: str, src_env=None) -> bool:
        self._apply("publish")
        return self._store.publish_file(src_path, addr, src_env=src_env)

    # -- control verbs (clean) -----------------------------------------

    def __getattr__(self, name):
        return getattr(self._store, name)

    def injected_counts(self) -> dict:
        with self._mu:
            out: dict[str, int] = {}
            for _o, _op, p in self.injected:
                out[p] = out.get(p, 0) + 1
            return out
