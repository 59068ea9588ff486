"""WriteBufferManager and SstFileManager (copied from
toplingdb_tpu/utils/rate_limiter.py, trimmed to these two; the rate
limiter and write controller are not in the port): the roles of RocksDB's
memtable/write_buffer_manager.cc and file/sst_file_manager_impl.cc with
file/delete_scheduler.cc."""

from __future__ import annotations

import os
import threading

from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils import statistics as _st
from toplingdb_tpu_torch.utils import concurrency as ccy


class WriteBufferManager:
    """Memtable memory budget shared by DB instances (RocksDB's
    write_buffer_manager.h:37): each DB charges its memtables' memory here
    (db.py _sync_wbm), and when the sum over all DBs reaches the budget,
    the next write of any of them flushes."""

    def __init__(self, buffer_size: int):
        self.buffer_size = buffer_size
        self._usage = 0
        self._mu = ccy.Lock("rate_limiter.WriteBufferManager._mu")

    def reserve(self, n: int) -> None:
        with self._mu:
            self._usage += n

    def free(self, n: int) -> None:
        with self._mu:
            self._usage = max(0, self._usage - n)

    def memory_usage(self) -> int:
        return self._usage

    def should_flush(self) -> bool:
        return self.buffer_size > 0 and self._usage >= self.buffer_size


PRESSURE_LEVELS = ("ok", "amber", "red")


class SstFileManager:
    """Tracks live SST + WAL + blob disk usage per DB root, paces trash
    deletion, and publishes a three-state disk-pressure level (RocksDB's
    include/rocksdb/sst_file_manager.h, file/delete_scheduler.cc, and
    sst_file_manager_impl's free-space poller + SetMaxAllowedSpaceUsage).

    The pressure basis is the tighter of two fractions: the remaining
    budget over `max_allowed_space_usage` (when a budget is set) and the
    env's real free space over (free + tracked). Escalation happens the
    moment the fraction crosses a threshold; de-escalation requires
    clearing the threshold by `pressure_hysteresis`, so a level never flaps
    on noise. Callbacks registered with add_pressure_callback fire OUTSIDE
    _mu. close() joins the poller and every trash deleter it started."""

    def __init__(self, bytes_per_sec_delete: int = 0,
                 max_trash_db_ratio: float = 0.25,
                 env=None, path: str | None = None,
                 max_allowed_space_usage: int = 0,
                 compaction_buffer_size: int = 0,
                 flush_headroom_bytes: int = 0,
                 free_space_poll_period_sec: float = 0.0,
                 amber_free_ratio: float = 0.10,
                 red_free_ratio: float = 0.05,
                 pressure_hysteresis: float = 0.02,
                 statistics=None):
        self.rate = bytes_per_sec_delete
        self.max_trash_db_ratio = max_trash_db_ratio
        self._env = env
        self._path = path
        self.max_allowed_space_usage = max_allowed_space_usage
        self.compaction_buffer_size = compaction_buffer_size
        self.flush_headroom_bytes = flush_headroom_bytes
        self.poll_period = free_space_poll_period_sec
        self.amber_free_ratio = amber_free_ratio
        self.red_free_ratio = red_free_ratio
        self.pressure_hysteresis = pressure_hysteresis
        self._stats = statistics
        self._tracked: dict[str, int] = {}
        self._trash: dict[str, int] = {}
        self._level = "ok"
        self._callbacks: list = []
        self._mu = ccy.Lock("rate_limiter.SstFileManager._mu")
        self._stop = threading.Event()
        self._wake = threading.Event()  # unpaces sleeping trash deleters
        self._delete_threads: list[threading.Thread] = []
        self._poller: threading.Thread | None = None

    # -- accounting ------------------------------------------------------

    def on_add_file(self, path: str, size: int | None = None) -> None:
        if size is None:
            size = self._probe_size(path)  # env IO stays outside _mu
        with self._mu:
            self._tracked[path] = size

    def on_file_size(self, path: str, size: int) -> None:
        """Update a tracked file's size (growing WALs and blobs)."""
        with self._mu:
            if path in self._tracked:
                self._tracked[path] = size

    def on_delete_file(self, path: str) -> None:
        with self._mu:
            self._tracked.pop(path, None)

    def _probe_size(self, path: str) -> int:
        try:
            if self._env is not None:
                return self._env.get_file_size(path)
            return os.path.getsize(path)
        except Exception as e:  # noqa: BLE001 - a vanished file counts 0
            _errors.swallow(reason="sfm-size-probe", exc=e)
            return 0

    def total_size(self) -> int:
        with self._mu:
            return sum(self._tracked.values())

    def trash_size(self) -> int:
        with self._mu:
            return sum(self._trash.values())

    def free_space(self) -> int:
        if self._env is not None and self._path is not None:
            return self._env.get_free_space(self._path)
        if self._path is not None:
            from toplingdb_tpu_torch.env import default_env

            return default_env().get_free_space(self._path)
        return 1 << 62

    def set_max_allowed_space_usage(self, nbytes: int) -> None:
        with self._mu:
            self.max_allowed_space_usage = int(nbytes)

    # -- pressure --------------------------------------------------------

    def _free_fraction(self, free: int) -> float:
        """Tighter of the budget-remaining and filesystem-free fractions.
        `free` is sampled by the caller BEFORE taking _mu (env IO never
        happens under the leaf lock)."""
        fracs = []
        used = sum(self._tracked.values())
        budget = self.max_allowed_space_usage
        if budget > 0:
            fracs.append(max(0.0, budget - used) / budget)
        if free < (1 << 61):
            basis = free + used
            if basis > 0:
                fracs.append(free / basis)
        return min(fracs) if fracs else 1.0

    def _level_for(self, frac: float, prev: str) -> str:
        h = self.pressure_hysteresis
        if frac <= self.red_free_ratio:
            return "red"
        if prev == "red" and frac <= self.red_free_ratio + h:
            return "red"
        if frac <= self.amber_free_ratio:
            return "amber"
        if prev in ("amber", "red") and frac <= self.amber_free_ratio + h:
            return "amber"
        return "ok"

    def pressure(self) -> str:
        with self._mu:
            return self._level

    def poll(self) -> str:
        """One pressure evaluation; fires callbacks on level transitions."""
        try:
            free = self.free_space()
        except Exception as e:  # noqa: BLE001 - a sick disk reads as roomy
            _errors.swallow(reason="sfm-free-space", exc=e)
            free = 1 << 62
        with self._mu:
            prev = self._level
            frac = self._free_fraction(free)
            level = self._level_for(frac, prev)
            self._level = level
            callbacks = list(self._callbacks) if level != prev else []
            info = {
                "level": level, "prev": prev, "free_fraction": frac,
                "tracked_bytes": sum(self._tracked.values()),
                "trash_bytes": sum(self._trash.values()),
                "budget_bytes": self.max_allowed_space_usage,
            }
        if self._stats is not None:
            self._stats.record_tick(_st.DISK_PRESSURE_POLLS, 1)
            if level != "ok":
                self._stats.record_tick(_st.DISK_PRESSURE_POLLS_BAD, 1)
            if level != prev:
                self._stats.record_tick(_st.DISK_PRESSURE_TRANSITIONS, 1)
        if level != prev:
            if level == "ok":
                self._wake.clear()  # back to paced trash deletion
            for cb in callbacks:
                cb(level, prev, info)
        return level

    def add_pressure_callback(self, fn) -> None:
        """fn(level, prev_level, info_dict), called outside manager locks."""
        with self._mu:
            self._callbacks.append(fn)

    def start_poller(self) -> None:
        if self.poll_period <= 0 or self._poller is not None:
            return

        def loop():
            while not self._stop.is_set():
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001
                    # A failing callback (or a statvfs error on a sick
                    # disk) must not kill the poller: pressure sensing is
                    # most needed exactly when IO is failing.
                    _errors.swallow(reason="disk-pressure-poll", exc=e)
                self._stop.wait(self.poll_period)

        self._poller = ccy.spawn("tpt-disk-pressure-poller", loop,
                                 owner=self)

    # -- preflight -------------------------------------------------------

    def check_flush(self, out_bytes: int) -> bool:
        """May a flush writing ~out_bytes start? Flushes and the WAL may
        consume the reserved headroom (ingest must always be able to
        drain), so they check against the FULL budget and raw free
        space."""
        with self._mu:
            budget = self.max_allowed_space_usage
            if budget > 0:
                used = sum(self._tracked.values())
                if used + out_bytes > budget:
                    return False
        try:
            free = self.free_space()
        except Exception as e:  # noqa: BLE001
            _errors.swallow(reason="sfm-free-space", exc=e)
            return True
        return free >= out_bytes

    def check_compaction(self, out_bytes: int) -> bool:
        """May a compaction writing ~out_bytes start? Compactions must
        leave the flush headroom AND the compaction buffer untouched."""
        reserve = self.flush_headroom_bytes + self.compaction_buffer_size
        with self._mu:
            budget = self.max_allowed_space_usage
            if budget > 0:
                used = sum(self._tracked.values())
                if used + out_bytes + reserve > budget:
                    return False
        try:
            free = self.free_space()
        except Exception as e:  # noqa: BLE001
            _errors.swallow(reason="sfm-free-space", exc=e)
            return True
        return free >= out_bytes + reserve

    def has_headroom(self) -> bool:
        """Recovery gate: is there space to resume background work? True
        once a fresh poll lands outside red AND the budget (if any) has at
        least the flush headroom available again."""
        level = self.poll()
        if level == "red":
            return False
        with self._mu:
            budget = self.max_allowed_space_usage
            if budget > 0:
                used = sum(self._tracked.values())
                if used + self.flush_headroom_bytes > budget:
                    return False
        return True

    # -- trash deletion --------------------------------------------------

    def accelerate_deletes(self) -> None:
        """Reclaim ladder rung 1: unpace every sleeping trash deleter."""
        self._wake.set()

    def _unpaced(self) -> bool:
        if self._wake.is_set():
            return True
        with self._mu:
            if self._level != "ok":
                return True
            total = sum(self._tracked.values())
            trash = sum(self._trash.values())
            return (self.max_trash_db_ratio > 0 and total > 0
                    and trash > self.max_trash_db_ratio * total)

    def schedule_delete(self, path: str) -> None:
        """Rate-limited deletion: rename to .trash, delete slowly. Pacing
        is skipped outright when trash already exceeds
        `max_trash_db_ratio` of the live tree or pressure is amber / red
        (RocksDB's DeleteScheduler ratio bypass)."""
        with self._mu:
            size = self._tracked.get(path)
        if size is None:
            size = self._probe_size(path)
        trash = path + ".trash"
        try:
            if self._env is not None:
                self._env.rename_file(path, trash)
            else:
                os.replace(path, trash)
        except Exception as e:  # noqa: BLE001 - the file is already gone
            _errors.swallow(reason="sfm-trash-rename", exc=e)
            return
        self.on_delete_file(path)
        with self._mu:
            self._trash[trash] = size

        def worker():
            if self.rate > 0 and size > 0 and not self._unpaced():
                # Interruptible pacing: close() and the reclaim ladder's
                # accelerate_deletes() must not block behind a sleeping
                # deleter.
                self._wake.wait(min(size / self.rate, 10.0))
            try:
                if self._env is not None:
                    self._env.delete_file(trash)
                else:
                    os.remove(trash)
            except Exception as e:  # noqa: BLE001
                _errors.swallow(reason="sfm-trash-delete", exc=e)
            with self._mu:
                self._trash.pop(trash, None)
            if self._stats is not None and size:
                self._stats.record_tick(_st.DISK_TRASH_BYTES_FREED, size)

        t = ccy.spawn("tpt-sst-trash-delete", worker, owner=self)
        with self._mu:
            self._delete_threads = [
                x for x in self._delete_threads if x.is_alive()]
            self._delete_threads.append(t)

    def wait_for_deletes(self, timeout: float = 15.0) -> None:
        """Join every in-flight trash deleter and the poller."""
        self._stop.set()
        self._wake.set()
        with self._mu:
            pending, self._delete_threads = self._delete_threads, []
            poller, self._poller = self._poller, None
        for t in pending:
            t.join(timeout)
        if poller is not None:
            poller.join(timeout)
        self._stop.clear()
        self._wake.clear()

    close = wait_for_deletes
