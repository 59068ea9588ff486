"""Failure policy around the compaction executor boundary, and job leases
for dcompact jobs (copied from toplingdb_tpu/compaction/resilience.py,
trimmed to `DcompactOptions`, the retry driver `execute_resilient` with
per-attempt retry and the job deadline, and the lease files: the DB side's `write_lease` and the worker's
`HeartbeatWriter`; circuit breakers, the local-pin gate, the orphan sweep
and their statistics and listener events come with the HTTP executor).

A job dir carries `lease.json` (written by the submitting side before the
worker starts) and `heartbeat` (touched by the worker every ~lease/3
seconds while it runs). A worker killed -9 stops heartbeating; the file's
mtime then ages past the lease and the job dir can be told from a live
one by any process, with no out-of-band state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time

HEARTBEAT_FILE = "heartbeat"
LEASE_FILE = "lease.json"


def write_lease(job_dir: str, job_id: int, attempt: int,
                lease_sec: float) -> None:
    """Submitting side: stamp the attempt dir with its lease terms before
    the worker starts."""
    try:
        with open(os.path.join(job_dir, LEASE_FILE), "w") as f:
            json.dump({"job_id": job_id, "attempt": attempt,
                       "pid": os.getpid(), "lease_sec": lease_sec,
                       "submitted_unix": time.time()}, f)
    except OSError:
        pass  # the lease is advisory; the job itself still runs


class HeartbeatWriter:
    """Worker side: touch `job_dir/heartbeat` every ~lease/3 seconds while
    the job runs, from a daemon thread."""

    def __init__(self, job_dir: str, lease_sec: float):
        self._path = os.path.join(job_dir, HEARTBEAT_FILE)
        self._interval = max(0.2, float(lease_sec) / 3.0)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        try:
            with open(self._path, "w") as f:
                f.write(f"{os.getpid()} {time.time():.3f}\n")
        except OSError:
            pass

    def start(self) -> "HeartbeatWriter":
        self.beat()
        self._thread = threading.Thread(
            target=self._loop, name="dcompact-heartbeat", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


@dataclasses.dataclass
class DcompactOptions:
    """Retry and deadline policy for executor-run compactions
    (Options.dcompact), trimmed to the fields the retry driver reads; the
    breaker, local-pin, transport-timeout and lease fields come with the
    HTTP and subprocess executors."""

    max_attempts: int = 3            # executor tries per job (>=1)
    backoff_base: float = 0.05       # seconds before attempt 2
    backoff_multiplier: float = 2.0  # exponential growth per retry
    backoff_jitter: float = 0.2      # +/- fraction of the computed delay
    job_deadline: float = 0.0        # wall-clock budget across attempts;
                                     # 0 = attempts bound the job alone

    def backoff_delay(self, retry_index: int, rng=None) -> float:
        """Delay before retry `retry_index` (1-based), with jitter."""
        d = self.backoff_base * (self.backoff_multiplier ** (retry_index - 1))
        j = self.backoff_jitter
        if j > 0:
            r = (rng or random).random()
            d *= 1.0 + j * (2.0 * r - 1.0)
        return max(0.0, d)


class DeadlineExceeded(Exception):
    """No attempt could start before the job deadline."""


def execute_resilient(db, factory, compaction, snapshots, alloc,
                      policy: DcompactOptions | None = None):
    """Run one compaction through `factory` with per-attempt retry
    (exponential backoff + jitter) and a per-job deadline. When every
    attempt failed, or the deadline passed before the next one, the last
    error is raised: the port never re-runs a device job on the CPU path
    (toplingdb_tpu's driver falls back to it when the factory allows)."""
    policy = policy or getattr(db.options, "dcompact", None) \
        or DcompactOptions()
    deadline = (time.monotonic() + policy.job_deadline
                if policy.job_deadline > 0 else None)
    last_error: BaseException | None = None
    for attempt in range(max(1, policy.max_attempts)):
        if deadline is not None and time.monotonic() >= deadline:
            raise last_error or DeadlineExceeded(
                "compaction job deadline exceeded before first attempt")
        if attempt > 0:
            delay = policy.backoff_delay(attempt)
            if deadline is not None:
                delay = min(delay, max(0.0, deadline - time.monotonic()))
            if delay > 0:
                time.sleep(delay)
        executor = factory.new_executor(compaction)
        try:
            return executor.execute(db, compaction, snapshots, alloc)
        except Exception as e:
            last_error = e
    raise last_error
