"""Job leases for dcompact jobs (copied from
toplingdb_tpu/compaction/resilience.py, trimmed to the lease files, the DB
side's `write_lease` and the worker's `HeartbeatWriter`; the retry loop,
circuit breakers and the orphan sweep come with the DB engine).

A job dir carries `lease.json` (written by the submitting side before the
worker starts) and `heartbeat` (touched by the worker every ~lease/3
seconds while it runs). A worker killed -9 stops heartbeating; the file's
mtime then ages past the lease and the job dir can be told from a live
one by any process, with no out-of-band state.
"""

from __future__ import annotations

import json
import os
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
