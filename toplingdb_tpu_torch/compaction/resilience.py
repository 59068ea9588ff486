"""Failure policy around the compaction executor boundary (copied from
toplingdb_tpu/compaction/resilience.py, without the local pin gate).

The dcompact design fans compaction jobs out to remote workers that can
crash, hang, or vanish (RocksDB's compaction_executor.h); this module is
the failure policy, factored around the CompactionExecutor seam so every
transport (device, subprocess, HTTP service) inherits it:

  DcompactOptions       retry/backoff/deadline/breaker/lease knobs, with a
                        to_config / from_config pair (the "dcompact" key
                        of a SidePlugin-style document).
  CircuitBreaker /      per-worker-URL health: consecutive failures open the
  WorkerHealthRegistry  breaker, a half-open probe re-admits recovered
                        workers, round-robin URL picks skip open circuits.
  execute_resilient     the retry driver the scheduler calls: per-attempt
                        retry with exponential backoff + jitter, a per-job
                        deadline, DCOMPACTION_* statistics, listener events
                        and event-log lines.
  write_lease /         lease.json and heartbeat files in the job dir; a
  HeartbeatWriter /     crashed worker's job is detected by lease expiry
  sweep_orphan_jobs     and its partial outputs swept on DB open.
  DcompactFaultInjector deterministic fault points for the subprocess/HTTP
                        transports (drop request, delay response, kill the
                        worker mid-job, truncate/corrupt results JSON).

Unlike toplingdb_tpu's driver, the port's never runs a job locally: when
every attempt failed, the deadline passed, or every worker's circuit is
open, the last error is raised and becomes the DB's background error. So
the local pin gate, `allow_fallback` and `min_input_bytes` are not
ported, and the DCOMPACTION_FALLBACK_* tickers keep their names and
stay 0.
"""

from __future__ import annotations

import dataclasses
import os
import random
import shutil
import threading
import time

from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils import statistics as stats_mod
from toplingdb_tpu_torch.utils.status import IOError_
from toplingdb_tpu_torch.utils import concurrency as ccy


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DcompactOptions:
    """Retry/health/lease policy for distributed compaction. Lives on
    Options.dcompact and serializes through utils.config (JSON key
    "dcompact"), so a SidePlugin-style document can tune the whole failure
    policy without code."""

    # -- per-attempt retry ------------------------------------------------
    max_attempts: int = 3            # remote tries per job (>=1)
    backoff_base: float = 0.05       # seconds before attempt 2
    backoff_multiplier: float = 2.0  # exponential growth per retry
    backoff_jitter: float = 0.2      # +/- fraction of the computed delay
    attempt_timeout: float = 3600.0  # per-attempt transport timeout (s)
    job_deadline: float = 0.0        # wall-clock budget across attempts;
                                     # 0 = attempts bound the job alone
    # -- worker health / circuit breaking ---------------------------------
    breaker_failure_threshold: int = 3   # consecutive failures -> OPEN
    breaker_reset_timeout: float = 30.0  # OPEN -> HALF_OPEN probe delay (s)
    # -- job leases -------------------------------------------------------
    lease_sec: float = 30.0          # heartbeat older than this = orphan

    def backoff_delay(self, retry_index: int, rng=None) -> float:
        """Delay before retry `retry_index` (1-based), with jitter."""
        d = self.backoff_base * (self.backoff_multiplier ** (retry_index - 1))
        j = self.backoff_jitter
        if j > 0:
            r = (rng or random).random()
            d *= 1.0 + j * (2.0 * r - 1.0)
        return max(0.0, d)

    def to_config(self) -> dict:
        base = DcompactOptions()
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) != getattr(base, f.name)
        }

    @staticmethod
    def from_config(d: dict) -> "DcompactOptions":
        return DcompactOptions(**d)


# ---------------------------------------------------------------------------
# Worker health: per-URL circuit breakers
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Classic three-state breaker for ONE worker URL. CLOSED admits all
    traffic; `failure_threshold` consecutive failures OPEN it; after
    `reset_timeout` the next allow() admits exactly one HALF_OPEN probe —
    success re-CLOSEs, failure re-OPENs (and restarts the timer)."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout: float = 30.0, clock=time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._mu = ccy.Lock("resilience.CircuitBreaker._mu")
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    def allow(self) -> bool:
        with self._mu:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout:
                    self.state = self.HALF_OPEN
                    self._probe_inflight = True
                    return True
                return False
            # HALF_OPEN: one probe at a time.
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def on_success(self) -> bool:
        """Returns True when this success CLOSEd a non-closed breaker."""
        with self._mu:
            self._probe_inflight = False
            self.consecutive_failures = 0
            if self.state != self.CLOSED:
                self.state = self.CLOSED
                return True
            return False

    def on_failure(self) -> bool:
        """Returns True when this failure OPENed a non-open breaker."""
        with self._mu:
            self._probe_inflight = False
            self.consecutive_failures += 1
            if self.state == self.HALF_OPEN or (
                    self.state == self.CLOSED
                    and self.consecutive_failures >= self.failure_threshold):
                self.state = self.OPEN
                self._opened_at = self._clock()
                return True
            return False


class WorkerHealthRegistry:
    """URL -> CircuitBreaker map + breaker-aware round-robin pick. Shared by
    every executor a factory makes, so health outlives individual jobs."""

    def __init__(self, policy: DcompactOptions | None = None,
                 clock=time.monotonic):
        self.policy = policy or DcompactOptions()
        self._clock = clock
        self._mu = ccy.Lock("resilience.WorkerHealthRegistry._mu")
        self._breakers: dict[str, CircuitBreaker] = {}
        self._rr = 0
        # Observers: callables (url, state, consecutive_failures) -> None,
        # fired on every state TRANSITION (open/close).
        self.observers: list = []
        self.skipped_open = 0  # picks that skipped >=1 open circuit

    def breaker(self, url: str) -> CircuitBreaker:
        with self._mu:
            b = self._breakers.get(url)
            if b is None:
                b = CircuitBreaker(self.policy.breaker_failure_threshold,
                                   self.policy.breaker_reset_timeout,
                                   self._clock)
                self._breakers[url] = b
            return b

    def _notify(self, url: str, b: CircuitBreaker) -> None:
        # observers must never take down job routing
        for obs in list(self.observers):
            with _errors.guard(listener=obs):
                obs(url, b.state, b.consecutive_failures)

    def pick(self, urls: list[str]) -> str | None:
        """Round-robin over `urls`, skipping URLs whose breaker refuses
        traffic. Returns None when every circuit is open (the caller then
        falls back to local WITHOUT paying a remote timeout)."""
        if not urls:
            return None
        with self._mu:
            start = self._rr
            self._rr += 1
        skipped = 0
        for i in range(len(urls)):
            url = urls[(start + i) % len(urls)]
            if self.breaker(url).allow():
                if skipped:
                    with self._mu:
                        self.skipped_open += skipped
                return url
            skipped += 1
        with self._mu:
            self.skipped_open += skipped
        return None

    def record_success(self, url: str) -> None:
        b = self.breaker(url)
        if b.on_success():
            self._notify(url, b)

    def record_failure(self, url: str) -> None:
        b = self.breaker(url)
        if b.on_failure():
            self._notify(url, b)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                url: {"state": b.state,
                      "consecutive_failures": b.consecutive_failures}
                for url, b in sorted(self._breakers.items())
            }


# ---------------------------------------------------------------------------
# Job leases + orphan sweeping
# ---------------------------------------------------------------------------

HEARTBEAT_FILE = "heartbeat"
LEASE_FILE = "lease.json"


def write_lease(job_dir: str, job_id: int, attempt: int,
                lease_sec: float) -> None:
    """DB side: stamp the attempt dir with its lease terms before the
    worker starts, so ANY process (including a later DB open) can decide
    orphan-ness without out-of-band state."""
    import json

    try:
        with open(os.path.join(job_dir, LEASE_FILE), "w") as f:
            json.dump({"job_id": job_id, "attempt": attempt,
                       "pid": os.getpid(), "lease_sec": lease_sec,
                       "submitted_unix": time.time()}, f)
    except OSError:
        pass  # lease is advisory; the job itself still runs


class HeartbeatWriter:
    """Worker side: touch `job_dir/heartbeat` every ~lease/3 seconds while
    the job runs. A worker killed -9 stops heartbeating; the file's mtime
    then ages past the lease and the job dir becomes sweepable."""

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
        self._thread = ccy.spawn("dcompact-heartbeat", self._loop,
                                 owner=self, stop=self.stop)
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def _lease_expired(att_dir: str, lease_sec: float, now: float) -> bool:
    """An attempt dir is orphaned when its freshest liveness signal
    (heartbeat, else lease, else the dir itself) is older than the lease."""
    newest = None
    for name in (HEARTBEAT_FILE, LEASE_FILE, "params.json"):
        try:
            m = os.path.getmtime(os.path.join(att_dir, name))
        except OSError:
            continue
        newest = m if newest is None else max(newest, m)
    if newest is None:
        try:
            newest = os.path.getmtime(att_dir)
        except OSError:
            return True  # vanished under us: nothing to keep
    return (now - newest) > lease_sec


def sweep_orphan_jobs(job_root: str, lease_sec: float,
                      statistics=None, event_logger=None,
                      now: float | None = None) -> list[str]:
    """Scan `job_root/job-*` for attempt dirs whose lease expired (a
    `kill -9`'d worker leaves params + partial outputs + a stale
    heartbeat) and delete them. Runs on DB open; the compaction whose job
    died never installed, so its inputs are still live in the version and
    the picker simply re-runs it — sweeping is all the re-queue needed.
    Returns the swept job dirs."""
    now = time.time() if now is None else now
    swept: list[str] = []
    try:
        jobs = sorted(os.listdir(job_root))
    except OSError:
        return swept
    for job in jobs:
        if not job.startswith("job-"):
            continue
        job_dir = os.path.join(job_root, job)
        if not os.path.isdir(job_dir):
            continue
        atts = [a for a in sorted(os.listdir(job_dir))
                if a.startswith("att-")]
        live = False
        for att in atts:
            att_dir = os.path.join(job_dir, att)
            if not _lease_expired(att_dir, lease_sec, now):
                live = True
                continue
            shutil.rmtree(att_dir, ignore_errors=True)
            swept.append(att_dir)
            if event_logger is not None:
                event_logger.log("dcompact_orphan_swept", job_dir=att_dir)
        if not live:
            # Every attempt gone (or none existed): remove the skeleton.
            try:
                if not os.listdir(job_dir):
                    os.rmdir(job_dir)
            except OSError:
                pass
    if swept and statistics is not None:
        statistics.record_tick(stats_mod.DCOMPACTION_ORPHANS_SWEPT,
                               len(swept))
    return swept


# ---------------------------------------------------------------------------
# Deterministic fault injection for the transports
# ---------------------------------------------------------------------------


class DcompactFaultInjector:
    """env/fault_injection.py-style fault points for the dcompact
    transports, decided deterministically per (job, attempt) so chaos tests
    are reproducible. Plans:

      "drop"      the request never reaches a worker (raised before spawn)
      "delay"     the response is delayed `delay_sec` before the spawn runs
      "kill"      the worker dies hard mid-job (subprocess transport: the
                  child os._exit()s after writing heartbeats + partial
                  output, exactly a kill -9)
      "truncate"  results.json is cut to half its bytes after the worker
                  returns (a crash between write and rename)
      "corrupt"   results.json is overwritten with non-JSON garbage

    `schedule` maps attempt ordinal (0-based, global across jobs) or
    (job_id, attempt) to a plan; `rate` injects pseudo-randomly from `seed`
    with plan weights `plans`."""

    def __init__(self, schedule: dict | None = None, rate: float = 0.0,
                 plans: tuple = ("drop", "kill", "truncate"),
                 seed: int = 0, delay_sec: float = 0.05):
        self.schedule = dict(schedule or {})
        self.rate = rate
        self.plans = tuple(plans)
        self.delay_sec = delay_sec
        self._rng = random.Random(seed)
        self._mu = ccy.Lock("resilience.DcompactFaultInjector._mu")
        self._ordinal = 0
        self.injected: list[tuple[int, int, str]] = []  # (job, attempt, plan)

    def plan(self, job_id: int, attempt: int) -> str | None:
        with self._mu:
            ordinal = self._ordinal
            self._ordinal += 1
            p = self.schedule.get((job_id, attempt),
                                  self.schedule.get(ordinal))
            if p is None and self.rate > 0 and self.plans:
                if self._rng.random() < self.rate:
                    p = self.plans[self._rng.randrange(len(self.plans))]
            if p:
                self.injected.append((job_id, attempt, p))
            return p

    def injected_counts(self) -> dict:
        with self._mu:
            out: dict[str, int] = {}
            for _j, _a, p in self.injected:
                out[p] = out.get(p, 0) + 1
            return out

    # -- transport hooks -------------------------------------------------

    def before_spawn(self, plan: str | None) -> None:
        if plan == "drop":
            raise IOError_("injected: dcompact request dropped")
        if plan == "delay":
            time.sleep(self.delay_sec)

    def after_spawn(self, plan: str | None, job_dir: str) -> None:
        if plan not in ("truncate", "corrupt"):
            return
        rpath = os.path.join(job_dir, "results.json")
        try:
            if plan == "truncate":
                size = os.path.getsize(rpath)
                with open(rpath, "rb+") as f:
                    f.truncate(max(1, size // 2))
            else:
                with open(rpath, "wb") as f:
                    f.write(b"\x00garbage{{{not-json")
        except OSError:
            pass  # worker already failed: nothing to mangle


# ---------------------------------------------------------------------------
# The retry driver
# ---------------------------------------------------------------------------


class DeadlineExceeded(IOError_):
    """No attempt could start before the job deadline."""


class AllCircuitsOpen(IOError_):
    """Every dcompact worker's circuit is open."""


def _notify_attempt(db, info) -> None:
    from toplingdb_tpu_torch.utils.listener import notify

    notify(db.options.listeners, "on_dcompact_attempt", db, info)


def _wire_health_observer(db, factory, health, tick, logger) -> None:
    """Breaker transitions -> tickers, event-log lines and listener events.
    Wired once per factory; a factory shared across DBs reports to the
    first."""
    if getattr(factory, "_health_obs_wired", False):
        return
    factory._health_obs_wired = True

    def _on_transition(url, state, consecutive_failures):
        from toplingdb_tpu_torch.utils.listener import WorkerHealthInfo, notify

        tick(stats_mod.DCOMPACTION_BREAKER_OPEN
             if state == CircuitBreaker.OPEN
             else stats_mod.DCOMPACTION_BREAKER_CLOSE)
        if logger is not None:
            logger.log("dcompact_worker_health", url=url, state=state,
                       consecutive_failures=consecutive_failures)
        notify(db.options.listeners, "on_worker_health_changed", db,
               WorkerHealthInfo(url=url, state=state,
                                consecutive_failures=consecutive_failures))

    health.observers.append(_on_transition)


def execute_resilient(db, factory, compaction, snapshots, alloc,
                      policy: DcompactOptions | None = None):
    """Run one compaction through `factory` with the failure policy:
    per-attempt retry (exponential backoff + jitter), a per-job deadline,
    circuit-breaker bookkeeping (when the factory exposes a health
    registry), and DCOMPACTION_* statistics, listener events and event-log
    lines for every decision. When every attempt failed, the deadline
    passed, or every circuit is open, the last error is raised: nothing
    re-runs the job locally."""
    from toplingdb_tpu_torch.utils.listener import DcompactAttemptInfo

    policy = policy or getattr(db.options, "dcompact", None) \
        or DcompactOptions()
    stats = db.options.statistics
    logger = getattr(db, "event_logger", None)
    health: WorkerHealthRegistry | None = getattr(factory, "health", None)

    def tick(name, n=1):
        if stats is not None:
            stats.record_tick(name, n)

    if health is not None:
        _wire_health_observer(db, factory, health, tick, logger)

    deadline = (time.monotonic() + policy.job_deadline
                if policy.job_deadline > 0 else None)
    max_attempts = max(1, policy.max_attempts)
    last_error: BaseException | None = None
    for attempt in range(max_attempts):
        if deadline is not None and time.monotonic() >= deadline:
            tick(stats_mod.DCOMPACTION_DEADLINE_EXCEEDED)
            raise last_error or DeadlineExceeded(
                "dcompact job deadline exceeded before first attempt")
        if attempt > 0:
            delay = policy.backoff_delay(attempt)
            if deadline is not None:
                delay = min(delay, max(0.0, deadline - time.monotonic()))
            if delay > 0:
                time.sleep(delay)
        executor = factory.new_executor(compaction)
        if executor is None:
            # Breaker-aware factories return None when every worker's
            # circuit is open: raise without paying a transport timeout.
            tick(stats_mod.DCOMPACTION_BREAKER_SKIPPED)
            raise last_error or AllCircuitsOpen(
                "every dcompact worker circuit is open")
        executor.attempt = attempt
        url = getattr(executor, "url", "")
        t0 = time.monotonic()
        tick(stats_mod.DCOMPACTION_ATTEMPTS)
        try:
            outputs, cstats = executor.execute(db, compaction, snapshots,
                                               alloc)
        except Exception as e:
            last_error = e
            if health is not None and url:
                health.record_failure(url)
            elapsed = int((time.monotonic() - t0) * 1e6)
            if stats is not None:
                stats.record_in_histogram(
                    stats_mod.DCOMPACTION_ATTEMPT_MICROS, elapsed)
            will_retry = attempt + 1 < max_attempts
            if db.options.listeners:
                _notify_attempt(db, DcompactAttemptInfo(
                    db_name=db.dbname,
                    job_id=getattr(executor, "_job_seq", 0),
                    attempt=attempt, url=url, ok=False,
                    error=repr(e)[:300], elapsed_micros=elapsed,
                    will_retry=will_retry))
            if logger is not None:
                logger.log("dcompact_attempt_failed", attempt=attempt,
                           url=url, error=repr(e)[:300],
                           will_retry=will_retry)
            if will_retry:
                tick(stats_mod.DCOMPACTION_RETRIES)
                continue
            tick(stats_mod.DCOMPACTION_JOB_FAILURES)
            raise
        elapsed = int((time.monotonic() - t0) * 1e6)
        if stats is not None:
            stats.record_in_histogram(
                stats_mod.DCOMPACTION_ATTEMPT_MICROS, elapsed)
        if health is not None and url:
            health.record_success(url)
        if db.options.listeners:
            _notify_attempt(db, DcompactAttemptInfo(
                db_name=db.dbname, job_id=getattr(executor, "_job_seq", 0),
                attempt=attempt, url=url, ok=True, error=None,
                elapsed_micros=elapsed, will_retry=False))
        return outputs, cstats
    raise last_error  # unreachable: the loop returns or raises
