"""EventListener callbacks + structured EventLogger (copied from
toplingdb_tpu/utils/listener.py, whole).

RocksDB's include/rocksdb/listener.h (EventListener) and
logging/event_logger.cc (JSON event stream). RocksDB's listeners also
travel to distributed compaction workers (CompactionParams::listeners);
these fire on the DB side after the results merge.
"""

from __future__ import annotations

import json
import time
from toplingdb_tpu_torch.utils import errors as _errors
from dataclasses import dataclass, field
from toplingdb_tpu_torch.utils import concurrency as ccy


@dataclass
class FlushJobInfo:
    db_name: str
    file_number: int
    file_size: int
    num_entries: int
    smallest_seqno: int
    largest_seqno: int


@dataclass
class CompactionJobInfo:
    db_name: str
    input_level: int
    output_level: int
    input_files: list = field(default_factory=list)
    output_files: list = field(default_factory=list)
    input_records: int = 0
    output_records: int = 0
    elapsed_micros: int = 0
    device: str = "cpu"
    reason: str = ""


@dataclass
class IngestionInfo:
    db_name: str
    external_file_path: str
    internal_file_number: int
    level: int


@dataclass
class DcompactAttemptInfo:
    """One remote compaction attempt (compaction/resilience.py): fired on
    success AND failure, so monitoring can attribute every retry and
    fallback to a worker."""

    db_name: str
    job_id: int
    attempt: int          # 0-based
    url: str              # "" for non-URL transports (subprocess/device)
    ok: bool
    error: str | None
    elapsed_micros: int
    will_retry: bool


@dataclass
class WorkerHealthInfo:
    """A worker circuit-breaker state TRANSITION (open/close)."""

    url: str
    state: str            # CircuitBreaker.CLOSED / OPEN / HALF_OPEN
    consecutive_failures: int


@dataclass
class CorruptionInfo:
    """The IntegrityScrubber (db/integrity.py) found a live file whose
    on-disk bytes no longer match the MANIFEST-recorded checksum; the
    file has been quarantined."""

    db_name: str
    file_number: int
    path: str
    reason: str
    recorded_checksum: str = ""      # hex
    checksum_func_name: str = ""


@dataclass
class SLOAlertInfo:
    """A multi-window burn-rate SLO alert TRANSITION (utils/slo.py):
    fired when both the fast and slow windows burn error budget faster
    than the spec's thresholds, resolved when the fast window recovers."""

    db_name: str
    slo_name: str
    kind: str             # "latency" / "fraction" / "stall" / "replication_lag"
    state: str            # "firing" / "resolved"
    burn_rate_fast: float
    burn_rate_slow: float
    value: float          # last bad-fraction over the fast window
    objective: float
    window_fast_sec: float
    window_slow_sec: float


@dataclass
class DiskPressureInfo:
    """A disk-pressure level TRANSITION from the SstFileManager's
    free-space poller (utils/rate_limiter.py). `level`/`prev` are one of
    "ok" / "amber" / "red"; a red→ok recovery is also a transition."""

    db_name: str
    path: str
    level: str
    prev_level: str
    free_fraction: float
    tracked_bytes: int
    trash_bytes: int
    budget_bytes: int     # 0 = no max_allowed_space_usage budget set


@dataclass
class ErrorRecoveryInfo:
    """A cleared background-error latch (manual resume() or the
    auto-recover loop), reference ErrorHandler recovery notifications."""

    db_name: str
    reason: str           # the latched error's bg reason ("" if unknown)
    auto: bool            # True when the auto-recover loop cleared it


class EventListener:
    """Override any subset (reference EventListener)."""

    def on_flush_completed(self, db, info: FlushJobInfo) -> None:
        pass

    def on_compaction_completed(self, db, info: CompactionJobInfo) -> None:
        pass

    def on_table_file_created(self, db, path: str, file_number: int) -> None:
        pass

    def on_table_file_deleted(self, db, path: str) -> None:
        pass

    def on_external_file_ingested(self, db, info: IngestionInfo) -> None:
        pass

    def on_background_error(self, db, error: BaseException) -> None:
        pass

    def on_dcompact_attempt(self, db, info: DcompactAttemptInfo) -> None:
        pass

    def on_worker_health_changed(self, db, info: WorkerHealthInfo) -> None:
        pass

    def on_corruption_detected(self, db, info: CorruptionInfo) -> None:
        pass

    def on_slo_alert(self, db, info: SLOAlertInfo) -> None:
        pass

    def on_disk_pressure(self, db, info: DiskPressureInfo) -> None:
        pass

    def on_error_recovery_completed(self, db, info: ErrorRecoveryInfo) -> None:
        pass


def notify(listeners, method: str, *args) -> None:
    # listener failures must never take down the engine
    for l in listeners or ():
        with _errors.guard(listener=method):
            getattr(l, method)(*args)


class EventLogger:
    """Structured JSON event stream (reference logging/event_logger.cc):
    one JSON object per line, `time_micros` + `event` + payload. Thread-safe:
    user write/flush threads and background compaction threads share one
    sink."""

    def __init__(self, sink=None):

        self._sink = sink  # callable(str) or file-like; None = discarded
        self._mu = ccy.Lock("listener.EventLogger._mu")

    def log(self, event: str, **payload) -> str:
        rec = {"time_micros": int(time.time() * 1e6), "event": event}
        # Telemetry correlation: lifecycle events emitted inside a traced
        # operation carry its trace_id, so `ldb dump_events` lines join
        # against /traces waterfalls.
        from toplingdb_tpu_torch.utils import telemetry as _tm

        tid = _tm.current_trace_id()
        if tid is not None:
            rec["trace_id"] = tid
        rec.update(payload)
        line = json.dumps(rec)
        if self._sink is not None:
            with self._mu:
                try:
                    if callable(self._sink):
                        self._sink(line)
                    else:
                        self._sink.write(line + "\n")
                except Exception as e:
                    # The info LOG is best-effort, like the reference's:
                    # a full or failing disk must not take down whatever
                    # background thread happened to emit an event (the
                    # disk-pressure poller, most ironically).
                    from toplingdb_tpu_torch.utils import errors as _errors

                    _errors.swallow(reason="event-log-append", exc=e)
        return line
