"""Thread status registry (copied from toplingdb_tpu/utils/thread_status.py,
whole).

The role of RocksDB's thread-status mechanism
(monitoring/thread_status_updater.cc, ThreadStatus::STAGE_COMPACTION_RUN):
background workers report their current operation and stage into a
process-wide registry that operators list — the "what is the DB doing
right now" surface, read by DB.get_property("tpulsm.threads")."""

from __future__ import annotations

import threading
import time
from toplingdb_tpu_torch.utils import concurrency as ccy

_REGISTRY: dict[int, dict] = {}
_MU = ccy.Lock("thread_status._MU")


def set_thread_operation(operation: str, stage: str = "",
                         db_name: str = "") -> None:
    """Record what the CURRENT thread is doing (empty operation clears)."""
    tid = threading.get_ident()
    with _MU:
        if not operation:
            _REGISTRY.pop(tid, None)
            return
        _REGISTRY[tid] = {
            "thread_id": tid,
            "thread_name": threading.current_thread().name,
            "operation": operation,
            "stage": stage,
            "db": db_name,
            "since": time.time(),
        }


class thread_operation:
    """Context manager: report an operation for the scope's duration.
    Nesting-safe: the previous entry (e.g. an outer 'ingest' around a
    write-triggered flush) is restored on exit."""

    def __init__(self, operation: str, stage: str = "", db_name: str = ""):
        self._args = (operation, stage, db_name)
        self._prev = None

    def __enter__(self):
        tid = threading.get_ident()
        with _MU:
            self._prev = _REGISTRY.get(tid)
        set_thread_operation(*self._args)
        return self

    def __exit__(self, *exc):
        tid = threading.get_ident()
        with _MU:
            if self._prev is not None:
                _REGISTRY[tid] = self._prev
            else:
                _REGISTRY.pop(tid, None)


def get_thread_list() -> list[dict]:
    """Snapshot of active background operations (RocksDB's
    Env::GetThreadList)."""
    now = time.time()
    with _MU:
        return [
            {**info, "elapsed_s": round(now - info["since"], 3)}
            for info in _REGISTRY.values()
        ]
