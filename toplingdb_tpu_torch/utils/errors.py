"""Error-policy helpers: the ONE sanctioned way to swallow broad exceptions
(copied from toplingdb_tpu/utils/errors.py).

Every deliberately swallowed failure is countable instead of invisible:
the `BG_ERROR_SWALLOWED` ticker ticks on the attributed `Statistics` when
one is supplied, and a process-wide counter always increments
(`swallowed_total()`).

Two spellings, one policy:

    # Replace `try: ... except Exception: pass` wholesale:
    with errors.swallow(reason="cache-probe-best-effort"):
        probe()

    # Inside a handler that still needs fallback work:
    try:
        return native_path()
    except Exception as e:
        errors.swallow(reason="native-fallback", exc=e)
        return python_path()

    # Listener/callback fan-out (user code must never kill the engine):
    with errors.guard(listener=method):
        cb(*args)

`KeyboardInterrupt`/`SystemExit` are `BaseException`, not `Exception`,
so neither helper ever suppresses them. (Copied from
toplingdb_tpu/utils/errors.py, without its TPULSM_ERRORS_DEBUG switch:
the port reads no process-wide knobs; `recent()` lists the swallows.)
"""

from __future__ import annotations

import collections

from toplingdb_tpu_torch.utils import concurrency as ccy

_UNSET = object()

_mu = ccy.Lock("errors._mu")
_total = 0
_recent: collections.deque = collections.deque(maxlen=64)


def _record(reason: str, exc: BaseException | None, stats) -> None:
    global _total
    with _mu:
        _total += 1
        _recent.append((reason, type(exc).__name__ if exc else None))
    if stats is not None:
        # Outside _mu: record_tick takes statistics.Statistics._lock and
        # the two classes share rank 3 (never nested).
        from toplingdb_tpu_torch.utils import statistics as st

        stats.record_tick(st.BG_ERROR_SWALLOWED)


class _Swallow:
    """Context manager: suppress `Exception`, record the swallow."""

    __slots__ = ("reason", "stats")

    def __init__(self, reason: str, stats=None):
        self.reason = reason
        self.stats = stats

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is not None and issubclass(et, Exception):
            _record(self.reason, ev, self.stats)
            return True
        return False


def swallow(reason: str, exc=_UNSET, stats=None):
    """Declare a deliberate broad-exception swallow.

    As a context manager (`exc` omitted) it replaces the whole
    try/except; called with `exc=` inside an existing handler it records
    the swallow and returns None so fallback work can follow. `stats=`
    attributes the `BG_ERROR_SWALLOWED` tick to a specific DB's
    Statistics; the process-wide counter increments either way.
    """
    if exc is not _UNSET:
        _record(reason, exc, stats)
        return None
    return _Swallow(reason, stats)


def guard(listener, stats=None) -> _Swallow:
    """Swallow policy for listener/callback fan-out: user callbacks must
    never take down the engine. `listener` names the hook (string or the
    bound method itself)."""
    name = listener if isinstance(listener, str) else getattr(
        listener, "__name__", str(listener))
    return _Swallow(f"listener:{name}", stats)


def swallowed_total() -> int:
    """Process-wide count of policy-swallowed exceptions (the
    `tpulsm_bg_error_swallowed_total` /metrics gauge)."""
    with _mu:
        return _total


def recent() -> list:
    """Last 64 (reason, exc_type_name) swallows, oldest first."""
    with _mu:
        return list(_recent)
