"""Stats history: time-series snapshots of the Statistics tickers (copied
from toplingdb_tpu/utils/stats_history.py, whole; the dump thread is named
"tpt-stats-dump").

Analogue of the reference's InMemoryStatsHistoryIterator /
PersistentStatsHistoryIterator (monitoring/in_memory_stats_history.cc,
monitoring/persistent_stats_history.cc; surfaced via DBImpl::GetStatsHistory,
db/db_impl/db_impl.cc:1102). Snapshots are delta-encoded like the reference
(each sample stores the ticker increase since the previous sample).

Health-plane extension: each sample also carries per-histogram interval
rows (count/sum/max delta since the previous snapshot), so /stats_history
can reconstruct latency and rate time series — the sensing the SLO engine
and the fleet autopilot (ROADMAP item 1) consume.
"""

from __future__ import annotations

import threading

import time
import warnings

from . import statistics as _st
from toplingdb_tpu_torch.utils import concurrency as ccy


class StatsHistory:
    """Bounded in-memory ring of (timestamp, ticker deltas, histogram
    interval rows) samples."""

    def __init__(self, statistics, max_samples: int = 1024):
        self._stats = statistics
        self._max = max_samples
        self._samples: list[tuple[int, dict[str, int], dict[str, dict]]] = []
        self._last_absolute: dict[str, int] = {}
        # Per-histogram (count, sum) at the previous snapshot, for the
        # interval-delta rows.
        self._last_hist: dict[str, tuple[int, float]] = {}
        self._mu = ccy.Lock("stats_history.StatsHistory._mu")

    def snapshot(self, now: int | None = None) -> None:
        """Record the ticker + histogram deltas since the previous
        snapshot."""
        if self._stats is None:
            return
        now = int(time.time()) if now is None else now
        with self._stats._lock:
            absolute = dict(self._stats._tickers)
            hist_abs = {
                k: (h.count, h.sum, h) for k, h in
                self._stats._histograms.items() if h.count
            }
        with self._mu:
            delta = {
                k: v - self._last_absolute.get(k, 0)
                for k, v in absolute.items()
                if v - self._last_absolute.get(k, 0)
            }
            self._last_absolute = absolute
            hist_rows: dict[str, dict] = {}
            for k, (cnt, total, h) in hist_abs.items():
                pc, ps = self._last_hist.get(k, (0, 0))
                dc = cnt - pc
                if dc <= 0:
                    continue
                # Interval max: the windowed ring's recent max when the
                # histogram keeps one (exact enough for sensing); the
                # lifetime max otherwise.
                if isinstance(h, _st.WindowedHistogram):
                    mx = h.windowed().max
                else:
                    mx = h.max
                hist_rows[k] = {"count": dc, "sum": total - ps, "max": mx}
            self._last_hist = {k: (c, s) for k, (c, s, _) in hist_abs.items()}
            self._samples.append((now, delta, hist_rows))
            if len(self._samples) > self._max:
                del self._samples[: len(self._samples) - self._max]

    def last_sample(self):
        """Most recent (ts, delta) or None — taken under the lock so a
        concurrent snapshot() can't hand back someone else's sample."""
        with self._mu:
            if not self._samples:
                return None
            ts, d, _ = self._samples[-1]
            return ts, dict(d)

    def get(self, start_time: int = 0,
            end_time: int = 2 ** 62) -> list[tuple[int, dict[str, int]]]:
        """Samples with start_time <= ts < end_time (reference
        GetStatsHistory contract). Ticker deltas only — see series()
        for the histogram rows."""
        with self._mu:
            return [
                (ts, dict(d)) for ts, d, _ in self._samples
                if start_time <= ts < end_time
            ]

    def series(self, start_time: int = 0,
               end_time: int = 2 ** 62) -> list[dict]:
        """Full samples: [{"ts", "tickers", "histograms"}] where
        histograms is {name: {"count", "sum", "max"}} per interval."""
        with self._mu:
            return [
                {"ts": ts, "tickers": dict(d), "histograms":
                 {k: dict(r) for k, r in hr.items()}}
                for ts, d, hr in self._samples
                if start_time <= ts < end_time
            ]


class StatsDumpScheduler:
    """Periodic snapshot thread (reference stats_persist_period_sec /
    stats_dump_period_sec via the periodic task scheduler). Daemonized;
    stop() joins. `on_snapshot` (optional) fires after each snapshot —
    the DB hooks its event-log stats_dump line there."""

    def __init__(self, history: StatsHistory, period_sec: float,
                 on_snapshot=None, statistics=None):
        self._history = history
        self._period = period_sec
        self._on_snapshot = on_snapshot
        # Swallowed-exception accounting goes to the stats the history
        # samples, so a perpetually-failing dump line is visible.
        self._statistics = statistics if statistics is not None \
            else history._stats
        self.errors = 0
        self._stop = threading.Event()
        self._thread = ccy.spawn("tpt-stats-dump", self._run, owner=self,
                                 stop=self.stop)

    def _run(self) -> None:
        while not self._stop.wait(self._period):
            self._history.snapshot()
            if self._on_snapshot is not None:
                try:
                    self._on_snapshot()
                except Exception:
                    # A dump-line failure must not kill the sampler, but
                    # it must not be invisible either.
                    self.errors += 1
                    if self._statistics is not None:
                        self._statistics.record_tick(_st.STATS_DUMP_ERRORS)

    def stop(self) -> bool:
        """Stop and join. Returns True when the thread exited; False
        (with a RuntimeWarning) when it is still alive after the join
        timeout — a hung on_snapshot callback."""
        self._stop.set()
        self._thread.join(timeout=2.0)
        if self._thread.is_alive():
            warnings.warn(
                "StatsDumpScheduler thread did not exit within 2s "
                "(on_snapshot hung?)", RuntimeWarning, stacklevel=2)
            return False
        return True
