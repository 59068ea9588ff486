"""Declarative SLOs with multi-window burn-rate alerting (copied from
toplingdb_tpu/utils/slo.py, whole).

The health plane's decision layer: each `SLOSpec` names an objective
("99.9% of Gets under 2ms", "stall fraction under 1%", "replication lag
under 500ms") and the engine evaluates the *bad-event fraction* over two
trailing windows — a fast window that reacts within seconds and a slow
window that filters blips. An alert fires only when BOTH windows burn
error budget faster than their thresholds (the SRE multiwindow
multi-burn-rate pattern), and resolves when the fast window recovers.

Bad-event counts are derived from cumulative, monotone measures
(histogram buckets above the threshold; ticker sums; the stall-micros
counter), so a window is just a difference of two snapshots — the engine
keeps a small time-bounded ring of them and never needs the histograms'
ring to span the slow window.

Alerts surface four ways: the `on_slo_alert` EventListener callback, the
SLO_* ticker family, `/slo/<name>` JSON, and burn-rate gauges on
`/metrics`. Per-shard health scores (health_score) fold the SLO verdict
together with stall state, breaker state, and replication lag into the
green/degraded/unhealthy rubric ShardRouter.status() reports.
"""

from __future__ import annotations

import threading
import time
from dataclasses import asdict, dataclass

from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import errors as _errors

from . import statistics as _st
from .listener import SLOAlertInfo, notify

# The closed set of spec kinds.
KINDS = ("latency", "fraction", "stall", "replication_lag",
         "disk_pressure")

HEALTH_GREEN = "green"
HEALTH_DEGRADED = "degraded"
HEALTH_UNHEALTHY = "unhealthy"
_HEALTH_RANK = {HEALTH_GREEN: 0, HEALTH_DEGRADED: 1, HEALTH_UNHEALTHY: 2}


@dataclass
class SLOSpec:
    """One objective. `objective` is the good-event target (0.999 =
    99.9%); the error budget is 1-objective and burn rate 1.0 means
    "spending budget exactly at the sustainable rate"."""

    name: str
    kind: str = "latency"
    objective: float = 0.99
    # latency / replication_lag: the histogram sampled and the
    # threshold above which a sample is a bad event.
    histogram: str = _st.DB_GET_MICROS
    threshold_usec: float = 10_000.0
    # fraction: bad/total ticker families (sums of each tuple).
    bad_tickers: tuple = ()
    total_tickers: tuple = ()
    # Windows; None inherits the engine default (fast) / 5x fast (slow).
    window_fast_sec: float | None = None
    window_slow_sec: float | None = None
    # Burn-rate thresholds (Google SRE workbook's page-tier defaults:
    # a fast window burning >= `burn_fast` x budget AND the slow window
    # confirming at >= `burn_slow` x).
    burn_fast: float = 6.0
    burn_slow: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}; one of {KINDS}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.kind == "replication_lag":
            # Sugar: a latency objective over the ship->apply lag series.
            self.histogram = _st.REPLICATION_LAG_MICROS
        if self.kind == "disk_pressure":
            # Sugar: a fraction objective over the free-space poller —
            # bad events are passes that landed at amber/red, so
            # "objective=0.99" reads "99% of polls see a healthy disk".
            self.bad_tickers = (_st.DISK_PRESSURE_POLLS_BAD,)
            self.total_tickers = (_st.DISK_PRESSURE_POLLS,)
        if self.kind == "fraction" and (not self.bad_tickers
                                        or not self.total_tickers):
            raise ValueError(
                "fraction SLO needs bad_tickers and total_tickers "
                "(total = the full event denominator)")


def _as_spec(s) -> SLOSpec:
    if isinstance(s, SLOSpec):
        return s
    d = dict(s)
    for k in ("bad_tickers", "total_tickers"):
        if k in d and isinstance(d[k], list):
            d[k] = tuple(d[k])
    return SLOSpec(**d)


@dataclass
class _SpecState:
    firing: bool = False
    since: float | None = None      # wall ts of the firing transition
    burn_fast: float = 0.0
    burn_slow: float = 0.0
    value: float = 0.0              # bad fraction over the fast window
    last_alert: dict | None = None


class SLOEngine:
    """Evaluates a set of SLOSpecs against one Statistics instance.

    evaluate() is cheap (a few dict lookups + one 64-bucket scan per
    latency spec) and safe to call from any thread; start(period) runs
    it on a daemon thread. Tests drive evaluate(now=...) with synthetic
    clocks."""

    def __init__(self, statistics, specs, db=None, db_name: str = "",
                 listeners=(), default_window_sec: float = 60.0,
                 clock=None):
        self._stats = statistics
        self.specs = [_as_spec(s) for s in (specs or ())]
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO spec names: {names}")
        self._db = db
        self.db_name = db_name
        self._listeners = list(listeners or ())
        self._default_fast = float(default_window_sec) or 60.0
        self._clock = clock if clock is not None else time.time
        self._mu = ccy.Lock("slo.SLOEngine._mu")
        # Ring of (ts, {spec_name: (bad, total)}) cumulative measures.
        self._ring: list[tuple[float, dict[str, tuple[float, float]]]] = []
        self._state: dict[str, _SpecState] = {
            s.name: _SpecState() for s in self.specs}
        self._stop_ev = threading.Event()
        self._thread: threading.Thread | None = None
        self._max_slow = max(
            [self._slow_sec(s) for s in self.specs] or [self._default_fast])

    # -- window plumbing -------------------------------------------------

    def _fast_sec(self, spec: SLOSpec) -> float:
        return float(spec.window_fast_sec or self._default_fast)

    def _slow_sec(self, spec: SLOSpec) -> float:
        return float(spec.window_slow_sec or 5 * self._fast_sec(spec))

    def _measure(self, spec: SLOSpec) -> tuple[float, float]:
        """Cumulative (bad, total) for one spec — both monotone, so any
        window is a difference of two of these."""
        if spec.kind in ("latency", "replication_lag"):
            h = self._stats.get_histogram(spec.histogram)
            return h.fraction_above(spec.threshold_usec) * h.count, h.count
        if spec.kind == "stall":
            # total is wall time; filled in per-window at delta time.
            return float(self._stats.get_ticker_count(_st.STALL_MICROS)), 0.0
        bad = sum(self._stats.get_ticker_count(t) for t in spec.bad_tickers)
        tot = sum(self._stats.get_ticker_count(t) for t in spec.total_tickers)
        return float(bad), float(tot)

    def _ref(self, now: float, window: float):
        """Most recent ring sample at least `window` old (so the delta
        covers >= window); the oldest sample while history is short —
        this is what lets an induced stall fire within a few evaluation
        periods instead of waiting out the slow window."""
        ref = None
        for ts, m in self._ring:
            if ts <= now - window:
                ref = (ts, m)
            else:
                break
        if ref is None and self._ring:
            ref = self._ring[0]
        return ref

    def _bad_fraction(self, spec: SLOSpec, now: float,
                      cur: tuple[float, float], window: float) -> float:
        ref = self._ref(now, window)
        if ref is None:
            return 0.0
        ts0, m0 = ref
        b0, t0 = m0.get(spec.name, (0.0, 0.0))
        db = max(0.0, cur[0] - b0)
        if spec.kind == "stall":
            wall_us = max(1.0, (now - ts0) * 1e6)
            return min(1.0, db / wall_us)
        dt = cur[1] - t0
        if dt <= 0:
            return 0.0
        return min(1.0, db / dt)

    # -- the evaluation pass ---------------------------------------------

    def evaluate(self, now: float | None = None) -> dict:
        """One pass: snapshot measures, compute burn rates, transition
        alerts. Returns the status() dict."""
        now = self._clock() if now is None else now
        measures = {s.name: self._measure(s) for s in self.specs}
        alerts: list[SLOAlertInfo] = []
        with self._mu:
            burst = 0
            for spec in self.specs:
                st = self._state[spec.name]
                budget = max(1e-9, 1.0 - spec.objective)
                fast = self._bad_fraction(
                    spec, now, measures[spec.name], self._fast_sec(spec))
                slow = self._bad_fraction(
                    spec, now, measures[spec.name], self._slow_sec(spec))
                st.burn_fast = fast / budget
                st.burn_slow = slow / budget
                st.value = fast
                breached = (st.burn_fast >= spec.burn_fast
                            and st.burn_slow >= spec.burn_slow)
                if breached:
                    burst += 1
                if breached and not st.firing:
                    st.firing, st.since = True, now
                    alerts.append(self._info(spec, st, "firing"))
                elif st.firing and st.burn_fast < spec.burn_fast:
                    st.firing, st.since = False, None
                    alerts.append(self._info(spec, st, "resolved"))
                if alerts and alerts[-1].slo_name == spec.name:
                    st.last_alert = asdict(alerts[-1])
            self._ring.append((now, measures))
            cutoff = now - self._max_slow * 2
            while len(self._ring) > 2 and self._ring[0][0] < cutoff:
                self._ring.pop(0)
        if self._stats is not None:
            self._stats.record_tick(_st.SLO_EVALUATIONS)
            if burst:
                self._stats.record_tick(_st.SLO_WINDOWS_BREACHED, burst)
            for a in alerts:
                self._stats.record_tick(
                    _st.SLO_ALERTS_FIRED if a.state == "firing"
                    else _st.SLO_ALERTS_RESOLVED)
        for a in alerts:
            notify(self._listeners, "on_slo_alert", self._db, a)
        return self.status()

    def _info(self, spec: SLOSpec, st: _SpecState,
              state: str) -> SLOAlertInfo:
        return SLOAlertInfo(
            db_name=self.db_name, slo_name=spec.name, kind=spec.kind,
            state=state, burn_rate_fast=st.burn_fast,
            burn_rate_slow=st.burn_slow, value=st.value,
            objective=spec.objective,
            window_fast_sec=self._fast_sec(spec),
            window_slow_sec=self._slow_sec(spec))

    # -- reporting -------------------------------------------------------

    def status(self) -> dict:
        with self._mu:
            specs = {}
            for spec in self.specs:
                st = self._state[spec.name]
                specs[spec.name] = {
                    "kind": spec.kind,
                    "objective": spec.objective,
                    "burn_rate_fast": round(st.burn_fast, 4),
                    "burn_rate_slow": round(st.burn_slow, 4),
                    "bad_fraction_fast": round(st.value, 6),
                    "firing": st.firing,
                    "since": st.since,
                    "window_fast_sec": self._fast_sec(spec),
                    "window_slow_sec": self._slow_sec(spec),
                    "last_alert": st.last_alert,
                }
        return {"health": self._health_locked(specs), "specs": specs}

    @staticmethod
    def _health_locked(specs: dict) -> str:
        if any(r["firing"] for r in specs.values()):
            return HEALTH_UNHEALTHY
        if any(r["burn_rate_fast"] >= 1.0 for r in specs.values()):
            return HEALTH_DEGRADED
        return HEALTH_GREEN

    def health(self) -> str:
        return self.status()["health"]

    def last_alerts(self) -> dict:
        """{spec_name: last alert dict} for specs that ever alerted."""
        with self._mu:
            return {n: dict(s.last_alert) for n, s in self._state.items()
                    if s.last_alert}

    # -- background thread -----------------------------------------------

    def start(self, period_sec: float) -> None:
        if self._thread is not None:
            return
        self._stop_ev.clear()

        def _run():
            while not self._stop_ev.wait(period_sec):
                try:
                    self.evaluate()
                except Exception as e:
                    # an evaluation bug must not kill the sampler
                    _errors.swallow(reason="slo-eval-retry", exc=e)

        self._thread = ccy.spawn("slo-eval", _run, owner=self,
                                 stop=self.stop)

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_ev.set()
        self._thread.join(timeout=2.0)
        self._thread = None


def health_score(stall_state: str | None = None,
                 slo_health: str = HEALTH_GREEN,
                 breakers_open: int = 0,
                 lag_exceeded: bool = False) -> str:
    """The shard-health rubric: fold stall state (db.write_stall_state),
    the SLO verdict, replica breaker state, and a lag flag into one
    green/degraded/unhealthy score (worst input wins)."""
    score = _HEALTH_RANK.get(slo_health, 0)
    if stall_state == "stopped":
        score = max(score, 2)
    elif stall_state == "delayed":
        score = max(score, 1)
    if breakers_open > 0 or lag_exceeded:
        score = max(score, 1)
    for name, rank in _HEALTH_RANK.items():
        if rank == score:
            return name
    return HEALTH_GREEN


def health_num(health: str) -> int:
    """Gauge encoding: green=0 degraded=1 unhealthy=2."""
    return _HEALTH_RANK.get(health, 0)


def health_doc(db, name: str, role: str = "primary") -> dict:
    """The aggregator wire format: one JSON-portable document carrying a
    member's identity, health verdict, stall state, SLO rows, mergeable
    histograms (cumulative + recent window), and tickers. Every fleet
    member endpoint (/health/<name>, /replication/health) serves this;
    tools/fleet_health.py merges them."""
    stats = getattr(db, "stats", None)
    engine = getattr(db, "slo_engine", None)
    slo = engine.status() if engine is not None else None
    stall = None
    ws = getattr(db, "write_stall_state", None)
    if callable(ws):
        stall = ws()
    stall_state = (stall or {}).get("state") if isinstance(stall, dict) \
        else stall
    doc = {
        "name": name,
        "role": role,
        "health": health_score(
            stall_state=stall_state,
            slo_health=(slo or {}).get("health", HEALTH_GREEN)),
        "stall": stall,
        "slo": slo,
        "histograms": {},
        "tickers": {},
        "last_sequence": getattr(
            getattr(db, "versions", None), "last_sequence", None),
    }
    if stats is not None:
        doc["tickers"] = stats.tickers()
        with stats._lock:
            hists = [(k, h) for k, h in stats._histograms.items() if h.count]
        for k, h in hists:
            row = {"cumulative": h.to_dict()}
            if isinstance(h, _st.WindowedHistogram):
                row["recent"] = h.windowed().to_dict()
                row["window_sec"] = h.window_sec
            doc["histograms"][k] = row
    return doc
