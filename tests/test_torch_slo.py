"""The SLO engine of toplingdb_tpu_torch (utils/slo.py, and its wiring in
the DB: Options.slo_specs / slo_eval_period_sec / slo_window_sec) against
toplingdb_tpu's, on the CPU.

- Both packages' SLOEngines, over their own Statistics, are fed the same
  seeded events (latency samples, ticker families, stall micros, disk
  polls, replication lag) under one fake clock: their status() docs are
  equal after every evaluation pass (floats within 1e-12), and so are
  their alerts, the on_slo_alert infos and the SLO_* tickers.
- What the engine reads, held first: the windowed histograms under one
  clock, write_stall_state on the same DB history, and health_doc on the
  same scripted DB state.
- The reference's own cases, tests/test_health.py:229-337 (spec
  validation, burn rate fires and resolves with a listener, an alert
  under an induced write stall on a real DB, the health rubric), on the
  port; the engine's thread, started by DB.open and joined by close().

Tolerance: 1e-12 on floats, counts equal.
"""

import dataclasses
import time

import numpy as np
import pytest

import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.options as ref_opts
from toplingdb_tpu.utils import listener as ref_listener
from toplingdb_tpu.utils import slo as ref_slo
from toplingdb_tpu.utils import statistics as ref_st

import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.options as opts_mod
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import listener
from toplingdb_tpu_torch.utils import slo as slomod
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.slo import SLOEngine, SLOSpec
from toplingdb_tpu_torch.utils.statistics import (
    Histogram,
    Statistics,
    WindowedHistogram,
)

TOL = 1e-12


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _close(a, b, path="doc"):
    """Structural equality with floats within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _specs(stm):
    """The same specs for either package (dicts, as a JSON config gives
    them), over `stm`'s names."""
    return [
        {"name": "get-p99", "kind": "latency", "objective": 0.99,
         "histogram": stm.DB_GET_MICROS, "threshold_usec": 10_000,
         "window_fast_sec": 30.0, "window_slow_sec": 150.0},
        {"name": "misses", "kind": "fraction", "objective": 0.9,
         "bad_tickers": [stm.BLOCK_CACHE_MISS],
         "total_tickers": [stm.BLOCK_CACHE_MISS, stm.BLOCK_CACHE_HIT]},
        {"name": "stall", "kind": "stall", "objective": 0.999},
        {"name": "disk", "kind": "disk_pressure", "objective": 0.95},
        {"name": "lag", "kind": "replication_lag", "objective": 0.99,
         "threshold_usec": 500_000},
    ]


class _Seen:
    def __init__(self, base):
        self.infos = []
        outer = self

        class L(base):
            def on_slo_alert(self, db, info):
                outer.infos.append(dataclasses.asdict(info))

        self.listener = L()


def test_status_docs_equal_under_one_clock():
    clk = FakeClock(1000.0)
    sides = {}
    for name, stm, sl, lmod in (("ref", ref_st, ref_slo, ref_listener),
                                ("port", st, slomod, listener)):
        stats = stm.Statistics(histogram_window_sec=60.0)
        seen = _Seen(lmod.EventListener)
        eng = sl.SLOEngine(stats, _specs(stm), db_name="d",
                           listeners=[seen.listener],
                           default_window_sec=20.0, clock=clk)
        sides[name] = (stm, stats, eng, seen)
    rng = np.random.default_rng(20)
    for step in range(60):
        # Phases: calm, a latency / miss / stall / disk / lag burst, calm.
        burst = 15 <= step < 30
        lat = rng.choice([100, 50_000], size=int(rng.integers(20, 80)),
                         p=[0.7, 0.3] if burst else [0.999, 0.001])
        lag = rng.integers(1000, 900_000 if burst else 400_000, size=10)
        miss = int(rng.integers(0, 40 if burst else 3))
        hit = int(rng.integers(10, 50))
        stall_us = int(rng.integers(100_000, 3_000_000)) if burst else 0
        polls_bad = int(burst)
        clk.t += float(rng.integers(3, 12))
        docs = {}
        for name, (stm, stats, eng, _seen) in sides.items():
            for v in lat:
                stats.record_in_histogram(stm.DB_GET_MICROS, float(v))
            for v in lag:
                stats.record_in_histogram(stm.REPLICATION_LAG_MICROS,
                                          float(v))
            stats.record_tick(stm.BLOCK_CACHE_MISS, miss)
            stats.record_tick(stm.BLOCK_CACHE_HIT, hit)
            if stall_us:
                stats.record_tick(stm.STALL_MICROS, stall_us)
            stats.record_tick(stm.DISK_PRESSURE_POLLS, 1)
            stats.record_tick(stm.DISK_PRESSURE_POLLS_BAD, polls_bad)
            docs[name] = eng.evaluate()
        _close(docs["port"], docs["ref"], f"step{step}")
    ref_side, port_side = sides["ref"], sides["port"]
    assert port_side[3].infos == ref_side[3].infos
    states = {(i["slo_name"], i["state"]) for i in port_side[3].infos}
    # Every spec fired in the burst and resolved after it.
    for spec in ("get-p99", "misses", "stall", "disk", "lag"):
        assert (spec, "firing") in states and (spec, "resolved") in states
    for t in ("SLO_EVALUATIONS", "SLO_WINDOWS_BREACHED", "SLO_ALERTS_FIRED",
              "SLO_ALERTS_RESOLVED"):
        assert port_side[1].get_ticker_count(getattr(st, t)) == \
            ref_side[1].get_ticker_count(getattr(ref_st, t)) > 0
    _close(port_side[2].last_alerts(), ref_side[2].last_alerts())
    assert port_side[2].health() == ref_side[2].health()


def test_windowed_histograms_equal_under_one_clock():
    clk = FakeClock(50.0)
    ref_h = ref_st.WindowedHistogram(60.0, intervals=6, clock=clk)
    h = WindowedHistogram(60.0, intervals=6, clock=clk)
    rng = np.random.default_rng(3)
    for step in range(40):
        vals = rng.lognormal(6.0, 1.5, size=int(rng.integers(1, 200)))
        for v in vals:
            ref_h.add(float(v))
            h.add(float(v))
        clk.t += float(rng.integers(1, 25))
        _close(h.windowed().to_dict(), ref_h.windowed().to_dict())
        _close(h.to_dict(), ref_h.to_dict())
        for q in (50, 90, 99, 99.9):
            assert abs(h.percentile(q) - ref_h.percentile(q)) <= TOL
        assert abs(h.fraction_above(1000.0)
                   - ref_h.fraction_above(1000.0)) <= TOL


def _stall_history(p_dbm, p_opts, p_st, path, factory=None):
    kw = {} if factory is None else {"compaction_executor_factory": factory}
    stats = p_st.Statistics()
    db = p_dbm.DB.open(path, p_opts.Options(
        create_if_missing=True, statistics=stats,
        level0_slowdown_writes_trigger=1, level0_stop_writes_trigger=100,
        level0_file_num_compaction_trigger=64, **kw))
    out = []
    try:
        out.append(db.write_stall_state())
        db.put(b"a", b"1")
        db.flush()
        db.put(b"b", b"2")
        db.flush()
        out.append(db.write_stall_state())
        for i in range(3):
            db.put(b"c%d" % i, b"3")
        out.append(db.write_stall_state())
        db.pause_background_work()
        out.append(db.write_stall_state())
        db.continue_background_work()
    finally:
        db.close()
    for row in out:
        # time-valued: the ramp's sleeps
        row.pop("stall_micros")
        row.pop("last_stall_micros")
    return out


def test_write_stall_state_matches_reference(tmp_path):
    ref = _stall_history(ref_dbm, ref_opts, ref_st, str(tmp_path / "r"))
    port = _stall_history(dbm, opts_mod, st, str(tmp_path / "p"),
                          DeviceCompactionExecutorFactory(device="cpu"))
    assert port == ref
    assert [r["state"] for r in port] == ["none", "delayed", "delayed",
                                          "none"]
    assert port[2]["stalls"] >= 3


def _doc_workload(p_dbm, p_opts, p_st, path, factory=None):
    kw = {} if factory is None else {"compaction_executor_factory": factory}
    db = p_dbm.DB.open(path, p_opts.Options(
        create_if_missing=True, disable_auto_compactions=True,
        statistics=p_st.Statistics(histogram_window_sec=60.0),
        slo_specs=({"name": "get-p99", "kind": "latency",
                    "threshold_usec": 10_000},), **kw))
    try:
        for i in range(200):
            db.put(b"k%04d" % i, b"v%d" % i)
        db.flush()
        for i in range(50):
            db.get(b"k%04d" % (i * 3))
        db.slo_engine.evaluate()
        mod = ref_slo if p_dbm is ref_dbm else slomod
        return mod.health_doc(db, "d")
    finally:
        db.close()


def test_health_doc_matches_reference(tmp_path):
    ref = _doc_workload(ref_dbm, ref_opts, ref_st, str(tmp_path / "r"))
    port = _doc_workload(dbm, opts_mod, st, str(tmp_path / "p"),
                         DeviceCompactionExecutorFactory(device="cpu"))
    for d in (ref, port):
        d["stall"].pop("stall_micros")
        d["stall"].pop("last_stall_micros")
    for k in ("name", "role", "health", "stall", "last_sequence"):
        assert port[k] == ref[k], k
    assert sorted(port["histograms"]) == sorted(ref["histograms"])
    for k, row in port["histograms"].items():
        assert row["cumulative"]["count"] == \
            ref["histograms"][k]["cumulative"]["count"], k
        assert sorted(row) == sorted(ref["histograms"][k])
    assert port["slo"]["health"] == ref["slo"]["health"] == "green"
    assert port["slo"]["specs"]["get-p99"]["firing"] is False
    assert port["histograms"][st.DB_GET_MICROS]["cumulative"]["count"] == 50


# ---------------------------------------------------------------------------
# tests/test_health.py:229-337 on the port
# ---------------------------------------------------------------------------


def test_slo_spec_validation():                                      # :229
    with pytest.raises(ValueError):
        SLOSpec(name="x", kind="bogus")
    with pytest.raises(ValueError):
        SLOSpec(name="x", objective=1.0)
    with pytest.raises(ValueError):
        SLOSpec(name="x", kind="fraction", bad_tickers=(st.STALL_MICROS,))
    with pytest.raises(ValueError):
        SLOEngine(Statistics(), [SLOSpec(name="a"), SLOSpec(name="a")])
    assert SLOSpec(name="r", kind="replication_lag").histogram == \
        st.REPLICATION_LAG_MICROS
    assert SLOSpec(name="d", kind="disk_pressure").bad_tickers == \
        (st.DISK_PRESSURE_POLLS_BAD,)


def test_slo_burn_rate_fires_and_resolves_with_listener():           # :241
    clk = FakeClock()
    s = Statistics(histogram_window_sec=60.0)
    seen = []

    class L(listener.EventListener):
        def on_slo_alert(self, db, info):
            seen.append(info)

    eng = SLOEngine(
        s, [SLOSpec(name="get-p99", kind="latency", objective=0.99,
                    histogram=st.DB_GET_MICROS, threshold_usec=10_000,
                    window_fast_sec=30.0, window_slow_sec=150.0)],
        db_name="t", listeners=[L()], clock=clk)
    for _ in range(200):
        s.record_in_histogram(st.DB_GET_MICROS, 100)
    for _ in range(3):
        clk.t += 10.0
        eng.evaluate()
    assert not eng.status()["specs"]["get-p99"]["firing"]
    assert eng.health() == slomod.HEALTH_GREEN
    for i in range(500):
        s.record_in_histogram(
            st.DB_GET_MICROS, 50_000 if i % 5 == 0 else 100)
    fired_after = None
    for step in range(3):
        clk.t += 10.0
        eng.evaluate()
        if eng.status()["specs"]["get-p99"]["firing"]:
            fired_after = step + 1
            break
    assert fired_after is not None and fired_after <= 3
    assert eng.health() == slomod.HEALTH_UNHEALTHY
    assert [a.state for a in seen] == ["firing"]
    assert seen[0].slo_name == "get-p99" and seen[0].db_name == "t"
    assert seen[0].burn_rate_fast >= 6.0
    for _ in range(20_000):
        s.record_in_histogram(st.DB_GET_MICROS, 100)
    for _ in range(30):
        clk.t += 10.0
        eng.evaluate()
        if not eng.status()["specs"]["get-p99"]["firing"]:
            break
    assert not eng.status()["specs"]["get-p99"]["firing"]
    assert [a.state for a in seen] == ["firing", "resolved"]
    assert s.get_ticker_count(st.SLO_ALERTS_FIRED) == 1
    assert s.get_ticker_count(st.SLO_ALERTS_RESOLVED) == 1
    assert s.get_ticker_count(st.SLO_EVALUATIONS) > 0
    assert "get-p99" in eng.last_alerts()


def test_slo_alert_under_induced_write_stall(tmp_path):               # :294
    """level0_slowdown_writes_trigger=1 makes every post-flush write ride
    the delay ramp; the stall SLO's burn rate crosses its thresholds
    within 3 evaluation passes, driven by a fake clock."""
    stats = Statistics(histogram_window_sec=60.0)
    db = dbm.DB.open(str(tmp_path / "d"), opts_mod.Options(
        create_if_missing=True, write_buffer_size=1 << 20,
        statistics=stats, level0_slowdown_writes_trigger=1,
        level0_stop_writes_trigger=100,
        level0_file_num_compaction_trigger=64,
        slo_specs=(SLOSpec(name="stall", kind="stall", objective=0.999),),
        slo_window_sec=5.0,
        compaction_executor_factory=DeviceCompactionExecutorFactory(
            device="cpu")))
    try:
        eng = db.slo_engine
        assert eng is not None and eng._thread is None  # no period: manual
        clk = FakeClock(1000.0)
        eng._clock = clk
        eng.evaluate()
        assert eng.health() == slomod.HEALTH_GREEN
        db.put(b"a", b"1")
        db.flush()
        db.put(b"b", b"2")
        db.flush()
        for i in range(4):
            db.put(b"c%d" % i, b"3")  # each write sleeps on the ramp
        stalled = stats.get_ticker_count(st.STALL_MICROS)
        assert stalled > 0
        fired = False
        for _ in range(3):
            # The fake clock advances by the stalled time, so the bad
            # fraction is the stall's share of the window whatever the
            # host's load.
            clk.t += stalled / 1e6 * 2
            eng.evaluate()
            if eng.status()["specs"]["stall"]["firing"]:
                fired = True
                break
        assert fired
        assert eng.health() == slomod.HEALTH_UNHEALTHY
        doc = slomod.health_doc(db, "d")
        assert doc["health"] == slomod.HEALTH_UNHEALTHY
        assert doc["slo"]["specs"]["stall"]["firing"]
        assert st.DB_WRITE_MICROS in doc["histograms"]
        assert doc["stall"]["state"] == "delayed"
    finally:
        db.close()


def test_health_score_rubric():                                      # :337
    assert slomod.health_score() == slomod.HEALTH_GREEN
    assert slomod.health_score(stall_state="delayed") \
        == slomod.HEALTH_DEGRADED
    assert slomod.health_score(stall_state="stopped") \
        == slomod.HEALTH_UNHEALTHY
    assert slomod.health_score(breakers_open=1) == slomod.HEALTH_DEGRADED
    assert slomod.health_score(lag_exceeded=True) == slomod.HEALTH_DEGRADED
    assert slomod.health_score(stall_state="delayed",
                               slo_health=slomod.HEALTH_UNHEALTHY) \
        == slomod.HEALTH_UNHEALTHY
    assert slomod.health_num(slomod.HEALTH_UNHEALTHY) == 2
    for h in (slomod.HEALTH_GREEN, slomod.HEALTH_DEGRADED,
              slomod.HEALTH_UNHEALTHY):
        assert slomod.health_num(h) == ref_slo.health_num(h)
        assert slomod.health_score(stall_state="delayed", slo_health=h) == \
            ref_slo.health_score(stall_state="delayed", slo_health=h)


def test_engine_thread_started_by_open_and_joined_by_close(tmp_path):
    """slo_eval_period_sec > 0 starts the evaluation thread (through
    ccy.spawn, owned by the engine); close() stops it and the DB's leak
    check finds nothing."""
    stats = Statistics()
    db = dbm.DB.open(str(tmp_path / "d"), opts_mod.Options(
        create_if_missing=True, statistics=stats,
        slo_specs=({"name": "get", "kind": "latency"},),
        slo_eval_period_sec=0.01,
        compaction_executor_factory=DeviceCompactionExecutorFactory(
            device="cpu")))
    eng = db.slo_engine
    try:
        assert [t.name for t in ccy.registry.live(owner=eng)] == ["slo-eval"]
        deadline = time.monotonic() + 10.0
        while stats.get_ticker_count(st.SLO_EVALUATIONS) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        db.close()
    assert ccy.registry.check_leaks(owner=eng) == []
    assert ccy.registry.check_leaks(owner=db) == []
    # A DB without statistics builds no engine (as toplingdb_tpu's).
    with dbm.DB.open(str(tmp_path / "e"), opts_mod.Options(
            create_if_missing=True,
            slo_specs=({"name": "get", "kind": "latency"},),
            compaction_executor_factory=DeviceCompactionExecutorFactory(
                device="cpu"))) as db2:
        assert db2.slo_engine is None


def test_histogram_quantiles_match_reference():
    """The histograms the latency specs read: the same samples give the
    same quantiles and fraction_above in both packages."""
    rng = np.random.default_rng(11)
    ref_h, h = ref_st.Histogram(), Histogram()
    for v in rng.exponential(3000.0, size=5000):
        ref_h.add(float(v))
        h.add(float(v))
    for thr in (10.0, 1000.0, 5000.0, 1e6):
        assert abs(h.fraction_above(thr) - ref_h.fraction_above(thr)) <= TOL
    for q in (0.1, 50, 99, 100):
        assert abs(h.percentile(q) - ref_h.percentile(q)) <= TOL
