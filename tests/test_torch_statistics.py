"""Statistics, listeners, the event log and the span tracer of the port's
DB (utils/statistics.py, utils/listener.py, utils/stats_history.py,
utils/errors.py and their wiring in db/db.py, db/db_iter.py,
db/table_cache.py, compaction/scheduler.py) against toplingdb_tpu's, on
the CPU.

The scenario is tests/test_statistics_breadth.py:7's single-threaded one,
run through both DBs side by side: every ticker count must equal the
reference's, except the named time-valued or thread-order-valued ones
(`EXCLUDED`, each with its reason), and the count of every histogram must
be equal. It runs on both sides' host planes (`planes`): "python" pins
both DBs to their Python write, get and iterator paths
(TPULSM_WRITE_PLANE=0 and TPULSM_ITER_CHUNK=0 for the reference's open,
write_plane=False and iter_chunk_rows=0 for the port's, and both DBs'
native get library unset); "native" runs both DBs on their defaults (the
native group commit, the native get chain and the chunked scan plane), on
the skiplist memtable with explicit flushes, and compares the
WRITE_GROUP_NATIVE_COMMITS, BLOCK_CACHE_* and ITER_CHUNK_* counts with the
rest. The other tests here run the python planes. Also: the listener
event sequences of
tests/test_utilities.py:297, the `event` names in LOG (:318), the span
names of traced writes, gets, flushes and compactions, the worker spans
an HTTP job stitches (tests/test_telemetry.py:218), and the mirrors of
tests/test_health.py:70,181,201, tests/test_telemetry.py:501,540 and
tests/test_compaction_pipeline.py:412. `time.time()` is frozen in the
runs that compare counts, so histograms recorded only for a non-zero time
read alike. Tolerance: counts equal.
"""

import dataclasses
import json
import os
import time
import types

import pytest

import toplingdb_tpu.compaction.dcompact_service as ref_svc
import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.options as ref_opts
import toplingdb_tpu.utils.listener as ref_listener
import toplingdb_tpu.utils.statistics as ref_st
import toplingdb_tpu.utils.stats_history as ref_sh

import toplingdb_tpu_torch.compaction.dcompact_service as svc_mod
import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.options as opts_mod
import toplingdb_tpu_torch.utils.listener as listener
import toplingdb_tpu_torch.utils.statistics as st
import toplingdb_tpu_torch.utils.stats_history as sh
from toplingdb_tpu_torch.compaction.executor import (
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.utils.status import NotSupported

FROZEN_TIME = 1_700_000_000.0

# Tickers whose counts are times or depend on thread interleaving; the
# single-threaded scenario ticks none of them, and none is compared.
EXCLUDED = {
    st.STALL_MICROS: "time-valued (microseconds stalled)",
    st.WRITE_GROUP_FOLLOWERS: "thread-order-valued (who joins a group)",
    st.WRITE_DONE_BY_OTHER: "thread-order-valued (who leads a group)",
}

REF = types.SimpleNamespace(name="ref", DB=ref_dbm.DB, Options=ref_opts.Options,
                            WriteOptions=ref_opts.WriteOptions, st=ref_st,
                            listener=ref_listener, sh=ref_sh)
PORT = types.SimpleNamespace(name="port", DB=dbm.DB, Options=opts_mod.Options,
                             WriteOptions=opts_mod.WriteOptions, st=st,
                             listener=listener, sh=sh)


def _pin_python_planes(monkeypatch):
    """The reference's open on its Python write and iterator paths (the
    port's are DB.open arguments, see _open)."""
    monkeypatch.setenv("TPULSM_WRITE_PLANE", "0")
    monkeypatch.setenv("TPULSM_ITER_CHUNK", "0")


@pytest.fixture
def python_paths(monkeypatch):
    """Both DBs on their Python write and iterator paths, time frozen."""
    _pin_python_planes(monkeypatch)
    monkeypatch.setattr(time, "time", lambda: FROZEN_TIME)


@pytest.fixture(scope="module")
def services():
    ref = ref_svc.DcompactWorkerService(device="cpu-jax")
    port = svc_mod.DcompactWorkerService(device="cpu-jax")
    urls = {"ref": f"http://127.0.0.1:{ref.start()}",
            "port": f"http://127.0.0.1:{port.start()}"}
    yield urls
    ref.stop()
    port.stop()


def _factory(pkg, executor, urls):
    if executor == "local":
        return None if pkg is REF else LocalCompactionExecutorFactory()
    if pkg is REF:
        return ref_svc.HttpCompactionExecutorFactory(
            [urls["ref"]], device="cpu-jax", allow_fallback=False)
    return svc_mod.HttpCompactionExecutorFactory([urls["port"]],
                                                 device="cpu-jax")


def _open(pkg, path, planes="python", **kw):
    """Open `pkg`'s DB. planes="python": the Python write, get and
    iterator paths (the reference's also need _pin_python_planes);
    "native": each DB's defaults."""
    opts = pkg.Options(create_if_missing=True, **kw)
    if planes == "native":
        return pkg.DB.open(path, opts)
    if pkg is REF:
        db = pkg.DB.open(path, opts)
    else:
        db = pkg.DB.open(path, opts, write_plane=False, iter_chunk_rows=0)
    db._nget_lib = None  # the Python get chain
    return db


class _Recorder:
    """A listener recording every callback it receives, in order."""

    def __init__(self, pkg):
        events = self.events = []

        class L(pkg.listener.EventListener):
            def on_flush_completed(self, db, info):
                events.append(("flush", dataclasses.asdict(info)))

            def on_compaction_completed(self, db, info):
                d = dataclasses.asdict(info)
                d.pop("elapsed_micros")  # time-valued
                events.append(("compaction", d))

            def on_dcompact_attempt(self, db, info):
                events.append(("attempt", info.attempt, info.ok,
                               info.will_retry))

            def on_background_error(self, db, e):
                events.append(("bg_error", type(e).__name__))

        self.listener = L()


def _breadth(pkg, root, executor, urls, planes="python"):
    """tests/test_statistics_breadth.py:7's scenario. Returns the
    statistics, the listener's events and the LOG's event names. On the
    python planes the vector memtable rep charges logical bytes, so the
    flushes on memory use cut at the same entries in both DBs (the
    skiplist's physical charge follows random node heights that depend on
    what ran before in the process). The native planes need the skiplist:
    its write buffer is not filled, and the DB flushes every 700 puts (3
    L0 files in all, below the compaction trigger, so compact_range runs
    the one compaction)."""
    stats = pkg.st.Statistics()
    rec = _Recorder(pkg)
    path = os.path.join(root, pkg.name, "db")
    native = planes == "native"
    with _open(pkg, path, planes=planes,
               write_buffer_size=(64 << 20) if native else 64 * 1024,
               statistics=stats,
               memtable_rep="skiplist" if native else "vector",
               listeners=[rec.listener],
               compaction_executor_factory=_factory(pkg, executor,
                                                    urls)) as db:
        for i in range(2000):
            db.put(b"key%05d" % i, b"v" * 20)
            if native and i % 700 == 699:
                db.flush()
        db.put(b"sync", b"x", pkg.WriteOptions(sync=True))
        db.flush()
        for i in range(0, 2000, 7):
            assert db.get(b"key%05d" % i) is not None
        assert db.get(b"missing-key") is None
        it = db.new_iterator()
        it.seek(b"key01000")
        for _ in range(50):
            it.next()
        it.prev()
        db.compact_range()
        db.wait_for_compactions()
    with open(os.path.join(path, "LOG")) as f:
        log = [json.loads(line)["event"] for line in f]
    for e in rec.events:
        if e[0] in ("flush", "compaction"):
            e[1]["db_name"] = os.path.relpath(e[1]["db_name"],
                                              os.path.dirname(path))
    return stats, rec.events, log


@pytest.mark.parametrize(
    "planes,executor",
    [("python", "local"), ("python", "http"), ("native", "local"),
     ("native", "http")],
    ids=["local", "http", "native-local", "native-http"])
def test_breadth_tickers_histograms_events_match_reference(
        tmp_path, monkeypatch, services, planes, executor):
    if planes == "python":
        _pin_python_planes(monkeypatch)
    monkeypatch.setattr(time, "time", lambda: FROZEN_TIME)
    got = {pkg.name: _breadth(pkg, str(tmp_path), executor, services,
                              planes)
           for pkg in (REF, PORT)}
    (rs, rev, rlog), (ps, pev, plog) = got["ref"], got["port"]
    rt, pt = rs.tickers(), ps.tickers()
    names = (set(rt) | set(pt)) - set(EXCLUDED)
    diff = {k: (rt.get(k, 0), pt.get(k, 0)) for k in names
            if rt.get(k, 0) != pt.get(k, 0)}
    assert not diff, diff
    # The families test_statistics_breadth.py asserts on populated.
    assert pt[st.NUMBER_KEYS_WRITTEN] == 2001 and pt[st.WAL_SYNCS] >= 1
    assert pt[st.NUMBER_DB_NEXT] == 50 and pt[st.NO_ITERATOR_CREATED] == 1
    assert pt[st.NO_FILE_OPENS] >= 1 and pt[st.FLUSH_WRITE_BYTES] > 0
    assert pt[st.COMPACT_WRITE_BYTES] > 0
    family = (st.LCOMPACTION_READ_BYTES if executor == "local"
              else st.DCOMPACTION_READ_BYTES)
    assert pt[family] > 0
    if executor == "http":
        assert pt[st.DCOMPACTION_ATTEMPTS] == 1
    if planes == "native":
        # Every put committed natively, gets read through the native
        # chain's block cache, the scan through the chunk plane until
        # prev() dropped it.
        assert pt[st.WRITE_GROUP_NATIVE_COMMITS] == 2001
        assert pt.get(st.WRITE_GROUP_FALLBACKS, 0) == 0
        assert pt[st.BLOCK_CACHE_MISS] > 0
        assert pt[st.ITER_CHUNK_REFILLS] > 0
        assert pt[st.ITER_CHUNK_FALLBACKS] == 1
    else:
        assert pt[st.WRITE_GROUP_FALLBACKS] == 2001
        assert pt.get(st.ITER_CHUNK_REFILLS, 0) == 0
    hist = set(rs._histograms) | set(ps._histograms)
    hdiff = {k: (rs.get_histogram(k).count, ps.get_histogram(k).count)
             for k in hist
             if rs.get_histogram(k).count != ps.get_histogram(k).count}
    assert not hdiff, hdiff
    assert ps.get_histogram(st.DB_GET_MICROS).count == 287
    assert "lcompaction" in ps.to_string() or "dcompaction" in ps.to_string()
    assert pev == rev
    kinds = [e[0] for e in pev]
    assert "flush" in kinds and "compaction" in kinds
    assert plog == rlog
    assert "flush_finished" in plog and "compaction_finished" in plog


def _traced_spans(pkg, path, urls):
    """Span names under each root of a traced write, get, flush and
    compaction (trace_sample_every=1)."""
    db = _open(pkg, path, write_buffer_size=1 << 20, trace_sample_every=1,
               statistics=pkg.st.Statistics(),
               disable_auto_compactions=True,
               compaction_executor_factory=_factory(pkg, "local", urls))
    try:
        for r in range(2):
            for i in range(200):
                db.put(b"key%06d" % (i * 2 + r), b"v" * 24)
            db.flush()
        assert db.get(b"key000007") == b"v" * 24
        db.compact_range()
        out = {}
        for t in db.tracer.finished(limit=1000):
            out.setdefault(t.name, set()).update(s.name for s in t.spans)
        return out
    finally:
        db.close()


def test_traced_span_names_match_reference(tmp_path, python_paths):
    got = {pkg.name: _traced_spans(pkg, str(tmp_path / pkg.name), None)
           for pkg in (REF, PORT)}
    assert got["port"] == got["ref"]
    assert {"db.write", "db.get", "flush", "compaction"} <= set(got["port"])
    assert "flush.build_table" in got["port"]["flush"]
    assert {"write.wal_frame", "write.memtable_apply"} <= \
        got["port"]["db.write"]


def test_http_job_stitches_worker_spans(tmp_path, monkeypatch, services):
    """Mirror of tests/test_telemetry.py:218: the worker's spans of an HTTP
    job come back in results.json and join the DB-side compaction trace:
    one trace id, the worker root under the compaction root, the pipelined
    interior inside."""
    from toplingdb_tpu_torch.ops import pipeline as pl

    # Engage the pipelined plane inside the in-process worker; the row
    # floor would send a test-sized job to the serial route, and the shard
    # count (TPULSM_PIPELINE_SHARDS=4 in the reference's test) to one
    # shard.
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.setattr(pl, "_pipeline_shards",
                        lambda total_rows, requested=None: 4)
    fac = svc_mod.HttpCompactionExecutorFactory([services["port"]],
                                                device="cpu-jax")
    db = _open(PORT, str(tmp_path / "db"), write_buffer_size=1 << 14,
               disable_auto_compactions=True, trace_sample_every=1,
               compaction_executor_factory=fac, statistics=st.Statistics())
    try:
        for i in range(2400):
            db.put(b"key%05d" % (i % 800), b"val%07d" % i)
            if i % 300 == 299:
                db.flush()
        db.flush()
        db.compact_range()
        assert db.get(b"key00799") == b"val%07d" % 2399
        comps = [t for t in db.tracer.finished(limit=300)
                 if t.name == "compaction"]
        stitched = [t for t in comps
                    if any(s.proc == "dcompact-worker" for s in t.spans)]
        assert stitched, "no compaction trace carries worker spans"
        t = stitched[0]
        worker_spans = [s for s in t.spans if s.proc == "dcompact-worker"]
        names = {s.name for s in worker_spans}
        assert "dcompact.worker" in names
        assert {s.trace_id for s in worker_spans} == {t.trace_id}
        wroot = next(s for s in worker_spans if s.name == "dcompact.worker")
        assert wroot.parent_id == t.root.span_id
        assert t.root.tags.get("mode") == "remote"
        assert {"pipeline.scan", "pipeline.merge_gc"} <= names
    finally:
        db.close()


def test_prefetch_tickers_match_reference(tmp_path, monkeypatch):
    """Mirror of tests/test_compaction_pipeline.py:412: the compaction
    input scan exports its FilePrefetchBuffer counters as PREFETCH_HITS /
    PREFETCH_MISSES (the host compaction path on both sides, as that
    test's default Options run it); the device executor's are counted in
    test_breadth_tickers_histograms_events_match_reference[http]."""
    from toplingdb_tpu.table.builder import TableOptions as RefTO

    from toplingdb_tpu_torch.table.builder import TableOptions

    monkeypatch.setattr(time, "time", lambda: FROZEN_TIME)
    counts = {}
    for pkg, fac, to in ((REF, None, RefTO),
                         (PORT, LocalCompactionExecutorFactory(),
                          TableOptions)):
        stats = pkg.st.Statistics()
        # Auto compactions off (which L0 files a background job finds
        # depends on thread timing), and the vector rep's logical charge
        # (the skiplist's physical one moves the flush cuts).
        with _open(pkg, str(tmp_path / pkg.name), write_buffer_size=16 * 1024,
                   table_options=to(block_size=256), statistics=stats,
                   disable_auto_compactions=True, memtable_rep="vector",
                   compaction_executor_factory=fac) as db:
            for i in range(4000):
                db.put(b"key%05d" % (i % 1200), b"val%06d" % i)
            db.flush()
            db.compact_range()
            db.wait_for_compactions()
        counts[pkg.name] = (stats.get_ticker_count(pkg.st.PREFETCH_HITS),
                            stats.get_ticker_count(pkg.st.PREFETCH_MISSES))
    assert counts["port"] == counts["ref"]
    assert counts["port"][0] > 0 and counts["port"][1] > 0


# ---------------------------------------------------------------------------
# Mirrors of tests/test_health.py and tests/test_telemetry.py
# ---------------------------------------------------------------------------


def test_histogram_merge_and_dict_roundtrip_matches_reference():
    out = {}
    for pkg in (REF, PORT):
        H = pkg.st.Histogram
        a, b = H(), H()
        for v in (1, 2, 300):
            a.add(v)
        for v in (4_000_000, 7):
            b.add(v)
        m = H.from_dict(a.to_dict()).merge(H.from_dict(b.to_dict()))
        one = H()
        for v in (1, 2, 300, 4_000_000, 7):
            one.add(v)
        assert m.buckets == one.buckets
        out[pkg.name] = (m.to_dict(), [m.percentile(p) for p in (50, 99)])
    assert out["port"] == out["ref"]
    assert out["port"][0]["count"] == 5


def test_stats_history_interval_rows_match_reference():
    out = {}
    for pkg in (REF, PORT):
        s = pkg.st.Statistics(histogram_window_sec=60.0)
        hist = pkg.sh.StatsHistory(s, max_samples=10)
        s.record_in_histogram(pkg.st.DB_WRITE_MICROS, 100)
        s.record_in_histogram(pkg.st.DB_WRITE_MICROS, 300)
        s.record_tick(pkg.st.NUMBER_KEYS_WRITTEN, 2)
        hist.snapshot(now=10)
        s.record_in_histogram(pkg.st.DB_WRITE_MICROS, 900)
        s.record_tick(pkg.st.NUMBER_KEYS_WRITTEN, 1)
        hist.snapshot(now=20)
        out[pkg.name] = (hist.series(), hist.get(0, 15), hist.last_sample())
    assert out["port"] == out["ref"]
    rows = out["port"][0]
    assert rows[0]["histograms"][st.DB_WRITE_MICROS]["count"] == 2
    assert rows[-1]["histograms"][st.DB_WRITE_MICROS]["sum"] == 900


def test_stats_dump_scheduler_error_ticker_and_stop():
    s = st.Statistics()
    hist = sh.StatsHistory(s, max_samples=50)
    boom = {"n": 0}

    def on_snapshot():
        boom["n"] += 1
        raise RuntimeError("dump line failed")

    sched = sh.StatsDumpScheduler(hist, period_sec=0.01,
                                  on_snapshot=on_snapshot)
    assert sched._thread.name == "tpt-stats-dump"
    deadline = time.monotonic() + 5.0
    while boom["n"] < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sched.stop() is True
    assert boom["n"] >= 3 and sched.errors == boom["n"]
    assert s.get_ticker_count(st.STATS_DUMP_ERRORS) == sched.errors
    assert hist.last_sample() is not None


def test_event_log_correlation_and_stats_dump(tmp_path, python_paths):
    """Mirror of tests/test_telemetry.py:501 (reading LOG directly: the
    ldb tool is not ported): flush events carry their trace id, a
    persist_stats + dump hook writes a stats_dump line, a reopen rolls LOG
    to LOG.old. Then persist_stats(to_db=True), twice, in both DBs: after
    a reopen (an empty in-memory history) the hidden stats CF is listed
    and get_stats_history(include_persisted=True) returns both samples,
    equal to the reference's."""
    persisted = {}
    for pkg in (REF, PORT):
        d = str(tmp_path / pkg.name)
        db = _open(pkg, d, trace_sample_every=1,
                   statistics=pkg.st.Statistics(),
                   compaction_executor_factory=_factory(pkg, "local", None))
        try:
            for i in range(50):
                db.put(b"key%06d" % i, b"v" * 24)
            db.flush()
            db.persist_stats()
            db._log_stats_dump()
            assert len(db.get_stats_history()) == 1
            db.persist_stats(to_db=True)
            db.put(b"after", b"x")
            db.persist_stats(to_db=True)
        finally:
            db.close()
        if pkg is PORT:
            with open(os.path.join(d, "LOG")) as f:
                events = [json.loads(line) for line in f]
            kinds = {e["event"] for e in events}
            assert {"flush_finished", "stats_dump"} <= kinds
            assert any("trace_id" in e for e in events
                       if e["event"] == "flush_finished")
            assert all(isinstance(e["time_micros"], int) for e in events)
        db = _open(pkg, d, statistics=pkg.st.Statistics(),
                   compaction_executor_factory=_factory(pkg, "local", None))
        try:
            assert db.get_stats_history() == []
            persisted[pkg.name] = (
                [h.name for h in db.list_column_families()],
                db.get_stats_history(include_persisted=True))
        finally:
            db.close()
        assert os.path.exists(os.path.join(d, "LOG.old"))
    names, history = persisted["port"]
    assert names == ["default", "__tpulsm_stats__"]
    assert len(history) == 2 and history[1][1]
    assert persisted["port"] == persisted["ref"]


def test_stats_dump_thread_writes_log(tmp_path):
    """Mirror of tests/test_telemetry.py:540: stats_dump_period_sec starts
    the dump thread, which samples the history and logs stats_dump;
    close() joins it."""
    import threading

    d = str(tmp_path / "db")
    db = _open(PORT, d, statistics=st.Statistics(), stats_dump_period_sec=1,
               compaction_executor_factory=LocalCompactionExecutorFactory())
    try:
        for i in range(50):
            db.put(b"key%06d" % i, b"v" * 24)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if db.stats_history.last_sample() is not None:
                break
            time.sleep(0.05)
        assert db.stats_history.last_sample() is not None
    finally:
        db.close()
    assert not [t for t in threading.enumerate()
                if t.name == "tpt-stats-dump"]
    with open(os.path.join(d, "LOG")) as f:
        assert '"event": "stats_dump"' in f.read()


def test_listener_failure_is_swallowed_and_counted(tmp_path):
    """Listener fan-out goes through errors.guard: a raising callback does
    not reach the engine; BG_ERROR_SWALLOWED counts it process-wide."""
    from toplingdb_tpu_torch.utils import errors

    class Bad(listener.EventListener):
        def on_flush_completed(self, db, info):
            raise RuntimeError("user code")

    before = errors.swallowed_total()
    with _open(PORT, str(tmp_path / "db"), listeners=[Bad()],
               compaction_executor_factory=(
                   LocalCompactionExecutorFactory())) as db:
        db.put(b"a", b"1")
        db.flush()
        assert db.get(b"a") == b"1"
    assert errors.swallowed_total() == before + 1
    assert errors.recent()[-1] == ("listener:on_flush_completed",
                                   "RuntimeError")
    s = st.Statistics()
    with errors.swallow(reason="test", stats=s):
        raise ValueError("x")
    assert s.get_ticker_count(st.BG_ERROR_SWALLOWED) == 1


# ---------------------------------------------------------------------------
# What now opens, and what still raises
# ---------------------------------------------------------------------------

NOW_OPEN = {
    "statistics": lambda: st.Statistics(),
    "listeners": lambda: [listener.EventListener()],
    "stats_dump_period_sec": lambda: 3600,
    "stats_persist_period_sec": lambda: 3600,
    "histogram_window_sec": lambda: 30.0,
    "trace_sample_every": lambda: 2,
    "trace_slow_usec": lambda: 10_000,
    "trace_ring": lambda: 8,
    "info_log": lambda: object(),
}


@pytest.mark.parametrize("name", sorted(NOW_OPEN))
def test_ported_option_opens(tmp_path, name):
    assert name not in opts_mod.UNPORTED
    opts = opts_mod.Options(
        compaction_executor_factory=LocalCompactionExecutorFactory(),
        **{name: NOW_OPEN[name]()})
    assert opts_mod.unported_fields(opts) == []
    with dbm.DB.open(str(tmp_path / "db"), opts) as db:
        db.put(b"k", b"v")
        db.flush()
        assert db.get(b"k") == b"v"
        if name in ("trace_sample_every", "trace_slow_usec"):
            assert db.tracer is not None
        if name == "statistics":
            assert db.stats.get_ticker_count(st.NUMBER_KEYS_WRITTEN) == 1


def test_slo_fields_still_refused(tmp_path):
    """The three SLO fields were refused until the SLO engine was ported
    (utils/slo.py); now they open: the DB builds its engine, starts its
    evaluation thread, and close() joins it. Only db_write_buffer_size
    stays refused: shared_store opens since the storage plane was ported
    (storage/), and its DB runs on a SharedSstEnv."""
    for name in ("slo_specs", "slo_eval_period_sec", "slo_window_sec"):
        assert name not in opts_mod.UNPORTED
    assert sorted(opts_mod.UNPORTED) == ["db_write_buffer_size"]
    db = dbm.DB.open(str(tmp_path / "db"), opts_mod.Options(
        statistics=st.Statistics(),
        slo_specs=({"name": "get", "kind": "latency"},),
        slo_eval_period_sec=1.0, slo_window_sec=5.0,
        compaction_executor_factory=LocalCompactionExecutorFactory()))
    try:
        eng = db.slo_engine
        assert eng is not None and eng._thread is not None
        assert eng.status()["specs"]["get"]["window_fast_sec"] == 5.0
    finally:
        db.close()
    assert eng._thread is None
    with pytest.raises(NotSupported, match="db_write_buffer_size"):
        dbm.DB.open(str(tmp_path / "db2"), opts_mod.Options(
            db_write_buffer_size=1 << 20,
            compaction_executor_factory=LocalCompactionExecutorFactory()))
    with dbm.DB.open(str(tmp_path / "db3"), opts_mod.Options(
            shared_store=str(tmp_path / "store"),
            compaction_executor_factory=LocalCompactionExecutorFactory())
            ) as db3:
        assert hasattr(db3.env, "publish_sst")
