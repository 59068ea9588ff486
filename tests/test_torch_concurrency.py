"""The concurrency correctness plane of toplingdb_tpu_torch
(utils/concurrency.py, utils/sync_point.py, and every lock and thread of
the package made through them) against toplingdb_tpu's, on the CPU.

- Lock classes: every lock the reference creates through its named
  factories, in a module and class the port has, is created through the
  port's factories under the same name; the port makes no other lock or
  thread with `threading` directly, apart from the named port-only sites.
- Lock order: the reference's DB smoke workload
  (tests/test_concurrency.py:364), and a wider one (pipelined writes, the
  async WAL, the scrubber, the SLO engine's thread, the op trace, a
  compaction, iterators, multi_get), run in debug mode on both packages
  (host compaction path on both): the lock_order_edges() key sets are
  equal. No edge differs. Module-level locks keep the mode they were made
  in, so every module both workloads reach is imported before debug mode
  turns on (toplingdb_tpu imports utils/thread_status lazily at the first
  flush; without the import the reference alone would record
  db.DB._mutex -> thread_status._MU).
- Debug mode on the native write plane and the device executor: no
  inversion, native commits unchanged, an acyclic graph, no long hold.
- No environment variable turns debug mode or the watchdog on.
- The reference's own cases, tests/test_concurrency.py:223-364 (inversion
  with both stacks, transitive inversion, the watchdog, scan_long_holds,
  Condition over a wrapper, RLock re-entry, the registry, DB.close's leak
  warning, a clean open/close, the DB smoke under debug) and
  tests/test_concurrency_interleavings.py:39 (a staged group's WAL
  barrier before the memtable switch), on the port; the flush and
  compaction seams.

Tolerance: none.
"""

import ast
import os
import re
import subprocess
import sys
import threading
import time
import warnings

import pytest

import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.options as ref_opts
import toplingdb_tpu.utils.slo  # noqa: F401  (imported before debug mode)
import toplingdb_tpu.utils.thread_status  # noqa: F401  (see the docstring)
import toplingdb_tpu.utils.trace  # noqa: F401
from toplingdb_tpu.utils import concurrency as ref_ccy
from toplingdb_tpu.utils import statistics as ref_st

import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.options as opts_mod
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.options import FlushOptions, Options, WriteOptions
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.sync_point import get_sync_point_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(REPO, "toplingdb_tpu")
PORT_PKG = os.path.join(REPO, "toplingdb_tpu_torch")

# Port-only sites that make a `threading` primitive directly: neither has
# a counterpart in toplingdb_tpu, and neither is taken under another lock.
RAW_SITES = {
    "ops/kernels.py": "the CUDA sources' build lock (a leaf)",
    "compaction/executor.py": "the device factory's job log (a leaf)",
    "utils/concurrency.py": "the plane's own infrastructure locks",
}


@pytest.fixture
def no_thread_leaks():
    """The test leaves no thread of the port's registry behind."""
    before = {id(t) for t in ccy.registry.live()}
    yield
    leaked = [t.name for t in ccy.registry.live() if id(t) not in before]
    assert not leaked, f"test leaked registered threads: {leaked}"


@pytest.fixture
def debug_locks():
    for c in (ccy, ref_ccy):
        c.reset_lock_graph()
        c.set_debug(True)
    yield
    for c in (ccy, ref_ccy):
        c.set_debug(False)
        c.reset_lock_graph()
        c.set_watchdog_ms(30000)
        c.set_watchdog_handler(None)


@pytest.fixture
def sync_points():
    reg = get_sync_point_registry()
    reg.clear_all()
    yield reg
    reg.clear_all()


def _port(**kw):
    kw.setdefault("create_if_missing", True)
    kw.setdefault("compaction_executor_factory",
                  DeviceCompactionExecutorFactory(device="cpu"))
    return Options(**kw)


# ---------------------------------------------------------------------------
# Lock classes
# ---------------------------------------------------------------------------

_FACTORY = re.compile(r'ccy\.(Lock|RLock|Condition)\(\s*(?:f?"([^"]+)")')


def _classes(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.ClassDef, ast.FunctionDef))}


def _named_sites(path):
    with open(path) as f:
        return {(m.group(1), m.group(2)) for m in _FACTORY.finditer(f.read())}


# Reference lock classes whose owner the port has only as a refusal
# (none since ChipPool was ported).
NOT_MADE: dict[str, str] = {}


def test_reference_lock_classes_made_the_same_way():
    checked = 0
    for dirpath, _, names in os.walk(REF_PKG):
        for n in names:
            if not n.endswith(".py"):
                continue
            ref_path = os.path.join(dirpath, n)
            rel = os.path.relpath(ref_path, REF_PKG)
            port_path = os.path.join(PORT_PKG, rel)
            if not os.path.exists(port_path) or rel == "utils/concurrency.py":
                continue
            port_sites = _named_sites(port_path)
            port_defs = _classes(port_path)
            for kind, name in _named_sites(ref_path):
                # "module.Class.attr" / "module.func.local" / "module.attr":
                # required where the port defines the class or function.
                parts = name.split(".")
                owner = parts[1] if len(parts) > 2 else None
                if (owner is not None and owner not in port_defs) \
                        or name in NOT_MADE:
                    continue
                assert (kind, name) in port_sites, (rel, kind, name)
                checked += 1
    assert checked >= 40
    # Every Condition over an existing lock shares its class.
    with open(os.path.join(PORT_PKG, "db/db.py")) as f:
        src = f.read()
    assert "self._mt_cv = ccy.Condition(lock=self._mutex)" in src


def test_no_raw_threading_primitives_outside_named_sites():
    pat = re.compile(r"threading\.(Lock|RLock|Condition|Thread)\(")
    for dirpath, _, names in os.walk(PORT_PKG):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            rel = os.path.relpath(path, PORT_PKG)
            with open(path) as f:
                hits = [ln for ln in f if pat.search(ln)
                        and not ln.lstrip().startswith("#")]
            if rel in RAW_SITES:
                continue
            assert not hits, (rel, hits)


def test_production_mode_is_plain_threading():
    assert not ccy.lock_debug_enabled()
    assert type(ccy.Lock("t.a")) is type(threading.Lock())
    assert type(ccy.RLock("t.b")) is type(threading.RLock())
    cv = ccy.Condition("t.c")
    assert type(cv) is threading.Condition
    assert type(cv._lock) is type(threading.RLock())  # threading's default
    with pytest.raises(TypeError):
        ccy.Condition()


def test_environment_does_not_turn_debug_on():
    code = ("from toplingdb_tpu_torch.utils import concurrency as c\n"
            "print(c.lock_debug_enabled(), c._WATCHDOG_MS,\n"
            "      type(c.Lock('x')).__name__)\n")
    env = dict(os.environ, PYTHONPATH=REPO, TPULSM_LOCK_DEBUG="1",
               TPULSM_LOCK_WATCHDOG_MS="5")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "30000.0", "lock"]
    with open(os.path.join(PORT_PKG, "utils/concurrency.py")) as f:
        assert "os.environ" not in f.read()


# ---------------------------------------------------------------------------
# Lock order against the reference
# ---------------------------------------------------------------------------


def _smoke(DB, opts, path, flush_opts):                # test_concurrency:364
    db = DB.open(path, opts)
    try:
        for i in range(200):
            db.put(b"k%04d" % i, b"v%d" % i)
        assert db.get(b"k0000") == b"v0"
        db.flush(flush_opts)
        assert db.get(b"k0150") == b"v150"
    finally:
        db.close()


def _wide(DB, opts, path, flush_opts):
    db = DB.open(path, opts)
    try:
        db.start_trace(path + ".trace")
        for i in range(3000):
            db.put(b"k%05d" % i, b"v%d" % i * 5)
        db.get(b"k00001")
        db.multi_get([b"k00001", b"k00002"])
        it = db.new_iterator()
        it.seek(b"k00100")
        it.next()
        db.flush(flush_opts)
        db.compact_range()
        db.wait_for_compactions()
        # No explicit scrub() beside the 0.05 s scrubber: toplingdb_tpu's
        # concurrent passes share one AsyncIORing slot and the second
        # pass's close() meets None (db/integrity.py:171-173).
        db.end_trace()
    finally:
        db.close()


@pytest.mark.parametrize("workload", ["smoke", "wide"])
def test_lock_order_edges_match_reference(tmp_path, debug_locks, workload):
    if workload == "smoke":
        ref_o = ref_opts.Options(create_if_missing=True)
        port_o = Options(create_if_missing=True,
                         compaction_executor_factory=(
                             LocalCompactionExecutorFactory()))
        run = _smoke
    else:
        kw = dict(create_if_missing=True, write_buffer_size=64 << 10,
                  enable_pipelined_write=True, enable_async_wal=True,
                  integrity_scrub_period_sec=0.05,
                  level0_file_num_compaction_trigger=2,
                  slo_specs=({"name": "g", "kind": "latency"},),
                  slo_eval_period_sec=0.02)
        ref_o = ref_opts.Options(statistics=ref_st.Statistics(), **kw)
        port_o = Options(statistics=st.Statistics(),
                         compaction_executor_factory=(
                             LocalCompactionExecutorFactory()), **kw)
        run = _wide
    run(ref_dbm.DB, ref_o, str(tmp_path / "ref"), ref_opts.FlushOptions())
    run(dbm.DB, port_o, str(tmp_path / "port"), FlushOptions())
    ref_edges = set(ref_ccy.lock_order_edges())
    port_edges = set(ccy.lock_order_edges())
    assert ref_edges, "the reference recorded no edge"
    assert port_edges == ref_edges
    assert ("db.DB._mutex", "version_set.VersionSet._lock") in port_edges


def _acyclic(edges) -> bool:
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    state = {}

    def visit(n):
        if state.get(n) == 1:
            return False
        if state.get(n) == 2:
            return True
        state[n] = 1
        ok = all(visit(m) for m in adj.get(n, ()))
        state[n] = 2
        return ok

    return all(visit(n) for n in list(adj))


def test_debug_mode_keeps_the_native_plane_and_device_jobs(
        tmp_path, debug_locks, no_thread_leaks):
    """Debug wrappers on every lock the DB makes, with 4 writers on the
    native write plane, the async WAL, the scrubber, auto compactions on
    the device executor ("cpu"): no inversion, every group a native
    commit, an acyclic graph, and no lock still held at the end."""
    stats = st.Statistics()
    db = dbm.DB.open(str(tmp_path / "db"), _port(
        statistics=stats, write_buffer_size=128 << 10,
        level0_file_num_compaction_trigger=2, enable_async_wal=True,
        integrity_scrub_period_sec=0.05))
    assert type(db._mutex).__name__ == "_DebugRLock"
    errs = []

    def writer(t):
        try:
            for i in range(0, 4000, 50):
                from toplingdb_tpu_torch.db.write_batch import WriteBatch

                b = WriteBatch()
                for j in range(i, i + 50):
                    b.put(b"w%d-%06d" % (t, j), b"x" * 20)
                db.write(b)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ths = [threading.Thread(target=writer, args=(t,), name=f"w{t}")
           for t in range(4)]
    try:
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert not errs, errs
        db.flush()
        db.wait_for_compactions()
        db.scrub()
        t = stats.tickers()
        assert t[st.WRITE_GROUP_NATIVE_COMMITS] == t[st.WRITE_GROUP_LED] > 0
        assert db.options.compaction_executor_factory.jobs
        assert db.get(b"w3-003999") == b"x" * 20
    finally:
        db.close()
    edges = ccy.lock_order_edges()
    assert edges and _acyclic(edges)
    assert ccy.scan_long_holds(threshold_ms=0) == []
    assert ccy.registry.check_leaks(owner=db) == []


# ---------------------------------------------------------------------------
# tests/test_concurrency.py:223-364 on the port
# ---------------------------------------------------------------------------


def test_induced_inversion_raises_with_both_stacks(debug_locks):     # :223
    a = ccy.Lock("test.inv.A")
    b = ccy.Lock("test.inv.B")
    with a:
        with b:
            pass
    assert ("test.inv.A", "test.inv.B") in ccy.lock_order_edges()
    with pytest.raises(ccy.LockInversionError) as ei:
        with b:
            with a:
                pass
    msg = str(ei.value)
    assert "test.inv.A" in msg and "test.inv.B" in msg
    assert "acquiring stack" in msg and "witness" in msg
    assert msg.count("test_torch_concurrency.py") >= 2
    assert ccy.held_lock_classes() == []
    with a:
        pass


def test_transitive_inversion_detected(debug_locks):                 # :248
    a, b, c = (ccy.Lock("test.tri.A"), ccy.Lock("test.tri.B"),
               ccy.Lock("test.tri.C"))
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(ccy.LockInversionError) as ei:
        with c:
            with a:
                pass
    assert "test.tri.A -> test.tri.B" in str(ei.value)
    assert "test.tri.B -> test.tri.C" in str(ei.value)


def test_watchdog_reports_long_hold(debug_locks):                    # :266
    calls = []
    ccy.set_watchdog_ms(10)
    ccy.set_watchdog_handler(
        lambda cls, held_s, stack: calls.append((cls, held_s, stack)))
    lk = ccy.Lock("test.wd.slow")
    with lk:
        time.sleep(0.05)
    assert calls, "watchdog did not fire"
    cls, held_s, stack = calls[0]
    assert cls == "test.wd.slow" and held_s >= 0.01
    assert "test_torch_concurrency.py" in stack


def test_scan_long_holds_finds_wedged_holder(debug_locks):           # :281
    ccy.set_watchdog_handler(lambda *a: None)
    lk = ccy.Lock("test.wd.wedged")
    lk.acquire()
    try:
        time.sleep(0.03)
        hits = [e for e in ccy.scan_long_holds(threshold_ms=10)
                if e["lock_class"] == "test.wd.wedged"]
        assert hits and hits[0]["held_s"] >= 0.01
        assert "test_torch_concurrency.py" in hits[0]["holder_stack"]
    finally:
        lk.release()
    assert not [e for e in ccy.scan_long_holds(threshold_ms=10)
                if e["lock_class"] == "test.wd.wedged"]


def test_condition_over_wrapper_keeps_held_set_honest(debug_locks):  # :298
    cv = ccy.Condition("test.cv.C")
    with cv:
        assert ccy.held_lock_classes() == ["test.cv.C"]
        cv.wait(timeout=0.01)
        assert ccy.held_lock_classes() == ["test.cv.C"]
    assert ccy.held_lock_classes() == []
    mu = ccy.RLock("test.cv.R")
    cv2 = ccy.Condition(lock=mu)
    with mu:
        with mu:
            cv2.wait(timeout=0.01)  # a re-entered RLock round trip
            assert ccy.held_lock_classes() == ["test.cv.R"]
    assert ccy.held_lock_classes() == []


def test_rlock_reentry_is_not_an_edge(debug_locks):                  # :307
    lk = ccy.RLock("test.re.R")
    with lk:
        with lk:
            pass
    assert ccy.held_lock_classes() == []
    assert ("test.re.R", "test.re.R") not in ccy.lock_order_edges()


def test_registry_rejects_unnamed_thread():                          # :321
    t = threading.Thread(target=lambda: None)
    with pytest.raises(ValueError, match="unnamed"):
        ccy.registry.register(t)


def test_registry_catches_and_stops_leaked_thread():                 # :327
    owner = object()
    stop_ev = threading.Event()
    ccy.spawn("test-leaky", stop_ev.wait, owner=owner, stop=stop_ev.set)
    assert ccy.registry.check_leaks(owner=owner) == ["test-leaky"]
    assert ccy.registry.stop_all(owner=owner) == []
    assert ccy.registry.check_leaks(owner=owner) == []


def test_db_close_warns_on_unstopped_thread(tmp_path, monkeypatch):  # :336
    orig = ccy.registry.join_all
    monkeypatch.setattr(
        ccy.registry, "join_all",
        lambda owner=None, timeout=5.0: orig(owner=owner, timeout=0.2))
    db = dbm.DB.open(str(tmp_path / "db"), _port())
    ev = threading.Event()
    ccy.spawn("test-scrubber", ev.wait, owner=db)
    try:
        with pytest.warns(RuntimeWarning, match="leaked threads.*scrubber"):
            db.close()
    finally:
        ev.set()


def test_clean_open_write_close_leaves_no_threads(tmp_path,
                                                  no_thread_leaks):  # :353
    db = dbm.DB.open(str(tmp_path / "db"), _port(
        integrity_scrub_period_sec=0.05, enable_async_wal=True))
    for i in range(100):
        db.put(b"k%03d" % i, b"v%d" % i)
    db.flush(FlushOptions())
    assert ccy.registry.check_leaks(owner=db) == ["tpt-integrity-scrubber"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        db.close()
    assert not [w for w in caught if "leaked threads" in str(w.message)]
    assert ccy.registry.check_leaks(owner=db) == []


def test_db_smoke_under_lock_debug(tmp_path, debug_locks):           # :364
    _smoke(dbm.DB, _port(), str(tmp_path / "db"), FlushOptions())
    assert ccy.lock_order_edges(), "debug layer recorded no edges"


# ---------------------------------------------------------------------------
# Sync points: tests/test_concurrency_interleavings.py:39 and the seams
# ---------------------------------------------------------------------------


def test_wal_barrier_vs_memtable_switch(tmp_path, sync_points):      # :39
    """Forced order: a pipelined group reaches its async-WAL barrier,
    THEN the flush's memtable switch may start. The switch closes the
    group's WAL; every acknowledged write survives a reopen."""
    reg = sync_points
    db = dbm.DB.open(str(tmp_path / "db"), _port(
        enable_pipelined_write=True, enable_async_wal=True))
    at_barrier = threading.Event()
    reg.set_callback("DBImpl::GroupCommit:BeforeWALBarrier",
                     lambda _arg: at_barrier.set())
    reg.load_dependency([("DBImpl::GroupCommit:BeforeWALBarrier",
                          "DBImpl::SwitchMemtable:Start")])
    reg.enable_processing()
    err = []

    def writer():
        try:
            for i in range(50):
                db.put(b"k%04d" % i, b"v%d" % i,
                       WriteOptions(sync=(i % 7 == 0)))
        except BaseException as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=writer, name="interleave-writer")
    t.start()
    assert at_barrier.wait(timeout=30.0), "no group reached the barrier"
    db.flush(FlushOptions())
    t.join(timeout=30.0)
    assert not t.is_alive() and not err, err
    reg.clear_all()
    db.close()
    db2 = dbm.DB.open(str(tmp_path / "db"), _port())
    try:
        for i in range(50):
            assert db2.get(b"k%04d" % i) == b"v%d" % i
    finally:
        db2.close()


@pytest.mark.parametrize("plane", ["native", "python"])
def test_barrier_seam_on_both_commit_paths(tmp_path, sync_points, plane):
    """The group commit's barrier seam fires on the native plane's commit
    and on the Python commit alike (the async WAL's barrier)."""
    reg = sync_points
    hits = []
    reg.set_callback("DBImpl::GroupCommit:BeforeWALBarrier", hits.append)
    reg.enable_processing()
    stats = st.Statistics()
    with dbm.DB.open(str(tmp_path / "db"), _port(
            enable_async_wal=True, statistics=stats),
            write_plane=(plane == "native")) as db:
        for i in range(10):
            db.put(b"k%d" % i, b"v")
    assert len(hits) == 10
    native = stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS)
    assert (native == 10) == (plane == "native")


def test_flush_and_compaction_seams(tmp_path, sync_points):
    reg = sync_points
    seen = []
    reg.set_callback("FlushJob::Start", lambda _a: seen.append("flush"))
    reg.set_callback("DBImpl::SwitchMemtable:Start",
                     lambda _a: seen.append("switch"))
    reg.set_callback("CompactionJob::BeforeInstall",
                     lambda c: seen.append(("install", c.level,
                                            c.output_level)))
    reg.enable_processing()
    with dbm.DB.open(str(tmp_path / "db"), _port(
            disable_auto_compactions=True)) as db:
        for r in range(2):
            for i in range(100):
                db.put(b"k%04d" % i, b"v%d" % r)
            db.flush()
        db.compact_range()
        reg.disable_processing()
    assert seen[:4] == ["switch", "flush", "switch", "flush"]
    assert ("install", 0, 1) in seen
