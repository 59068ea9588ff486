"""Distributed compaction from the port's DB (compaction/executor.py's
SubprocessCompactionExecutor, compaction/dcompact_service.py,
compaction/resilience.py) against toplingdb_tpu's, on the CPU.

- the resilience classes whose outputs are deterministic (breaker
  lifecycle, health pick, seeded backoff, the options' config round trip,
  the injector's plan sequence, the orphan sweep) held against the
  reference's classes on the same inputs, and the worker's heartbeat;
- byte parity: the port's DB through its in-process HTTP service and
  through its subprocess worker, both on "cpu-jax", against the reference's
  DB through the reference's transports on the same writes: live SST bytes
  by file number, level file sets and WAL bytes; the mirrors of
  tests/test_device_compaction.py:181 and :291 ride on the same runs;
- the chaos matrix (mirror of tests/test_fault_soak.py:141 and :179):
  every faulted run is byte-identical to its fault-free twin, with the
  reference's DCOMPACTION_ATTEMPTS / RETRIES under the same schedule;
- no fallback: a dead worker, every circuit open; a store no worker can
  reopen sends a job down the path mode;
- an orphaned job dir swept on open, and the job re-run.

`time.time()` is frozen (as tests/test_fault_soak.py freezes it) so the
tables' creation_time is equal across runs and packages; lease and
heartbeat ages use file mtimes. Every service binds port 0. Tolerance:
bytes equal.
"""

import json
import os
import random
import time
import types

import pytest

import toplingdb_tpu.compaction.dcompact_service as ref_svc
import toplingdb_tpu.compaction.executor as ref_ex
import toplingdb_tpu.compaction.resilience as ref_res
import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.options as ref_opts
import toplingdb_tpu.utils.listener as ref_listener
import toplingdb_tpu.utils.statistics as ref_st

import toplingdb_tpu_torch.compaction.dcompact_service as svc_mod
import toplingdb_tpu_torch.compaction.executor as ex
import toplingdb_tpu_torch.compaction.resilience as res
import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.options as opts_mod
import toplingdb_tpu_torch.utils.listener as listener
import toplingdb_tpu_torch.utils.statistics as st
from toplingdb_tpu_torch.utils.status import IOError_

FROZEN_TIME = 1_700_000_000.0

REF = types.SimpleNamespace(
    name="ref", DB=ref_dbm.DB, Options=ref_opts.Options, st=ref_st,
    res=ref_res, Service=ref_svc.DcompactWorkerService,
    Http=ref_svc.HttpCompactionExecutorFactory,
    Sub=ref_ex.SubprocessCompactionExecutorFactory,
    listener=ref_listener)
PORT = types.SimpleNamespace(
    name="port", DB=dbm.DB, Options=opts_mod.Options, st=st, res=res,
    Service=svc_mod.DcompactWorkerService,
    Http=svc_mod.HttpCompactionExecutorFactory,
    Sub=ex.SubprocessCompactionExecutorFactory, listener=listener)


def _freeze_time(mp):
    mp.setattr(time, "time", lambda: FROZEN_TIME)


@pytest.fixture
def frozen(monkeypatch):
    _freeze_time(monkeypatch)


def _policy(pkg, **kw):
    base = dict(max_attempts=3, backoff_base=0.005, backoff_jitter=0.1,
                attempt_timeout=120.0, breaker_failure_threshold=2,
                breaker_reset_timeout=0.15, lease_sec=5.0)
    base.update(kw)
    if pkg is REF:
        base.setdefault("local_pin_failures", 10 ** 6)
    return pkg.res.DcompactOptions(**base)


def _factory(pkg, transport, url=None, **kw):
    """The package's transport on "cpu-jax"; the reference's never falls
    back (the port has no fallback to turn off)."""
    if pkg is REF:
        kw["allow_fallback"] = False
    if transport == "http":
        return pkg.Http([url], device="cpu-jax", **kw)
    return pkg.Sub(device="cpu-jax", **kw)


def _snapshot(db):
    """Live SST bytes by file number, the level file sets and the WAL
    bytes of one DB."""
    v = db.versions.current
    levels = [[(f.number, f.smallest, f.largest, f.smallest_seqno,
                f.largest_seqno, f.num_entries) for f in v.files[lvl]]
              for lvl in range(v.num_levels)]
    ssts = {}
    for lvl in v.files:
        for f in lvl:
            with open(os.path.join(db.dbname, "%06d.sst" % f.number),
                      "rb") as fh:
                ssts[f.number] = fh.read()
    wals = {}
    for name in os.listdir(db.dbname):
        if name.endswith(".log"):
            with open(os.path.join(db.dbname, name), "rb") as fh:
                wals[name] = fh.read()
    return levels, ssts, wals


def _workload(pkg, root, factory, stats, policy=None):
    """tests/test_fault_soak.py's matrix workload: 1600 overwrites of 500
    keys, a flush every 400, then compact_range (one remote L0->L1 job,
    then trivial moves). Returns the snapshot; the DB stays correct. The
    write buffer is never filled: a flush on memory use would cut where
    the skiplist's random node heights put it, and those depend on what
    ran before in the process."""
    opts = pkg.Options(write_buffer_size=1 << 20,
                       disable_auto_compactions=True,
                       compaction_executor_factory=factory, statistics=stats,
                       dcompact=policy or getattr(factory, "policy", None))
    db = pkg.DB.open(root, opts)
    try:
        model = {}
        for i in range(1600):
            k = b"mk%05d" % (i % 500)
            v = b"mv%07d" % i
            db.put(k, v)
            model[k] = v
            if i % 400 == 399:
                db.flush()
        db.flush()
        db.compact_range()
        assert db._bg_error is None
        bad = [k for k, v in model.items() if db.get(k) != v]
        assert not bad, bad[:3]
        v = db.versions.current
        assert sum(f.num_entries for lvl in v.files for f in lvl) == 500
        return _snapshot(db)
    finally:
        db.close()


def _dcompact_leftovers(root):
    out = []
    for r, _d, fs in os.walk(os.path.join(root, "dcompact")):
        out += [os.path.join(r, f) for f in fs]
    return out


def _attempt_counts(stats, pkg):
    t = stats.tickers()
    s = pkg.st
    return (t.get(s.DCOMPACTION_ATTEMPTS, 0), t.get(s.DCOMPACTION_RETRIES, 0),
            t.get(s.DCOMPACTION_JOB_FAILURES, 0),
            t.get(s.DCOMPACTION_FALLBACK_LOCAL, 0))


class _Services:
    """One in-process "cpu-jax" worker service per package."""

    def __init__(self):
        self.ref = ref_svc.DcompactWorkerService(device="cpu-jax")
        self.port = svc_mod.DcompactWorkerService(device="cpu-jax")
        self.urls = {
            "ref": f"http://127.0.0.1:{self.ref.start()}",
            "port": f"http://127.0.0.1:{self.port.start()}",
        }

    def stop(self):
        self.ref.stop()
        self.port.stop()


@pytest.fixture(scope="module")
def services():
    s = _Services()
    yield s
    s.stop()


@pytest.fixture(scope="module")
def clean_twin(tmp_path_factory, services):
    """The port's fault-free run over HTTP, the twin of every faulted run,
    with its statistics."""
    with pytest.MonkeyPatch.context() as mp:
        _freeze_time(mp)
        stats = st.Statistics()
        snap = _workload(
            PORT, str(tmp_path_factory.mktemp("clean") / "db"),
            _factory(PORT, "http", services.urls["port"],
                     policy=_policy(PORT)), stats)
    return snap, stats


# ---------------------------------------------------------------------------
# The resilience classes against the reference's
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_circuit_breaker_lifecycle_matches_reference():
    trace = {}
    for pkg in (REF, PORT):
        clk = FakeClock()
        b = pkg.res.CircuitBreaker(failure_threshold=3, reset_timeout=10.0,
                                   clock=clk)
        steps = []
        ops = (["allow", "fail", "fail", "allow", "fail", "allow",
                ("t", 9.0), "allow", ("t", 2.0), "allow", "allow", "ok",
                "allow", "fail", "fail", "fail", ("t", 11.0), "allow",
                "fail", "allow"])
        for op in ops:
            if isinstance(op, tuple):
                clk.t += op[1]
                continue
            r = {"allow": b.allow, "fail": b.on_failure,
                 "ok": b.on_success}[op]()
            steps.append((op, r, b.state, b.consecutive_failures))
        trace[pkg.name] = steps
    assert trace["port"] == trace["ref"]
    assert trace["port"][-1][2] == "open"


def test_health_registry_pick_matches_reference():
    urls = ["http://a", "http://b", "http://c"]
    trace = {}
    for pkg in (REF, PORT):
        clk = FakeClock()
        pol = _policy(pkg, breaker_failure_threshold=1,
                      breaker_reset_timeout=60.0)
        reg = pkg.res.WorkerHealthRegistry(pol, clock=clk)
        seen = []
        reg.observers.append(lambda *a, seen=seen: seen.append(a))
        picks = [reg.pick(urls) for _ in range(3)]
        reg.record_failure("http://b")
        picks += [reg.pick(urls) for _ in range(6)]
        reg.record_failure("http://a")
        reg.record_failure("http://c")
        picks.append(reg.pick(urls))
        clk.t += 61.0
        picks.append(reg.pick(urls))
        reg.record_success(picks[-1])
        trace[pkg.name] = (picks, reg.skipped_open, reg.snapshot(), seen)
    assert trace["port"] == trace["ref"]
    assert trace["port"][0][9] is None  # every circuit open


def test_seeded_backoff_matches_reference():
    delays = {}
    for pkg in (REF, PORT):
        pol = _policy(pkg, backoff_base=0.1, backoff_multiplier=2.0,
                      backoff_jitter=0.5)
        rng = random.Random(7)
        delays[pkg.name] = [pol.backoff_delay(i, rng)
                            for i in (1, 2, 3) for _ in range(20)]
        assert _policy(pkg, backoff_base=0.1, backoff_jitter=0.0
                       ).backoff_delay(3) == pytest.approx(0.4)
    assert delays["port"] == delays["ref"]
    for j, d in enumerate(delays["port"]):
        nominal = 0.1 * 2.0 ** (j // 20)
        assert 0.5 * nominal <= d <= 1.5 * nominal


def test_dcompact_options_round_trip_matches_reference():
    cfg = {"max_attempts": 5, "backoff_base": 0.01, "lease_sec": 7.5,
           "breaker_failure_threshold": 2, "attempt_timeout": 9.0,
           "job_deadline": 4.0, "breaker_reset_timeout": 3.0}
    for pkg in (REF, PORT):
        o = pkg.res.DcompactOptions.from_config(cfg)
        assert o.to_config() == cfg
        assert pkg.res.DcompactOptions.from_config({}).to_config() == {}
    ref_fields = {f for f in ref_res.DcompactOptions.__dataclass_fields__}
    port_fields = set(res.DcompactOptions.__dataclass_fields__)
    # Every field but the local pin gate's (not ported: no job falls back).
    assert ref_fields - port_fields == {"local_pin_failures",
                                        "local_pin_cooldown"}
    assert port_fields <= ref_fields
    for name in port_fields:
        assert getattr(res.DcompactOptions(), name) == \
            getattr(ref_res.DcompactOptions(), name)


@pytest.mark.parametrize("seed", [0, 42])
def test_fault_injector_plan_sequence_matches_reference(seed):
    seqs = {}
    for pkg in (REF, PORT):
        inj = pkg.res.DcompactFaultInjector(
            schedule={3: "kill", (5, 1): "corrupt"}, rate=0.4,
            plans=("drop", "truncate", "delay"), seed=seed)
        seq = [inj.plan(j, a) for j in range(12) for a in range(2)]
        seqs[pkg.name] = (seq, inj.injected, inj.injected_counts())
    assert seqs["port"] == seqs["ref"]
    assert "kill" in seqs["port"][0] and None in seqs["port"][0]


def _make_orphan(job_root, job_id=42, attempt=0, age=300.0):
    """The on-disk state a kill -9'd worker leaves behind: params, lease,
    a stale heartbeat and a partial output SST."""
    att = os.path.join(job_root, f"job-{job_id:05d}", f"att-{attempt:02d}")
    os.makedirs(os.path.join(att, "out"), exist_ok=True)
    with open(os.path.join(att, "params.json"), "w") as f:
        json.dump({"job_id": job_id, "attempt": attempt}, f)
    with open(os.path.join(att, "lease.json"), "w") as f:
        json.dump({"job_id": job_id, "lease_sec": 5.0}, f)
    with open(os.path.join(att, "heartbeat"), "w") as f:
        f.write("9999 0.0\n")
    with open(os.path.join(att, "out", "000001.sst"), "wb") as f:
        f.write(b"\x00" * 512)
    old = time.time() - age
    for name in ("params.json", "lease.json", "heartbeat"):
        os.utime(os.path.join(att, name), (old, old))
    os.utime(att, (old, old))
    return att


def test_sweep_orphan_jobs_matches_reference(tmp_path):
    result = {}
    for pkg in (REF, PORT):
        root = str(tmp_path / pkg.name / "dcompact")
        dead = _make_orphan(root, job_id=1, age=300.0)
        _make_orphan(root, job_id=1, attempt=1, age=400.0)
        live = _make_orphan(root, job_id=2, age=0.0)
        _make_orphan(root, job_id=3, age=0.0)
        _make_orphan(root, job_id=3, attempt=1, age=900.0)
        stats = pkg.st.Statistics()
        lines = []
        swept = pkg.res.sweep_orphan_jobs(
            root, lease_sec=30.0, statistics=stats,
            event_logger=pkg.listener.EventLogger(lines.append))
        assert not os.path.exists(dead) and os.path.exists(live)
        assert pkg.res.sweep_orphan_jobs(root, lease_sec=30.0) == []
        result[pkg.name] = (
            [os.path.relpath(p, root) for p in swept],
            sorted(os.path.relpath(os.path.join(r, f), root)
                   for r, _d, fs in os.walk(root) for f in fs),
            stats.tickers(),
            [json.loads(line)["event"] for line in lines])
    assert result["port"] == result["ref"]
    assert result["port"][2] == {"dcompaction.orphans.swept": 3}


def test_worker_heartbeats_while_running(tmp_path):
    hb = res.HeartbeatWriter(str(tmp_path), lease_sec=0.9)
    hb.start()
    p = os.path.join(str(tmp_path), "heartbeat")
    assert os.path.exists(p)
    m0 = os.path.getmtime(p)
    deadline = time.monotonic() + 3.0
    while os.path.getmtime(p) == m0 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert os.path.getmtime(p) > m0  # it beats
    hb.stop()
    m1 = os.path.getmtime(p)
    time.sleep(0.7)
    assert os.path.getmtime(p) == m1  # and stops cleanly
    assert not hb._thread.is_alive()


# ---------------------------------------------------------------------------
# Byte parity through both transports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["http", "subprocess"])
def test_transport_byte_parity_with_reference(tmp_path, frozen, services,
                                              transport):
    """Mirror of tests/test_device_compaction.py:291 (HTTP) and :181
    (subprocess, one worker process per package): the same writes through
    both DBs and their transports end in equal SST bytes by file number,
    level file sets and WAL bytes; every job ran remote and left no job
    dir behind."""
    snaps, stats = {}, {}
    for pkg in (REF, PORT):
        stats[pkg.name] = pkg.st.Statistics()
        root = str(tmp_path / pkg.name)
        snaps[pkg.name] = _workload(
            pkg, root, _factory(pkg, transport, services.urls[pkg.name],
                                policy=_policy(pkg)),
            stats[pkg.name])
        assert _dcompact_leftovers(root) == []
    levels, ssts, wals = snaps["port"]
    assert levels == snaps["ref"][0]
    assert sorted(ssts) == sorted(snaps["ref"][1])
    for num in ssts:
        assert ssts[num] == snaps["ref"][1][num], num
    assert wals == snaps["ref"][2] and wals
    assert _attempt_counts(stats["port"], PORT) == \
        _attempt_counts(stats["ref"], REF) == (1, 0, 0, 0)
    t = stats["port"].tickers()
    assert t[st.DCOMPACTION_READ_BYTES] == \
        stats["ref"].tickers()[ref_st.DCOMPACTION_READ_BYTES]
    assert t[st.DCOMPACTION_WRITE_BYTES] == \
        stats["ref"].tickers()[ref_st.DCOMPACTION_WRITE_BYTES]
    # Count-valued histograms (time is frozen, so their values are not).
    for name in (st.DCOMPACTION_TIME_MICROS, st.DCOMPACTION_ATTEMPT_MICROS,
                 st.COMPACTION_TIME_MICROS):
        assert stats["port"].get_histogram(name).count == \
            stats["ref"].get_histogram(name).count == 1, name


# ---------------------------------------------------------------------------
# Chaos
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", ["drop", "kill", "truncate", "corrupt",
                                  "delay"])
def test_chaos_matrix_byte_parity(tmp_path, frozen, services, clean_twin,
                                  plan):
    """Mirror of tests/test_fault_soak.py:141 over the HTTP transport: a
    dropped request, a worker killed mid-job, truncated or corrupted
    results, a delayed response. Each faulted run ends byte-identical to
    the fault-free twin, with the reference's attempt, retry and failure
    counts under the same schedule (delay alone succeeds first time)."""
    counts = {}
    for pkg in (REF, PORT):
        stats = pkg.st.Statistics()
        inj = pkg.res.DcompactFaultInjector(schedule={0: plan},
                                            delay_sec=0.05)
        root = str(tmp_path / pkg.name)
        snap = _workload(pkg, root, _factory(
            pkg, "http", services.urls[pkg.name], policy=_policy(pkg),
            fault_injector=inj), stats)
        assert inj.injected_counts() == {plan: 1}
        assert _dcompact_leftovers(root) == []
        counts[pkg.name] = _attempt_counts(stats, pkg)
        if pkg is PORT:
            assert snap == clean_twin[0], plan
    assert counts["port"] == counts["ref"]
    clean_attempts = _attempt_counts(clean_twin[1], PORT)[0]
    want = (clean_attempts, 0) if plan == "delay" else (clean_attempts + 1, 1)
    assert counts["port"] == want + (0, 0)


def test_kill_9_subprocess_worker_retries(tmp_path, frozen, clean_twin):
    """Mirror of tests/test_fault_soak.py:179: a REAL worker process dies
    mid-job (exit 137 after a partial output, heartbeat written, no
    results.json). The attempt dir is swept, the retry succeeds, the bytes
    equal the fault-free twin's, and the attempt counts equal the
    reference's under the same schedule (two worker processes per
    package)."""
    counts = {}
    for pkg in (REF, PORT):
        stats = pkg.st.Statistics()
        events = []

        class Watch(pkg.listener.EventListener):
            def on_dcompact_attempt(self, db, info):
                events.append((info.attempt, info.ok, info.will_retry,
                               "rc=137" in (info.error or "")))

        inj = pkg.res.DcompactFaultInjector(schedule={0: "kill"})
        root = str(tmp_path / pkg.name)
        opts = pkg.Options(
            write_buffer_size=1 << 20, disable_auto_compactions=True,
            compaction_executor_factory=_factory(
                pkg, "subprocess", policy=_policy(pkg), fault_injector=inj),
            statistics=stats, dcompact=_policy(pkg), listeners=[Watch()])
        db = pkg.DB.open(root, opts)
        try:
            for i in range(1600):
                db.put(b"mk%05d" % (i % 500), b"mv%07d" % i)
                if i % 400 == 399:
                    db.flush()
            db.flush()
            db.compact_range()
            assert db._bg_error is None
            snap = _snapshot(db)
        finally:
            db.close()
        assert inj.injected_counts() == {"kill": 1}
        assert events == [(0, False, True, True), (1, True, False, False)]
        assert _dcompact_leftovers(root) == []
        assert [d for d in os.listdir(os.path.join(root, "dcompact"))
                if d.startswith("job-")] == []
        counts[pkg.name] = _attempt_counts(stats, pkg)
        if pkg is PORT:
            assert snap == clean_twin[0]
    assert counts["port"] == counts["ref"] == (2, 1, 0, 0)


# ---------------------------------------------------------------------------
# No fallback
# ---------------------------------------------------------------------------


def test_dead_worker_raises_as_background_error(tmp_path):
    """A dead worker URL: the job's attempts fail, the job raises and
    becomes the DB's background error, listeners hear of it, no output SST
    is left, and every acknowledged write still reads back."""
    errors = []

    class Watch(listener.EventListener):
        def on_background_error(self, db, e):
            errors.append(e)

    stats = st.Statistics()
    policy = res.DcompactOptions(max_attempts=2, backoff_base=0.001)
    fac = svc_mod.HttpCompactionExecutorFactory(
        ["http://127.0.0.1:1"], device="cpu-jax", timeout=0.5, policy=policy)
    path = str(tmp_path / "db")
    db = dbm.DB.open(path, opts_mod.Options(
        write_buffer_size=1 << 20, level0_file_num_compaction_trigger=2,
        compaction_executor_factory=fac, statistics=stats, dcompact=policy,
        listeners=[Watch()]))
    try:
        model = {}
        for r in range(2):
            for i in range(300):
                k, v = b"k%05d" % (i * 2 + r), b"v%d-%d" % (r, i)
                db.put(k, v)
                model[k] = v
            db.flush()
        with pytest.raises(IOError_):
            db.wait_for_compactions()
        assert isinstance(db._compaction_scheduler.last_error, IOError_)
        assert errors == [db._bg_error]
        ssts = sorted(f for f in os.listdir(path) if f.endswith(".sst"))
        assert len(ssts) == 2  # the two flushes only
        assert _dcompact_leftovers(path) == []
        assert all(db.get(k) == v for k, v in model.items())
        with pytest.raises(IOError_):
            db.put(b"x", b"y")
        t = stats.tickers()
        assert (t[st.DCOMPACTION_ATTEMPTS], t[st.DCOMPACTION_RETRIES],
                t[st.DCOMPACTION_JOB_FAILURES]) == (2, 1, 1)
        assert t.get(st.DCOMPACTION_FALLBACK_LOCAL, 0) == 0
    finally:
        db.close()


def test_all_circuits_open_raises_without_timeout(tmp_path):
    """Every worker's breaker open: new_executor returns None and the job
    raises at once (DCOMPACTION_BREAKER_SKIPPED), in well under the
    transport timeout, without an attempt or a local run."""
    stats = st.Statistics()
    policy = res.DcompactOptions(breaker_failure_threshold=1,
                                 breaker_reset_timeout=600.0,
                                 attempt_timeout=30.0)
    fac = svc_mod.HttpCompactionExecutorFactory(
        ["http://worker-a", "http://worker-b"], device="cpu-jax",
        policy=policy)
    fac.health.record_failure("http://worker-a")
    fac.health.record_failure("http://worker-b")
    path = str(tmp_path / "db")
    db = dbm.DB.open(path, opts_mod.Options(
        disable_auto_compactions=True, compaction_executor_factory=fac,
        statistics=stats, dcompact=policy))
    try:
        for r in range(2):
            for i in range(100):
                db.put(b"k%05d" % (i * 2 + r), b"v")
            db.flush()
        before = sorted(os.listdir(path))
        t0 = time.monotonic()
        with pytest.raises(res.AllCircuitsOpen):
            db.compact_range()
        assert time.monotonic() - t0 < 5.0
        assert sorted(os.listdir(path)) == before
        t = stats.tickers()
        assert t[st.DCOMPACTION_BREAKER_SKIPPED] == 1
        assert t.get(st.DCOMPACTION_ATTEMPTS, 0) == 0
        assert db._compaction_scheduler.num_local_jobs == 0
    finally:
        db.close()


class _SharedStoreEnv:
    """An env whose tables publish to a shared store that no worker
    process can reopen: it has `publish_sst` and a store with neither a
    root path nor a URL."""

    def __init__(self, env):
        self._env = env
        self.store = object()
        self.published = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def publish_sst(self, path, meta):
        self.published.append(os.path.basename(path))


def test_store_spec_job_refused_before_any_file(tmp_path):
    """A store-mode dcompact job is no longer refused (storage/ is
    ported): a store no worker can reopen sends the job down the path
    mode, as toplingdb_tpu's _store_spec_of decides, so the job runs on
    its device and ships its outputs through the job dir; the install
    publishes them. tests/test_torch_storage.py holds a real store's job,
    which ships no SST byte."""
    from toplingdb_tpu_torch.env import default_env

    path = str(tmp_path / "db")
    env = _SharedStoreEnv(default_env())
    db = dbm.DB.open(path, opts_mod.Options(
        disable_auto_compactions=True, statistics=st.Statistics(),
        compaction_executor_factory=ex.SubprocessCompactionExecutorFactory(
            device="cpu-jax")), env=env)
    try:
        for r in range(2):
            db.put(b"k%d" % r, b"v")
            db.flush()
        assert len(env.published) == 2
        db.compact_range()
        live = [f for f in db.versions.current.all_files()]
        assert len(live) == 1 and live[0][0] == 6  # the last level
        assert env.published[-1] == "%06d.sst" % live[0][1].number
        assert db.stats.get_ticker_count(st.DCOMPACTION_ATTEMPTS) == 1
        jobs = os.path.join(path, "dcompact")
        assert not os.path.isdir(jobs) or not [
            d for d in os.listdir(jobs) if d.startswith("job-")]
        assert [db.get(b"k%d" % r) for r in range(2)] == [b"v", b"v"]
    finally:
        db.close()


@pytest.mark.parametrize("bad", ["tpu", "gpu", "cpu-torch"])
def test_transports_refuse_unknown_devices(bad):
    with pytest.raises(ValueError):
        ex.SubprocessCompactionExecutorFactory(device=bad)
    with pytest.raises(ValueError):
        svc_mod.HttpCompactionExecutorFactory(["http://x"], device=bad)
    with pytest.raises(ValueError):
        svc_mod.DcompactWorkerService(device=bad)


def test_defaults_name_the_card_and_refuse_chips():
    assert ex.SubprocessCompactionExecutorFactory().device == "cuda"
    assert svc_mod.HttpCompactionExecutorFactory(["http://x"]).device == \
        "cuda"
    assert svc_mod.DcompactWorkerService().device == "cuda"
    # Multi-card packing is ported (the mesh route): --chips no longer
    # refuses, and a grant of two cards names them as the job's mesh.
    svc = svc_mod.DcompactWorkerService(device="cpu-jax", chips=2)
    assert svc.pool.chips == ["chip:0", "chip:1"]
    assert svc.grant_devices(["chip:0", "chip:1"]) == ["cpu", "cpu"]
    assert svc_mod.DcompactWorkerService(chips=2).grant_devices(
        ["chip:1", "chip:0"]) == ["cuda:1", "cuda:0"]
    assert svc.grant_devices(["chip:1"]) is None
    pool = svc_mod.ChipPool(2)
    assert sorted(pool.admit()) == ["chip:0", "chip:1"]


# ---------------------------------------------------------------------------
# Orphans and the service surface
# ---------------------------------------------------------------------------


def test_orphaned_job_swept_on_open_and_job_reruns(tmp_path, services):
    """An orphaned attempt dir with an expired lease is swept on open
    (DCOMPACTION_ORPHANS_SWEPT, a `dcompact_orphan_swept` LOG line) and the
    compaction whose job died re-runs through the worker."""
    path = str(tmp_path / "db")
    db = dbm.DB.open(path, opts_mod.Options(
        write_buffer_size=1 << 14, disable_auto_compactions=True,
        compaction_executor_factory=ex.LocalCompactionExecutorFactory()))
    for i in range(1800):
        db.put(b"key%05d" % (i % 600), b"val%07d" % i)
        if i % 300 == 299:
            db.flush()
    db.flush()
    assert len(db.versions.current.files[0]) >= 2
    db.close()
    orphan = _make_orphan(os.path.join(path, "dcompact"), job_id=99942,
                          age=600.0)
    stats = st.Statistics()
    done0 = services.port.jobs_done
    db = dbm.DB.open(path, opts_mod.Options(
        write_buffer_size=1 << 14, level0_file_num_compaction_trigger=2,
        compaction_executor_factory=_factory(
            PORT, "http", services.urls["port"], policy=_policy(PORT)),
        statistics=stats, dcompact=_policy(PORT)))
    try:
        assert not os.path.exists(orphan)
        assert stats.get_ticker_count(st.DCOMPACTION_ORPHANS_SWEPT) == 1
        db.wait_for_compactions()
        assert services.port.jobs_done > done0
        assert db.get(b"key00599") == b"val%07d" % 1799
        assert len(db.versions.current.files[0]) < 2
        assert db._bg_error is None
    finally:
        db.close()
    with open(os.path.join(path, "LOG")) as f:
        events = [json.loads(line)["event"] for line in f]
    assert events[0] == "dcompact_orphan_swept"


def test_service_endpoints(services):
    import urllib.request

    url = services.urls["port"]
    stats = json.loads(urllib.request.urlopen(url + "/stats",
                                              timeout=10).read())
    assert stats["device"] == "cpu-jax" and stats["jobs_done"] >= 0
    assert json.loads(urllib.request.urlopen(
        url + "/health", timeout=10).read()) == {"ok": True,
                                                 "device": "cpu-jax"}
    body = urllib.request.urlopen(url + "/metrics", timeout=10).read()
    assert b'tpulsm_dcompact_jobs_done{device="cpu-jax"}' in body
    req = urllib.request.Request(url + "/dcompact", data=b"{}",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 500
