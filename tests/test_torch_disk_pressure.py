"""The storage-pressure plane of toplingdb_tpu_torch against toplingdb_tpu's,
on the CPU: Env.get_free_space, the SstFileManager (accounting, pressure
levels with hysteresis, preflight math, paced trash deletion with the
ratio bypass and accelerate_deletes), FaultInjectionEnv's disk budget
(torn short writes, refunds, ENOSPC), and the DB's wiring: live-file
tracking, the flush preflight's SOFT `no_space` latch with autonomous
recovery, the compaction preflight (amber first), resume() notifications,
SOFT -> HARD escalation with a single successor recovery thread, and the
disk-full soak.

- the cases of tests/test_disk_pressure.py at :63, :71, :83, :110, :139,
  :155, :189, :240, :288, :329, :360 and :475 run on each package (the
  port's DB with DeviceCompactionExecutorFactory(device="cpu"), the
  reference's with its device factory on "cpu-jax"), with what the
  reference's test asserts; each case's observations (latch reasons,
  severities, tickers, recovery notifications, counts) are equal across
  the packages. :360 runs under each package's lock-graph debug mode
  (utils/concurrency.set_debug), as the reference's does; :475 runs
  both its legs (the recovered primary, then a FollowerDB fed from its
  WAL stream through a LogShipper, which must read the merged oracle),
  and reports the port's WRITE_GROUP_NATIVE_COMMITS / _FALLBACKS under the
  fault env;
- the port alone: an ENOSPC inside a device job (a "*.sst" budget of
  FaultInjectionEnv) raises through the executor and latches SOFT
  no_space; the torn output is gone and its bytes refunded; once the
  budget grows the latch clears on its own, the job reruns on the same
  device executor (no host-path job), and its inputs leave the disk;
- a budgeted twin: the same writes through both DBs under
  max_allowed_space_usage until the flush preflight latches, the budget
  raised, both recover on their own, flush and compact_range on the
  device executors: level sets and SST bytes equal.

Tolerance: none.
"""

import os
import threading
import time

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.compaction.executor import (
    DeviceCompactionExecutorFactory as RefFactory,
)
from toplingdb_tpu.env import MemEnv as RefMemEnv
from toplingdb_tpu.env import PosixEnv as RefPosixEnv
from toplingdb_tpu.env.fault_injection import (
    FaultInjectionEnv as RefFaultInjectionEnv,
)
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import WriteOptions as RefWriteOptions
import toplingdb_tpu.replication as ref_repl
from toplingdb_tpu.utils import listener as ref_listener
from toplingdb_tpu.utils import statistics as ref_st
from toplingdb_tpu.utils import concurrency as ref_ccy
from toplingdb_tpu.utils import status as ref_status
from toplingdb_tpu.utils.rate_limiter import SstFileManager as RefSfm

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.env import MemEnv, PosixEnv
from toplingdb_tpu_torch.env.fault_injection import FaultInjectionEnv
from toplingdb_tpu_torch.options import Options, WriteOptions
import toplingdb_tpu_torch.replication as repl
from toplingdb_tpu_torch.utils import listener
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import status
from toplingdb_tpu_torch.utils.rate_limiter import SstFileManager

from test_torch_block_cache import no_thread_leaks  # noqa: F401


class Pkg:
    """One package's storage-pressure surface under the same names."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.MemEnv = RefMemEnv if ref else MemEnv
        self.PosixEnv = RefPosixEnv if ref else PosixEnv
        self.FaultInjectionEnv = (RefFaultInjectionEnv if ref
                                  else FaultInjectionEnv)
        self.SstFileManager = RefSfm if ref else SstFileManager
        self.st = ref_st if ref else st
        self.status = ref_status if ref else status
        self.listener = ref_listener if ref else listener
        self.WriteOptions = RefWriteOptions if ref else WriteOptions
        self.repl = ref_repl if ref else repl
        self.Options = RefOptions if ref else Options
        # The auto-recover thread's name.
        self.recover_thread = "db-auto-recover" if ref else "tpt-auto-recover"
        self.ccy = ref_ccy if ref else ccy

    def options(self, **kw):
        if self.ref:
            return RefOptions(compaction_executor_factory=RefFactory(
                device="cpu-jax"), **kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)


def _wait_until(cond, timeout=15.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _watch(p):
    class RecoveryWatch(p.listener.EventListener):
        def __init__(self):
            self.recovered = []
            self.pressure = []
            self.bg_errors = []

        def on_error_recovery_completed(self, db, info):
            self.recovered.append(info)

        def on_disk_pressure(self, db, info):
            self.pressure.append((info.prev_level, info.level))

        def on_background_error(self, db, e):
            self.bg_errors.append(e)

    return RecoveryWatch()


# ---------------------------------------------------------------------------
# The cases of tests/test_disk_pressure.py (line numbers of that file)
# ---------------------------------------------------------------------------


def sc_posix_free_space_real_and_unborn_paths(p, d, obs):           # :63
    env = p.PosixEnv()
    os.makedirs(d)
    free = env.get_free_space(d)
    assert 0 < free < (1 << 61)
    # A path that does not exist yet walks up to its closest live parent.
    assert env.get_free_space(os.path.join(d, "not", "yet", "made")) > 0
    obs.append(True)


def sc_mem_env_capacity_and_wrappers(p, d, obs):                    # :71
    env = p.MemEnv()
    obs.append(env.get_free_space("/x"))  # unlimited by default
    env.set_capacity(1000)
    env.write_file("/x/a", b"z" * 300)
    obs.append(env.get_free_space("/x"))
    fe = p.FaultInjectionEnv(env)
    obs.append(fe.get_free_space("/x"))  # passthrough
    fe.set_disk_budget("*", 100)
    obs.append(fe.get_free_space("/x"))  # the injected budget wins
    assert obs == [1 << 62, 700, 700, 100]


def sc_fault_env_budget_torn_write_refund_and_enospc(p, d, obs):    # :83
    env = p.MemEnv()
    fe = p.FaultInjectionEnv(env)
    fe.set_disk_budget("*", 10)
    f = fe.new_writable_file("/d/a")
    with pytest.raises(OSError) as ei:
        f.append(b"x" * 25)
    assert p.status.is_no_space(ei.value)
    obs.append(fe.enospc_injected)
    # Torn short write: the affordable prefix landed before the failure.
    obs.append(env.get_file_size("/d/a"))
    with pytest.raises(OSError):
        f.sync()  # fsync on a full disk fails too
    f.close()
    fe.delete_file("/d/a")  # refund
    obs.append(fe.disk_budget_remaining("*"))
    g = fe.new_writable_file("/d/b")
    g.append(b"y" * 8)
    g.sync()  # budget not exhausted: sync succeeds again
    g.close()
    obs.append(fe.disk_budget_remaining("*"))
    assert obs == [1, 10, 10, 2]


def sc_pressure_levels_and_hysteresis(p, d, obs):                   # :110
    stats = p.st.Statistics()
    m = p.SstFileManager(max_allowed_space_usage=1000, statistics=stats,
                         amber_free_ratio=0.10, red_free_ratio=0.05,
                         pressure_hysteresis=0.02)
    seen = []
    m.add_pressure_callback(lambda lvl, prev, info: seen.append(
        (prev, lvl, info["tracked_bytes"], round(info["free_fraction"], 6))))
    try:
        m.on_add_file("/x/a.sst", 850)
        levels = [m.poll()]
        m.on_add_file("/x/b.sst", 80)  # used 930: frac 0.07, amber
        levels.append(m.poll())
        m.on_add_file("/x/c.sst", 25)  # used 955: frac 0.045, red
        levels.append(m.poll())
        # De-escalation must CLEAR the threshold plus the hysteresis:
        # frac 0.06 is above red (0.05) but inside red + h (0.07).
        m.on_delete_file("/x/c.sst")
        m.on_file_size("/x/b.sst", 90)  # used 940: frac 0.06
        levels.append(m.poll())
        m.on_file_size("/x/b.sst", 20)  # used 870: frac 0.13, ok
        levels.append(m.poll())
        assert levels == ["ok", "amber", "red", "red", "ok"]
        assert [s[:2] for s in seen] == [("ok", "amber"), ("amber", "red"),
                                         ("red", "ok")]
        ticks = [stats.get_ticker_count(t) for t in (
            p.st.DISK_PRESSURE_TRANSITIONS, p.st.DISK_PRESSURE_POLLS,
            p.st.DISK_PRESSURE_POLLS_BAD)]
        assert ticks == [3, 5, 3]
        obs += [levels, seen, ticks, m.total_size()]
    finally:
        m.close()


def sc_preflight_math_reserves_flush_headroom(p, d, obs):           # :139
    m = p.SstFileManager(max_allowed_space_usage=1000,
                         flush_headroom_bytes=200,
                         compaction_buffer_size=100)
    try:
        m.on_add_file("/x/a.sst", 500)
        # Flushes may consume the headroom: the full budget applies.
        # Compactions must leave headroom + buffer (300) untouched.
        got = [m.check_flush(400), m.check_flush(600),
               m.check_compaction(200), m.check_compaction(300),
               m.has_headroom()]
        assert got == [True, False, True, False, True]
        obs.append(got)
    finally:
        m.close()


def sc_trash_ratio_bypass_and_accelerate(p, d, obs):                # :155
    env = p.MemEnv()
    for name in ("a", "b"):
        env.write_file(f"/db/{name}.sst", b"z" * 100)
    stats = p.st.Statistics()
    # 1 byte/sec: a paced delete of 100 bytes would sleep ~10s (capped).
    m = p.SstFileManager(bytes_per_sec_delete=1, max_trash_db_ratio=0.25,
                         env=env, path="/db", statistics=stats)
    try:
        m.on_add_file("/db/a.sst", 100)
        m.on_add_file("/db/b.sst", 100)
        t0 = time.monotonic()
        m.schedule_delete("/db/a.sst")  # trash 100 > 0.25 * 100 live
        assert _wait_until(lambda: not env.file_exists("/db/a.sst.trash"),
                           timeout=5.0)
        assert time.monotonic() - t0 < 5.0  # the ratio bypass skipped pacing
        assert not env.file_exists("/db/a.sst")
        # A paced delete wakes at once under accelerate_deletes().
        m.on_add_file("/db/big.sst", 100_000)  # the ratio no longer trips
        m.schedule_delete("/db/b.sst")
        m.accelerate_deletes()
        assert _wait_until(lambda: not env.file_exists("/db/b.sst.trash"),
                           timeout=5.0)
        obs += [stats.get_ticker_count(p.st.DISK_TRASH_BYTES_FREED),
                m.trash_size(), m.total_size(), env.get_children("/db")]
        assert obs[:2] == [200, 0]
    finally:
        m.close()


def sc_live_db_deletions_seen_by_manager(p, d, obs):                # :189
    stats = p.st.Statistics()
    db = p.DB.open(d, p.options(write_buffer_size=8 * 1024,
                                level0_file_num_compaction_trigger=2,
                                max_allowed_space_usage=1 << 30,
                                statistics=stats))
    try:
        assert db._sfm is not None and db._sfm_owned
        for i in range(400):
            db.put(b"k%04d" % (i % 120), b"v" * 64)
            if i % 100 == 99:
                db.flush()
        db.wait_for_compactions()
        db._sfm.wait_for_deletes()
        tracked = dict(db._sfm._tracked)
        assert tracked, "manager lost track of the live tree"
        # Every tracked file exists; every obsolete SST went through
        # schedule_delete (no stale entries for vanished files).
        for path in tracked:
            assert db.env.file_exists(path), f"stale tracked entry {path}"
        live = {f"{db.dbname}/{c}" for c in db.env.get_children(db.dbname)}
        sst_on_disk = {x for x in live if x.endswith(".sst")}
        sst_tracked = {x for x in tracked if x.endswith(".sst")}
        assert sst_tracked == sst_on_disk
        assert not any(x.endswith(".trash") for x in live)
        freed = stats.get_ticker_count(p.st.DISK_TRASH_BYTES_FREED)
        assert freed > 0
        obs += [bool(tracked), bool(sst_tracked), freed > 0]
    finally:
        db.close()


def sc_flush_preflight_latches_soft_and_auto_resumes(p, d, obs):    # :240
    stats = p.st.Statistics()
    watch = _watch(p)
    db = p.DB.open(d, p.options(write_buffer_size=8 * 1024,
                                disable_auto_compactions=True,
                                max_allowed_space_usage=24 * 1024,
                                flush_headroom_bytes=1,  # starve headroom
                                statistics=stats, listeners=[watch]))
    try:
        acked = {}
        latched = False
        for i in range(4000):
            k, v = b"k%05d" % i, b"v" * 120
            try:
                db.put(k, v)
                acked[k] = v
            except Exception as e:  # noqa: BLE001
                assert p.status.is_no_space(e), repr(e)
                latched = True
                break
            if db._bg_error is not None:
                latched = True
                break
        assert latched, "budget never tripped"
        assert _wait_until(lambda: db._bg_error is not None, timeout=5.0)
        # (How many writes fit varies with the skiplist's random node
        # heights, in both packages: not an observation.)
        obs += [db._bg_error_reason,
                db._bg_error_severity.name,
                type(db._bg_error).__name__]
        assert db._bg_error_reason == "no_space"
        assert db._bg_error_severity.name == "SOFT_ERROR"
        ticks = [stats.get_ticker_count(t) for t in (
            p.st.NO_SPACE_ERRORS, p.st.NO_SPACE_PREFLIGHT_BLOCKS)]
        assert min(ticks) >= 1
        # Operator-free recovery: GROW the budget and the auto-recover
        # loop clears the latch itself.
        db._sfm.set_max_allowed_space_usage(1 << 30)
        assert _wait_until(lambda: db._bg_error is None, timeout=20.0), \
            "auto-recovery never cleared the no_space latch"
        assert stats.get_ticker_count(p.st.BG_ERROR_RESUMES) >= 1
        assert any(i.auto and i.reason == "no_space"
                   for i in watch.recovered)
        bad = [k for k, v in acked.items() if db.get(k) != v]
        assert not bad, bad[:3]
        db.flush()  # the DB can flush again
        obs += [ticks, [(i.reason, i.auto) for i in watch.recovered],
                [type(e).__name__ for e in watch.bg_errors]]
    finally:
        db.close()


def sc_compaction_preflight_pauses_amber_first(p, d, obs):          # :288
    stats = p.st.Statistics()
    db = p.DB.open(d, p.options(write_buffer_size=4 * 1024,
                                level0_file_num_compaction_trigger=2,
                                max_allowed_space_usage=1 << 30,
                                statistics=stats))
    try:
        for gen in (b"v", b"w"):
            for i in range(200):
                db.put(b"k%04d" % i, gen * 64)
            db.flush()
        db.wait_for_compactions()
        # Force amber and pile up L0: the scheduler must refuse to START
        # (the ticker moves) and must not hot-loop (num_completed frozen).
        with db._sfm._mu:
            db._sfm._level = "amber"
        done_before = db._compaction_scheduler.num_completed
        for gen in (b"y", b"z"):
            for i in range(200):
                db.put(b"x%04d" % i, gen * 64)
            db.flush()
        db._maybe_schedule_compaction()
        db._compaction_scheduler.wait_idle()
        blocks = stats.get_ticker_count(p.st.NO_SPACE_PREFLIGHT_BLOCKS)
        assert blocks >= 1
        assert db._compaction_scheduler.num_completed == done_before
        assert db._compaction_scheduler._space_blocks == blocks
        # Pressure clears: compactions resume.
        with db._sfm._mu:
            db._sfm._level = "ok"
        db._maybe_schedule_compaction()
        db.wait_for_compactions()
        assert db._compaction_scheduler.num_completed > done_before
        assert db._compaction_scheduler._space_blocks == 0
        assert db.get(b"x0000") == b"z" * 64
        obs += [blocks >= 1, db.get(b"k0199")]
    finally:
        db.close()


def sc_manual_resume_notifies_and_ticks(p, d, obs):                 # :329
    stats = p.st.Statistics()
    watch = _watch(p)
    db = p.DB.open(d, p.options(statistics=stats, listeners=[watch]))
    try:
        err = p.status.IOError_("synthetic hard flush failure")
        db._set_background_error(err, reason="wal")
        assert db._bg_error is err
        obs.append(db._bg_error_severity.name)
        db.resume()
        assert db._bg_error is None
        obs.append(stats.get_ticker_count(p.st.BG_ERROR_RESUMES))
        obs.append([(i.auto, i.reason) for i in watch.recovered])
        db.resume()  # no latch: must NOT notify or tick again
        obs.append(stats.get_ticker_count(p.st.BG_ERROR_RESUMES))
        obs.append(len(watch.recovered))
        assert obs == ["HARD_ERROR", 1, [(False, "wal")], 1, 1]
    finally:
        db.close()


def sc_soft_to_hard_escalation_single_successor(p, d, obs):         # :360
    """A SOFT no_space latch chased by one recovery thread escalates to a
    HARD retryable error: exactly one successor resumes; the first loop
    bows out at its identity check (BG_ERROR_RESUMES == 1). Under the
    lock-graph debug mode of each package (the reference's debug_locks
    fixture): every DB lock instrumented, no inversion raised, edges
    recorded."""
    p.ccy.reset_lock_graph()
    p.ccy.set_debug(True)
    try:
        _escalation(p, d, obs)
    finally:
        p.ccy.set_debug(False)
    obs.append(bool(p.ccy.lock_order_edges()))
    p.ccy.reset_lock_graph()
    assert obs[-1], "the debug layer recorded no edge"


def _escalation(p, d, obs):
    stats = p.st.Statistics()
    watch = _watch(p)
    db = p.DB.open(d, p.options(statistics=stats, listeners=[watch],
                                max_allowed_space_usage=1000))
    assert type(db._mutex).__name__ == "_DebugRLock"
    try:
        # Pin the manager at red so the no_space chaser parks on its
        # headroom gate (spending no attempts while parked).
        db._sfm.on_add_file("/x/fill.sst", 990)
        db._sfm.poll()
        assert db.disk_pressure() == "red"
        soft = p.status.NoSpace("flush would breach budget")
        db._set_background_error(soft, reason="no_space")
        assert db._bg_error is soft
        assert _wait_until(lambda: any(
            t.name.startswith(p.recover_thread)
            for t in threading.enumerate()), timeout=5.0)
        hard = p.status.IOError_("wal torn tail", retryable=True)
        db._set_background_error(hard, reason="wal")
        assert db._bg_error is hard
        obs.append(db._bg_error_severity.name)
        assert _wait_until(lambda: db._bg_error is None, timeout=20.0), \
            "the successor never resumed the HARD retryable latch"
        db._sfm.on_delete_file("/x/fill.sst")
        db._sfm.poll()
        assert _wait_until(lambda: not any(
            t.name.startswith(p.recover_thread)
            for t in threading.enumerate()), timeout=10.0)
        obs.append(stats.get_ticker_count(p.st.BG_ERROR_RESUMES))
        obs.append([i.reason for i in watch.recovered])
        obs.append(watch.pressure)
        assert obs[:3] == ["HARD_ERROR", 1, ["wal"]]
    finally:
        db.close()


def sc_disk_full_soak_enospc_recover_parity(p, d, obs):             # :475
    """Fill a byte-budgeted injected filesystem until a genuine ENOSPC
    latches the DB, free space, and require: autonomous un-latch (zero
    resume() calls), zero lost acked writes, a clean follower catch-up,
    and a clean reopen."""
    stats = p.st.Statistics()
    watch = _watch(p)
    fe = p.FaultInjectionEnv(p.PosixEnv())
    fe.set_disk_budget("*", 192 * 1024)
    db = p.DB.open(d, p.options(write_buffer_size=16 * 1024,
                                level0_file_num_compaction_trigger=3,
                                free_space_poll_period_sec=0.02,
                                flush_headroom_bytes=32 * 1024,
                                statistics=stats, listeners=[watch]),
                   env=fe)
    ship = p.repl.LogShipper(db, statistics=stats)
    oracle: dict[bytes, bytes] = {}
    wo = p.WriteOptions(sync=True)
    try:
        hit_wall = False
        # The live set (800 keys x 256B ~= 200KB) exceeds the budget, so
        # trash-refund reclamation alone can never dodge the wall.
        for i in range(6000):
            k = b"k%05d" % (i % 800)
            v = (b"v%06d" % i).ljust(256, b".")
            try:
                db.put(k, v, wo)
                oracle[k] = v  # acked: must survive
            except Exception as e:  # noqa: BLE001
                assert p.status.is_no_space(e) or isinstance(
                    e, p.status.Busy), repr(e)
                hit_wall = True
            if hit_wall and db._bg_error is not None:
                break
        assert hit_wall, "budget never filled"
        assert fe.enospc_injected >= 1 or stats.get_ticker_count(
            p.st.NO_SPACE_PREFLIGHT_BLOCKS) >= 1
        assert _wait_until(lambda: db._bg_error is not None, timeout=10.0)
        assert db._bg_error_reason == "no_space"
        assert db._bg_error_severity.name == "SOFT_ERROR"
        # While latched SOFT, reads serve every acked write.
        bad = [k for k, v in oracle.items() if db.get(k) != v]
        assert not bad, ("read during latch", bad[:3])
        # Space comes back: ZERO resume() calls from here on.
        fe.add_disk_budget("*", 8 << 20)
        assert _wait_until(lambda: db._bg_error is None, timeout=30.0), \
            "no_space latch never auto-cleared after space returned"
        assert any(i.auto and i.reason == "no_space"
                   for i in watch.recovered)
        assert _wait_until(lambda: db.disk_pressure() == "ok", timeout=10.0)
        for i in range(200):
            k, v = b"post%04d" % i, (b"p%06d" % i).ljust(256, b".")
            db.put(k, v, wo)
            oracle[k] = v
        db.flush()
        db.wait_for_compactions()
        bad = [k for k, v in oracle.items() if db.get(k) != v]
        assert not bad, ("post-recovery", bad[:3])
        # Follower leg: a replica fed from the recovered primary's WAL
        # stream converges to the same merged oracle.
        fol = p.repl.FollowerDB.open(
            d, p.Options(statistics=stats),
            transport=p.repl.LocalTransport(ship), mode="shared")
        try:
            for _ in range(4):
                fol.catch_up()
            fbad = [k for k, v in oracle.items() if fol.get(k) != v]
            assert not fbad, ("follower", fbad[:3])
            assert fol.applied_sequence() == db.versions.last_sequence
        finally:
            fol.close()
        if not p.ref:
            # The native write plane frames through the budgeted writable.
            native = stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS)
            fallbacks = stats.get_ticker_count(st.WRITE_GROUP_FALLBACKS)
            assert native > 0, (native, fallbacks)
            print(f"port under FaultInjectionEnv: WRITE_GROUP_NATIVE_COMMITS"
                  f"={native} WRITE_GROUP_FALLBACKS={fallbacks}")
        db.close()
        db = None
        # Reopen on the REAL env: durability held through the chaos.
        with p.DB.open(d, p.options()) as db2:
            rbad = [k for k, v in oracle.items() if db2.get(k) != v]
            assert not rbad, ("reopen", rbad[:3])
        obs += [hit_wall, "no_space", len(oracle) > 0]
    finally:
        if db is not None:
            db.close()


SCENARIOS = [
    sc_posix_free_space_real_and_unborn_paths,
    sc_mem_env_capacity_and_wrappers,
    sc_fault_env_budget_torn_write_refund_and_enospc,
    sc_pressure_levels_and_hysteresis,
    sc_preflight_math_reserves_flush_headroom,
    sc_trash_ratio_bypass_and_accelerate,
    sc_live_db_deletions_seen_by_manager,
    sc_flush_preflight_latches_soft_and_auto_resumes,
    sc_compaction_preflight_pauses_amber_first,
    sc_manual_resume_notifies_and_ticks,
    sc_soft_to_hard_escalation_single_successor,
    sc_disk_full_soak_enospc_recover_parity,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_disk_pressure_against_reference(tmp_path, no_thread_leaks,  # noqa: F811
                                         scenario):
    seen = {}
    for name in ("ref", "port"):
        obs = []
        scenario(Pkg(name == "ref"), str(tmp_path / name), obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------------------
# A budgeted workload on the device executors: the same bytes after recovery
# ---------------------------------------------------------------------------


def _budgeted(p, d):
    """Rounds of 150 writes, each flushed, under a 71,000-byte budget
    until the flush preflight latches (the fourth flush: ~78 KB of
    tracked tree + memtable estimate, the third ~64 KB; memtable estimates
    vary by ~0.3 KB with the skiplist's random node heights), then the
    budget raised; returns the DB's observations and its level sets and
    SST bytes after flush + compact_range."""
    stats = p.st.Statistics()
    db = p.DB.open(d, p.options(write_buffer_size=1 << 20,
                                disable_auto_compactions=True,
                                max_allowed_space_usage=71_000,
                                flush_headroom_bytes=1,
                                statistics=stats))
    try:
        rounds = 0
        for r in range(8):
            for i in range(150):
                k = b"k%05d" % ((r * 150 + i) * 7919 % 3000)
                db.put(k, b"%06d" % i * 12)
            rounds += 1
            try:
                db.flush()
            except Exception as e:  # noqa: BLE001
                assert p.status.is_no_space(e), repr(e)
                break
        assert _wait_until(lambda: db._bg_error is not None, timeout=5.0)
        latch = (db._bg_error_reason, db._bg_error_severity.name)
        db._sfm.set_max_allowed_space_usage(1 << 30)
        assert _wait_until(lambda: db._bg_error is None, timeout=20.0)
        for i in range(200):
            db.put(b"post%04d" % i, b"p" * 40)
        db.flush()
        db.compact_range()
        levels = [[(f.number, f.smallest, f.largest, f.smallest_seqno,
                    f.largest_seqno, f.file_size) for f in fl]
                  for fl in db.versions.current.files]
        names = ["%06d.sst" % f[0] for fl in levels for f in fl]
        ticks = [stats.get_ticker_count(t) for t in (
            p.st.NO_SPACE_ERRORS, p.st.NO_SPACE_PREFLIGHT_BLOCKS,
            p.st.BG_ERROR_RESUMES)]
        assert ticks == [1, 1, 1], ticks
    finally:
        db.close()
    files = {}
    for name in names:
        with open(os.path.join(d, name), "rb") as f:
            files[name] = f.read()
    return (rounds, latch, ticks, levels), files


def test_budgeted_twin_writes_the_same_bytes(tmp_path, no_thread_leaks,  # noqa: F811
                                             monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    ref_obs, ref_files = _budgeted(Pkg(True), str(tmp_path / "ref"))
    obs, files = _budgeted(Pkg(False), str(tmp_path / "port"))
    assert obs == ref_obs
    assert obs[:2] == (4, ("no_space", "SOFT_ERROR"))
    assert sorted(files) == sorted(ref_files) and files
    for name in files:
        assert files[name] == ref_files[name], name


# ---------------------------------------------------------------------------
# ENOSPC inside a device job
# ---------------------------------------------------------------------------


def test_enospc_in_a_device_job_latches_and_reruns(tmp_path,
                                                   no_thread_leaks):  # noqa: F811
    d = str(tmp_path / "db")
    fe = FaultInjectionEnv(PosixEnv())
    factory = DeviceCompactionExecutorFactory(device="cpu")
    stats = st.Statistics()
    db = dbm.DB.open(d, Options(write_buffer_size=1 << 20,
                                compaction_executor_factory=factory,
                                statistics=stats), env=fe)
    want = {}
    try:
        for r in range(4):
            if r == 3:
                # Half the bytes of the three L0 files: the job that the
                # fourth flush starts cannot write its outputs.
                l0 = [f for f in os.listdir(d) if f.endswith(".sst")]
                budget = sum(os.path.getsize(os.path.join(d, f))
                             for f in l0) // 2
                fe.set_disk_budget("*.sst", budget)
            for i in range(5000):
                k, v = b"k%06d" % (i * 7 % 20000), b"r%d-%d" % (r, i) * 3
                db.put(k, v)
                want[k] = v
            db.flush()
        db._compaction_scheduler.wait_idle()
        assert fe.enospc_injected >= 1
        assert (db._bg_error_reason, db._bg_error_severity.name) == (
            "no_space", "SOFT_ERROR")
        assert stats.get_ticker_count(st.NO_SPACE_ERRORS) == 1
        # No output of the failed job is left, and its bytes came back.
        live = {"%06d.sst" % f.number
                for _, f in db.versions.current.all_files()}
        assert {f for f in os.listdir(d) if f.endswith(".sst")} == live
        l0 = db.versions.current.files[0]
        assert len(l0) == 4
        assert fe.disk_budget_remaining("*.sst") == budget - l0[0].file_size
        fe.add_disk_budget("*.sst", 10 << 20)
        assert _wait_until(lambda: db._bg_error is None, timeout=20.0)
        db.wait_for_compactions()
        v = db.versions.current
        assert not v.files[0] and v.files[1]
        assert db._compaction_scheduler.num_local_jobs == 0
        assert factory.jobs  # the rerun, on the same device executor
        live = {"%06d.sst" % f.number for _, f in v.all_files()}
        assert {f for f in os.listdir(d) if f.endswith(".sst")} == live
        for k, val in want.items():
            assert db.get(k) == val, k
    finally:
        db.close()
