"""Transactions in toplingdb_tpu_torch against toplingdb_tpu's, on the CPU.

Each case of tests/test_utilities.py's transaction tests (pessimistic,
optimistic, lock conflicts, deadlocks, range locks, 2PC recovery) and all
13 cases of tests/test_write_prepared.py run as one op script on each
package, with the reference tests' assertions; the sequences of reads and
of error types each records must be equal. The port's DB runs its
compactions on the device executor's "cpu" device (the kernels' plain
versions), so the parked WritePrepared guard is held through a device job:
the job's snapshot list must carry the guard's sequence.

Also: a get without transactions on the port, and on a TransactionDB with
no undecided transaction, is still decided by the native point-read chain;
an undecided range takes the Python chain.

Tolerance: none.
"""

import os
import subprocess
import sys
import threading
import time

import pytest

import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.utilities.transactions as ref_tx
from toplingdb_tpu.db.write_batch import WriteBatch as RefWriteBatch
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.options import WriteOptions as RefWriteOptions
from toplingdb_tpu.utils import status as ref_status

import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.utilities.transactions as tx
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.options import Options, ReadOptions, WriteOptions
from toplingdb_tpu_torch.utils import status


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.tx = ref_tx if ref else tx
        self.ReadOptions = RefReadOptions if ref else ReadOptions
        self.WriteOptions = RefWriteOptions if ref else WriteOptions
        self.WriteBatch = RefWriteBatch if ref else WriteBatch
        self.status = ref_status if ref else status

    def options(self, **kw):
        kw.setdefault("write_buffer_size", 16 * 1024)
        if self.ref:
            return RefOptions(**kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)

    def wp_open(self, path, **kw):
        return self.tx.TransactionDB.open(
            path, self.options(), write_policy="write_prepared", **kw)

    def raises(self, obs, exc_name, fn, *a):
        """Run fn, which must raise the package's `exc_name`; record the
        raised type's name."""
        exc = getattr(self.status, exc_name, None) or getattr(self.tx,
                                                               exc_name)
        with pytest.raises(exc) as ei:
            fn(*a)
        obs.append(("raised", type(ei.value).__name__))


def both(scenario, tmp_path):
    seen = {}
    for name in ("ref", "port"):
        d = str(tmp_path / name)
        os.makedirs(d)
        obs = []
        scenario(Side(name == "ref"), os.path.join(d, "db"), obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]
    return seen["port"]


def crash(db):
    """Drop a DB as a killed process leaves it (tests/test_utilities.py's
    2PC crash recipe)."""
    db._wal.sync()
    db._closed = True
    db._compaction_scheduler.shutdown()


# -- tests/test_utilities.py ------------------------------------------------


def sc_pessimistic_commit_rollback(s, d, obs):      # test_utilities:173
    with s.tx.TransactionDB.open(d, s.options()) as tdb:
        txn = tdb.begin_transaction()
        txn.put(b"k", b"v1")
        obs.append(txn.get(b"k"))
        obs.append(tdb.get(b"k"))
        txn.commit()
        obs.append(tdb.get(b"k"))
        txn2 = tdb.begin_transaction()
        txn2.put(b"k", b"v2")
        txn2.rollback()
        obs.append(tdb.get(b"k"))
        obs.append((txn.state, txn2.state))
    assert obs[:4] == [b"v1", None, b"v1", b"v1"]


def sc_lock_conflict(s, d, obs):                    # test_utilities:190
    with s.tx.TransactionDB.open(d, s.options()) as tdb:
        t1 = tdb.begin_transaction(lock_timeout=0.1)
        t2 = tdb.begin_transaction(lock_timeout=0.1)
        t1.put(b"k", b"t1")
        s.raises(obs, "Busy", t2.put, b"k", b"t2")
        t1.commit()
        t2.put(b"k", b"t2")
        t2.commit()
        obs.append(tdb.get(b"k"))
    assert obs[-1] == b"t2"


def sc_deadlock(s, d, obs):                         # test_utilities:206
    with s.tx.TransactionDB.open(d, s.options()) as tdb:
        t1 = tdb.begin_transaction(lock_timeout=5.0)
        t2 = tdb.begin_transaction(lock_timeout=5.0)
        t1.put(b"a", b"1")
        t2.put(b"b", b"2")
        errors = []

        def t1_waits():
            try:
                t1.put(b"b", b"1b")  # blocks on t2
            except s.status.Busy as e:
                errors.append(e)

        th = threading.Thread(target=t1_waits)
        th.start()
        time.sleep(0.1)
        s.raises(obs, "DeadlockError", t2.put, b"a", b"2a")
        t2.rollback()
        th.join()
        t1.commit()
        obs.append((len(errors), tdb.get(b"a"), tdb.get(b"b")))
    assert obs[-1] == (0, b"1", b"1b")


def sc_get_for_update(s, d, obs):                   # test_utilities:235
    with s.tx.TransactionDB.open(d, s.options()) as tdb:
        tdb.put(b"k", b"v0")
        t1 = tdb.begin_transaction(lock_timeout=0.1)
        obs.append(t1.get_for_update(b"k"))
        t2 = tdb.begin_transaction(lock_timeout=0.1)
        s.raises(obs, "Busy", t2.put, b"k", b"nope")
        t1.commit()
        t1b = tdb.begin_transaction(lock_timeout=0.1)
        t1b.get_for_update(b"k")
        t1b.undo_get_for_update(b"k")   # unwritten: released at once
        t2.put(b"k", b"now")
        t2.commit()
        obs.append(tdb.get(b"k"))
    assert obs[0] == b"v0" and obs[-1] == b"now"


def sc_optimistic_conflict(s, d, obs):              # test_utilities:249
    with s.tx.OptimisticTransactionDB.open(d, s.options()) as odb:
        odb.db.put(b"k", b"v0")
        t1 = odb.begin_transaction()
        t2 = odb.begin_transaction()
        obs.append(t1.get_for_update(b"k"))
        t2.put(b"k", b"t2")
        t2.commit()
        t1.put(b"k", b"t1")
        s.raises(obs, "Busy", t1.commit)
        obs.append((odb.get(b"k"), t1.state, t2.state))
    assert obs[-1] == (b"t2", "aborted", "committed")


def sc_optimistic_no_conflict(s, d, obs):           # test_utilities:266
    with s.tx.OptimisticTransactionDB.open(d, s.options()) as odb:
        t1 = odb.begin_transaction()
        t1.put(b"x", b"1")
        t1.commit()
        obs.append(odb.get(b"x"))
    assert obs == [b"1"]


def sc_optimistic_snapshot_and_track(s, d, obs):    # test_utilities:602
    with s.tx.OptimisticTransactionDB.open(d, s.options()) as odb:
        odb.db.put(b"k", b"v0")
        t1 = odb.begin_transaction()
        odb.db.put(b"k", b"v1")            # interleaved write
        obs.append(t1.get_for_update(b"k"))
        t1.put(b"k", b"t1")
        s.raises(obs, "Busy", t1.commit)
        obs.append(odb.get(b"k"))
    assert obs[0] == b"v0" and obs[-1] == b"v1"


def sc_optimistic_sees_flushed_write(s, d, obs):
    """The conflict check reads the newest seqno from the SSTs too."""
    with s.tx.OptimisticTransactionDB.open(d, s.options()) as odb:
        t1 = odb.begin_transaction()
        odb.db.put(b"k", b"other")
        odb.db.flush()
        t1.get_for_update(b"k")
        t1.put(b"k", b"t1")
        s.raises(obs, "Busy", t1.commit)
        t2 = odb.begin_transaction()
        t2.get_for_update(b"j")
        t2.put(b"j", b"1")
        t2.commit()
        obs.append((odb.get(b"k"), odb.get(b"j")))


def sc_two_phase_commit_recovery(s, d, obs):        # test_utilities:1148
    tdb = s.tx.TransactionDB.open(d, s.options())
    tdb.put(b"base", b"v")
    t1 = tdb.begin_transaction()
    t1.set_name("t1")
    t1.put(b"pk", b"pv")
    t1.prepare()
    t2 = tdb.begin_transaction()
    t2.set_name("t2")
    t2.put(b"rk", b"rv")
    t2.prepare()
    crash(tdb.db)
    tdb2 = s.tx.TransactionDB.open(d, s.options())
    obs.append(tdb2.get(b"pk"))
    recovered = {t.name: t for t in tdb2.get_prepared_transactions()}
    obs.append(sorted(recovered))
    recovered["t1"].commit()
    recovered["t2"].rollback()
    obs.append((tdb2.get(b"pk"), tdb2.get(b"rk"), tdb2.get(b"base")))
    tdb2.close()
    tdb3 = s.tx.TransactionDB.open(d, s.options())
    obs.append((tdb3.get_prepared_transactions(), tdb3.get(b"pk")))
    tdb3.close()
    assert obs == [None, ["t1", "t2"], (b"pv", None, b"v"), ([], b"pv")]


def sc_two_phase_crash_after_commit(s, d, obs):     # test_utilities:1186
    tdb = s.tx.TransactionDB.open(d, s.options())
    t = tdb.begin_transaction()
    t.set_name("tx")
    t.put(b"k", b"v1")
    t.prepare()
    marker = s.tx.TransactionDB._MARKER_PREFIX + b"tx"
    batch = s.WriteBatch(t.wbwi.batch.data())
    batch.put(marker, b"1", cf=tdb._txn_cf.id)
    tdb.db.write(batch)
    crash(tdb.db)
    tdb2 = s.tx.TransactionDB.open(d, s.options())
    obs.append(tdb2.get_prepared_transactions())
    obs.append(tdb2.get(b"k"))
    obs.append(tdb2.db.get(marker, cf=tdb2._txn_cf))
    tdb2.close()
    assert obs == [[], b"v1", None]


def sc_two_phase_fault_injected_crash(s, d, obs):
    """The 2PC crash through FaultInjectionEnv: the prepared batch is
    synced, the DB's unsynced tail is lost, recovery offers the
    prepared transaction."""
    if s.ref:
        from toplingdb_tpu.env import PosixEnv as E
        from toplingdb_tpu.env.fault_injection import FaultInjectionEnv as F
    else:
        from toplingdb_tpu_torch.env import PosixEnv as E
        from toplingdb_tpu_torch.env.fault_injection import (
            FaultInjectionEnv as F,
        )
    fenv = F(E())
    db = s.DB.open(d, s.options(), env=fenv)
    tdb = s.tx.TransactionDB(db)
    tdb.put(b"base", b"v", s.WriteOptions(sync=True))
    t = tdb.begin_transaction()
    t.set_name("fi")
    t.put(b"pk", b"pv")
    t.prepare()
    tdb.db.put(b"unsynced", b"x")
    fenv.drop_unsynced_and_deactivate()
    s.raises(obs, "IOError_", tdb.db.put, b"y", b"z",
             s.WriteOptions(sync=True))
    db._closed = True
    db._compaction_scheduler.shutdown()
    fenv.reactivate_and_truncate()
    tdb2 = s.tx.TransactionDB(s.DB.open(d, s.options(), env=fenv))
    obs.append([x.name for x in tdb2.get_prepared_transactions()])
    obs.append((tdb2.get(b"base"), tdb2.get(b"pk"), tdb2.get(b"unsynced")))
    tdb2.get_prepared_transactions()[0].commit()
    obs.append(tdb2.get(b"pk"))
    tdb2.close()
    assert obs[1:] == [["fi"], (b"v", None, None), b"pv"]


def sc_range_lock_conflict(s, d, obs):              # test_utilities:1516
    with s.tx.TransactionDB.open(d, s.options(),
                                 use_range_locking=True) as tdb:
        t1 = tdb.begin_transaction(lock_timeout=0.05)
        t1.get_range_lock(b"b", b"d")
        t2 = tdb.begin_transaction(lock_timeout=0.05)
        s.raises(obs, "Busy", t2.put, b"c", b"x")
        t2.put(b"e", b"ok")
        t1.put(b"c", b"t1")
        t1.commit()
        t2.put(b"c", b"t2")
        t2.commit()
        obs.append((tdb.get(b"c"), tdb.get(b"e")))
        t3 = tdb.begin_transaction()
        t3.undo_get_for_update(b"c")      # a no-op under range locking
        t3.rollback()
    with s.tx.TransactionDB.open(d, s.options()) as tdb:
        t = tdb.begin_transaction()
        s.raises(obs, "InvalidArgument", t.get_range_lock, b"a", b"b")
        t.rollback()


def sc_range_lock_deadlock(s, d, obs):              # test_utilities:1541
    with s.tx.TransactionDB.open(d, s.options(),
                                 use_range_locking=True) as tdb:
        t1 = tdb.begin_transaction(lock_timeout=5.0)
        t2 = tdb.begin_transaction(lock_timeout=5.0)
        t1.get_range_lock(b"a", b"c")
        t2.get_range_lock(b"m", b"p")
        res = {}

        def t1_waits():
            try:
                t1.get_range_lock(b"n", b"n")
                res["t1"] = "got"
            except s.status.Busy as e:
                res["t1"] = type(e).__name__

        th = threading.Thread(target=t1_waits)
        th.start()
        time.sleep(0.1)
        s.raises(obs, "DeadlockError", t2.get_range_lock, b"b", b"b")
        t2.rollback()
        th.join()
        t1.commit()
        obs.append(res)
    assert obs[-1] == {"t1": "got"}


def sc_range_lock_managers(s, d, obs):          # test_utilities:1573-1660
    m = s.tx.RangeLockManager(max_ranges_per_txn=4)
    for i in range(8):
        m.try_lock_range(1, b"k%02d" % (2 * i), b"k%02d" % (2 * i))
    obs.append((m._counts[1], [tuple(r) for r in m._ranges]))
    m.try_lock_range(2, b"z1", b"z3")
    m.try_lock_range(2, b"z2", b"z5")
    obs.append([tuple(r) for r in m._ranges if r[2] == 2])
    s.raises(obs, "Busy", m.try_lock_range, 3, b"k00", b"k01", 0.05)
    s.raises(obs, "InvalidArgument", m.try_lock_range, 3, b"b", b"a")
    m.unlock_all(1)
    m.try_lock_range(3, b"k00", b"k01", 0.05)
    obs.append(sorted(tuple(r) for r in m._ranges))
    # Multi-holder deadlock: 3 waits on 1 and 2; 1 asking for 3's range
    # closes the cycle.
    mm = s.tx.RangeLockManager()
    mm.try_lock_range(1, b"a", b"b")
    mm.try_lock_range(2, b"c", b"d")
    mm.try_lock_range(3, b"x", b"y")
    done = {}

    def waiter():
        try:
            mm.try_lock_range(3, b"a", b"d", 5.0)
            done["t3"] = "got"
        except s.status.Busy as e:
            done["t3"] = type(e).__name__

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.1)
    s.raises(obs, "DeadlockError", mm.try_lock_range, 1, b"x", b"x", 5.0)
    mm.unlock_all(1)
    mm.unlock_all(2)
    th.join()
    obs.append(done)
    pm = s.tx.PointLockManager()
    pm.try_lock(1, b"k")
    s.raises(obs, "Busy", pm.try_lock, 2, b"k", 0.05)
    pm.unlock_all(1, [b"k"])
    pm.try_lock(2, b"k", 0.05)
    obs.append(s.tx._has_wait_cycle({1: 2, 2: {3}, 3: 1}, 1, 2))


def sc_range_lock_2pc_recovery(s, d, obs):          # test_utilities:1670
    pkg = "toplingdb_tpu" if s.ref else "toplingdb_tpu_torch"
    extra = "" if s.ref else (
        "from toplingdb_tpu_torch.options import Options\n"
        "from toplingdb_tpu_torch.compaction.executor import "
        "DeviceCompactionExecutorFactory\n"
        "o = Options(compaction_executor_factory="
        "DeviceCompactionExecutorFactory(device='cpu'))\n")
    child = (
        "import sys, os\n"
        f"sys.path.insert(0, {os.getcwd()!r})\n"
        f"from {pkg}.utilities.transactions import TransactionDB\n"
        + extra +
        f"tdb = TransactionDB.open({d!r}, "
        f"{'None' if s.ref else 'o'}, use_range_locking=True)\n"
        "t = tdb.begin_transaction()\n"
        "t.get_range_lock(b'g100', b'g200')\n"
        "t.put(b'g150', b'prepared-val')\n"
        "t.set_name('gaplock')\n"
        "t.prepare()\n"
        "os._exit(0)\n")
    r = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr
    s.raises(obs, "InvalidArgument", s.tx.TransactionDB.open, d,
             s.options())
    tdb = s.tx.TransactionDB.open(d, s.options(), use_range_locking=True)
    [rec] = tdb.get_prepared_transactions()
    obs.append(rec.name)
    t2 = tdb.begin_transaction(lock_timeout=0.05)
    s.raises(obs, "Busy", t2.put, b"g175", b"intruder")
    rec.commit()
    t2.put(b"g175", b"after-commit")
    t2.commit()
    obs.append((tdb.get(b"g150"), tdb.get(b"g175")))
    tdb.close()
    assert obs[-1] == (b"prepared-val", b"after-commit")


def sc_names_and_states(s, d, obs):
    with s.tx.TransactionDB.open(d, s.options()) as tdb:
        t = tdb.begin_transaction()
        for bad in ("", "a/b", ".x", "rb.x"):
            s.raises(obs, "InvalidArgument", t.set_name, bad)
        s.raises(obs, "InvalidArgument", t.prepare)
        t.set_name("n1")
        s.raises(obs, "InvalidArgument", t.set_name, "n2")
        t2 = tdb.begin_transaction()
        s.raises(obs, "InvalidArgument", t2.set_name, "n1")
        t.put(b"k", b"v")
        t.prepare()
        s.raises(obs, "InvalidArgument", t.prepare)
        t.commit()
        s.raises(obs, "InvalidArgument", t.commit)
        t2.set_name("n1")   # released by the commit
        t2.rollback()
        obs.append(tdb.get(b"k"))


TXN_SCENARIOS = [
    sc_pessimistic_commit_rollback, sc_lock_conflict, sc_deadlock,
    sc_get_for_update, sc_optimistic_conflict, sc_optimistic_no_conflict,
    sc_optimistic_snapshot_and_track, sc_optimistic_sees_flushed_write,
    sc_two_phase_commit_recovery, sc_two_phase_crash_after_commit,
    sc_two_phase_fault_injected_crash, sc_range_lock_conflict,
    sc_range_lock_deadlock, sc_range_lock_managers,
    sc_range_lock_2pc_recovery, sc_names_and_states,
]


@pytest.mark.parametrize("scenario", TXN_SCENARIOS,
                         ids=[f.__name__[3:] for f in TXN_SCENARIOS])
def test_transaction_scenarios_match_reference(tmp_path, scenario):
    both(scenario, tmp_path)


# -- tests/test_write_prepared.py -------------------------------------------


def wp_policy_dispatch(s, d, obs):                  # :24
    tdb = s.wp_open(d)
    obs.append(type(tdb.begin_transaction()).__name__)
    tdb.close()
    tdb = s.tx.TransactionDB.open(d + "2", s.options(),
                                  write_policy="write_unprepared")
    obs.append(type(tdb.begin_transaction()).__name__)
    tdb.close()
    s.raises(obs, "InvalidArgument", s.tx.TransactionDB.open, d + "3",
             s.options(), False, "bogus")
    assert obs[:2] == ["WritePreparedTransaction",
                       "WriteUnpreparedTransaction"]


def wp_invisible_until_commit(s, d, obs):           # :38
    tdb = s.wp_open(d)
    tdb.put(b"base", b"committed")
    txn = tdb.begin_transaction()
    txn.set_name("t1")
    txn.put(b"k1", b"v1")
    txn.put(b"base", b"overwritten")
    txn.prepare()
    obs.append((tdb.get(b"k1"), tdb.get(b"base")))
    it = tdb.db.new_iterator(s.ReadOptions())
    it.seek_to_first()
    obs.append([k for k, _ in it.entries()])
    obs.append(txn.get(b"k1"))
    obs.append(tdb.db.multi_get([b"k1", b"base"]))
    txn.commit()
    obs.append((tdb.get(b"k1"), tdb.get(b"base")))
    tdb.close()
    assert obs[0] == (None, b"committed") and obs[1] == [b"base"]
    assert obs[-1] == (b"v1", b"overwritten")


def wp_snapshot_during_prepare(s, d, obs):          # :61
    tdb = s.wp_open(d)
    txn = tdb.begin_transaction()
    txn.set_name("t1")
    txn.put(b"x", b"txn-value")
    txn.prepare()
    snap = tdb.db.get_snapshot()
    txn.commit()
    obs.append(tdb.get(b"x", s.ReadOptions(snapshot=snap)))
    obs.append(tdb.get(b"x"))
    snap.release()
    tdb.close()
    assert obs == [None, b"txn-value"]


def wp_rollback_restores(s, d, obs):                # :76
    tdb = s.wp_open(d)
    tdb.put(b"a", b"old-a")
    txn = tdb.begin_transaction()
    txn.set_name("t1")
    txn.put(b"a", b"new-a")
    txn.put(b"b", b"new-b")
    txn.delete(b"a")
    txn.prepare()
    txn.rollback()
    obs.append((tdb.get(b"a"), tdb.get(b"b")))
    t2 = tdb.begin_transaction()
    t2.put(b"a", b"after")
    t2.commit()
    obs.append(tdb.get(b"a"))
    tdb.close()
    assert obs == [(b"old-a", None), b"after"]


def wp_commit_without_prepare(s, d, obs):           # :97
    tdb = s.wp_open(d)
    txn = tdb.begin_transaction()
    txn.put(b"k", b"v")
    txn.commit()
    obs.append(tdb.get(b"k"))
    tdb.close()
    assert obs == [b"v"]


def wp_recovery_commit(s, d, obs):                  # :106
    tdb = s.wp_open(d)
    txn = tdb.begin_transaction()
    txn.set_name("crashy")
    txn.put(b"pending", b"data")
    txn.prepare()
    tdb.db.close()
    tdb = s.wp_open(d)
    obs.append(tdb.get(b"pending"))
    rec = tdb.get_prepared_transactions()
    obs.append([t.name for t in rec])
    rec[0].commit()
    obs.append(tdb.get(b"pending"))
    tdb.close()
    tdb = s.wp_open(d)
    obs.append((tdb.get(b"pending"), len(tdb.get_prepared_transactions())))
    tdb.close()
    assert obs == [None, ["crashy"], b"data", (b"data", 0)]


def wp_recovery_rollback(s, d, obs):                # :128
    tdb = s.wp_open(d)
    tdb.put(b"k", b"original")
    txn = tdb.begin_transaction()
    txn.set_name("crashy")
    txn.put(b"k", b"uncommitted")
    txn.prepare()
    tdb.db.close()
    tdb = s.wp_open(d)
    obs.append(tdb.get(b"k"))
    tdb.get_prepared_transactions()[0].rollback()
    obs.append(tdb.get(b"k"))
    tdb.close()
    tdb = s.wp_open(d)
    obs.append(tdb.get(b"k"))
    tdb.close()
    assert obs == [b"original"] * 3


def wp_survives_flush_and_compaction(s, d, obs):    # :147
    tdb = s.wp_open(d)
    for i in range(100):
        tdb.put(b"w%03d" % i, b"v%d" % i)
    txn = tdb.begin_transaction()
    txn.set_name("t1")
    txn.put(b"w050", b"pending")
    txn.prepare()
    tdb.db.flush()
    tdb.db.compact_range()
    obs.append(tdb.get(b"w050"))
    txn.commit()
    obs.append(tdb.get(b"w050"))
    tdb.close()
    assert obs == [b"v50", b"pending"]


def wp_unprepared_spills(s, d, obs):                # :163
    tdb = s.tx.TransactionDB.open(d, s.options(),
                                  write_policy="write_unprepared")
    txn = tdb.begin_transaction()
    txn.spill_threshold = 256
    big = b"x" * 64
    for i in range(50):
        txn.put(b"big%03d" % i, big)
    obs.append(txn._spill_off is not None)
    obs.append((tdb.get(b"big000"), txn.get(b"big000")))
    txn.commit()
    obs.append(tdb.get(b"big049"))
    tdb.close()
    assert obs == [True, (None, big), big]


def wp_unprepared_rollback_and_crash(s, d, obs):    # :181
    tdb = s.tx.TransactionDB.open(d, s.options(),
                                  write_policy="write_unprepared")
    tdb.put(b"big000", b"pre-existing")
    txn = tdb.begin_transaction()
    txn.spill_threshold = 128
    for i in range(30):
        txn.put(b"big%03d" % i, b"y" * 64)
    obs.append(txn._spill_off is not None)
    txn.rollback()
    obs.append((tdb.get(b"big000"), tdb.get(b"big001")))
    txn2 = tdb.begin_transaction()
    txn2.spill_threshold = 128
    for i in range(30):
        txn2.put(b"crash%03d" % i, b"z" * 64)
    obs.append(txn2._spill_off is not None)
    tdb.db.close()
    tdb = s.tx.TransactionDB.open(d, s.options(),
                                  write_policy="write_unprepared")
    obs.append((tdb.get(b"crash000"), tdb.get(b"big000"),
                len(tdb.get_prepared_transactions())))
    tdb.close()
    assert obs == [True, (b"pre-existing", None), True,
                   (None, b"pre-existing", 0)]


def wp_snapshot_exclusion_through_compaction(s, d, obs):  # :209
    tdb = s.wp_open(d)
    tdb.put(b"k", b"pre")
    txn = tdb.begin_transaction()
    txn.set_name("t1")
    txn.put(b"k", b"txn")
    txn.prepare()
    snap = tdb.db.get_snapshot()
    guard = txn._guard_snap.sequence
    obs.append(snap.excluded_ranges)
    txn.commit()
    obs.append(len(tdb._parked_guards))
    tdb.db.flush()
    tdb.db.compact_range()
    obs.append(tdb.get(b"k", s.ReadOptions(snapshot=snap)))
    obs.append(tdb.get(b"k"))
    obs.append(guard in tdb.db.snapshots.sequences())
    snap.release()
    tdb.begin_transaction().rollback()
    obs.append(len(tdb._parked_guards))
    tdb.close()
    assert obs[1:] == [1, b"pre", b"txn", True, 0]


def wp_reserved_rb_names(s, d, obs):                # :233
    tdb = s.wp_open(d)
    txn = tdb.begin_transaction()
    s.raises(obs, "InvalidArgument", txn.set_name, "rb.evil")
    tdb.close()


def wp_conflict_isolation(s, d, obs):               # :241
    tdb = s.wp_open(d)
    txn = tdb.begin_transaction()
    txn.set_name("holder")
    txn.put(b"locked", b"v")
    txn.prepare()
    t2 = tdb.begin_transaction(lock_timeout=0.05)
    s.raises(obs, "Busy", t2.put, b"locked", b"other")
    txn.commit()
    t2.put(b"locked", b"other")
    t2.commit()
    obs.append(tdb.get(b"locked"))
    tdb.close()
    assert obs[-1] == b"other"


def wp_reads_every_way(s, d, obs):
    """Undecided data through every read path: a snapshot read, multi_get,
    get_merge_operands, a backward scan, a bounded scan; then after the
    commit."""
    tdb = s.wp_open(d)
    for i in range(20):
        tdb.put(b"r%02d" % i, b"v%02d" % i)
    tdb.db.flush()
    txn = tdb.begin_transaction()
    txn.set_name("t1")
    for i in range(0, 20, 3):
        txn.put(b"r%02d" % i, b"T%02d" % i)
    txn.delete(b"r01")
    txn.prepare()
    keys = [b"r%02d" % i for i in range(20)]

    def view():
        it = tdb.db.new_iterator()
        it.seek_to_last()
        back = []
        while it.valid():
            back.append((it.key(), it.value()))
            it.prev()
        it2 = tdb.db.new_iterator(s.ReadOptions(
            iterate_lower_bound=b"r05", iterate_upper_bound=b"r12"))
        it2.seek_to_first()
        return (tdb.db.multi_get(keys), back, list(it2.entries()),
                tdb.db.get_merge_operands(b"r03"))

    obs.append(view())
    snap = tdb.db.get_snapshot()
    txn.commit()
    obs.append(view())
    obs.append(tdb.db.multi_get(keys, s.ReadOptions(snapshot=snap)))
    snap.release()
    tdb.close()
    assert obs[0][0][3] == b"v03" and obs[1][0][3] == b"T03"


WP_SCENARIOS = [
    wp_policy_dispatch, wp_invisible_until_commit, wp_snapshot_during_prepare,
    wp_rollback_restores, wp_commit_without_prepare, wp_recovery_commit,
    wp_recovery_rollback, wp_survives_flush_and_compaction,
    wp_unprepared_spills, wp_unprepared_rollback_and_crash,
    wp_snapshot_exclusion_through_compaction, wp_reserved_rb_names,
    wp_conflict_isolation, wp_reads_every_way,
]


@pytest.mark.parametrize("scenario", WP_SCENARIOS,
                         ids=[f.__name__[3:] for f in WP_SCENARIOS])
def test_write_prepared_scenarios_match_reference(tmp_path, scenario):
    both(scenario, tmp_path)


def test_parked_guard_reaches_the_device_job(tmp_path, monkeypatch):
    """The guard of a committed transaction that a live snapshot excludes
    is in the snapshot list the scheduler hands to the device executor,
    and the job (on the kernels' plain versions) keeps the pre-transaction
    version that snapshot reads."""
    from toplingdb_tpu_torch.compaction import executor as ex

    seen = []
    run = ex.DeviceCompactionExecutor.execute

    def spy(self, db, compaction, snapshots, alloc):
        seen.append(list(snapshots))
        return run(self, db, compaction, snapshots, alloc)

    monkeypatch.setattr(ex.DeviceCompactionExecutor, "execute", spy)
    s = Side(False)
    tdb = s.wp_open(str(tmp_path / "db"))
    for i in range(50):
        tdb.put(b"k%02d" % i, b"pre%02d" % i)
    tdb.db.flush()
    txn = tdb.begin_transaction()
    txn.set_name("t")
    for i in range(0, 50, 5):
        txn.put(b"k%02d" % i, b"new%02d" % i)
    txn.prepare()
    snap = tdb.db.get_snapshot()
    guard = txn._guard_snap.sequence
    txn.commit()
    tdb.db.compact_range()
    assert seen and all(guard in snaps for snaps in seen), (guard, seen)
    for i in range(0, 50, 5):
        k = b"k%02d" % i
        assert tdb.get(k, ReadOptions(snapshot=snap)) == b"pre%02d" % i
        assert tdb.get(k) == b"new%02d" % i
    snap.release()
    tdb.close()


def _count_native(db):
    """Wrap the instance's _native_get; returns the list of handled flags."""
    calls = []
    real = db._native_get

    def wrapped(*a, **k):
        out = real(*a, **k)
        calls.append(out[0])
        return out

    db._native_get = wrapped
    return calls


def test_gets_without_undecided_data_stay_native(tmp_path):
    from toplingdb_tpu_torch import native

    if native.lib() is None:
        pytest.skip("the native library did not build")
    s = Side(False)
    db = dbm.DB.open(str(tmp_path / "plain"), s.options())
    for i in range(200):
        db.put(b"p%03d" % i, b"v%03d" % i)
    db.flush()
    calls = _count_native(db)
    assert [db.get(b"p%03d" % i) for i in range(200)] == \
        [b"v%03d" % i for i in range(200)]
    assert calls and all(calls), "a plain get left the native chain"
    db.close()
    # A write_prepared TransactionDB with nothing undecided: still native.
    tdb = s.wp_open(str(tmp_path / "wp"))
    for i in range(50):
        tdb.put(b"w%02d" % i, b"v%02d" % i)
    tdb.db.flush()
    calls = _count_native(tdb.db)
    assert tdb.get(b"w10") == b"v10"
    assert calls == [True]
    # An undecided range: the Python chain decides, and hides the data.
    txn = tdb.begin_transaction()
    txn.set_name("u")
    txn.put(b"w10", b"undecided")
    txn.prepare()
    assert tdb.get(b"w10") == b"v10"
    assert calls == [True, False]
    txn.commit()
    assert tdb.get(b"w10") == b"undecided"
    tdb.close()
