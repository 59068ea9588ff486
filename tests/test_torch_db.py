"""The DB engine of toplingdb_tpu_torch against toplingdb_tpu's, on the CPU
(the port's DeviceCompactionExecutorFactory(device="cpu") runs its kernels'
plain versions; the reference's factory runs device="cpu-jax" on JAX's CPU
backend, as tests/test_device_compaction.py runs it).

- the DB scenarios of tests/test_db.py as cases of one parametrised test,
  each run through both DBs: the `get` and forward / backward scan views
  must be equal at every check point and after close and reopen. In the
  cases that flush and compact only on explicit calls (a write buffer the
  case does not fill, auto compactions off), every live SST must be
  byte-identical by file number, the per-level file sets equal (number,
  smallest, largest, seqnos), the WAL bytes and the MANIFEST bytes equal.
  Two cases leave the file layout to background flushes and compactions
  and compare the views only. Each case runs with the device executor
  and with the host compaction path (the reference with no executor, the
  port with LocalCompactionExecutorFactory). The Twin's operations take
  a column family's name (tests/test_torch_column_families.py);
- the mirror of tests/test_device_compaction.py::test_device_executor_in_db
  on the port's DB;
- auto compactions on, 4 writer threads: the port's views equal a dict
  oracle and the reference DB's views over the same writes;
- a get that overlaps a flush's install or a memtable switch folds each
  merge operand once (the windows held open by hand);
- a failing device job raises, latches the DB's background error and
  writes no output (nothing re-runs it on the CPU path);
- the default Options send every compaction to the device executor on
  "cuda".

Wall-clock time enters the outputs only as the tables' creation_time; the
`pinned_clock` fixture fixes `time.time()` in the modules of both packages
that stamp it. Tolerance: none.
"""

import os
import random
import struct
import threading
import time

import pytest

import toplingdb_tpu.compaction.compaction_job as ref_cj
import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.ops.device_compaction as ref_dc
import toplingdb_tpu.ops.pipeline as ref_pl
from toplingdb_tpu.compaction.executor import (
    DeviceCompactionExecutorFactory as RefFactory,
)
from toplingdb_tpu.db.write_batch import WriteBatch as RefWriteBatch
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.options import WriteOptions as RefWriteOptions
from toplingdb_tpu.utils import merge_operator as ref_mo

import toplingdb_tpu_torch.compaction.compaction_job as cj
import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.ops.device_compaction as dc
import toplingdb_tpu_torch.ops.pipeline as pl
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.options import Options, ReadOptions, WriteOptions
from toplingdb_tpu_torch.utils import merge_operator as mo
from toplingdb_tpu_torch.utils.status import IOError_
from toplingdb_tpu_torch.utils.sync_point import get_sync_point_registry

CLOCK = 1_700_000_000.0


class _PinnedTime:
    """`time` as a module sees it, with time.time() fixed."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return CLOCK


@pytest.fixture
def pinned_clock(monkeypatch):
    for m in (ref_dbm, ref_cj, ref_dc, ref_pl, dbm, cj, dc, pl):
        monkeypatch.setattr(m, "time", _PinnedTime())


# ---------------------------------------------------------------------------
# Both DBs side by side
# ---------------------------------------------------------------------------


class Twin:
    """The same operations on the reference DB and the port's DB in two
    sibling directories; `check` holds the views (and, with byte parity,
    the files) equal. Operations take `cf=`, a column family's name (None:
    the default CF); every CF's views are checked. Byte parity turns auto
    compactions off unless `auto=True`: then the case waits for both DBs'
    compactions after every flush, compact_range and reopen, so both pick
    from the same versions and no check races a background job."""

    def __init__(self, root, executor: str, byte_parity: bool, auto=False,
                 **kw):
        self.root = root
        self.executor = executor
        self.byte_parity = byte_parity
        self.auto = auto
        self.kw = kw
        self.ref_dir = os.path.join(root, "ref")
        self.dir = os.path.join(root, "port")
        self.ref = self.port = None
        self.keys: dict[str | None, set[bytes]] = {None: set()}
        self.open()

    def _options(self):
        kw = dict(self.kw)
        rkw, pkw = dict(kw), dict(kw)
        if self.byte_parity:
            for d in (rkw, pkw):
                d.setdefault("write_buffer_size", 1 << 20)
                d["disable_auto_compactions"] = not self.auto
        op = kw.pop("merge_operator", None)
        if op is not None:
            rkw["merge_operator"] = getattr(ref_mo, op)()
            pkw["merge_operator"] = getattr(mo, op)()
        if self.executor == "device":
            rkw["compaction_executor_factory"] = RefFactory(device="cpu-jax")
            pkw["compaction_executor_factory"] = (
                DeviceCompactionExecutorFactory(device="cpu"))
        else:
            pkw["compaction_executor_factory"] = (
                LocalCompactionExecutorFactory())
        return RefOptions(**rkw), Options(**pkw)

    def open(self):
        ro, po = self._options()
        self.ref = ref_dbm.DB.open(self.ref_dir, ro)
        self.port = dbm.DB.open(self.dir, po)

    def close(self):
        for db in (self.port, self.ref):
            if db is not None and not db._closed:
                db.close()

    def reopen(self):
        self.close()
        self.open()
        if self.auto and self.byte_parity:
            self.wait()  # the opens may have scheduled jobs on either side
        self.check()

    # -- column families ----------------------------------------------

    def _h(self, cf):
        """(reference handle, port handle) of CF `cf` (None: default)."""
        if cf is None:
            return None, None
        return self.ref.get_column_family(cf), self.port.get_column_family(cf)

    def create_cf(self, name):
        r = self.ref.create_column_family(name)
        p = self.port.create_column_family(name)
        assert p.id == r.id and p.name == r.name == name
        self.keys[name] = set()

    def drop_cf(self, name):
        r, p = self._h(name)
        self.ref.drop_column_family(r)
        self.port.drop_column_family(p)
        del self.keys[name]

    # -- operations on both -------------------------------------------

    def put(self, k, v, sync=False, cf=None):
        self.keys[cf].add(k)
        r, p = self._h(cf)
        self.ref.put(k, v, RefWriteOptions(sync=sync), cf=r)
        self.port.put(k, v, WriteOptions(sync=sync), cf=p)

    def delete(self, k, cf=None):
        self.keys[cf].add(k)
        r, p = self._h(cf)
        self.ref.delete(k, cf=r)
        self.port.delete(k, cf=p)

    def merge(self, k, v, cf=None):
        self.keys[cf].add(k)
        r, p = self._h(cf)
        self.ref.merge(k, v, cf=r)
        self.port.merge(k, v, cf=p)

    def delete_range(self, b, e, cf=None):
        r, p = self._h(cf)
        self.ref.delete_range(b, e, cf=r)
        self.port.delete_range(b, e, cf=p)

    def write(self, ops):
        """One batch on each side. An op is (name, *args), with the CF's
        name appended as a str for a CF other than the default."""
        rb, pb = RefWriteBatch(), WriteBatch()
        for op, *args in ops:
            cf = args.pop() if isinstance(args[-1], str) else None
            self.keys[cf].add(args[0])
            r, p = self._h(cf)
            getattr(rb, op)(*args, cf=r.id if r is not None else 0)
            getattr(pb, op)(*args, cf=p.id if p is not None else 0)
        self.ref.write(rb)
        self.port.write(pb)

    def flush(self):
        self.ref.flush()
        self.port.flush()
        if self.auto and self.byte_parity:
            self.wait()

    def compact_range(self):
        self.ref.compact_range()
        self.port.compact_range()
        if self.auto and self.byte_parity:
            self.wait()

    def wait(self):
        self.ref.wait_for_compactions()
        self.port.wait_for_compactions()

    def snapshot(self):
        return self.ref.get_snapshot(), self.port.get_snapshot()

    def get(self, k, snap=None, cf=None):
        r_h, p_h = self._h(cf)
        r = self.ref.get(k, RefReadOptions(snapshot=snap[0]) if snap
                         else RefReadOptions(), cf=r_h)
        p = self.port.get(k, ReadOptions(snapshot=snap[1]) if snap
                          else ReadOptions(), cf=p_h)
        assert p == r, (cf, k, p, r)
        return p

    # -- views and files ----------------------------------------------

    @staticmethod
    def _scan(db, reverse=False, cf=None):
        it = db.new_iterator(cf=cf)
        out = []
        if reverse:
            it.seek_to_last()
            while it.valid():
                out.append((it.key(), it.value()))
                it.prev()
        else:
            it.seek_to_first()
            out = list(it.entries())
        return out

    @staticmethod
    def _files(d):
        return sorted(os.listdir(d))

    @staticmethod
    def _level_sets(db):
        """Every CF's level file sets, by CF name."""
        return {h.name: [[(f.number, f.smallest, f.largest,
                           f.smallest_seqno, f.largest_seqno,
                           f.num_entries, f.file_size, f.blob_refs)
                          for f in fl]
                         for fl in db.versions.cf_current(h.id).files]
                for h in db.list_column_families()}

    def check(self, snap=None):
        names = [h.name for h in self.port.list_column_families()]
        assert names == [h.name for h in self.ref.list_column_families()]
        fwd = None
        for cf in self.keys:
            for k in sorted(self.keys[cf]) + [b"missing"]:
                self.get(k, snap, cf)
            r, p = self._h(cf)
            view = self._scan(self.port, cf=p)
            assert view == self._scan(self.ref, cf=r), cf
            rev = self._scan(self.port, reverse=True, cf=p)
            assert rev == list(reversed(view)), cf
            if cf is None:
                fwd = view
        if self.executor == "device":
            # Every compaction of the port ran on the device executor.
            assert self.port._compaction_scheduler.num_local_jobs == 0
        if not self.byte_parity:
            return fwd
        assert self.port.versions.last_sequence == \
            self.ref.versions.last_sequence
        assert self._level_sets(self.port) == self._level_sets(self.ref)
        # Live files: every CF's SSTs and the blob files they reference,
        # the WALs from the MANIFEST's log number on and the MANIFEST (the
        # reference may keep obsolete files a while longer: an old Version
        # its read path still holds pins them).
        assert self.port.versions.log_number == self.ref.versions.log_number
        metas = [f for h in self.port.list_column_families()
                 for _, f in self.port.versions.cf_current(h.id).all_files()]
        live = [f"{f.number:06d}.sst" for f in metas] + [
            f"{n:06d}.blob" for n in sorted({n for f in metas
                                             for n in f.blob_refs})]
        wals = [n for n in self._files(self.dir) if n.endswith(".log")
                and int(n[:-4]) >= self.port.versions.log_number]
        assert wals == [n for n in self._files(self.ref_dir)
                        if n.endswith(".log")
                        and int(n[:-4]) >= self.ref.versions.log_number]
        assert wals, "no live WAL"
        manifest = "MANIFEST-%06d" % self.port.versions.manifest_file_number
        assert manifest == \
            "MANIFEST-%06d" % self.ref.versions.manifest_file_number
        for name in live + wals + [manifest]:
            a = open(os.path.join(self.dir, name), "rb").read()
            b = open(os.path.join(self.ref_dir, name), "rb").read()
            assert a == b, name
        return fwd


# ---------------------------------------------------------------------------
# The scenarios of tests/test_db.py (line numbers of that file)
# ---------------------------------------------------------------------------


def case_open_put_get_close_reopen(t):                      # :16
    t.put(b"a", b"1")
    t.put(b"b", b"2")
    assert t.get(b"a") == b"1" and t.get(b"missing") is None
    t.check()
    t.reopen()
    assert t.get(b"b") == b"2"


def case_overwrite_and_delete(t):                           # :38
    t.put(b"k", b"v1")
    t.put(b"k", b"v2")
    assert t.get(b"k") == b"v2"
    t.delete(b"k")
    assert t.get(b"k") is None
    t.put(b"k", b"v3")
    t.check()
    t.flush()
    t.compact_range()
    assert t.get(b"k") == b"v3"
    t.check()


def case_flush_and_read_from_sst(t):                        # :49
    for i in range(100):
        t.put(b"key%04d" % i, b"val%04d" % i)
    t.flush()
    assert t.port.mem.empty()
    assert len(t.port.versions.current.files[0]) >= 1
    assert t.get(b"key0050") == b"val0050"
    t.check()
    t.delete(b"key0050")
    t.flush()
    assert t.get(b"key0050") is None
    t.check()
    t.compact_range()
    t.check()


def case_recovery_replays_wal(t):                           # :62
    t.put(b"durable", b"yes", sync=True)
    t.put(b"also", b"this")
    t.check()
    # Crash: drop both handles without close() (no flush), then reopen.
    for db in (t.ref, t.port):
        db._compaction_scheduler.shutdown()
        db._wal.sync()
        db._wal.close()
        db._closed = True
    t.open()
    assert t.get(b"durable") == b"yes"
    t.check()
    t.reopen()


def case_auto_flush_on_write_buffer_full(t):                # :72
    for i in range(2000):
        t.put(b"key%06d" % i, b"x" * 30)
    t.wait()
    assert t.port.versions.current.num_files() > 0
    assert t.get(b"key000000") == b"x" * 30
    assert t.get(b"key001999") == b"x" * 30
    t.check()
    t.reopen()


def case_snapshot_isolation(t):                             # :82
    t.put(b"k", b"old")
    snap = t.snapshot()
    t.put(b"k", b"new")
    t.delete(b"k2")
    assert t.get(b"k", snap) == b"old"
    assert t.get(b"k") == b"new"
    t.check(snap)
    t.flush()
    assert t.get(b"k", snap) == b"old"
    t.compact_range()  # the snapshot keeps the old version alive
    assert t.get(b"k", snap) == b"old"
    t.check(snap)
    for s in snap:
        s.release()
    t.check()


def case_merge_operator(t):                                 # :96
    def u64(v):
        return struct.pack("<Q", v)

    t.merge(b"c", u64(1))
    t.merge(b"c", u64(2))
    assert struct.unpack("<Q", t.get(b"c"))[0] == 3
    t.flush()
    t.merge(b"c", u64(10))  # operand in mem, base in SST
    assert struct.unpack("<Q", t.get(b"c"))[0] == 13
    t.put(b"c", u64(100))   # put resets the chain
    t.merge(b"c", u64(1))
    assert struct.unpack("<Q", t.get(b"c"))[0] == 101
    t.check()
    t.flush()
    t.compact_range()
    t.check()
    t.reopen()


def case_merge_across_flush_with_delete(t):                 # :109
    t.put(b"s", b"base")
    t.flush()
    t.delete(b"s")
    t.merge(b"s", b"x")
    t.merge(b"s", b"y")
    assert t.get(b"s") == b"x,y"  # delete cuts the chain from base
    t.check()
    t.compact_range()
    t.check()


def case_delete_range(t):                                   # :119
    for i in range(100):
        t.put(b"key%03d" % i, b"v")
    t.delete_range(b"key020", b"key040")
    assert t.get(b"key019") == b"v"
    assert t.get(b"key020") is None
    assert t.get(b"key040") == b"v"
    t.put(b"key025", b"back")
    assert t.get(b"key025") == b"back"
    t.flush()
    assert t.get(b"key030") is None
    t.check()
    t.reopen()
    assert t.get(b"key030") is None
    t.compact_range()
    t.check()


def case_write_batch_atomic(t):                             # :139
    t.write([("put", b"a", b"1"), ("put", b"b", b"2"), ("delete", b"a")])
    assert t.get(b"a") is None
    assert t.get(b"b") == b"2"
    t.write([("put", b"c", b"3"), ("delete_range", b"b", b"c"),
             ("single_delete", b"d"), ("merge", b"e", b"m")])
    assert t.get(b"b") is None
    t.check()
    t.flush()
    t.compact_range()
    t.check()


def case_reopen_after_many_flushes(t):                      # :152
    for round_ in range(3):
        for i in range(50):
            t.put(b"key%03d" % (round_ * 50 + i), b"r%d" % round_)
        t.flush()
        t.reopen()
    t.compact_range()
    t.check()


def case_write_stall_on_l0_pileup(t):                       # :284
    for r in range(5):
        for i in range(100):
            t.put(b"k%05d" % (r * 100 + i), b"x" * 30)
        t.flush()
    assert len(t.port.versions.current.files[0]) >= 5
    # Stalls are a no-op while compaction is disabled (bulk-load mode).
    t0 = time.monotonic()
    t.port._maybe_stall_writes(timeout=1.0)
    assert time.monotonic() - t0 < 0.2
    # Enable compaction and lower the triggers: the stall must hold until
    # L0 drains below the stop trigger (or the timeout).
    for db in (t.ref, t.port):
        db.options.level0_slowdown_writes_trigger = 2
        db.options.level0_stop_writes_trigger = 4
        db.options.disable_auto_compactions = False
    t0 = time.monotonic()
    t.port._maybe_stall_writes(timeout=3.0)
    dt = time.monotonic() - t0
    assert t.port._max_l0_files() < 4 or dt >= 3.0
    t.ref._maybe_stall_writes(timeout=3.0)
    t.wait()
    t.check()


# (case, options, byte parity)
CASES = [
    (case_open_put_get_close_reopen, {}, True),
    (case_overwrite_and_delete, {}, True),
    (case_flush_and_read_from_sst, {}, True),
    (case_recovery_replays_wal, {}, True),
    (case_auto_flush_on_write_buffer_full,
     {"write_buffer_size": 8 * 1024}, False),
    (case_snapshot_isolation, {}, True),
    (case_merge_operator, {"merge_operator": "UInt64AddOperator"}, True),
    (case_merge_across_flush_with_delete,
     {"merge_operator": "StringAppendOperator"}, True),
    (case_delete_range, {}, True),
    (case_write_batch_atomic, {"merge_operator": "StringAppendOperator"},
     True),
    (case_reopen_after_many_flushes, {}, True),
    (case_write_stall_on_l0_pileup,
     {"write_buffer_size": 4 * 1024, "disable_auto_compactions": True},
     False),
]


@pytest.mark.parametrize("executor", ["device", "cpu"])
@pytest.mark.parametrize("case,kw,byte_parity", CASES,
                         ids=[c[0].__name__[5:] for c in CASES])
def test_db_scenario(tmp_path, pinned_clock, case, kw, byte_parity,
                     executor):
    t = Twin(str(tmp_path), executor, byte_parity, **kw)
    try:
        case(t)
        t.check()
        t.reopen()
    finally:
        t.close()


@pytest.mark.parametrize("rep", ["skiplist", "vector"])
def test_memtable_reps_write_the_same_files(tmp_path, pinned_clock, rep):
    """Both memtable reps flush the same SST bytes as the reference (the
    skiplist through the columnar flush, the vector rep through the
    per-entry TableBuilder)."""
    t = Twin(str(tmp_path), "device", True, memtable_rep=rep)
    try:
        rng = random.Random(3)
        for i in range(600):
            k = b"%06d" % rng.randrange(300)
            if i % 7 == 0:
                t.delete(k)
            else:
                t.put(k, b"v%d" % i * rng.randrange(1, 5))
        t.delete_range(b"000100", b"000120")
        t.check()
        t.flush()
        t.check()
        t.compact_range()
        t.check()
    finally:
        t.close()


def test_device_executor_in_db(tmp_path):
    """tests/test_device_compaction.py::test_device_executor_in_db on the
    port's DB: a delete_range, then compact_range on the device executor."""
    factory = DeviceCompactionExecutorFactory(device="cpu")
    opts = Options(write_buffer_size=8 * 1024,
                   compaction_executor_factory=factory)
    with dbm.DB.open(str(tmp_path / "db"), opts) as db:
        for i in range(3000):
            db.put(b"key%05d" % (i % 1000), b"val%07d" % i)
        db.delete_range(b"key00100", b"key00200")
        db.flush()
        db.compact_range()
        assert db.get(b"key00150") is None
        assert db.get(b"key00250") is not None
        assert db._compaction_scheduler.last_error is None
        assert factory.jobs
        assert db._compaction_scheduler.num_local_jobs == 0


def test_get_overlapping_an_install_folds_each_operand_once(tmp_path):
    """A get that overlaps a memtable switch or a flush's install reads
    one view of the memtables and the version (the CF's SuperVersion), so
    each merge operand is folded once. Gets run on other threads while a
    real flush holds the DB mutex: after its switch ("FlushJob::Start")
    and right after its install ("FlushJob::InstallResults"); then a
    reader thread polls through a run of real flushes."""
    reg = get_sync_point_registry()
    db = dbm.DB.open(str(tmp_path / "db"), Options(
        merge_operator=mo.StringAppendOperator(),
        disable_auto_compactions=True,
        compaction_executor_factory=LocalCompactionExecutorFactory()))
    seen = {}

    def get_from_another_thread(point):
        out = []
        th = threading.Thread(target=lambda: out.append(db.get(b"k")))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive(), f"a get at {point} blocked"
        seen[point] = (out[0], len(db.imm),
                       len(db.versions.current.files[0]))

    try:
        db._nget_lib = None  # merges go to the Python chain anyway
        db.put(b"k", b"base")
        db.flush()
        db.merge(b"k", b"a")
        db.merge(b"k", b"b")
        for point in ("FlushJob::Start", "FlushJob::InstallResults"):
            reg.set_callback(point, lambda _arg, p=point:
                             get_from_another_thread(p))
        reg.enable_processing()
        try:
            db.flush()
        finally:
            reg.clear_all()
        # After the switch the sealed memtable is the only immutable one;
        # after the install its L0 file is the second and no memtable is.
        assert seen == {"FlushJob::Start": (b"base,a,b", 1, 1),
                        "FlushJob::InstallResults": (b"base,a,b", 0, 2)}
        assert db.get(b"k") == b"base,a,b"
        db.merge(b"k", b"c")
        assert db.get(b"k") == b"base,a,b,c"

        stop = threading.Event()
        bad = []

        def reader():
            while not stop.is_set():
                v = db.get(b"k")
                ops = v.split(b",")
                if len(set(ops)) != len(ops):
                    bad.append(v)
        th = threading.Thread(target=reader)
        th.start()
        try:
            for i in range(30):
                db.merge(b"k", b"m%d" % i)
                db.flush()
        finally:
            stop.set()
            th.join(timeout=30)
        assert not th.is_alive() and not bad, bad[:3]
        assert db.get(b"k") == b",".join(
            [b"base", b"a", b"b", b"c"] + [b"m%d" % i for i in range(30)])
    finally:
        db.close()


def test_reads_after_installs_never_wait_for_the_mutex(tmp_path):
    """Every install publishes its CF's read view under the DB mutex, so
    a get, a multi_get and get_merge_operands read the view as published:
    after promote_l0, a compaction install and delete_files_in_range they
    finish while another thread holds the mutex (as a flush does for its
    whole SST build), and they see the installed files."""
    db = dbm.DB.open(str(tmp_path / "db"), Options(
        merge_operator=mo.StringAppendOperator(),
        disable_auto_compactions=True,
        compaction_executor_factory=LocalCompactionExecutorFactory()))

    def read_while_the_mutex_is_held():
        held, release = threading.Event(), threading.Event()

        def holder():
            with db._mutex:
                held.set()
                release.wait(timeout=60)
        h = threading.Thread(target=holder)
        h.start()
        held.wait(timeout=30)
        out = []
        th = threading.Thread(target=lambda: out.append((
            db.get(b"k"), db.multi_get([b"k", b"k2"]),
            db.get_merge_operands(b"k"))))
        th.start()
        th.join(timeout=30)
        done = not th.is_alive()
        release.set()
        h.join(timeout=30)
        th.join(timeout=30)
        assert done, "a read waited for the DB mutex"
        return out[0]

    try:
        db.put(b"k", b"base")
        db.put(b"k2", b"v2")
        db.flush()
        db.promote_l0(1)  # a metadata-only install
        assert db.versions.current.files[1] and not \
            db.versions.current.files[0]
        assert read_while_the_mutex_is_held() == (
            b"base", [b"base", b"v2"], [b"base"])
        db.merge(b"k", b"a")
        db.flush()
        db.compact_range()  # a compaction install
        assert not db.versions.current.files[0]
        assert read_while_the_mutex_is_held() == (
            b"base,a", [b"base,a", b"v2"], [b"base,a"])
        assert db.delete_files_in_range(b"", b"\xff") > 0
        assert not any(db.versions.current.files)
        assert read_while_the_mutex_is_held() == (None, [None, None], [])
    finally:
        db.close()


def _threaded_fill(db, batch_cls, n_threads, per, seed):
    errs = []

    def worker(t):
        rng = random.Random(seed + t)
        try:
            for i in range(0, per, 20):
                b = batch_cls()
                for j in range(i, i + 20):
                    k = b"%08d" % ((t * per + j) * 2654435761 % (4 * per))
                    b.put(k, b"t%d-%d" % (t, j) * rng.randrange(1, 4))
                db.write(b)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in ts), "a writer thread hung"
    assert not errs, errs


def test_auto_compactions_with_threaded_writers(tmp_path):
    """Auto compactions on, 4 writer threads: the file layout depends on
    thread timing, so the views are compared (dict oracle, reference)."""
    n_threads, per = 4, 1000
    oracle = {}
    for t in range(n_threads):
        rng = random.Random(11 + t)
        for j in range(0, per, 20):
            for jj in range(j, j + 20):
                k = b"%08d" % ((t * per + jj) * 2654435761 % (4 * per))
                oracle[k] = b"t%d-%d" % (t, jj) * rng.randrange(1, 4)
    kw = dict(write_buffer_size=16 * 1024,
              level0_file_num_compaction_trigger=2,
              max_bytes_for_level_base=64 * 1024,
              target_file_size_base=16 * 1024)
    factory = DeviceCompactionExecutorFactory(device="cpu")
    port = dbm.DB.open(str(tmp_path / "port"), Options(
        compaction_executor_factory=factory, **kw))
    ref = ref_dbm.DB.open(str(tmp_path / "ref"), RefOptions(
        compaction_executor_factory=RefFactory(device="cpu-jax"), **kw))
    try:
        _threaded_fill(port, WriteBatch, n_threads, per, 11)
        _threaded_fill(ref, RefWriteBatch, n_threads, per, 11)
        for db in (port, ref):
            db.wait_for_compactions()
        assert factory.jobs, "no compaction ran on the device executor"
        assert port._compaction_scheduler.num_local_jobs == 0
        assert port._compaction_scheduler.last_error is None
        want = sorted(oracle.items())
        assert Twin._scan(port) == want
        assert Twin._scan(ref) == want
        for k in random.Random(2).sample(sorted(oracle), 300):
            assert port.get(k) == oracle[k] == ref.get(k)
        port.close()
        port = dbm.DB.open(str(tmp_path / "port"), Options(
            compaction_executor_factory=factory, **kw))
        assert Twin._scan(port) == want
    finally:
        port.close()
        ref.close()


def test_group_commit_under_contention(tmp_path):
    """More writer threads than cores with a short switch interval: every
    acknowledged write is readable, the sequence numbers of the
    acknowledged batches are disjoint and cover 1..last_sequence, and the
    WAL replays to the same state."""
    import sys

    n_threads, per = 24, 60
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    path = str(tmp_path / "db")
    db = dbm.DB.open(path, Options(write_buffer_size=24 * 1024,
                                   disable_auto_compactions=True))
    tokens, errs = [], []
    lock = threading.Lock()

    def worker(t):
        try:
            for j in range(per):
                b = WriteBatch()
                b.put(b"t%02d-%04d" % (t, j), b"%d" % j)
                b.put(b"last-%02d" % t, b"%d" % j)
                last = db.write(b)
                with lock:
                    tokens.append((last - 1, last))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    try:
        ts = [threading.Thread(target=worker, args=(t,))
              for t in range(n_threads)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in ts), "a writer thread hung"
        assert not errs, errs
        seqs = sorted(s for pair in tokens for s in pair)
        assert seqs == list(range(1, 2 * n_threads * per + 1))
        assert db.versions.last_sequence == 2 * n_threads * per
        assert db.num_flushes > 0
        want = {b"t%02d-%04d" % (t, j): b"%d" % j
                for t in range(n_threads) for j in range(per)}
        want.update({b"last-%02d" % t: b"%d" % (per - 1)
                     for t in range(n_threads)})
        assert Twin._scan(db) == sorted(want.items())
    finally:
        sys.setswitchinterval(old)
        db.close()
    with dbm.DB.open(path, Options(disable_auto_compactions=True)) as db:
        assert Twin._scan(db) == sorted(want.items())


class _Boom(RuntimeError):
    pass


def _failing_device(monkeypatch):
    def boom(*a, **k):
        raise _Boom("device job failed")

    monkeypatch.setattr(dc, "run_device_compaction", boom)


def _fill_l0(db, rounds=3):
    for r in range(rounds):
        for i in range(200):
            db.put(b"k%05d" % (i * 3 + r), b"v%d" % r)
        db.flush()


def test_device_failure_raises_and_writes_nothing(tmp_path, monkeypatch):
    """A failed device job is not re-run elsewhere: the failure surfaces
    from compact_range, as the scheduler's last_error of a background job
    and as the DB's background error, and no output file is written."""
    _failing_device(monkeypatch)
    factory = DeviceCompactionExecutorFactory(device="cpu")
    path = str(tmp_path / "db")
    db = dbm.DB.open(path, Options(
        disable_auto_compactions=True, compaction_executor_factory=factory))
    try:
        _fill_l0(db)
        before = sorted(f for f in os.listdir(path) if f.endswith(".sst"))
        with pytest.raises(_Boom):
            db._compaction_scheduler.compact_range(None, None)
        assert sorted(f for f in os.listdir(path)
                      if f.endswith(".sst")) == before
        assert not factory.jobs
        assert db._compaction_scheduler.num_local_jobs == 0
        # The same failure in a background job latches the DB's error.
        db.options.disable_auto_compactions = False
        db.options.level0_file_num_compaction_trigger = 2
        db._maybe_schedule_compaction()
        with pytest.raises(IOError_):
            db.wait_for_compactions()
        assert isinstance(db._compaction_scheduler.last_error, _Boom)
        with pytest.raises(IOError_):
            db.put(b"x", b"y")
        assert sorted(f for f in os.listdir(path)
                      if f.endswith(".sst")) == before
    finally:
        db.close()


def test_default_options_compact_on_the_card(tmp_path, monkeypatch):
    """Options() sends every compaction to the device executor on "cuda":
    the job reaches run_device_compaction with device_name="cuda" (stopped
    there by a spy, so the test runs without a card), never the host
    path."""
    seen = []

    def spy(*a, **k):
        seen.append(k["device_name"])
        raise _Boom("stopped at the device plane")

    monkeypatch.setattr(dc, "run_device_compaction", spy)
    opts = Options(disable_auto_compactions=True)
    factory = opts.compaction_executor_factory
    assert type(factory) is DeviceCompactionExecutorFactory
    assert factory.device == "cuda"
    assert Options().compaction_executor_factory is not factory
    path = str(tmp_path / "db")
    with dbm.DB.open(path, opts) as db:
        _fill_l0(db)
        with pytest.raises(_Boom):
            db._compaction_scheduler.compact_range(None, None)
        assert seen and set(seen) == {"cuda"}
        assert db._compaction_scheduler.num_local_jobs == 0
