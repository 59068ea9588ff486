"""The write modes of toplingdb_tpu_torch's DB against toplingdb_tpu's, on
the CPU: the staged write path (enable_pipelined_write, unordered_write),
parallel memtable inserts, the async WAL writer (enable_async_wal) and the
WriteBufferManager, on the skiplist and the CSPP-role trie.

- single-writer byte parity for every mode on every rep (skiplist,
  vector, cspp, hash_skiplist:8): the same seeded ops through both DBs on
  the host compaction path, flushing only on explicit calls, give equal
  WAL, SST and MANIFEST bytes, level sets, gets, scans both ways,
  snapshot reads and tickers, and again after a reopen;
- the scenarios of tests/test_write_modes.py (:46 with its four modes,
  :64, :96, :110, :138), each on the skiplist and the trie: several
  writer threads leave both packages with the same contents, and a copy
  of the directory taken with the DB open (its WAL synced, nothing
  flushed) replays to them; unordered snapshots drain the writes
  allocated before them; memtable switches under pipelined writers lose
  nothing, and a flush, a close or an unordered snapshot that starts while
  a staged insert is held open waits for it; merges and range deletes
  survive the parallel fan-out;
  concurrent native inserts with a reader lose no entry;
- the async WAL writer (tests/test_write_plane.py:200, :249 and the ring
  unit test after them): concurrent sync writers coalesce fsyncs
  (WRITE_GROUP_FSYNCS_COALESCED equals the ring's count) and every
  acknowledged write survives a reopen; a seeded WAL-writer failure
  fails its group, latches a HARD background error with reason "wal"
  that resume() clears; the ring merges N sync tokens into one fsync and
  parks an append error for the file's next barrier only;
- a WriteBufferManager shared by two DBs forces flushes that neither
  write buffer would, flush() leaves a residual charge under 4096 bytes
  and close() none (tests/test_db.py:544).

Tolerance: none.
"""

import random
import shutil
import struct
import threading

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.db.write_batch import WriteBatch as RefWriteBatch
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.utils import merge_operator as ref_mo
from toplingdb_tpu.utils import statistics as ref_st

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.memtable import (
    MemTable,
    NativeSkipListRep,
    NativeTrieRep,
)
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator, ValueType
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.env.env import AsyncIORing
from toplingdb_tpu_torch.env.fault_injection import WalWriterFaultInjector
from toplingdb_tpu_torch.options import Options, ReadOptions, WriteOptions
from toplingdb_tpu_torch.utils import merge_operator as mo
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.rate_limiter import WriteBufferManager
from toplingdb_tpu_torch.utils.status import IOError_, Severity

from test_torch_db import Twin, pinned_clock  # noqa: F401

MODES = {
    "default": {},
    "pipelined": dict(enable_pipelined_write=True),
    "unordered": dict(unordered_write=True),
    "pipelined+async": dict(enable_pipelined_write=True,
                            enable_async_wal=True),
}
REPS = ["skiplist", "vector", "cspp", "hash_skiplist:8"]


def _port(path, **kw):
    return dbm.DB.open(path, Options(
        create_if_missing=True,
        compaction_executor_factory=LocalCompactionExecutorFactory(), **kw))


# ---------------------------------------------------------------------------
# Single-writer byte parity
# ---------------------------------------------------------------------------


class ModeTwin(Twin):
    """Twin with one write mode and memtable rep on both sides, each
    side's own Statistics, on the host compaction path."""

    def __init__(self, root, mode, rep):
        self.ref_stats = ref_st.Statistics()
        self.port_stats = st.Statistics()
        super().__init__(root, "local", byte_parity=True, memtable_rep=rep,
                         **MODES[mode])

    def open(self):
        ro, po = self._options()
        ro.statistics, po.statistics = self.ref_stats, self.port_stats
        self.ref = ref_dbm.DB.open(self.ref_dir, ro)
        self.port = dbm.DB.open(self.dir, po)

    def check(self, snap=None):
        out = super().check(snap)
        # Twin scans the port backward too; the reference's backward scan
        # here keeps the two sides' iterator tickers comparable.
        assert self._scan(self.ref, reverse=True) == list(reversed(out))
        return out


def _ops(t, rng, n):
    for _ in range(n):
        r = rng.random()
        k = b"key%04d" % rng.randrange(300)
        v = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 50)))
        if r < 0.6:
            t.put(k, v, sync=rng.random() < 0.05)
        elif r < 0.7:
            t.delete(k)
        elif r < 0.75:
            a = rng.randrange(300)
            t.delete_range(b"key%04d" % a, b"key%04d" % (a + 4))
        else:
            t.write([("put", b"key%04d" % rng.randrange(300), v),
                     ("delete", b"key%04d" % rng.randrange(300)),
                     ("put", k, v[::-1])])


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_single_writer_byte_parity(tmp_path, pinned_clock, monkeypatch,
                                   mode, rep):
    """The same seeded single-writer ops through both DBs in one write
    mode on one rep: equal WAL, SST and MANIFEST bytes, level sets, gets,
    scans both ways and snapshot reads (Twin.check), equal tickers, and
    after a reopen (WAL replay) all of it again."""
    monkeypatch.delenv("TPULSM_WRITE_PLANE", raising=False)
    monkeypatch.delenv("TPULSM_ITER_CHUNK", raising=False)
    t = ModeTwin(str(tmp_path), mode, rep)
    try:
        assert (t.port._wal_ring is not None) == ("async" in mode)
        rng = random.Random(2024)
        for _ in range(2):
            _ops(t, rng, 120)
            snap = t.snapshot()
            _ops(t, rng, 30)
            t.check(snap)
            t.ref.release_snapshot(snap[0])
            t.port.release_snapshot(snap[1])
            t.flush()
            t.check()
        _ops(t, rng, 80)
        t.compact_range()
        t.check()
        _ops(t, rng, 60)
        t.port._wal.sync()
        t.ref._wal.sync()
        t.reopen()
        pt, rt = t.port_stats.tickers(), t.ref_stats.tickers()
        diff = {k: (pt.get(k), rt.get(k)) for k in set(pt) | set(rt)
                if k != st.STALL_MICROS and pt.get(k, 0) != rt.get(k, 0)}
        assert not diff
        native = pt.get(st.WRITE_GROUP_NATIVE_COMMITS, 0)
        assert (native > 0) == (rep in ("skiplist", "cspp"))
    finally:
        t.close()


# ---------------------------------------------------------------------------
# Several writers (tests/test_write_modes.py)
# ---------------------------------------------------------------------------


def _fill_threads(db, batch_cls, n_threads=4, per_thread=300, batch=10):
    errs = []

    def worker(t):
        try:
            for i in range(0, per_thread, batch):
                b = batch_cls()
                for j in range(i, i + batch):
                    b.put(b"t%02d-k%06d" % (t, j), b"v%06d-%02d" % (j, t))
                db.write(b)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t,))
          for t in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs


def _contents(db, n_threads=4, per_thread=300):
    """Every key's get (all must be found) and the forward scan."""
    gets = {}
    for t in range(n_threads):
        for j in range(per_thread):
            k = b"t%02d-k%06d" % (t, j)
            gets[k] = db.get(k)
            assert gets[k] == b"v%06d-%02d" % (j, t), k
    it = db.new_iterator()
    it.seek_to_first()
    scan = list(it.entries())
    assert len(scan) == n_threads * per_thread
    return gets, scan


def _replayed_copy(db, src, dst, opts):
    """The DB's directory copied with the DB open (its WAL synced, nothing
    flushed), as a crash leaves it: the contents of the reopened copy."""
    db._wal.sync()
    shutil.copytree(src, dst)
    with dbm.DB.open(dst, opts) as copy:
        return _contents(copy)


@pytest.mark.parametrize("rep", ["skiplist", "cspp"])
@pytest.mark.parametrize("mode", ["parallel", "pipelined", "unordered",
                                  "pipelined+parallel"])
def test_concurrent_fill_modes(tmp_path, mode, rep):            # :46
    """Four writer threads in the mode: the port's DB holds every write,
    with the reference's contents after the same fill; a copy taken with
    the DB open replays its WAL to the same contents, and so does a
    reopen after close."""
    kw = dict(memtable_rep=rep,
              allow_concurrent_memtable_write="parallel" in mode,
              enable_pipelined_write="pipelined" in mode,
              unordered_write=mode == "unordered")
    ref = ref_dbm.DB.open(str(tmp_path / "ref"), RefOptions(
        create_if_missing=True, **kw))
    try:
        _fill_threads(ref, RefWriteBatch)
        want = _contents(ref)
    finally:
        ref.close()
    d = str(tmp_path / "port")
    opts = Options(create_if_missing=True,
                   compaction_executor_factory=(
                       LocalCompactionExecutorFactory()), **kw)
    db = dbm.DB.open(d, opts)
    try:
        _fill_threads(db, WriteBatch)
        assert db.versions.last_sequence == db._seq_alloc == 1200
        assert db._mt_inflight == 0 and not db._alloc_ranges
        assert _contents(db) == want
        assert _replayed_copy(db, d, str(tmp_path / "copy"), opts) == want
    finally:
        db.close()
    with dbm.DB.open(d, opts) as db2:
        assert _contents(db2) == want


@pytest.mark.parametrize("rep", ["skiplist", "cspp"])
def test_unordered_snapshot_drains(tmp_path, rep):              # :64
    """Under a concurrent unordered writer, a snapshot waits for the
    writes allocated before it: its sequence is published, and a read at
    it sees every key a later read at it sees."""
    db = _port(str(tmp_path / "u"), unordered_write=True, memtable_rep=rep)
    stop = threading.Event()
    errs = []

    def writer():
        i = 0
        try:
            while not stop.is_set():
                db.put(b"w%08d" % i, b"x" * 16)
                i += 1
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(50):
            snap = db.get_snapshot()
            assert snap.sequence <= db.versions.last_sequence
            assert snap.sequence <= db._seq_alloc
            db.release_snapshot(snap)
    finally:
        stop.set()
        t.join()
    assert not errs, errs
    db.close()


@pytest.mark.parametrize("rep", ["skiplist", "cspp"])
def test_pipelined_flush_and_recovery(tmp_path, rep):           # :96
    """Pipelined writers over a 32 KiB write buffer: the memtable switches
    mid-run drain the staged inserts, so no published write is lost,
    before and after a reopen."""
    d = str(tmp_path / "p")
    opts = Options(create_if_missing=True, enable_pipelined_write=True,
                   write_buffer_size=32 * 1024, memtable_rep=rep,
                   compaction_executor_factory=(
                       LocalCompactionExecutorFactory()))
    db = dbm.DB.open(d, opts)
    try:
        _fill_threads(db, WriteBatch, n_threads=3, per_thread=400)
        assert db.num_flushes > 0
        for t in range(3):
            for j in range(400):
                assert db.get(b"t%02d-k%06d" % (t, j)) == \
                    b"v%06d-%02d" % (j, t)
    finally:
        db.close()
    with dbm.DB.open(d, opts) as db2:
        it = db2.new_iterator()
        it.seek_to_first()
        assert sum(1 for _ in it.entries()) == 1200


@pytest.mark.parametrize("rep", ["skiplist", "cspp"])
def test_parallel_group_mixed_ops(tmp_path, rep):               # :110
    """Merges and range deletes survive the parallel fan-out, with the
    reference's answers."""
    out = {}
    for pkg in ("ref", "port"):
        kw = dict(allow_concurrent_memtable_write=True, memtable_rep=rep)
        if pkg == "ref":
            db = ref_dbm.DB.open(str(tmp_path / pkg), RefOptions(
                create_if_missing=True,
                merge_operator=ref_mo.UInt64AddOperator(), **kw))
        else:
            db = _port(str(tmp_path / pkg),
                       merge_operator=mo.UInt64AddOperator(), **kw)

        def worker(t, db=db):
            for _ in range(200):
                db.merge(b"ctr%02d" % t, struct.pack("<Q", 1))

        ts = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        got = [db.get(b"ctr%02d" % t) for t in range(4)]
        db.delete_range(b"ctr00", b"ctr02")
        got += [db.get(b"ctr%02d" % t) for t in range(4)]
        db.close()
        out[pkg] = got
    assert out["port"] == out["ref"]
    assert [struct.unpack("<Q", v)[0] for v in out["port"][:4]] == [200] * 4
    assert out["port"][4:6] == [None, None]


@pytest.mark.parametrize("waiter", ["flush", "close", "snapshot"])
def test_staged_insert_in_flight_is_waited_for(tmp_path, monkeypatch,
                                               waiter):
    """A staged group whose memtable phase is still running (its insert
    held open by hand) when a flush's memtable switch, a close or an
    unordered snapshot starts: the switch and the close wait for it, so
    the flush and the reopen see its key, and the snapshot includes it."""
    d = str(tmp_path / "db")
    db = dbm.DB.open(d, Options(
        create_if_missing=True, enable_pipelined_write=waiter != "snapshot",
        unordered_write=waiter == "snapshot",
        compaction_executor_factory=LocalCompactionExecutorFactory()),
        write_plane=False)
    db.put(b"first", b"1")
    inserting, release = threading.Event(), threading.Event()
    insert_into = WriteBatch.insert_into

    def held(self, mems):
        if self.count() == 1 and b"late" in self.data():
            inserting.set()
            release.wait(timeout=0.5)
        return insert_into(self, mems)

    monkeypatch.setattr(WriteBatch, "insert_into", held)
    t = threading.Thread(target=db.put, args=(b"late", b"2"))
    t.start()
    assert inserting.wait(timeout=10)
    try:
        if waiter == "flush":
            db.flush()
            assert db.get(b"late") == b"2"
            t.join()
            db.flush()
            assert db.get(b"late") == b"2"
        elif waiter == "close":
            db.close()
        else:
            snap = db.get_snapshot()
            assert db.get(b"late", ReadOptions(snapshot=snap)) == b"2"
            db.release_snapshot(snap)
    finally:
        release.set()
        t.join()
        db.close()
    with _port(d) as db2:
        assert db2.get(b"late") == b"2" and db2.get(b"first") == b"1"


@pytest.mark.parametrize("rep_cls", [NativeSkipListRep, NativeTrieRep],
                         ids=["skiplist", "cspp"])
def test_native_rep_concurrent_insert_stress(rep_cls):          # :138
    """Concurrent batch inserts from 8 threads lose no entry while a
    reader walks the rep, and the final order is the internal key
    order."""
    mt = MemTable(InternalKeyComparator(), rep_cls())
    n_threads, per_thread = 8, 2000
    barrier = threading.Barrier(n_threads + 1)
    done = threading.Event()
    seen = []

    def worker(t):
        barrier.wait()
        ops = [(ValueType.VALUE, b"%02d-%08d" % (t, i), b"val%08d" % i)
               for i in range(per_thread)]
        for s in range(0, per_thread, 100):
            mt.add_batch(t * per_thread + s + 1, ops[s:s + 100])

    def reader():
        barrier.wait()
        while not done.is_set():
            keys = [k for k, _ in mt.iter_entries()]
            assert keys == sorted(keys)
            seen.append(len(keys))

    ts = [threading.Thread(target=worker, args=(t,))
          for t in range(n_threads)]
    r = threading.Thread(target=reader)
    r.start()
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    done.set()
    r.join()
    entries = list(mt.iter_entries())
    assert len(entries) == n_threads * per_thread
    keys = [k for k, _ in entries]
    assert keys == sorted(keys)
    assert seen == sorted(seen)


# ---------------------------------------------------------------------------
# The async WAL writer (tests/test_write_plane.py)
# ---------------------------------------------------------------------------


def test_async_wal_fsync_coalescing(tmp_path):                  # :200
    """Concurrent sync=True writers through the async WAL writer, in
    pipelined mode (the durability barrier waits outside _mutex): fsyncs
    coalesce (WRITE_GROUP_FSYNCS_COALESCED equals the ring's count), and
    every acknowledged write survives a reopen. Seeded fsync delays widen
    the window."""
    env = PosixEnv()
    env.wal_writer_fault = WalWriterFaultInjector(
        rate=0.5, plans=("delay",), delay_sec=0.002, ops=("sync",), seed=5)
    stats = st.Statistics()
    d = str(tmp_path / "a")
    db = dbm.DB.open(d, Options(
        create_if_missing=True, statistics=stats,
        enable_pipelined_write=True, enable_async_wal=True,
        compaction_executor_factory=LocalCompactionExecutorFactory()),
        env=env)
    wo = WriteOptions(sync=True)
    errs = []

    def w(t):
        try:
            for i in range(60):
                db.put(b"t%d-%04d" % (t, i), b"v", wo)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=w, args=(t,)) for t in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    ring = db._wal_ring
    assert ring is not None and ring.fsyncs_coalesced > 0
    assert stats.get_ticker_count(st.WRITE_GROUP_FSYNCS_COALESCED) \
        == ring.fsyncs_coalesced
    db.close()
    assert not ring._thread.is_alive(), "close() left the WAL writer"
    with _port(d) as r:
        for t in range(6):
            for i in range(60):
                assert r.get(b"t%d-%04d" % (t, i)) == b"v"


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["group-commit", "pipelined"])
def test_async_wal_fault_injection_error_and_resume(tmp_path,  # :249
                                                    pipelined):
    """A seeded WAL-writer failure fails the group it covers, latches a
    HARD background error with reason "wal" that blocks writes until
    resume(); acknowledged writes stay readable, before and after a
    reopen."""
    env = PosixEnv()
    inj = WalWriterFaultInjector(schedule={3: "fail", 6: "delay"})
    env.wal_writer_fault = inj
    d = str(tmp_path / "fi")
    db = dbm.DB.open(d, Options(
        create_if_missing=True, enable_async_wal=True,
        enable_pipelined_write=pipelined,
        compaction_executor_factory=LocalCompactionExecutorFactory()),
        env=env)
    assert db._wal_ring.fault_hook is inj
    wo = WriteOptions(sync=True)
    acked, failed = [], []
    for i in range(10):
        k = b"f%04d" % i
        try:
            db.put(k, b"v", wo)
            acked.append(k)
        except IOError_:
            failed.append(k)
            assert db._bg_error_severity == Severity.HARD_ERROR
            assert db._bg_error_reason == "wal"
            with pytest.raises(IOError_, match="background error pending"):
                db.put(b"blocked", b"v")
            db.resume()
    assert failed, "no injected failure surfaced"
    assert inj.injected_counts().get("fail", 0) >= 1
    assert db._bg_error is None
    for k in acked:
        assert db.get(k) == b"v"
    db.close()
    with _port(d) as r:
        for k in acked:
            assert r.get(k) == b"v"
        assert r.get(b"blocked") is None


class _SlowFile:
    def __init__(self):
        self.data = b""
        self.fsyncs = 0
        self.fail_next_append = False

    def append(self, d):
        if self.fail_next_append:
            self.fail_next_append = False
            raise IOError_("boom")
        self.data += bytes(d)

    def flush(self):
        pass

    def sync(self):
        self.fsyncs += 1


def test_aio_ring_coalescing_unit():
    """AsyncIORing: N sync tokens drained together make ONE fsync; an
    append error parks on its file, surfaces at that file's next barrier
    only, then clears. The worker is held inside a first append (its
    fault hook waits on a gate) so the ops after it drain as one batch."""
    gate = threading.Event()
    held = threading.Event()

    def hook(kind, nbytes):
        if kind == "append" and not gate.is_set():
            held.set()
            gate.wait()

    coalesced = []
    ring = AsyncIORing(capacity=64, fault_hook=hook,
                       coalesce_cb=coalesced.append)
    f, g = _SlowFile(), _SlowFile()
    ring.submit_append(f, b"x0")
    held.wait()
    toks = [ring.submit_sync(f)]
    for i in range(1, 4):
        ring.submit_append(f, b"x%d" % i)
        toks.append(ring.submit_sync(f))
    gate.set()
    for t in toks:
        t.wait()
    assert f.data == b"x0x1x2x3"
    assert f.fsyncs == 1 and ring.fsyncs == 1
    assert ring.fsyncs_coalesced == 3 and coalesced == [3]
    # A failed append on f: its token and f's next barrier raise; g's
    # barrier in the same batch does not, and f resumes clean.
    f.fail_next_append = True
    atok = ring.submit_append(f, b"bad")
    btok = ring.submit_barrier(f)
    ring.submit_append(g, b"g")
    gtok = ring.submit_barrier(g)
    with pytest.raises(IOError_):
        atok.wait()
    with pytest.raises(IOError_):
        btok.wait()
    gtok.wait()
    assert g.data == b"g"
    ring.submit_append(f, b"ok")
    ring.submit_barrier(f).wait()
    assert f.data.endswith(b"ok")
    ring.close()
    assert not ring._thread.is_alive()
    with pytest.raises(IOError_, match="closed"):
        ring.submit_append(f, b"late")


# ---------------------------------------------------------------------------
# The WriteBufferManager (tests/test_db.py:544)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rep", ["skiplist", "cspp"])
def test_write_buffer_manager_across_dbs(tmp_path, rep):
    """A shared 24 KiB budget forces flushes across two DBs whose 64 MiB
    write buffers never would; flush() releases each DB's data charge (a
    residual under 4096 bytes: empty memtables' arenas count), close()
    all of it."""
    wbm = WriteBufferManager(24 * 1024)
    kw = dict(write_buffer_size=1 << 26, write_buffer_manager=wbm,
              memtable_rep=rep)
    with _port(str(tmp_path / "db1"), **kw) as db1, \
            _port(str(tmp_path / "db2"), **kw) as db2:
        for i in range(400):
            db1.put(b"a%04d" % i, b"x" * 40)
            db2.put(b"b%04d" % i, b"y" * 40)
        flushed = (db1.versions.current.num_files()
                   + db2.versions.current.num_files())
        assert flushed > 0, "shared budget never triggered a flush"
        assert wbm.memory_usage() <= 64 * 1024
        assert wbm.memory_usage() == db1._wbm_charged + db2._wbm_charged
        assert db1.get(b"a0000") == b"x" * 40
        assert db2.get(b"b0399") == b"y" * 40
        db1.flush()
        db2.flush()
        assert wbm.memory_usage() < 4096, \
            "flush must release the DB's data charge"
    assert wbm.memory_usage() == 0, "close must release the DB's charge"
