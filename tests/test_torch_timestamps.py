"""User-defined timestamps in toplingdb_tpu_torch's DB against
toplingdb_tpu's, on the CPU.

- the twenty cases of tests/test_timestamps.py run on each package, the
  port's compactions on DeviceCompactionExecutorFactory(device="cpu") (the
  per-entry device route with the history trim), the reference's on its
  host path (its device route refuses the comparator and its executor
  runs such jobs on the host), with the reference test's assertions and
  equal observations;
- a seeded twin of puts, deletes, single deletes, snapshots, flushes,
  increase_full_history_ts_low, compact_range and reopens: gets,
  get_with_ts, multi_get and scans at a read timestamp, the level sets and
  the live SST bytes are equal, and every port job ran on the device
  executor;
- over seeded timestamp streams with snapshots, bottommost on and off and
  several trim points, device_gc_entries (the device sort and GC mask,
  then the shared trim_history generator) yields what the host path's
  CompactionIterator.entries yields, in both packages;
- an automatic L0→L1 job after increase_full_history_ts_low trims on both
  sides: equal SST bytes (the port's scheduler carries the trim point into
  every picked job).

Tolerance: none.
"""

import os
import random

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.compaction.compaction_iterator import (
    CompactionIterator as RefCompactionIterator,
)
from toplingdb_tpu.db import dbformat as ref_dbformat
from toplingdb_tpu.db.write_batch import WriteBatch as RefWriteBatch
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.utils import status as ref_status

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.compaction_iterator import (
    CompactionIterator,
)
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.ops.device_compaction import device_gc_entries
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.utils import status

from test_torch_db import pinned_clock  # noqa: F401


class Side:
    """One package's names, so a scenario runs unchanged on either."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.dbformat = ref_dbformat if ref else dbformat
        self.ReadOptions = RefReadOptions if ref else ReadOptions
        self.WriteBatch = RefWriteBatch if ref else WriteBatch
        self.InvalidArgument = (ref_status if ref else status).InvalidArgument
        self.ts = self.dbformat.U64_TS_BYTEWISE

    def options(self, ts=True, **kw):
        if ts:
            kw["comparator"] = self.ts
        if self.ref:
            return RefOptions(**kw)  # the host path, as its executor runs it
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)


def raises(s, fn):
    """The name of the exception `fn` raises (InvalidArgument expected)."""
    with pytest.raises(s.InvalidArgument) as e:
        fn()
    return type(e.value).__name__


def device_jobs(s, db):
    """The port's jobs all ran on the device executor; their count."""
    if s.ref:
        return None
    assert db._compaction_scheduler.num_local_jobs == 0
    return len(db.options.compaction_executor_factory.jobs)


def entries(it):
    it.seek_to_first()
    return [(k, v) for k, v in it.entries()]


# ---------------------------------------------------------------------------
# The cases of tests/test_timestamps.py
# ---------------------------------------------------------------------------


def sc_ts_encoding_orders_descending(s, d, obs):
    enc, dec = s.dbformat.encode_ts, s.dbformat.decode_ts
    assert enc(9) < enc(5) < enc(0)
    for ts in (0, 1, 12345, 2**63, 2**64 - 1):
        assert dec(enc(ts)) == ts
        obs.append(enc(ts))
    for k in (b"", b"k", b"\x00", b"a\x00\xffb"):
        obs.append(s.dbformat.encode_ts_key(k, 7))
        assert s.dbformat.strip_ts(obs[-1]) == k
        assert s.dbformat.decode_ts(obs[-1]) == 7


def sc_ts_required_and_rejected(s, d, obs):
    db = s.DB.open(os.path.join(d, "db"), s.options())
    obs.append(raises(s, lambda: db.put(b"k", b"v")))
    plain = s.DB.open(os.path.join(d, "plain"), s.options(ts=False))
    obs.append(raises(s, lambda: plain.put(b"k", b"v", ts=5)))
    obs.append(raises(s, lambda: plain.get(
        b"k", s.ReadOptions(timestamp=5))))
    plain.close()
    db.close()


def sc_read_as_of_timestamp(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"k", b"v@10", ts=10)
    db.put(b"k", b"v@20", ts=20)
    db.put(b"k", b"v@30", ts=30)
    obs += [db.get(b"k"), db.get(b"k", s.ReadOptions(timestamp=25)),
            db.get(b"k", s.ReadOptions(timestamp=10)),
            db.get(b"k", s.ReadOptions(timestamp=9)),
            db.get_with_ts(b"k", s.ReadOptions(timestamp=25))]
    db.close()
    assert obs == [b"v@30", b"v@20", b"v@10", None, (b"v@20", 20)]


def sc_delete_at_timestamp(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"k", b"alive", ts=10)
    db.delete(b"k", ts=20)
    db.put(b"k", b"reborn", ts=30)
    obs += [db.get(b"k", s.ReadOptions(timestamp=15)),
            db.get(b"k", s.ReadOptions(timestamp=25)), db.get(b"k")]
    db.close()
    assert obs == [b"alive", None, b"reborn"]


def sc_iterate_as_of_ts_with_deletions(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"a", b"a@10", ts=10)
    db.put(b"b", b"b@10", ts=10)
    db.delete(b"b", ts=20)
    db.put(b"c", b"c@30", ts=30)
    obs += [entries(db.new_iterator(s.ReadOptions(timestamp=25))),
            entries(db.new_iterator(s.ReadOptions(timestamp=15))),
            entries(db.new_iterator(s.ReadOptions()))]
    db.close()
    assert obs == [[(b"a", b"a@10")],
                   [(b"a", b"a@10"), (b"b", b"b@10")],
                   [(b"a", b"a@10"), (b"c", b"c@30")]]


def sc_iterator_timestamp_accessor_and_backward(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"x", b"x@5", ts=5)
    db.put(b"y", b"y@7", ts=7)
    it = db.new_iterator(s.ReadOptions())
    it.seek(b"x")
    obs.append((it.valid(), it.key(), it.timestamp()))
    it.seek_to_last()
    obs.append((it.key(), it.value(), it.timestamp()))
    it.prev()
    obs.append(it.key())
    it.seek_for_prev(b"xzz")
    obs.append(it.key())
    db.close()
    assert obs == [(True, b"x", 5), (b"y", b"y@7", 7), b"x", b"x"]


def sc_ts_survives_flush_compact_reopen(s, d, obs):
    db = s.DB.open(d, s.options())
    for i in range(100):
        db.put(b"k%03d" % i, b"old%d" % i, ts=10)
    db.flush()
    for i in range(0, 100, 2):
        db.put(b"k%03d" % i, b"new%d" % i, ts=20)
    db.flush()
    db.compact_range()
    obs += [db.get(b"k000", s.ReadOptions(timestamp=15)), db.get(b"k000"),
            device_jobs(s, db) != 0]
    db.close()
    db = s.DB.open(d, s.options())
    obs += [db.get(b"k002", s.ReadOptions(timestamp=12)), db.get(b"k001")]
    db.close()
    assert obs == [b"old0", b"new0", True, b"old2", b"old1"]


def sc_full_history_ts_low_trims_compaction(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"k", b"v@10", ts=10)
    db.put(b"k", b"v@20", ts=20)
    db.put(b"k", b"v@30", ts=30)
    db.flush()
    db.increase_full_history_ts_low(25)
    obs.append(raises(s, lambda: db.increase_full_history_ts_low(5)))
    db.compact_range()
    obs += [db.get(b"k", s.ReadOptions(timestamp=26)), db.get(b"k")]
    obs.append(raises(s, lambda: db.new_iterator(
        s.ReadOptions(timestamp=10))))
    # The trim collapsed v@10 behind v@20 (the value visible at 25).
    st = db.versions.column_families[0]
    obs.append(sum(f.num_entries for _, f in st.current.all_files()))
    db.close()
    assert obs[1:4] == [b"v@20", b"v@30", "InvalidArgument"]
    assert obs[4] == 2


def sc_tombstone_not_dropped_at_bottommost(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"k", b"old", ts=3)
    db.delete(b"k", ts=5)
    db.flush()
    db.compact_range()
    obs += [db.get(b"k"), db.get(b"k", s.ReadOptions(timestamp=4))]
    db.close()
    assert obs == [None, b"old"]


def sc_trim_respects_seq_snapshots(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"k", b"v1", ts=1)
    snap = db.get_snapshot()
    db.put(b"k", b"v2", ts=2)
    db.increase_full_history_ts_low(10)
    db.flush()
    db.compact_range()
    obs += [db.get(b"k", s.ReadOptions(snapshot=snap)), db.get(b"k")]
    snap.release()
    db.close()
    assert obs == [b"v1", b"v2"]


def sc_ts_low_persists_across_reopen(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"k", b"v", ts=50)
    db.increase_full_history_ts_low(40)
    db.close()
    db = s.DB.open(d, s.options())
    obs.append(db.options.full_history_ts_low)
    obs.append(raises(s, lambda: db.increase_full_history_ts_low(30)))
    db.close()
    # A caller's lower value never lowers the persisted point.
    db = s.DB.open(d, s.options(full_history_ts_low=20))
    obs.append(db.options.full_history_ts_low)
    db.close()
    assert obs[0] == 40 and obs[2] == 40


def sc_single_delete_and_unsupported_ops(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"k", b"v", ts=10)
    db.single_delete(b"k", ts=20)
    obs += [db.get(b"k"), db.get(b"k", s.ReadOptions(timestamp=15))]
    obs.append(raises(s, lambda: db.merge(b"k", b"v")))
    obs.append(raises(s, lambda: db.delete_range(b"a", b"z")))
    db.close()
    assert obs[:2] == [None, b"v"]


def sc_raw_batch_rejected_on_ts_db(s, d, obs):
    db = s.DB.open(d, s.options())
    b = s.WriteBatch()
    b.put(b"raw", b"v")
    obs.append(raises(s, lambda: db.write(b)))
    b2 = s.WriteBatch()
    b2.delete_range(b"a", b"z")
    obs.append(raises(s, lambda: db.write(b2)))
    db.put(b"ok", b"v", ts=1)
    obs.append([k for k, _ in entries(db.new_iterator())])
    db.close()
    assert obs[2] == [b"ok"]


def sc_reads_below_ts_low_rejected(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"k", b"v@10", ts=10)
    db.put(b"k", b"v@30", ts=30)
    db.increase_full_history_ts_low(20)
    for fn in (
        lambda: db.get(b"k", s.ReadOptions(timestamp=12)),
        lambda: db.new_iterator(s.ReadOptions(timestamp=12)),
        lambda: db.multi_get([b"k"], s.ReadOptions(timestamp=12)),
        lambda: db.get_with_ts(b"k", s.ReadOptions(timestamp=12)),
    ):
        obs.append(raises(s, fn))
    obs.append(db.get(b"k", s.ReadOptions(timestamp=25)))
    db.close()
    assert obs[-1] == b"v@10"


def sc_ts_guard_on_plain_db_iterator_and_multiget(s, d, obs):
    plain = s.DB.open(d, s.options(ts=False))
    obs.append(raises(s, lambda: plain.new_iterator(
        s.ReadOptions(timestamp=5))))
    obs.append(raises(s, lambda: plain.multi_get(
        [b"k"], s.ReadOptions(timestamp=5))))
    obs.append(raises(s, lambda: plain.increase_full_history_ts_low(5)))
    plain.close()


def sc_bottommost_drops_fully_trimmed_tombstone(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"dead", b"v", ts=3)
    db.delete(b"dead", ts=5)
    db.put(b"live", b"v", ts=6)
    db.flush()
    db.increase_full_history_ts_low(100)
    db.compact_range()
    obs += [db.get(b"dead"), db.get(b"live")]
    st = db.versions.column_families[0]
    obs.append(sum(f.num_entries + f.num_deletions
                   for _, f in st.current.all_files()))
    db.close()
    assert obs == [None, b"v", 1]


def sc_multi_get_with_ts(s, d, obs):
    db = s.DB.open(d, s.options())
    db.put(b"a", b"1", ts=5)
    db.put(b"b", b"2", ts=15)
    obs += [db.multi_get([b"a", b"b", b"c"], s.ReadOptions(timestamp=10)),
            db.multi_get([b"a", b"b"])]
    db.close()
    assert obs == [[b"1", None, None], [b"1", b"2"]]


def sc_ts_fast_lookup_matches_iterator_path(s, d, obs):
    rng = random.Random(99)
    db = s.DB.open(d, s.options(write_buffer_size=16 * 1024))
    keys = [b"k%04d" % i for i in range(60)]
    for ts in range(1, 40):
        k = rng.choice(keys)
        if rng.random() < 0.15:
            db.delete(k, ts=ts)
        else:
            db.put(k, b"v-%04d-%d" % (ts, rng.randrange(99)), ts=ts)
        if ts == 15:
            db.flush()
        if ts == 25:
            db.flush()
            db.compact_range()
    for k in keys:
        for read_ts in (None, 5, 14, 20, 33, 39):
            ro = s.ReadOptions(timestamp=read_ts)
            fast = db._ts_fast_lookup(k, ro, None)
            assert fast is not db._TS_SLOW
            slow = db._ts_lookup(db.new_iterator(ro), k)
            assert fast == slow, (k, read_ts, fast, slow)
            obs.append(fast)
    db.close()


def sc_ts_get_skips_iterator_build(s, d, obs):
    n = 500
    db = s.DB.open(d, s.options())
    for i in range(n):
        db.put(b"key%06d" % i, b"v%06d" % i, ts=i + 1)
    db.flush()
    built = []
    orig = db.new_iterator
    db.new_iterator = lambda *a, **k: (built.append(1), orig(*a, **k))[1]
    for i in range(0, n, 5):
        obs.append(db.get(b"key%06d" % i))
        assert obs[-1] == b"v%06d" % i
    assert not built, "the timestamp get built an iterator"
    db.close()


def sc_ts_get_resolves_blob_values(s, d, obs):
    db = s.DB.open(d, s.options(enable_blob_files=True, min_blob_size=10))
    db.put(b"k", b"x" * 100, ts=5)
    db.flush()
    obs += [db.get(b"k", s.ReadOptions(timestamp=10)), db.get_with_ts(b"k")]
    db.close()
    assert obs == [b"x" * 100, (b"x" * 100, 5)]


SCENARIOS = [
    sc_ts_encoding_orders_descending,
    sc_ts_required_and_rejected,
    sc_read_as_of_timestamp,
    sc_delete_at_timestamp,
    sc_iterate_as_of_ts_with_deletions,
    sc_iterator_timestamp_accessor_and_backward,
    sc_ts_survives_flush_compact_reopen,
    sc_full_history_ts_low_trims_compaction,
    sc_tombstone_not_dropped_at_bottommost,
    sc_trim_respects_seq_snapshots,
    sc_ts_low_persists_across_reopen,
    sc_single_delete_and_unsupported_ops,
    sc_raw_batch_rejected_on_ts_db,
    sc_reads_below_ts_low_rejected,
    sc_ts_guard_on_plain_db_iterator_and_multiget,
    sc_bottommost_drops_fully_trimmed_tombstone,
    sc_multi_get_with_ts,
    sc_ts_fast_lookup_matches_iterator_path,
    sc_ts_get_skips_iterator_build,
    sc_ts_get_resolves_blob_values,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_timestamps_against_reference(tmp_path, scenario):
    seen = {}
    for name in ("ref", "port"):
        d = str(tmp_path / name)
        os.makedirs(d)
        obs = []
        scenario(Side(name == "ref"), d, obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------------------
# A seeded twin: the port's device jobs against the reference's host path
# ---------------------------------------------------------------------------


def _level_sets(db):
    return [[(f.number, f.smallest, f.largest, f.smallest_seqno,
              f.largest_seqno, f.num_entries, f.num_deletions)
             for f in fl] for fl in db.versions.current.files]


def _live_sst_bytes(db, d):
    out = {}
    for _lvl, f in db.versions.current.all_files():
        with open(os.path.join(d, "%06d.sst" % f.number), "rb") as fh:
            out[f.number] = fh.read()
    return out


class TsTwin:
    """A timestamp DB of each package in sibling directories; the port's
    jobs on the "cpu" device executor, the reference's on its host path;
    explicit flushes and compactions only unless `auto`."""

    def __init__(self, root, auto=False, **kw):
        self.sides = {name: Side(name == "ref") for name in ("ref", "port")}
        self.dirs = {name: os.path.join(root, name) for name in self.sides}
        kw.setdefault("write_buffer_size", 1 << 20)
        kw.setdefault("disable_auto_compactions", not auto)
        self.kw = kw
        self.auto = auto
        self.dbs = {}
        self.open()

    def open(self):
        for name, s in self.sides.items():
            self.dbs[name] = s.DB.open(self.dirs[name], s.options(**self.kw))

    def close(self):
        for db in self.dbs.values():
            db.close()

    def reopen(self):
        self.close()
        self.open()
        self.wait()

    def wait(self):
        if self.auto:
            for db in self.dbs.values():
                db.wait_for_compactions()

    def each(self, fn):
        """fn(side, db) on both sides; the two results, which must agree
        (an exception's type name stands for it)."""
        out = {}
        for name, db in self.dbs.items():
            try:
                out[name] = fn(self.sides[name], db)
            except Exception as e:  # noqa: BLE001 - compared by name
                out[name] = type(e).__name__
        assert out["port"] == out["ref"], out
        return out["port"]

    def flush(self):
        self.each(lambda s, db: db.flush())
        self.wait()

    def check(self, keys, read_ts_list, snaps=None):
        for read_ts in read_ts_list:
            for k in keys:
                self.each(lambda s, db: db.get(
                    k, s.ReadOptions(timestamp=read_ts)))
                self.each(lambda s, db: db.get_with_ts(
                    k, s.ReadOptions(timestamp=read_ts)))
            self.each(lambda s, db: db.multi_get(
                keys, s.ReadOptions(timestamp=read_ts)))
            self.each(lambda s, db: _scan_ts(
                db, s.ReadOptions(timestamp=read_ts)))
        for snap in snaps or ():
            for k in keys:
                self.each(lambda s, db: db.get(
                    k, s.ReadOptions(snapshot=snap[s.ref])))
                self.each(lambda s, db: db.get_with_ts(
                    k, s.ReadOptions(snapshot=snap[s.ref])))
        self.check_files()

    def check_files(self):
        port, ref = self.dbs["port"], self.dbs["ref"]
        assert port._compaction_scheduler.num_local_jobs == 0
        assert _level_sets(port) == _level_sets(ref)
        a = _live_sst_bytes(port, self.dirs["port"])
        b = _live_sst_bytes(ref, self.dirs["ref"])
        assert sorted(a) == sorted(b)
        for num in a:
            assert a[num] == b[num], num


def _scan_ts(db, ro):
    """Forward and backward scans at a read timestamp, with each entry's
    timestamp."""
    it = db.new_iterator(ro)
    fwd = []
    it.seek_to_first()
    while it.valid():
        fwd.append((it.key(), it.value(), it.timestamp()))
        it.next()
    bwd = []
    it.seek_to_last()
    while it.valid():
        bwd.append((it.key(), it.value(), it.timestamp()))
        it.prev()
    assert bwd == fwd[::-1]
    return fwd


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_ts_twin_sst_bytes(tmp_path, pinned_clock, seed):  # noqa: F811
    rng = random.Random(seed)
    t = TsTwin(str(tmp_path))
    keys = [b"k%03d" % i for i in range(40)] + [b"z\x00%d" % i
                                                for i in range(4)]
    ts, low = 0, 0
    snaps = []
    for step in range(600):
        ts += rng.choice((0, 1, 1, 2))
        k = rng.choice(keys)
        r = rng.random()
        if r < 0.70:
            v = b"v%d-%d" % (step, ts)
            t.each(lambda s, db: db.put(k, v, ts=ts))
        elif r < 0.85:
            t.each(lambda s, db: db.delete(k, ts=ts))
        elif r < 0.88:
            t.each(lambda s, db: db.single_delete(k, ts=ts))
        elif r < 0.90 and len(snaps) < 3:
            # (port's, reference's): indexed by Side.ref.
            snaps.append((t.dbs["port"].get_snapshot(),
                          t.dbs["ref"].get_snapshot()))
        elif r < 0.94:
            t.flush()
        elif r < 0.96 and ts > low:
            low = rng.randint(low, ts)
            t.each(lambda s, db: db.increase_full_history_ts_low(low))
        elif r < 0.98:
            t.each(lambda s, db: db.compact_range())
        elif r < 0.99 and not snaps:
            t.reopen()
        if step % 150 == 149:
            t.check(keys[::5], [None, max(low, ts // 2), ts])
    t.each(lambda s, db: db.compact_range())
    t.check(keys, [None, low, (low + ts) // 2, ts], snaps)
    assert t.dbs["port"].options.compaction_executor_factory.jobs
    for sp, sr in snaps:
        sp.release()
        sr.release()
    t.close()


# ---------------------------------------------------------------------------
# The shared trim generator on the device stream
# ---------------------------------------------------------------------------


class _ListIter:
    def __init__(self, items):
        self._items, self._i = items, 0

    def valid(self):
        return self._i < len(self._items)

    def key(self):
        return self._items[self._i][0]

    def value(self):
        return self._items[self._i][1]

    def next(self):
        self._i += 1


def _ts_stream(rng, n):
    """n raw entries of a timestamp DB: a few keys, timestamps with
    repeats, distinct seqnos, values, deletes and single deletes."""
    types = [dbformat.ValueType.VALUE] * 6 + [
        dbformat.ValueType.DELETION, dbformat.ValueType.SINGLE_DELETION]
    seqs = rng.sample(range(1, 10 * n), n)
    out = []
    for i in range(n):
        k = b"key%02d" % rng.randrange(12)
        if rng.random() < 0.1:
            k += b"\x00"
        stored = dbformat.encode_ts_key(k, rng.randrange(1, 60))
        out.append((dbformat.make_internal_key(stored, seqs[i],
                                               rng.choice(types)),
                    b"v%d" % i))
    return out


@pytest.mark.parametrize("bottommost", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_trim_on_device_stream_matches_compaction_iterator(seed, bottommost):
    rng = random.Random(seed)
    raw = _ts_stream(rng, 400)
    icmp = dbformat.InternalKeyComparator(dbformat.U64_TS_BYTEWISE)
    ref_icmp = ref_dbformat.InternalKeyComparator(
        ref_dbformat.U64_TS_BYTEWISE)
    ordered = sorted(raw, key=lambda kv: icmp.sort_key(kv[0]))
    for low in (0, 1, 20, 45, 100):
        snaps = sorted(rng.sample(range(1, 4000), rng.choice((0, 1, 3))))
        host = list(CompactionIterator(
            _ListIter(ordered), icmp, snaps, bottommost_level=bottommost,
            full_history_ts_low=low).entries())
        ref = list(RefCompactionIterator(
            _ListIter(ordered), ref_icmp, snaps, bottommost_level=bottommost,
            full_history_ts_low=low).entries())
        dev = list(device_gc_entries(
            list(raw), icmp, snaps, bottommost, device_name="cpu",
            full_history_ts_low=low))
        assert host == ref
        assert dev == host, (low, snaps)
        if low == 100 and not snaps:
            # Every timestamp is below the trim point: one version of
            # each key survives.
            assert len({dbformat.strip_ts(k[:-8]) for k, _ in dev}) \
                == len(dev)


# ---------------------------------------------------------------------------
# The scheduler's picks carry the trim point
# ---------------------------------------------------------------------------


def test_automatic_job_trims_like_the_reference(tmp_path, pinned_clock):  # noqa: F811
    t = TsTwin(str(tmp_path), auto=True,
               level0_file_num_compaction_trigger=2)
    keys = [b"a%03d" % i for i in range(50)]
    for round_ in range(3):
        for i, k in enumerate(keys):
            t.each(lambda s, db: db.put(k, b"r%d-%d" % (round_, i),
                                        ts=10 * round_ + 1))
        if round_ == 0:
            t.flush()
            t.each(lambda s, db: db.increase_full_history_ts_low(15))
    t.flush()  # the second L0 file: the automatic L0→L1 job runs
    port = t.dbs["port"]
    reasons = [j["reason"] for j in
               port.options.compaction_executor_factory.jobs]
    assert reasons and "manual" not in reasons, reasons
    t.check_files()
    # The job trimmed: round 0's versions sit below the trim point behind
    # round 1's, so the automatic job dropped them.
    n = sum(f.num_entries for _, f in port.versions.current.all_files())
    assert n < 3 * len(keys)
    t.check(keys[::7], [None, 15, 25])
    t.close()


# ---------------------------------------------------------------------------
# A timestamp job through the dcompact worker
# ---------------------------------------------------------------------------


def test_worker_ts_job_matches_in_process_job(tmp_path):
    """A u64-timestamp job dir through the port's run_job on "cpu-jax" (the
    per-entry device stream) gives the SST bytes of the same inputs through
    run_device_compaction in this process."""
    import json

    from test_torch_worker import copy_job, write_inputs, write_job

    from toplingdb_tpu_torch.compaction import worker
    from toplingdb_tpu_torch.compaction.executor import (
        CompactionParams,
        table_options_from_params,
    )
    from toplingdb_tpu_torch.compaction.picker import Compaction
    from toplingdb_tpu_torch.db.version_edit import FileMetaData
    from toplingdb_tpu_torch.env import PosixEnv
    from toplingdb_tpu_torch.ops.device_compaction import (
        run_device_compaction,
    )
    from toplingdb_tpu_torch.table.factory import open_table

    inputs = write_inputs(str(tmp_path), seed=5, comparator="u64ts")
    job = copy_job(write_job(str(tmp_path), inputs, comparator="u64ts",
                             device="cpu-jax"), "port")
    assert worker.main(["--job-dir", job]) == 0
    res = json.load(open(os.path.join(job, "results.json")))
    worker_files = {f["path"]: open(os.path.join(job, "out", f["path"]),
                                    "rb").read()
                    for f in res["output_files"]}
    assert worker_files

    params = CompactionParams.from_json(
        open(os.path.join(job, "params.json")).read())
    env = PosixEnv()
    icmp = dbformat.InternalKeyComparator(dbformat.U64_TS_BYTEWISE)
    topts = table_options_from_params(params)
    readers, metas = {}, []
    for i, path in enumerate(inputs, 1):
        readers[i] = open_table(env.new_random_access_file(path), icmp,
                                topts)
        metas.append(FileMetaData(number=i, file_size=os.path.getsize(path),
                                  smallest=b"", largest=b""))

    class Cache:
        def get_reader(self, number):
            return readers[number]

    out = tmp_path / "inproc"
    out.mkdir()
    counter = [0]

    def alloc():
        counter[0] += 1
        return counter[0]

    outputs, _stats = run_device_compaction(
        env, str(out), icmp,
        Compaction(level=0, output_level=params.output_level, inputs=metas,
                   bottommost=params.bottommost,
                   max_output_file_size=params.max_output_file_size),
        Cache(), topts, params.snapshots, new_file_number=alloc,
        creation_time=params.creation_time, device_name="cpu")
    mine = {"%06d.sst" % m.number: open(os.path.join(
        str(out), "%06d.sst" % m.number), "rb").read() for m in outputs}
    assert mine == worker_files
