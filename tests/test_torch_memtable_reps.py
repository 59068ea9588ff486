"""The trie and hash memtable reps of toplingdb_tpu_torch against
toplingdb_tpu's, on the CPU:

- the CSPP-role trie (NativeTrieRep) on the same seeded inserts as the
  reference's trie: `iter_all`, `len`, `memory_usage`, random seeks both
  ways, the forward position chain, `iter_from`, the columnar `export`
  bytes, a duplicate (key, seqno, type) replacing in place, and the wire
  batch inserts, plain and protected; and against the port's skiplist
  (tests/test_trie_memtable.py:19, :58, :76);
- the prefix-bucketed HashPrefixRep against the reference's on the same
  inserts and seeks;
- DBs on `memtable_rep="cspp"` and `"hash_skiplist"` with the reference's
  DB on the same rep: a model check of gets and scans
  (tests/test_trie_memtable.py:84, tests/test_memtable.py:77), and
  single-writer byte parity on `cspp` and `hash_skiplist:8` with the
  write plane on and off: WAL, SST and MANIFEST bytes, level sets, gets,
  forward and backward scans, snapshot reads and every ticker (both DBs
  on the host compaction path, named "cpu"), flushing only on explicit
  calls (the trie charges memory differently from the skiplist);
- the native point-read chain decides every get of a trie DB, in its
  memtable and in its SSTs, through the chain's trie branch.

Tolerance: none.
"""

import random

import numpy as np
import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.db import memtable as ref_mem
from toplingdb_tpu.db.dbformat import InternalKeyComparator as RefICmp
from toplingdb_tpu.db.write_batch import WriteBatch as RefWriteBatch
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.utils import statistics as ref_st

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db import memtable
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.utils import statistics as st

from test_torch_db import Twin, pinned_clock  # noqa: F401


def _random_key(rng, max_len=20):
    return bytes(rng.randrange(256) for _ in range(rng.randrange(max_len + 1)))


def _fill_reps(reps, seed, n=4000, key_space=None):
    """The same seeded (user key, inv) -> value inserts into every rep;
    returns the inserted sort keys. Keys of 0-20 random bytes, or of
    `key_space` distinct keys when given (many versions a key)."""
    rng = random.Random(seed)
    pool = ([_random_key(rng) for _ in range(key_space)] if key_space
            else None)
    skeys = []
    for i in range(n):
        uk = rng.choice(pool) if pool else _random_key(rng)
        inv = rng.randrange(1 << 62)
        v = bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
        for r in reps:
            r.insert((uk, inv), v)
        skeys.append((uk, inv))
    return skeys


def _probes(rng, skeys, n=600):
    for _ in range(n):
        if rng.random() < 0.5:
            yield rng.choice(skeys)
        else:
            yield _random_key(rng), rng.randrange(1 << 62)


def _entry(rep, pos):
    return rep.entry_at(pos) if pos else None


@pytest.mark.parametrize("seed,key_space", [(3, None), (11, None), (7, 300)],
                         ids=["random-3", "random-11", "versions-7"])
def test_trie_matches_reference_trie(seed, key_space):
    """The port's trie against the reference's on the same inserts: the
    whole order, count and charged memory, seeks both ways at random
    probes, the position chain forward from a seek, and iter_from."""
    port, ref = memtable.NativeTrieRep(), ref_mem.NativeTrieRep()
    skeys = _fill_reps([port, ref], seed, key_space=key_space)
    assert len(port) == len(ref)
    assert list(port.iter_all()) == list(ref.iter_all())
    assert port.memory_usage() == ref.memory_usage() > 0
    rng = random.Random(seed + 1)
    for skey in _probes(rng, skeys):
        for seek in ("pos_seek_ge", "pos_seek_lt"):
            pp = getattr(port, seek)(skey)
            rp = getattr(ref, seek)(skey)
            assert _entry(port, pp) == _entry(ref, rp), (seek, skey)
        pp, rp = port.pos_seek_ge(skey), ref.pos_seek_ge(skey)
        for _ in range(5):
            assert _entry(port, pp) == _entry(ref, rp)
            if pp is None:
                break
            pp, rp = port.pos_next(pp), ref.pos_next(rp)
    for skey in list(_probes(rng, skeys, 20)):
        assert list(port.iter_from(skey)) == list(ref.iter_from(skey))
    assert _entry(port, port.pos_first()) == _entry(ref, ref.pos_first())
    assert _entry(port, port.pos_last()) == _entry(ref, ref.pos_last())


def test_trie_matches_skiplist_random():                     # :19
    """The port's trie gives the port's skiplist's answers (and the
    reference trie's) across a random workload with keys of 0-20 bytes."""
    sl, tr = memtable.NativeSkipListRep(), memtable.NativeTrieRep()
    ref = ref_mem.NativeTrieRep()
    rng = random.Random(3)
    keys = []
    for i in range(8000):
        klen = rng.choice([0, 1, 3, 8, 8, 20])
        uk = bytes(rng.randrange(256) for _ in range(klen))
        inv = rng.randrange(1 << 62)
        for r in (sl, tr, ref):
            r.insert((uk, inv), b"v%d" % i)
        keys.append((uk, inv))
    assert len(sl) == len(tr) == len(ref)
    assert list(sl.iter_all()) == list(tr.iter_all()) == list(ref.iter_all())
    for skey in _probes(rng, keys, 800):
        for seek in ("pos_seek_ge", "pos_seek_lt"):
            got = [_entry(r, getattr(r, seek)(skey)) for r in (sl, tr, ref)]
            assert got[0] == got[1] == got[2], (seek, skey)
    pa, pb = sl.pos_first(), tr.pos_first()
    for _ in range(200):
        assert _entry(sl, pa) == _entry(tr, pb)
        if pa is None:
            break
        pa, pb = sl.pos_next(pa), tr.pos_next(pb)
    assert _entry(sl, sl.pos_last()) == _entry(tr, tr.pos_last())


def test_trie_export_matches_reference_and_skiplist():        # :58
    """tpulsm_trie_export's columnar arrays equal the reference trie's
    export and the port's skiplist export of the same inserts."""
    sl, tr = memtable.NativeSkipListRep(), memtable.NativeTrieRep()
    ref = ref_mem.NativeTrieRep()
    rng = random.Random(9)
    for i in range(5000):
        uk = b"k%06d" % rng.randrange(1500) if i % 7 else _random_key(rng)
        inv = rng.randrange(1 << 60)
        for r in (sl, tr, ref):
            r.insert((uk, inv), b"val%d" % i)
    got = [r.export_columnar() for r in (tr, ref, sl)]
    assert None not in got
    for other in got[1:]:
        for f in ("key_buf", "key_offs", "key_lens", "val_buf", "val_offs",
                  "val_lens"):
            assert np.array_equal(getattr(got[0][0], f),
                                  getattr(other[0], f)), f
        assert np.array_equal(got[0][1], other[1])
        assert np.array_equal(got[0][2], other[2])


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_trie_duplicate_replaces_in_place(pkg):               # :76
    rep = (memtable.NativeTrieRep() if pkg == "port"
           else ref_mem.NativeTrieRep())
    rep.insert((b"k", 42), b"v1")
    rep.insert((b"k", 42), b"v2")  # WAL-replay duplicate
    assert len(rep) == 1
    assert rep.entry_at(rep.pos_first()) == ((b"k", 42), b"v2")
    rep.insert((b"", 7), b"empty")  # the empty key's own stripe
    assert rep.entry_at(rep.pos_first()) == ((b"", 7), b"empty")
    assert len(rep) == 2


@pytest.mark.parametrize("pb", [0, 8], ids=["plain", "protected"])
def test_trie_wire_batch_insert_matches_reference(pb):
    """WriteBatch wire images into a trie memtable through one native call
    (tpulsm_trie_insert_wb, or _insert_wb_prot re-hashing every record
    against the batch's protection vector): the same applied counts,
    entries, memory and carried protection as the reference's."""
    port = memtable.MemTable(InternalKeyComparator(),
                             memtable.NativeTrieRep(), protection_bytes=pb)
    ref = ref_mem.MemTable(RefICmp(), ref_mem.NativeTrieRep(),
                           protection_bytes=pb)
    rng = random.Random(5)
    seq = 1
    for _ in range(40):
        pbat, rbat = WriteBatch(), RefWriteBatch()
        for _ in range(rng.randrange(1, 30)):
            k = b"k%04d" % rng.randrange(300)
            if rng.random() < 0.8:
                v = bytes(rng.randrange(256) for _ in range(rng.randrange(50)))
                pbat.put(k, v)
                rbat.put(k, v)
            else:
                pbat.delete(k)
                rbat.delete(k)
        if pb:
            pbat.ensure_protection(pb)
            rbat.ensure_protection(pb)
            got = port.add_encoded(seq, pbat.data(), pbat._prot, pb)
            want = ref.add_encoded(seq, rbat.data(), rbat._prot, pb)
        else:
            got = port.add_encoded(seq, pbat.data())
            want = ref.add_encoded(seq, rbat.data())
        assert got == want == pbat.count()
        seq += pbat.count()
    assert list(port._rep.iter_all()) == list(ref._rep.iter_all())
    assert port.approximate_memory_usage() == ref.approximate_memory_usage()
    assert port.protection_map() == ref.protection_map()


def test_hash_prefix_rep_matches_reference():
    """HashPrefixRep (4-byte buckets) against the reference's on the same
    inserts: order, count, memory and seeks both ways."""
    port = memtable.create_memtable_rep("hash_skiplist:4")
    ref = ref_mem.create_memtable_rep("hash_skiplist:4")
    assert type(ref).__name__ == type(port).__name__ == "HashPrefixRep"
    skeys = _fill_reps([port, ref], 21, n=3000, key_space=800)
    assert len(port) == len(ref)
    assert list(port.iter_all()) == list(ref.iter_all())
    assert port.memory_usage() == ref.memory_usage()
    rng = random.Random(22)
    for skey in _probes(rng, skeys, 400):
        for seek in ("pos_seek_ge", "pos_seek_lt"):
            pp = getattr(port, seek)(skey)
            rp = getattr(ref, seek)(skey)
            assert _entry(port, pp) == _entry(ref, rp), (seek, skey)
        pp = port.pos_seek_ge(skey)
        rp = ref.pos_seek_ge(skey)
        for _ in range(3):
            assert _entry(port, pp) == _entry(ref, rp)
            if pp is None:
                break
            pp, rp = port.pos_next(pp), ref.pos_next(rp)


# ---------------------------------------------------------------------------
# DBs on the reps
# ---------------------------------------------------------------------------


def _views(db, keys):
    it = db.new_iterator()
    it.seek_to_first()
    fwd = list(it.entries())
    it = db.new_iterator()
    it.seek_to_last()
    rev = []
    while it.valid():
        rev.append((it.key(), it.value()))
        it.prev()
    return [db.get(k) for k in keys], fwd, rev


@pytest.mark.parametrize("rep", ["cspp", "hash_skiplist"])
def test_rep_db_model_check(tmp_path, rep):             # :84, memtable :77
    """A DB on the rep, with flushes on memory (a 256 KiB write buffer) and
    background compactions, against a dict model and the reference's DB
    on the same rep: gets, forward and backward scans, after a reopen."""
    rng = random.Random(1)
    model = {}
    rdb = ref_dbm.DB.open(str(tmp_path / "ref"), RefOptions(
        create_if_missing=True, memtable_rep=rep,
        write_buffer_size=256 * 1024))
    pdb = dbm.DB.open(str(tmp_path / "port"), Options(
        create_if_missing=True, memtable_rep=rep,
        write_buffer_size=256 * 1024,
        compaction_executor_factory=LocalCompactionExecutorFactory()))
    try:
        for i in range(8000):
            k = b"key%05d" % rng.randrange(3000)
            if rng.random() < 0.1:
                for db in (rdb, pdb):
                    db.delete(k)
                model[k] = None
            else:
                v = b"val%d" % i
                for db in (rdb, pdb):
                    db.put(k, v)
                model[k] = v
        for db in (rdb, pdb):
            db.flush()
            db.wait_for_compactions()
        keys = sorted(model) + [b"absent"]
        want = ([model.get(k) for k in keys],
                sorted((k, v) for k, v in model.items() if v is not None))
        pv, rv = _views(pdb, keys), _views(rdb, keys)
        assert pv == rv
        assert (pv[0], pv[1]) == want and pv[2] == list(reversed(pv[1]))
    finally:
        pdb.close()
        rdb.close()
    with dbm.DB.open(str(tmp_path / "port"), Options(
            memtable_rep=rep, compaction_executor_factory=(
                LocalCompactionExecutorFactory()))) as db:
        assert _views(db, keys) == pv


class RepTwin(Twin):
    """Twin on one memtable rep with each side's own Statistics and the
    write plane switched alike: the port's by DB.open, the reference's by
    its env knob."""

    def __init__(self, root, monkeypatch, rep, native_plane, executor):
        self.mp = monkeypatch
        self.native_plane = native_plane
        self.ref_stats = ref_st.Statistics()
        self.port_stats = st.Statistics()
        super().__init__(root, executor, byte_parity=True, memtable_rep=rep)

    def open(self):
        ro, po = self._options()
        ro.statistics, po.statistics = self.ref_stats, self.port_stats
        self.mp.setenv("TPULSM_WRITE_PLANE", "1" if self.native_plane
                       else "0")
        self.ref = ref_dbm.DB.open(self.ref_dir, ro)
        self.port = dbm.DB.open(self.dir, po, write_plane=self.native_plane)

    def check(self, snap=None):
        out = super().check(snap)
        # Twin scans the port backward too; the reference's backward scan
        # here keeps the two sides' iterator tickers comparable.
        assert self._scan(self.ref, reverse=True) == list(reversed(out))
        return out


def _single_writer_ops(t, rng, n):
    for _ in range(n):
        r = rng.random()
        k = b"key%04d" % rng.randrange(400)
        v = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 60)))
        if r < 0.6:
            t.put(k, v)
        elif r < 0.7:
            t.delete(k)
        elif r < 0.75:
            a = rng.randrange(400)
            t.delete_range(b"key%04d" % a, b"key%04d" % (a + 5))
        else:
            t.write([("put", b"key%04d" % rng.randrange(400), v),
                     ("delete", b"key%04d" % rng.randrange(400)),
                     ("put", k, v[::-1])])


def _tickers_equal(t):
    pt, rt = t.port_stats.tickers(), t.ref_stats.tickers()
    skip = {st.WRITE_GROUP_FOLLOWERS, st.WRITE_DONE_BY_OTHER,
            st.STALL_MICROS}
    diff = {k: (pt.get(k), rt.get(k)) for k in set(pt) | set(rt)
            if k not in skip and pt.get(k, 0) != rt.get(k, 0)}
    assert not diff


@pytest.mark.parametrize("rep,plane,executor", [
    ("cspp", "native", "local"), ("cspp", "python", "local"),
    ("hash_skiplist:8", "native", "local"),
    ("hash_skiplist:8", "python", "local"), ("cspp", "native", "device")])
def test_rep_byte_parity(tmp_path, pinned_clock, monkeypatch, rep, plane,
                         executor):
    """The same seeded single-writer ops through both DBs on the rep,
    flushing only on explicit calls: equal WAL, SST and MANIFEST bytes,
    level sets, gets, scans both ways and snapshot reads (Twin.check);
    every ticker equal on the host path; after a reopen (WAL replay into
    the rep) all of it again."""
    t = RepTwin(str(tmp_path), monkeypatch, rep, plane == "native",
                executor)
    try:
        rng = random.Random(77)
        for _ in range(3):
            _single_writer_ops(t, rng, 150)
            snap = t.snapshot()
            _single_writer_ops(t, rng, 40)
            t.check(snap)
            t.ref.release_snapshot(snap[0])
            t.port.release_snapshot(snap[1])
            t.flush()
            t.check()
        _single_writer_ops(t, rng, 100)
        t.compact_range()
        t.check()
        _single_writer_ops(t, rng, 80)
        t.port._wal.sync()
        t.ref._wal.sync()
        t.reopen()
        pt = t.port_stats.tickers()
        native = pt.get(st.WRITE_GROUP_NATIVE_COMMITS, 0)
        assert (native > 0) == (plane == "native" and rep == "cspp")
        if executor == "local":
            _tickers_equal(t)
    finally:
        t.close()


def test_native_get_decides_trie_probes(tmp_path):
    """Every get of a trie DB, whether it finds its key in the trie
    memtable, in an SST below it, or nowhere, is decided by the native
    chain through its trie branch, with the reference's answers."""
    rdb = ref_dbm.DB.open(str(tmp_path / "ref"), RefOptions(
        create_if_missing=True, memtable_rep="cspp"))
    pdb = dbm.DB.open(str(tmp_path / "port"), Options(
        create_if_missing=True, memtable_rep="cspp",
        compaction_executor_factory=LocalCompactionExecutorFactory()))
    calls = {"native": 0, "python": 0}
    chain = pdb._native_get

    def spy(*a):
        r = chain(*a)
        calls["native" if r[0] else "python"] += 1
        return r

    pdb._native_get = spy
    try:
        for db in (rdb, pdb):
            for i in range(2000):
                db.put(b"sst%05d" % i, b"s%d" % i)
            db.flush()
            for i in range(0, 2000, 3):
                db.put(b"sst%05d" % i, b"m%d" % i)  # shadows the SST
            for i in range(1000):
                db.put(b"mem%05d" % i, b"x" * (i % 50))
            db.delete(b"mem00007")
            db.put(b"", b"empty key")
        assert isinstance(pdb.mem._rep, memtable.NativeTrieRep)
        assert len(pdb.mem._rep) > 1000
        snap = (rdb.get_snapshot(), pdb.get_snapshot())
        for db in (rdb, pdb):
            db.put(b"mem00001", b"after the snapshot")
        probes = ([b"sst%05d" % i for i in range(0, 2000, 7)]
                  + [b"mem%05d" % i for i in range(0, 1000, 3)]
                  + [b"", b"absent", b"mem", b"sst99999"])
        for k in probes:
            assert pdb.get(k) == rdb.get(k), k
            assert pdb.get(k, ReadOptions(snapshot=snap[1])) == \
                rdb.get(k, RefReadOptions(snapshot=snap[0])), k
        assert pdb.get(b"mem00001") == b"after the snapshot"
        assert calls == {"native": 2 * len(probes) + 1, "python": 0}, calls
        kinds = [getattr(m._rep, "_nget_mem_kind", None)
                 for m in [pdb.mem] + pdb.imm]
        assert kinds and set(kinds) == {1}
    finally:
        pdb.close()
        rdb.close()
