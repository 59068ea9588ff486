"""The DB engine's modules of toplingdb_tpu_torch against toplingdb_tpu's,
on the same inputs, on the CPU:

- WriteBatch wire bytes for every record kind (default and non-default
  column family), the parsed records, and the insert into a memtable;
- LogWriter bytes and LogReader records across 32 KiB block edges, in the
  classic and the recyclable formats, each package reading the other's
  log, and a torn tail dropped;
- VersionEdit encode bytes and decode, each package decoding the other's;
- MemTable point lookups, ordered iteration and iterator seeks on the
  skiplist and vector reps; the skiplist and trie reps refuse to start
  without the native library instead of dropping to the Python rep; every
  rep name of the factory opens a DB (the trie and hash reps against the
  reference's: tests/test_torch_memtable_reps.py), and a bad one raises
  InvalidArgument;
- the leveled picker's scores and pick on the same Version, GetContext's
  answers over the same entry streams, the subcompaction boundaries, and
  the CPU compaction path's SST bytes with 1 and 3 subcompactions;
- the retry driver: an executor failing twice then succeeding, a failing
  executor raising its last error, and the job deadline;
- every option the port's DB does not run raises NotSupported at open
  (the compaction styles, periodic compaction and blob files open:
  tests/test_torch_compaction_styles.py, tests/test_torch_blob_db.py);
  the three integrity fields, the five write-path fields and the three
  read-path fields open (`test_ported_option_opens`; held against the
  reference in tests/test_torch_integrity.py,
  tests/test_torch_write_modes.py, tests/test_torch_block_cache.py and
  tests/test_torch_read_path.py).

Tolerance: none; bytes, records and answers must be equal.
"""

import dataclasses
import os
import random
import struct
import time

import pytest

from toplingdb_tpu.compaction import compaction_job as ref_cj
from toplingdb_tpu.compaction import picker as ref_picker
from toplingdb_tpu.db import dbformat as ref_dbf
from toplingdb_tpu.db import get_context as ref_gc
from toplingdb_tpu.db import log as ref_log
from toplingdb_tpu.db import memtable as ref_mem
from toplingdb_tpu.db import version_edit as ref_ve
from toplingdb_tpu.db import version_set as ref_vs
from toplingdb_tpu.db import write_batch as ref_wb
from toplingdb_tpu.db.table_cache import TableCache as RefTableCache
from toplingdb_tpu.env import default_env as ref_env
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.table.builder import TableBuilder as RefTableBuilder
from toplingdb_tpu.table.builder import TableOptions as RefTO
from toplingdb_tpu.utils import merge_operator as ref_mo

from toplingdb_tpu_torch import native
from toplingdb_tpu_torch import options as popts
from toplingdb_tpu_torch.compaction import compaction_job as cj
from toplingdb_tpu_torch.compaction import picker
from toplingdb_tpu_torch.compaction import resilience
from toplingdb_tpu_torch.compaction.executor import (
    CompactionExecutor,
    CompactionExecutorFactory,
)
from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db import get_context
from toplingdb_tpu_torch.db import log
from toplingdb_tpu_torch.db import memtable
from toplingdb_tpu_torch.db import version_edit
from toplingdb_tpu_torch.db import version_set
from toplingdb_tpu_torch.db import write_batch
from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.db.snapshot import SnapshotList
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.table.builder import TableBuilder, TableOptions
from toplingdb_tpu_torch.utils import merge_operator as mo
from toplingdb_tpu_torch.utils.cache import LRUCache
from toplingdb_tpu_torch.utils.rate_limiter import (
    SstFileManager,
    WriteBufferManager,
)
from toplingdb_tpu_torch.utils.status import InvalidArgument, NotSupported
from toplingdb_tpu_torch.utils.statistics import Statistics

VT = dbformat.ValueType


# ---------------------------------------------------------------------------
# WriteBatch
# ---------------------------------------------------------------------------

OPS = {
    "put": [("put", b"k1", b"v1"), ("put", b"k" * 200, b"v" * 300)],
    "delete": [("delete", b"k1"), ("delete", b"")],
    "single_delete": [("single_delete", b"k2")],
    "merge": [("merge", b"m", b"+1"), ("merge", b"m", b"x" * 130)],
    "delete_range": [("delete_range", b"a", b"q")],
    "put_log_data": [("put", b"a", b"1"), ("put_log_data", b"blob"),
                     ("put", b"b", b"2")],
    "cf": [("put", b"k", b"v", 3), ("delete", b"k", 7),
           ("merge", b"k", b"v", 200)],
    "mixed": [("put", b"a", b"1"), ("delete", b"b"), ("merge", b"c", b"3"),
              ("single_delete", b"d"), ("delete_range", b"e", b"f"),
              ("put", b"g", b"")],
}


def _batches(ops, seq):
    rb, pb = ref_wb.WriteBatch(), write_batch.WriteBatch()
    for op, *args in ops:
        getattr(rb, op)(*args)
        getattr(pb, op)(*args)
    rb.set_sequence(seq)
    pb.set_sequence(seq)
    return rb, pb


@pytest.mark.parametrize("kind", sorted(OPS))
def test_write_batch_wire_bytes(kind):
    rb, pb = _batches(OPS[kind], 1234567)
    assert pb.data() == rb.data()
    assert pb.count() == rb.count() and pb.sequence() == rb.sequence()
    assert list(pb.entries_cf()) == list(rb.entries_cf())
    # Wire-loaded batches parse the same records.
    again = write_batch.WriteBatch(rb.data())
    assert list(again.entries_cf()) == list(rb.entries_cf())
    merged = write_batch.WriteBatch()
    merged.append_from(pb)
    merged.append_from(pb)
    rmerged = ref_wb.WriteBatch()
    rmerged.append_from(rb)
    rmerged.append_from(rb)
    assert merged.data() == rmerged.data()


@pytest.mark.parametrize("rep", ["skiplist", "vector"])
@pytest.mark.parametrize("kind", ["put", "mixed", "put_log_data"])
def test_write_batch_insert_into_memtable(rep, kind):
    rb, pb = _batches(OPS[kind], 50)
    ref_m = ref_mem.MemTable(ref_dbf.InternalKeyComparator(),
                             ref_mem.create_memtable_rep(rep))
    m = memtable.MemTable(dbformat.InternalKeyComparator(),
                          memtable.create_memtable_rep(rep))
    assert pb.insert_into(m) == rb.insert_into(ref_m)
    assert list(m.iter_entries()) == list(ref_m.iter_entries())
    assert list(m.range_del_entries()) == list(ref_m.range_del_entries())
    assert (m.num_entries, m.num_deletes) == (ref_m.num_entries,
                                              ref_m.num_deletes)


# ---------------------------------------------------------------------------
# Log framing
# ---------------------------------------------------------------------------

def _records(seed):
    rng = random.Random(seed)
    sizes = [0, 1, 100, 32768 - 7, 32768 - 11, 32768, 40000, 5, 100000, 3,
             32757, 32761, 65536 + 13]
    sizes += [rng.randrange(1, 9000) for _ in range(40)]
    return [bytes(rng.getrandbits(8) for _ in range(min(s, 64))) * (
        s // 64) + bytes(s % 64) for s in sizes]


def _write_log(mod, env, path, recs, recycled):
    w = mod.LogWriter(env.new_writable_file(path), log_number=77,
                      recycled=recycled)
    for r in recs:
        w.add_record(r)
    w.sync()
    w.close()
    return open(path, "rb").read()


@pytest.mark.parametrize("recycled", [False, True],
                         ids=["classic", "recyclable"])
def test_log_bytes_and_records(tmp_path, recycled):
    recs = _records(5)
    want = _write_log(ref_log, ref_env(), str(tmp_path / "ref.log"), recs,
                      recycled)
    got = _write_log(log, PosixEnv(), str(tmp_path / "port.log"), recs,
                     recycled)
    assert got == want and len(got) > 4 * log.BLOCK_SIZE
    env = PosixEnv()
    for path in ("ref.log", "port.log"):
        r = log.LogReader(env.new_sequential_file(str(tmp_path / path)),
                          log_number=77 if recycled else None)
        assert list(r.records()) == recs
        rr = ref_log.LogReader(
            ref_env().new_sequential_file(str(tmp_path / path)),
            log_number=77 if recycled else None)
        assert list(rr.records()) == recs
    # A torn final record is dropped by both readers.
    torn = tmp_path / "torn.log"
    torn.write_bytes(want[: len(want) - 9])
    a = list(log.LogReader(env.new_sequential_file(str(torn))).records())
    b = list(ref_log.LogReader(
        ref_env().new_sequential_file(str(torn))).records())
    assert a == b == recs[:-1]


def test_log_reader_names_a_corrupt_middle_record(tmp_path):
    recs = [b"x" * 100] * 400
    path = str(tmp_path / "c.log")
    data = bytearray(_write_log(log, PosixEnv(), path, recs, False))
    data[50] ^= 0xFF
    open(path, "wb").write(bytes(data))
    from toplingdb_tpu.utils.status import Corruption as RefCorruption
    from toplingdb_tpu_torch.utils.status import Corruption

    with pytest.raises(Corruption):
        list(log.LogReader(PosixEnv().new_sequential_file(path)).records())
    with pytest.raises(RefCorruption):
        list(ref_log.LogReader(ref_env().new_sequential_file(path)).records())


# ---------------------------------------------------------------------------
# VersionEdit
# ---------------------------------------------------------------------------

def _meta(mod, n, **kw):
    return mod.FileMetaData(
        number=n, file_size=1000 + n,
        smallest=b"a%03d" % n + bytes(8), largest=b"z%03d" % n + bytes(8),
        smallest_seqno=n, largest_seqno=n * 10, num_entries=n * 3,
        num_deletions=n % 3, num_range_deletions=n % 2, **kw)


EDITS = {
    "header": dict(comparator="leveldb.BytewiseComparator", log_number=9,
                   next_file_number=44, last_sequence=12345,
                   column_family_add="default", max_column_family=0),
    "files": dict(deleted=[(0, 5), (1, 6)], added=[(1, {}), (2, {})]),
    "ext": dict(added=[(0, {"marked_for_compaction": True}),
                       (3, {"blob_refs": [4, 8]}),
                       (6, {"file_checksum": b"\x01\x02\x03\x04",
                            "file_checksum_func_name": "crc32c"})]),
    "log": dict(log_number=77, prev_log_number=3,
                min_log_number_to_keep=5),
}


def _edit(mod, spec):
    spec = dict(spec)
    deleted = spec.pop("deleted", [])
    added = spec.pop("added", [])
    e = mod.VersionEdit(**spec)
    for lvl, n in deleted:
        e.delete_file(lvl, n)
    for i, (lvl, kw) in enumerate(added):
        e.add_file(lvl, _meta(mod, 10 + i, **kw))
    return e


@pytest.mark.parametrize("name", sorted(EDITS))
def test_version_edit_bytes(name):
    want = _edit(ref_ve, EDITS[name]).encode()
    got = _edit(version_edit, EDITS[name]).encode()
    assert got == want
    back = version_edit.VersionEdit.decode(want)
    assert back.encode() == want
    assert ref_ve.VersionEdit.decode(got).encode() == got
    assert [dataclasses.asdict(m) for _, m in back.new_files] == [
        dataclasses.asdict(m) for _, m in
        ref_ve.VersionEdit.decode(want).new_files]


# ---------------------------------------------------------------------------
# MemTable
# ---------------------------------------------------------------------------

def _fill_mems(rep, seed=7, n=3000):
    rng = random.Random(seed)
    ref_m = ref_mem.MemTable(ref_dbf.InternalKeyComparator(),
                             ref_mem.create_memtable_rep(rep))
    m = memtable.MemTable(dbformat.InternalKeyComparator(),
                          memtable.create_memtable_rep(rep))
    keys = [b"%05d" % rng.randrange(800) for _ in range(n)]
    for seq, k in enumerate(keys, start=1):
        t = rng.choice([VT.VALUE, VT.VALUE, VT.DELETION, VT.MERGE,
                        VT.SINGLE_DELETION])
        v = b"" if t in (VT.DELETION, VT.SINGLE_DELETION) else \
            b"v%d" % seq * rng.randrange(1, 4)
        ref_m.add(seq, t, k, v)
        m.add(seq, t, k, v)
    ref_m.add(n + 1, VT.RANGE_DELETION, b"00100", b"00200")
    m.add(n + 1, VT.RANGE_DELETION, b"00100", b"00200")
    return ref_m, m, sorted(set(keys)), n


@pytest.mark.parametrize("rep", ["skiplist", "vector"])
def test_memtable_get_and_iteration(rep):
    ref_m, m, keys, n = _fill_mems(rep)
    assert list(m.iter_entries()) == list(ref_m.iter_entries())
    assert len(m._rep) == len(ref_m._rep)
    for k in keys[::7] + [b"missing"]:
        for snap in (n // 3, n, n + 1):
            assert list(m.entries_for_key(k, snap)) == list(
                ref_m.entries_for_key(k, snap))
            assert m.covering_tombstone_seq(k, snap) == \
                ref_m.covering_tombstone_seq(k, snap)
    it, rit = m.new_iterator(), ref_m.new_iterator()
    for k in keys[::50]:
        target = dbformat.make_internal_key(k, n // 2, VT.VALUE)
        for a, b in ((it.seek, rit.seek),
                     (it.seek_for_prev, rit.seek_for_prev)):
            a(target)
            b(target)
            for _ in range(5):
                assert it.valid() == rit.valid()
                if not it.valid():
                    break
                assert (it.key(), it.value()) == (rit.key(), rit.value())
                it.prev()
                rit.prev()
    it.seek_to_last()
    rit.seek_to_last()
    assert it.key() == rit.key()
    if rep == "skiplist":
        kv, seqs, vtypes = m.export_columnar()
        rkv, rseqs, rvtypes = ref_m.export_columnar()
        assert kv.key_buf.tobytes() == rkv.key_buf.tobytes()
        assert kv.val_buf.tobytes() == rkv.val_buf.tobytes()
        assert list(seqs) == list(rseqs) and list(vtypes) == list(rvtypes)


def test_skiplist_rep_needs_the_native_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "pylib", lambda: None)
    with pytest.raises(NotSupported, match="native library"):
        memtable.create_memtable_rep("skiplist")
    assert isinstance(memtable.create_memtable_rep("vector"),
                      memtable.PyVectorRep)
    path = str(tmp_path / "db")
    with pytest.raises(NotSupported, match="native library"):
        DB.open(path, Options())
    assert not os.path.exists(path)
    with DB.open(path, Options(memtable_rep="vector")) as db:
        db.put(b"k", b"v")
        assert db.get(b"k") == b"v"


def test_trie_rep_needs_the_native_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "pylib", lambda: None)
    for name in ("cspp", "trie", "patricia"):
        with pytest.raises(NotSupported, match="native library"):
            memtable.create_memtable_rep(name)
    path = str(tmp_path / "db")
    with pytest.raises(NotSupported, match="native library"):
        DB.open(path, Options(memtable_rep="cspp"))
    assert not os.path.exists(path)


# The rep names the factory takes beside "skiplist" and "vector", and the
# rep each builds (tests/test_torch_memtable_reps.py holds them against the
# reference's reps).
NEW_REPS = {
    "cspp": memtable.NativeTrieRep,
    "trie": memtable.NativeTrieRep,
    "patricia": memtable.NativeTrieRep,
    "hash_skiplist": memtable.HashPrefixRep,
    "hash_linklist": memtable.HashPrefixRep,
    "prefix_hash": memtable.HashPrefixRep,
    "hash_skiplist:4": memtable.HashPrefixRep,
}


@pytest.mark.parametrize("name", sorted(NEW_REPS))
def test_memtable_rep_opens(tmp_path, name):
    from toplingdb_tpu_torch.compaction.executor import (
        LocalCompactionExecutorFactory,
    )

    rep = memtable.create_memtable_rep(name)
    assert type(rep) is NEW_REPS[name]
    if name == "hash_skiplist:4":
        assert rep._plen == 4
    opts = Options(memtable_rep=name, compaction_executor_factory=(
        LocalCompactionExecutorFactory()))
    assert popts.unported_fields(opts) == []
    path = str(tmp_path / "db")
    with DB.open(path, opts) as db:
        assert type(db.mem._rep) is NEW_REPS[name]
        for i in range(200):
            db.put(b"key%04d" % (i * 7 % 200), b"v%d" % i)
        db.delete(b"key0003")
        assert db.get(b"key0003") is None
        assert db.get(b"key0007") == b"v1"
        db.flush()
        db.put(b"key0003", b"back")
    with DB.open(path, opts) as db:
        it = db.new_iterator()
        it.seek_to_first()
        keys = [k for k, _ in it.entries()]
        assert keys == [b"key%04d" % i for i in range(200)]
        assert db.get(b"key0003") == b"back"


@pytest.mark.parametrize("name", ["bogus", "hash_skiplist:0",
                                  "hash_skiplist:x"])
def test_bad_memtable_rep_raises(tmp_path, name):
    with pytest.raises(InvalidArgument):
        memtable.create_memtable_rep(name)
    path = str(tmp_path / "db")
    with pytest.raises(InvalidArgument):
        DB.open(path, Options(memtable_rep=name))
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# Picker, GetContext, snapshots
# ---------------------------------------------------------------------------

def _versions(seed):
    rng = random.Random(seed)
    rv = ref_vs.Version(ref_dbf.InternalKeyComparator(), 7)
    pv = version_set.Version(dbformat.InternalKeyComparator(), 7)
    n = 1
    for level, count in ((0, rng.randrange(0, 7)), (1, 6), (2, 12)):
        lo = 0
        for i in range(count):
            if level == 0:
                a, b = rng.randrange(0, 500), rng.randrange(500, 1000)
            else:
                a, b = lo, lo + rng.randrange(5, 60)
                lo = b + rng.randrange(1, 30)
            kw = dict(number=n, file_size=rng.randrange(1, 40) << 20,
                      smallest=b"%06d" % a + bytes(8),
                      largest=b"%06d" % b + bytes(8),
                      smallest_seqno=n, largest_seqno=n + 5,
                      marked_for_compaction=rng.random() < 0.1)
            rv.files[level].append(ref_ve.FileMetaData(**kw))
            pv.files[level].append(version_edit.FileMetaData(**kw))
            n += 1
        if level == 0:
            rv.files[0].reverse()
            pv.files[0].reverse()
    return rv, pv


@pytest.mark.parametrize("seed", range(6))
def test_leveled_picker_picks_the_same(seed):
    rv, pv = _versions(seed)
    kw = dict(level0_file_num_compaction_trigger=3,
              max_bytes_for_level_base=64 << 20)
    rp = ref_picker.create_picker(RefOptions(**kw),
                                  ref_dbf.InternalKeyComparator())
    pp = picker.create_picker(Options(**kw), dbformat.InternalKeyComparator())
    assert pp.compaction_score(pv) == rp.compaction_score(rv)
    rc, pc = rp.pick_compaction(rv), pp.pick_compaction(pv)
    assert (pc is None) == (rc is None)
    if pc is not None:
        def shape(c):
            return (c.level, c.output_level, [f.number for f in c.inputs],
                    [f.number for f in c.output_level_inputs], c.bottommost,
                    c.reason, c.max_output_file_size)

        assert shape(pc) == shape(rc)
    if rv.files[0]:  # a busy L0 file: intra-L0 or nothing, as the reference
        rv.files[0][-1].being_compacted = True
        pv.files[0][-1].being_compacted = True
        rc, pc = rp.pick_compaction(rv), pp.pick_compaction(pv)
        assert (pc is None) == (rc is None)
        if pc is not None:
            assert [f.number for f in pc.inputs] == [
                f.number for f in rc.inputs]


@pytest.mark.parametrize("seed", range(4))
def test_get_context_answers(seed):
    rng = random.Random(seed)
    for _ in range(200):
        stream = []
        seq = 100
        for _ in range(rng.randrange(1, 6)):
            t = rng.choice([VT.VALUE, VT.MERGE, VT.MERGE, VT.DELETION,
                            VT.SINGLE_DELETION])
            stream.append((seq, t, b"%d" % seq))
            seq -= rng.randrange(1, 9)
        tomb = rng.choice([0, 0, 60, 95])
        snap = rng.choice([100, 90, 70])
        out = []
        for gmod, mmod in ((ref_gc, ref_mo), (get_context, mo)):
            ctx = gmod.GetContext(b"k", snap, mmod.StringAppendOperator())
            ctx.add_tombstone_seq(tomb)
            done = False
            for s, t, v in stream:
                if s <= snap and not ctx.save_value(s, t, v):
                    done = True
                    break
            if not done:
                ctx.finish()
            out.append((ctx.result(), ctx.state.value))
        assert out[0] == out[1], (stream, tomb, snap)


def test_snapshot_list():
    sl = SnapshotList()
    a, b, c = sl.new_snapshot(5), sl.new_snapshot(9), sl.new_snapshot(5)
    assert sl.sequences() == [5, 9]
    a.release()
    with b:
        assert sl.sequences() == [5, 9]
    assert sl.sequences() == [5] and not sl.empty()
    c.release()
    assert sl.empty()


# ---------------------------------------------------------------------------
# The CPU compaction path
# ---------------------------------------------------------------------------

def _write_inputs(tmp_path, seed=3, n_files=4, n=1500):
    """The same L0 input SSTs in two directories, one per package."""
    rng = random.Random(seed)
    metas = {}
    for side, Builder, TO, meta_mod, envf in (
            ("ref", RefTableBuilder, RefTO, ref_ve, ref_env),
            ("port", TableBuilder, TableOptions, version_edit, PosixEnv)):
        d = tmp_path / side
        d.mkdir()
        rng = random.Random(seed)
        env = envf()
        icmp = (ref_dbf if side == "ref" else dbformat).InternalKeyComparator()
        out = []
        seq = 1
        for f in range(n_files):
            rows = []
            for _ in range(n):
                k = b"%06d" % rng.randrange(3000)
                t = rng.choice([VT.VALUE] * 5 + [VT.DELETION])
                rows.append((k, seq, t, b"" if t == VT.DELETION
                             else b"v%d" % seq))
                seq += 1
            rows.sort(key=lambda r: (r[0], -r[1]))
            num = 10 + f
            w = env.new_writable_file(str(d / ("%06d.sst" % num)))
            b = Builder(w, icmp, TO(block_size=512))
            for k, s, t, v in rows:
                b.add((ref_dbf if side == "ref" else dbformat)
                      .make_internal_key(k, s, t), v)
            props = b.finish()
            w.close()
            out.append(meta_mod.FileMetaData(
                number=num, file_size=os.path.getsize(d / ("%06d.sst" % num)),
                smallest=b.smallest_key, largest=b.largest_key,
                smallest_seqno=props.smallest_seqno,
                largest_seqno=props.largest_seqno,
                num_entries=props.num_entries))
        metas[side] = out[::-1]
    return metas


@pytest.mark.parametrize("subcompactions", [1, 3])
def test_cpu_compaction_path_bytes(tmp_path, subcompactions):
    metas = _write_inputs(tmp_path)
    outs = {}
    for side in ("ref", "port"):
        d = str(tmp_path / side)
        if side == "ref":
            icmp, env = ref_dbf.InternalKeyComparator(), ref_env()
            c = ref_picker.Compaction(level=0, output_level=1,
                                      inputs=metas[side], bottommost=True,
                                      max_output_file_size=16 << 10)
            tc = RefTableCache(env, d, icmp, RefTO(block_size=512))
            run, topts = ref_cj.run_compaction_to_tables, RefTO(block_size=512)
        else:
            icmp, env = dbformat.InternalKeyComparator(), PosixEnv()
            c = picker.Compaction(level=0, output_level=1,
                                  inputs=metas[side], bottommost=True,
                                  max_output_file_size=16 << 10)
            tc = TableCache(env, d, icmp, TableOptions(block_size=512))
            run, topts = cj.run_compaction_to_tables, TableOptions(
                block_size=512)
        nums = iter(range(100, 200))
        files, stats = run(env, d, icmp, c, tc, topts, [2500],
                           new_file_number=lambda: next(nums),
                           creation_time=1234,
                           max_subcompactions=subcompactions)
        outs[side] = (files, stats)
        tc.close()
    rf, rs = outs["ref"]
    pf, ps = outs["port"]

    def shape(files, side):
        # Subcompaction threads draw file numbers in the order they finish
        # their outputs, in either package: match outputs by key range.
        out = []
        for m in sorted(files, key=lambda m: m.smallest):
            d = dataclasses.asdict(m)
            d.pop("number")
            name = "%06d.sst" % m.number
            out.append((d, (tmp_path / side / name).read_bytes()))
        return out

    assert shape(pf, "port") == shape(rf, "ref")
    assert (ps.input_records, ps.output_records, ps.dropped_obsolete) == (
        rs.input_records, rs.output_records, rs.dropped_obsolete)
    assert len(pf) > 1
    rc = ref_picker.Compaction(level=0, output_level=1, inputs=metas["ref"])
    pc = picker.Compaction(level=0, output_level=1, inputs=metas["port"])
    assert cj.gen_subcompaction_boundaries(
        pc, dbformat.InternalKeyComparator(), subcompactions) == \
        ref_cj.gen_subcompaction_boundaries(
            rc, ref_dbf.InternalKeyComparator(), subcompactions)
    if subcompactions == 1:
        assert [m.number for m in pf] == [m.number for m in rf]
        assert cj.make_version_edit(pc, pf).encode() == \
            ref_cj.make_version_edit(rc, rf).encode()


# ---------------------------------------------------------------------------
# The retry driver
# ---------------------------------------------------------------------------

class _Exec(CompactionExecutor):
    def __init__(self, results):
        self.results = results

    def execute(self, db, compaction, snapshots, alloc):
        r = self.results.pop(0)
        if isinstance(r, BaseException):
            raise r
        return r


class _Factory(CompactionExecutorFactory):
    def __init__(self, results):
        self.results = results
        self.executors = 0

    def new_executor(self, compaction):
        self.executors += 1
        return _Exec(self.results)


class _DB:
    def __init__(self, **kw):
        kw.setdefault("backoff_base", 0.001)
        self.options = Options(dcompact=resilience.DcompactOptions(**kw))


def test_device_factory_defaults():
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )

    f = DeviceCompactionExecutorFactory()
    assert f.device == "cuda" and f.jobs == []
    assert not f.should_run_local(None)
    for bad in ("tpu", "cpu-jax", "gpu"):
        with pytest.raises(ValueError):
            DeviceCompactionExecutorFactory(device=bad)


def test_retry_driver_retries_then_succeeds():
    f = _Factory([RuntimeError("a"), RuntimeError("b"), ("ok", 1)])
    assert resilience.execute_resilient(_DB(), f, None, [], None) == (
        "ok", 1)
    assert f.executors == 3


def test_retry_driver_raises_the_last_error():
    f = _Factory([RuntimeError("a"), RuntimeError("b"), RuntimeError("c")])
    with pytest.raises(RuntimeError, match="c"):
        resilience.execute_resilient(_DB(), f, None, [], None)
    assert f.executors == 3 and f.results == []


def test_retry_driver_deadline():
    f = _Factory([RuntimeError("a")] * 5)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        resilience.execute_resilient(
            _DB(job_deadline=0.05, backoff_base=0.2, backoff_jitter=0),
            f, None, [], None)
    assert time.monotonic() - t0 < 1.0


# ---------------------------------------------------------------------------
# Refused options
# ---------------------------------------------------------------------------

def _away_from_default(name):
    v = getattr(Options(), name)
    if isinstance(v, bool):
        return not v
    if isinstance(v, (int, float)):
        return v + 1
    if isinstance(v, (list, tuple)):
        return type(v)([object()])
    return object()


REFUSED = sorted(popts.UNPORTED) + ["compaction_executor_factory"]


@pytest.mark.parametrize("name", REFUSED)
def test_unported_option_raises(tmp_path, name):
    special = {
        "compaction_executor_factory": None,
    }
    opts = dataclasses.replace(
        Options(), **{name: special.get(name, _away_from_default(name))})
    path = str(tmp_path / "db")
    with pytest.raises(NotSupported, match=name):
        DB.open(path, opts)
    assert not os.path.exists(path)


# The integrity fields open (tests/test_torch_integrity.py holds them
# against the reference), the write-path fields
# (tests/test_torch_write_modes.py), the read-path fields
# (tests/test_torch_block_cache.py, tests/test_torch_read_path.py) and
# the WAL plane's (tests/test_torch_wal_recycle.py).
NOW_OPEN = {
    "block_cache": dict(block_cache=LRUCache(1 << 20)),
    "async_read_rings": dict(async_read_rings=2),
    "async_read_task_capacity": dict(async_read_task_capacity=16),
    "protection_bytes_per_key": dict(protection_bytes_per_key=8),
    "integrity_scrub_period_sec": dict(integrity_scrub_period_sec=60),
    "integrity_scrub_bytes_per_sec": dict(
        integrity_scrub_bytes_per_sec=1 << 20),
    "unordered_write": dict(unordered_write=True),
    "enable_pipelined_write": dict(enable_pipelined_write=True),
    "enable_async_wal": dict(enable_async_wal=True),
    "async_wal_ring_size": dict(enable_async_wal=True,
                                async_wal_ring_size=8),
    "write_buffer_manager": dict(write_buffer_manager=WriteBufferManager(
        1 << 20)),
    # WAL recycling and archiving (tests/test_torch_wal_recycle.py).
    "recycle_log_file_num": dict(recycle_log_file_num=2),
    "wal_ttl_seconds": dict(wal_ttl_seconds=3600.0),
    # The storage-pressure plane (tests/test_torch_disk_pressure.py); the
    # ratios and reserves with a budget, which builds the DB's manager.
    "sst_file_manager": dict(sst_file_manager=SstFileManager()),
    "max_allowed_space_usage": dict(max_allowed_space_usage=1 << 30),
    "compaction_buffer_size": dict(max_allowed_space_usage=1 << 30,
                                   compaction_buffer_size=1 << 20),
    "flush_headroom_bytes": dict(max_allowed_space_usage=1 << 30,
                                 flush_headroom_bytes=1 << 20),
    "free_space_poll_period_sec": dict(free_space_poll_period_sec=0.05),
    "disk_amber_free_ratio": dict(max_allowed_space_usage=1 << 30,
                                  disk_amber_free_ratio=0.2),
    "disk_red_free_ratio": dict(max_allowed_space_usage=1 << 30,
                                disk_red_free_ratio=0.1),
    "disk_pressure_hysteresis": dict(max_allowed_space_usage=1 << 30,
                                     disk_pressure_hysteresis=0.05),
    # The seqno-to-time mapping (tests/test_torch_seqno_time.py).
    "seqno_time_sample_period_sec": dict(seqno_time_sample_period_sec=1),
    "preclude_last_level_data_seconds": dict(
        preclude_last_level_data_seconds=3600),
    # Wide-column entities (tests/test_torch_wide_columns.py).
    "legacy_wide_column_unwrap": dict(legacy_wide_column_unwrap=True),
    # Read-only opens through DB.open (tests/test_torch_read_only.py) and
    # the timestamp trim point, which a plain DB accepts and does not read,
    # as toplingdb_tpu's does (tests/test_torch_timestamps.py).
    "read_only": dict(read_only=True),
    "full_history_ts_low": dict(full_history_ts_low=5),
    # The SLO engine (tests/test_torch_slo.py); a spec needs statistics.
    "slo_specs": dict(statistics=Statistics(),
                      slo_specs=({"name": "get", "kind": "latency"},)),
    "slo_eval_period_sec": dict(statistics=Statistics(),
                                slo_specs=({"name": "w", "kind": "stall"},),
                                slo_eval_period_sec=0.05),
    "slo_window_sec": dict(statistics=Statistics(),
                           slo_specs=({"name": "get", "kind": "latency"},),
                           slo_window_sec=5.0),
}


STORAGE_FIELDS = ("sst_file_manager", "max_allowed_space_usage",
                  "compaction_buffer_size", "flush_headroom_bytes",
                  "free_space_poll_period_sec", "disk_")


@pytest.mark.parametrize("name", sorted(NOW_OPEN))
def test_ported_option_opens(tmp_path, name):
    from toplingdb_tpu_torch.compaction.executor import (
        LocalCompactionExecutorFactory,
    )

    assert name not in popts.UNPORTED
    opts = Options(compaction_executor_factory=(
        LocalCompactionExecutorFactory()), **NOW_OPEN[name])
    assert popts.unported_fields(opts) == []
    with DB.open(str(tmp_path / "db"), opts) as db:
        db.put(b"k", b"v" * 300)
        assert (db.mem._prot is not None) == (
            name == "protection_bytes_per_key")
        assert (db._integrity_scrubber is not None) == (
            name == "integrity_scrub_period_sec")
        assert (db._wal_ring is not None) == ("async_wal" in name)
        assert db._wal._recycled == (name == "recycle_log_file_num")
        assert (db._sfm is not None) == name.startswith(STORAGE_FIELDS)
        assert (db.table_cache._block_cache is not None) == (
            name == "block_cache")
        assert (db.slo_engine is not None) == name.startswith("slo_")
        db.flush()
        assert db.get(b"k") == b"v" * 300
        db.compact_range()
        assert db.get(b"k") == b"v" * 300
        assert db.scrub()["files_scanned"] == 1
    with DB.open(str(tmp_path / "db"), opts) as db:
        assert db.get(b"k") == b"v" * 300


def test_timestamp_comparator_opens(tmp_path):
    """The u64-timestamp comparator and its trim point open; the DB's jobs
    run on the device executor (tests/test_torch_timestamps.py holds them
    against the reference)."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )

    factory = DeviceCompactionExecutorFactory(device="cpu")
    opts = Options(comparator=dbformat.U64_TS_BYTEWISE,
                   full_history_ts_low=5,
                   compaction_executor_factory=factory)
    assert popts.unported_fields(opts) == []
    with DB.open(str(tmp_path / "db"), opts) as db:
        assert db._write_plane is None  # Python commits, as in the reference
        db.put(b"k", b"v" * 300, ts=7)
        db.flush()
        db.put(b"k", b"w", ts=9)
        db.compact_range()
        assert db.get(b"k") == b"w"
        assert db.get_with_ts(b"k") == (b"w", 9)
        assert factory.jobs and db._compaction_scheduler.num_local_jobs == 0
    with DB.open(str(tmp_path / "db"), opts) as db:
        assert db.get_with_ts(b"k") == (b"w", 9)


def test_defaults_open(tmp_path):
    assert popts.unported_fields(Options()) == []
    with DB.open(str(tmp_path / "db"), Options()) as db:
        db.put(b"k", struct.pack("<Q", 1))
        assert db.get(b"k") == struct.pack("<Q", 1)
