"""The DB's three native host planes in toplingdb_tpu_torch against
toplingdb_tpu's, both on their default paths, on the CPU:

- the group-commit write plane (tpulsm_wb_group_commit): framed WAL bytes
  equal to the Python LogWriter's and to the reference's native frame, on
  both sides of the 32 KiB block boundary, classic and recyclable; the WAL
  files, SSTs and level sets of write groups of put / delete / merge /
  delete_range / single_delete batches equal to the reference DB's; the
  groups that must fall back (range deletes, merge-heavy batches, wide
  columns, the vector rep) falling back on both sides; threaded writers;
- the native point-read chain (tpulsm_getctx_get through the `fastget`
  extension): every get equal under snapshots, merges, single deletes and
  range tombstones, block and zip tables, while a writer flushes and
  compactions install versions, with 4 reader threads; blob indexes and
  merge operands handed to the Python chain on both sides;
- the chunked scan plane (ops/scan_plane.py): forward and backward scans,
  bounds, seeks, direction switches and a prefix-extractor DB equal, with
  equal ITER_CHUNK_REFILLS / ITER_CHUNK_FALLBACKS;
- a corrupted data block raises on both sides;
- DB.open refuses a plane without the native library, naming it; the port
  reads neither TPULSM_WRITE_PLANE nor TPULSM_ITER_CHUNK;
- the two packages' native libraries stay isolated in one process
  (a subprocess loading both, in either order, with protected DBs: the
  protection exports included).

The reference runs with TPULSM_WRITE_PLANE and TPULSM_ITER_CHUNK unset
(its defaults), the port with write_plane=True and iter_chunk_rows=4096
(its defaults). Compactions run the host path on both sides
(LocalCompactionExecutorFactory in the port), which the device executor's
parity tests (test_torch_db.py) cover byte for byte. Tolerance: none.
"""

import ast
import ctypes
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import toplingdb_tpu.compaction.compaction_job as ref_cj
import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu import native as ref_native
from toplingdb_tpu.db.dbformat import ValueType as RefValueType
from toplingdb_tpu.db.write_batch import WriteBatch as RefWriteBatch
from toplingdb_tpu.ops import scan_plane as ref_sp
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.options import WriteOptions as RefWriteOptions
from toplingdb_tpu.table.builder import TableOptions as RefTableOptions
from toplingdb_tpu.utils import merge_operator as ref_mo
from toplingdb_tpu.utils import slice_transform as ref_stx
from toplingdb_tpu.utils import statistics as ref_st

import toplingdb_tpu_torch.compaction.compaction_job as cj
import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.compaction.executor import (
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.dbformat import ValueType
from toplingdb_tpu_torch.db.log import LogWriter
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.ops import scan_plane as sp
from toplingdb_tpu_torch.options import Options, ReadOptions, WriteOptions
from toplingdb_tpu_torch.table.builder import TableOptions
from toplingdb_tpu_torch.utils import merge_operator as mo
from toplingdb_tpu_torch.utils import slice_transform as stx
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.status import NotSupported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK = 1_700_000_000.0


class _PinnedTime:
    """`time` as a module sees it, with time.time() fixed (tables carry
    creation_time)."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return CLOCK


@pytest.fixture
def defaults(monkeypatch):
    """Both DBs on their default planes, time pinned."""
    monkeypatch.delenv("TPULSM_WRITE_PLANE", raising=False)
    monkeypatch.delenv("TPULSM_ITER_CHUNK", raising=False)
    for m in (ref_dbm, ref_cj, dbm, cj):
        monkeypatch.setattr(m, "time", _PinnedTime())


def _open_pair(root, ref_stats=None, port_stats=None, merge=None,
               table_format=None, prefix=None, chunk=None, compression=0,
               **kw):
    """The reference DB and the port's DB in sibling directories."""
    rkw, pkw = dict(kw), dict(kw)
    if merge:
        rkw["merge_operator"] = getattr(ref_mo, merge)()
        pkw["merge_operator"] = getattr(mo, merge)()
    if table_format:
        rkw["table_options"] = RefTableOptions(format=table_format,
                                               compression=compression)
        pkw["table_options"] = TableOptions(format=table_format,
                                            compression=compression)
    if prefix:
        rkw["prefix_extractor"] = ref_stx.FixedPrefixTransform(prefix)
        pkw["prefix_extractor"] = stx.FixedPrefixTransform(prefix)
    ref = ref_dbm.DB.open(os.path.join(root, "ref"), RefOptions(
        create_if_missing=True, statistics=ref_stats, **rkw))
    popen = {} if chunk is None else {"iter_chunk_rows": chunk}
    port = dbm.DB.open(os.path.join(root, "port"), Options(
        create_if_missing=True, statistics=port_stats,
        compaction_executor_factory=LocalCompactionExecutorFactory(),
        **pkw), **popen)
    return ref, port


def _close(*dbs):
    for db in dbs:
        if not db._closed:
            db.close()


def _live_files_equal(ref, port):
    """SSTs of the current version, the WALs from the MANIFEST's log
    number on, and the level sets: equal bytes and metadata."""
    def levels(db):
        return [[(f.number, f.smallest, f.largest, f.smallest_seqno,
                  f.largest_seqno, f.num_entries, f.file_size)
                 for f in fl] for fl in db.versions.current.files]

    assert levels(port) == levels(ref)
    assert port.versions.log_number == ref.versions.log_number
    names = [f"{f.number:06d}.sst"
             for _, f in port.versions.current.all_files()]
    wals = sorted(n for n in os.listdir(port.dbname) if n.endswith(".log")
                  and int(n[:-4]) >= port.versions.log_number)
    assert wals == sorted(
        n for n in os.listdir(ref.dbname) if n.endswith(".log")
        and int(n[:-4]) >= ref.versions.log_number)
    for name in names + wals:
        a = open(os.path.join(port.dbname, name), "rb").read()
        b = open(os.path.join(ref.dbname, name), "rb").read()
        assert a == b, name
    return names, wals


def _scan(db, ropts, reverse=False):
    it = db.new_iterator(ropts)
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


def _tickers(stats, names):
    t = stats.tickers()
    return {n: t.get(n, 0) for n in names}


# ---------------------------------------------------------------------------
# The write plane
# ---------------------------------------------------------------------------


def _batch_pair(ops):
    rb, pb = RefWriteBatch(), WriteBatch()
    for op, *args in ops:
        if op == "entity":  # a wide-column entity record
            from toplingdb_tpu_torch.db import wide_columns

            enc = wide_columns.encode_entity({b"": args[1], b"c": b"x"})
            rb.put_entity(args[0], enc)
            pb._add_record(ValueType.WIDE_COLUMN_ENTITY, 0, args[0], enc)
            continue
        getattr(rb, op)(*args)
        getattr(pb, op)(*args)
    return rb, pb


@pytest.mark.parametrize("recycled", [False, True],
                         ids=["classic", "recyclable"])
def test_group_frame_equals_log_writer_and_reference(tmp_path, recycled):
    """The native frame of a merged group record is the Python
    LogWriter's add_record bytes and the reference's native frame, from
    block offsets that put the record across one or more 32 KiB block
    boundaries (fragment headers, block-tail padding)."""
    lib, rlib = native.lib(), ref_native.lib()
    rng = random.Random(7)
    for case in range(12):
        batches = []
        for b in range(rng.randint(1, 5)):
            wb = WriteBatch()
            for _ in range(rng.randint(1, 40)):
                k = b"k%06d" % rng.randrange(10 ** 6)
                r = rng.random()
                if r < 0.6:
                    wb.put(k, os.urandom(rng.choice([3, 200, 5000])))
                elif r < 0.8:
                    wb.delete(k)
                elif r < 0.9:
                    wb.single_delete(k)
                else:
                    wb.merge(k, b"m")
            batches.append(wb.data())
        first_seq = rng.randrange(1, 1 << 40)
        merged = WriteBatch()
        merged.set_sequence(first_seq)
        for d in batches:
            merged.append_from(WriteBatch(d))
        rec = merged.data()
        # Start 0-20 bytes before a block's end, or anywhere.
        start = rng.choice([32768 - rng.randint(0, 20),
                            rng.randrange(32768)])
        path = str(tmp_path / f"w{case}.log")
        from toplingdb_tpu_torch.env import PosixEnv

        wf = PosixEnv().new_writable_file(path)
        wf._size = start  # as if `start` bytes were written before
        w = LogWriter(wf, log_number=77, recycled=recycled)
        block_off, log_no = w.framing_state()
        w.add_record(rec)
        wf.close()
        want = open(path, "rb").read()
        framed = []
        for lb in (lib, rlib):
            n = len(batches)
            reps = (ctypes.c_char_p * n)(*batches)
            lens = (ctypes.c_int64 * n)(*[len(d) for d in batches])
            cap = len(rec) + 11 * (len(rec) // 32757 + 2) + 16
            buf = (ctypes.c_uint8 * cap)()
            out = (ctypes.c_int64 * 8)()
            rc = lb.tpulsm_wb_group_commit(
                None, 0, reps, lens, n, first_seq, None, 0, 0, 1,
                block_off, log_no, buf, cap, out)
            assert rc == merged.count(), rc
            assert out[1] == w.framing_state()[0]
            assert out[4] == len(rec)
            framed.append(bytes(buf[:out[0]]))
        assert framed[0] == want, case
        assert framed[1] == want, case


def _commit(db, batches, ref: bool, sync=False):
    """One write group of `batches`, committed by the group leader's
    function (the write queue would group by timing). The DBs run with
    allow_concurrent_memtable_write=False: no follower thread waits to
    insert its own batch on the Python path."""
    wo = (RefWriteOptions if ref else WriteOptions)(sync=sync)
    group = [(ref_dbm._Writer if ref else dbm._Writer)(b, wo)
             for b in batches]
    db._commit_write_group(group)


def _random_groups(rng, n_groups, keys):
    groups = []
    for _ in range(n_groups):
        group = []
        for _ in range(rng.randint(1, 6)):
            ops = []
            for _ in range(rng.randint(1, 30)):
                k = rng.choice(keys)
                r = rng.random()
                if r < 0.55:
                    ops.append(("put", k, b"v" * rng.choice([5, 900, 7000])))
                elif r < 0.7:
                    ops.append(("delete", k))
                elif r < 0.8:
                    ops.append(("single_delete", k))
                elif r < 0.97:
                    ops.append(("merge", k, b"m%d" % rng.randrange(99)))
                else:
                    j = rng.randrange(len(keys) - 3)
                    ops.append(("delete_range", keys[j], keys[j + 3]))
            group.append(_batch_pair(ops))
        groups.append(group)
    return groups


def test_write_groups_wal_ssts_levels_equal(tmp_path, defaults):
    """Multi-batch groups of every point type, some with range deletes or
    merge-heavy batches, across WAL block boundaries, with explicit
    flushes and a compaction: the live WAL, the SSTs and the level sets
    equal the reference's, and both count the same native commits and
    fallbacks."""
    rs, ps = ref_st.Statistics(), st.Statistics()
    ref, port = _open_pair(str(tmp_path), rs, ps, merge="StringAppendOperator",
                           write_buffer_size=64 << 20,
                           disable_auto_compactions=True,
                           allow_concurrent_memtable_write=False)
    try:
        rng = random.Random(11)
        keys = [b"key%04d" % i for i in range(300)]
        for r, groups in enumerate(
                [_random_groups(rng, 40, keys) for _ in range(3)]):
            for i, group in enumerate(groups):
                sync = i % 9 == 0
                _commit(ref, [b[0] for b in group], True, sync)
                _commit(port, [b[1] for b in group], False, sync)
            _live_files_equal(ref, port)
            for db in (ref, port):
                db.flush()
        for db in (ref, port):
            db.compact_range()
        names, _ = _live_files_equal(ref, port)
        assert names
        for k in keys:
            assert port.get(k) == ref.get(k), k
        assert _scan(port, ReadOptions()) == _scan(ref, RefReadOptions())
        want = (st.WRITE_GROUP_NATIVE_COMMITS, st.WRITE_GROUP_FALLBACKS,
                st.WRITE_GROUP_LED, st.WAL_BYTES, st.NUMBER_KEYS_WRITTEN)
        got = _tickers(ps, want)
        assert got == _tickers(rs, want)
        assert got[st.WRITE_GROUP_NATIVE_COMMITS] > 0
        assert got[st.WRITE_GROUP_FALLBACKS] > 0
    finally:
        _close(ref, port)


FALLBACK_CASES = {
    # name: (ops of each batch, group size, extra options, native?)
    "puts": ([("put", b"a", b"1"), ("put", b"b", b"2")], 3, {}, True),
    "deletes": ([("delete", b"a"), ("single_delete", b"b")], 2, {}, True),
    "merge_light": ([("merge", b"a", b"x"), ("put", b"b", b"2"),
                     ("put", b"c", b"3")], 2, {}, True),
    "merge_heavy": ([("merge", b"a", b"x"), ("merge", b"b", b"y"),
                     ("put", b"c", b"3")], 2, {}, False),
    "range_delete": ([("put", b"a", b"1"), ("delete_range", b"a", b"b")], 1,
                     {}, False),
    "wide_column": ([("entity", b"a", b"1")], 1, {}, False),
    "vector_rep": ([("put", b"a", b"1")], 2, {"memtable_rep": "vector"},
                   False),
    "wal_off": ([("put", b"a", b"1"), ("delete", b"b")], 2,
                {"wal_enabled": False}, True),
}


@pytest.mark.parametrize("case", sorted(FALLBACK_CASES))
def test_groups_take_the_same_path_as_reference(tmp_path, defaults, case):
    """Each kind of group takes the native plane or falls back to the
    Python interiors on both sides alike; the WAL bytes and the views
    agree either way."""
    ops, size, extra, is_native = FALLBACK_CASES[case]
    rs, ps = ref_st.Statistics(), st.Statistics()
    ref, port = _open_pair(str(tmp_path), rs, ps, merge="StringAppendOperator",
                           disable_auto_compactions=True,
                           allow_concurrent_memtable_write=False, **extra)
    try:
        for _ in range(4):
            group = [_batch_pair(ops) for _ in range(size)]
            _commit(ref, [b[0] for b in group], True)
            _commit(port, [b[1] for b in group], False)
        want = (st.WRITE_GROUP_NATIVE_COMMITS, st.WRITE_GROUP_FALLBACKS)
        got = _tickers(ps, want)
        assert got == _tickers(rs, want)
        assert got[st.WRITE_GROUP_NATIVE_COMMITS if is_native
                   else st.WRITE_GROUP_FALLBACKS] == 4
        for k in (b"a", b"b", b"c"):
            assert port.get(k) == ref.get(k), k
        assert _scan(port, ReadOptions()) == _scan(ref, RefReadOptions())
        if extra.get("wal_enabled", True):
            wal = f"{port._wal_number:06d}.log"
            assert port._wal_number == ref._wal_number
            for db in (ref, port):
                db._wal.flush()
            assert open(os.path.join(port.dbname, wal), "rb").read() == \
                open(os.path.join(ref.dbname, wal), "rb").read()
    finally:
        _close(ref, port)


def test_threaded_writers_views_and_replay_match_reference(tmp_path,
                                                           defaults):
    """4 writer threads per DB (each its own key range, so the result does
    not depend on how the queue groups them): equal views, and equal views
    again after a crash and WAL replay."""
    rs, ps = ref_st.Statistics(), st.Statistics()
    ref, port = _open_pair(str(tmp_path), rs, ps, merge="StringAppendOperator",
                           write_buffer_size=64 << 20,
                           disable_auto_compactions=True)

    def writer(db, is_ref, t, errs):
        try:
            rng = random.Random(t)
            for i in range(150):
                ops = []
                for j in range(rng.randint(1, 8)):
                    k = b"t%d-%04d" % (t, rng.randrange(200))
                    r = rng.random()
                    ops.append(("put", k, b"v%d" % i) if r < 0.6 else
                               ("delete", k) if r < 0.8 else
                               ("merge", k, b"m%d" % j))
                b = _batch_pair(ops)[0 if is_ref else 1]
                db.write(b)
                if i == 75 and t == 0:
                    db.flush()
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)

    try:
        for db, is_ref in ((ref, True), (port, False)):
            errs = []
            ts = [threading.Thread(target=writer, args=(db, is_ref, t, errs))
                  for t in range(4)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=300)
                assert not th.is_alive(), "a thread did not finish"
            assert not errs, errs
        view = _scan(port, ReadOptions())
        assert view == _scan(ref, RefReadOptions()) and view
        assert ps.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS) > 0
        for db in (ref, port):  # crash: no flush of the memtable
            db._compaction_scheduler.shutdown()
            db._wal.sync()
            db._wal.close()
            db._closed = True
        ref, port = _open_pair(str(tmp_path), merge="StringAppendOperator",
                               write_buffer_size=64 << 20,
                               disable_auto_compactions=True)
        assert _scan(port, ReadOptions()) == view
        assert _scan(ref, RefReadOptions()) == view
    finally:
        _close(ref, port)


# ---------------------------------------------------------------------------
# The point-read chain
# ---------------------------------------------------------------------------


def _fill_for_reads(ref, port, rng, keys, n_ops, tomb_every=0):
    """Deterministic mixed writes on both DBs: puts, deletes and merges of
    `keys`, and keys of their own that are put once and single-deleted
    once (SingleDelete's contract). Returns the snapshots taken on the
    way (pairs)."""
    snaps = []
    for i in range(n_ops):
        k = rng.choice(keys)
        r = rng.random()
        ops = ([("put", k, b"v%d" % i)] if r < 0.55 else
               [("delete", k)] if r < 0.65 else
               [("merge", k, b"m%d" % i)])
        if i % 10 == 0:
            ops.append(("put", b"sd-%05d" % i, b"once"))
        elif i % 10 == 5 and i >= 15:
            ops.append(("single_delete", b"sd-%05d" % (i - 15)))
        if tomb_every and i % tomb_every == tomb_every - 1:
            j = rng.randrange(len(keys) - 4)
            ops = [("delete_range", keys[j], keys[j + 4])]
        rb, pb = _batch_pair(ops)
        ref.write(rb)
        port.write(pb)
        if i % 400 == 399:
            snaps.append((ref.get_snapshot(), port.get_snapshot()))
            for db in (ref, port):
                db.flush()
    return snaps


@pytest.mark.parametrize("tombstones", [False, True],
                         ids=["points", "range_tombstones"])
@pytest.mark.parametrize("table_format", ["block", "zip"])
def test_gets_match_reference_under_concurrent_installs(tmp_path, defaults,
                                                        table_format,
                                                        tombstones):
    """Every get (latest and at 2 snapshots) equals the reference's, read
    by 4 threads while a writer thread adds keys, flushes and compacts
    (new versions install under the readers). Without range tombstones
    the port's native chain decides most gets (merge operands and single
    deletes in SSTs go to the Python chain); a table or memtable holding
    range tombstones sends every get that reaches it to the Python chain,
    as in the reference."""
    rs, ps = ref_st.Statistics(), st.Statistics()
    ref, port = _open_pair(str(tmp_path), rs, ps, merge="StringAppendOperator",
                           table_format=table_format,
                           write_buffer_size=64 << 20,
                           disable_auto_compactions=True)
    calls = {"native": 0, "python": 0}
    lock = threading.Lock()
    orig = port._native_get

    def spy(*a):
        r = orig(*a)
        with lock:
            calls["native" if r[0] else "python"] += 1
        return r

    port._native_get = spy
    try:
        rng = random.Random(3)
        keys = [b"key%05d" % i for i in range(300)]
        snaps = _fill_for_reads(ref, port, rng, keys, 800,
                                tomb_every=150 if tombstones else 0)
        for db in (ref, port):
            db.compact_range()
        _fill_for_reads(ref, port, rng, keys, 300)
        probes = keys + [b"absent", b"key99999"] + [
            b"sd-%05d" % i for i in range(0, 800, 10)]
        want = {}
        for i, (rsnap, _) in enumerate([(None, None)] + snaps):
            ro = RefReadOptions(snapshot=rsnap)
            want[i] = [ref.get(k, ro) for k in probes]

        def reader(db, is_ref, t, got):
            rng = random.Random(100 + t)
            for _ in range(2):
                order = list(want)
                rng.shuffle(order)
                for i in order:
                    snap = None if i == 0 else snaps[i - 1][0 if is_ref
                                                            else 1]
                    ro = (RefReadOptions if is_ref else ReadOptions)(
                        snapshot=snap)
                    vals = [db.get(k, ro) if snap is not None or rng.random()
                            < 0.5 else db.get(k) for k in probes]
                    got.append((i, vals))

        def churn(db, is_ref):
            for r in range(3):
                for j in range(200):
                    b = (RefWriteBatch if is_ref else WriteBatch)()
                    b.put(b"new%d-%04d" % (r, j), b"x" * 10)
                    db.write(b)
                db.flush()
                db.compact_range()

        for db, is_ref in ((ref, True), (port, False)):
            got = []
            ts = [threading.Thread(target=reader, args=(db, is_ref, t, got))
                  for t in range(4)]
            ts.append(threading.Thread(target=churn, args=(db, is_ref)))
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=300)
                assert not th.is_alive(), "a thread did not finish"
            assert len(got) == 4 * 2 * len(want)
            for i, vals in got:
                bad = [(probes[j], a, b) for j, (a, b) in
                       enumerate(zip(vals, want[i])) if a != b]
                assert not bad, (is_ref, i, bad[:5])
        if tombstones:
            assert calls["python"] > calls["native"]
        else:
            assert calls["native"] > calls["python"] > 0
        for k in (b"new2-0007", b"new0-0199"):
            assert port.get(k) == ref.get(k) == b"x" * 10
    finally:
        _close(ref, port)


def test_blob_index_and_merge_operands_fall_back_on_both(tmp_path, defaults):
    """The native chain decides nothing it cannot: a blob index (added to
    the memtable directly: the DB writes no blob files yet) or merge
    operands make both packages' native get hand the key to the Python
    chain; plain values and deletions it decides itself."""
    ref, port = _open_pair(str(tmp_path), merge="StringAppendOperator")
    try:
        for db, vt in ((ref, RefValueType), (port, ValueType)):
            seq = db.versions.last_sequence
            db.mem.add(seq + 1, vt.BLOB_INDEX, b"blob", b"\x01index")
            db.mem.add(seq + 2, vt.MERGE, b"merged", b"m")
            db.mem.add(seq + 3, vt.VALUE, b"plain", b"p")
            db.mem.add(seq + 4, vt.DELETION, b"gone", b"")
            db.versions.last_sequence = seq + 4
        seq = port.versions.last_sequence
        cfd = ref._cf_data(None)
        for key, handled, val in ((b"blob", False, None),
                                  (b"merged", False, None),
                                  (b"plain", True, b"p"),
                                  (b"gone", True, None)):
            r = ref._native_get(cfd, key, seq, RefReadOptions())
            p = port._native_get(port._cf_data(None), key, seq,
                                 ReadOptions())
            assert (p[0], p[1]) == (r[0], r[1]) == (handled, val), key
    finally:
        _close(ref, port)


# ---------------------------------------------------------------------------
# The scan plane
# ---------------------------------------------------------------------------


SCAN_CASES = {
    "default": {},
    "small_chunks": {"chunk": 16},
    "prefix_extractor": {"prefix": 4},
    "merge_operator": {"merge": "StringAppendOperator"},
    "zip": {"table_format": "zip"},
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scans_match_reference(tmp_path, defaults, monkeypatch, case):
    """Forward and backward scans, bounds, seeks, a direction switch and
    snapshot scans over memtable, L0 and L1 sources with range tombstones
    in both: equal views and equal ITER_CHUNK_REFILLS /
    ITER_CHUNK_FALLBACKS (a merge operator keeps the plane off on both
    sides; "small_chunks" is TPULSM_ITER_CHUNK=16 against
    iter_chunk_rows=16)."""
    kw = dict(SCAN_CASES[case])
    if "chunk" in kw:
        monkeypatch.setenv("TPULSM_ITER_CHUNK", str(kw["chunk"]))
    rs, ps = ref_st.Statistics(), st.Statistics()
    ref, port = _open_pair(str(tmp_path), rs, ps, write_buffer_size=64 << 20,
                           disable_auto_compactions=True, **kw)
    try:
        rng = random.Random(5)
        keys = [b"k%03d-%04d" % (i % 7, i) for i in range(900)]
        keys.sort()
        for r in range(3):
            for i in range(400):
                k = rng.choice(keys)
                op = rng.random()
                ops = ([("put", k, b"v%d-%d" % (r, i))] if op < 0.8 else
                       [("delete", k)])
                if i == 200:
                    ops = [("delete_range", keys[100 * r], keys[100 * r + 30])]
                rb, pb = _batch_pair(ops)
                ref.write(rb)
                port.write(pb)
            if r == 0:
                snaps = (ref.get_snapshot(), port.get_snapshot())
            if r < 2:
                for db in (ref, port):
                    db.flush()
            if r == 0:
                for db in (ref, port):
                    db.compact_range()
        views = []
        for db, RO in ((ref, RefReadOptions), (port, ReadOptions)):
            snap = snaps[0] if db is ref else snaps[1]
            v = [_scan(db, RO()), _scan(db, RO(), reverse=True),
                 _scan(db, RO(snapshot=snap)),
                 _scan(db, RO(iterate_lower_bound=keys[150],
                              iterate_upper_bound=keys[700]))]
            it = db.new_iterator(RO(iterate_upper_bound=keys[800]))
            steps = []
            for target in (keys[10], keys[333], b"k003", keys[799], b"zzz"):
                it.seek(target)
                for _ in range(5):
                    if not it.valid():
                        break
                    steps.append((it.key(), it.value()))
                    it.next()
            it.seek(keys[500])
            for _ in range(3):
                it.next()
            while it.valid() and len(steps) < 200:  # direction switch
                steps.append((it.key(), it.value()))
                it.prev()
            v.append(steps)
            views.append(v)
        assert views[1] == views[0]
        assert views[1][0] and views[1][1] == list(reversed(views[1][0]))
        want = (st.ITER_CHUNK_REFILLS, st.ITER_CHUNK_FALLBACKS,
                st.NUMBER_DB_SEEK, st.NUMBER_DB_NEXT, st.NUMBER_DB_PREV,
                st.ITER_BYTES_READ)
        got = _tickers(ps, want)
        assert got == _tickers(rs, want)
        if case == "merge_operator":
            assert got[st.ITER_CHUNK_REFILLS] == 0
        else:
            assert got[st.ITER_CHUNK_REFILLS] > 0
            assert got[st.ITER_CHUNK_FALLBACKS] > 0  # the backward steps
    finally:
        _close(ref, port)


def test_native_order_matches_reference():
    """The scan plane's merge of presorted runs (tpulsm_merge_runs, and
    tpulsm_sort_entries for user keys over 8 bytes) gives the reference's
    order, new-key marks and trailers."""
    rng = np.random.default_rng(9)
    for klen in (6, 8, 12):
        runs = []
        for _ in range(4):
            n = int(rng.integers(1, 400))
            uks = sorted(bytes(rng.integers(97, 100, klen, dtype=np.uint8))
                         for _ in range(n))
            runs.append([uk + int(rng.integers(1, 1 << 40) << 8 | 1)
                         .to_bytes(8, "little") for uk in uks])
        flat = [k for r in runs for k in r]
        kb = np.frombuffer(b"".join(flat), np.uint8)
        kl = np.array([len(k) for k in flat], np.int64)
        ko = np.concatenate([[0], np.cumsum(kl)[:-1]]).astype(np.int64)
        rs = np.concatenate([[0], np.cumsum([len(r) for r in runs])])
        got = sp._native_order(native.lib(), kb, ko, kl, rs)
        want = ref_sp._native_order(ref_native.lib(), kb, ko, kl, rs)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), klen


def test_planners_match_reference(tmp_path, defaults):
    """TableReader.plan_block_reads and ZipTableReader.plan_value_groups
    on the same files give the reference's byte ranges and value groups."""
    for fmt_name in ("block", "zip"):
        # zstd: the zip file's value groups compress (the planner lists
        # compressed groups only).
        ref, port = _open_pair(str(tmp_path / fmt_name),
                               table_format=fmt_name, compression=7,
                               disable_auto_compactions=True)
        try:
            for i in range(3000):
                rb, pb = _batch_pair([("put", b"key%05d" % i,
                                       b"value-%03d" % (i % 10) * 20)])
                ref.write(rb)
                port.write(pb)
            for db in (ref, port):
                db.flush()
            from toplingdb_tpu.db.dbformat import make_internal_key

            seeks = [make_internal_key(b"key%05d" % i, 1 << 40, 1)
                     for i in range(0, 3200, 37)]
            f = port.versions.current.files[0][0]
            pr = port.table_cache.get_reader(f.number)
            rr = ref.table_cache.get_reader(f.number)
            name = ("plan_block_reads" if fmt_name == "block"
                    else "plan_value_groups")
            got = getattr(pr, name)(seeks)
            assert got == getattr(rr, name)(seeks) and got, fmt_name
        finally:
            _close(ref, port)


# ---------------------------------------------------------------------------
# Corruption, refusal, knobs
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raised", type(e).__name__)


def test_corrupted_data_block_same_outcome(tmp_path, defaults):
    """A byte flipped inside one data block of an SST: the get of a key in
    that block and a full scan raise Corruption on both sides (the native
    chain's and the scan plane's checksum checks hand the read to the
    Python path, which raises); a get outside it reads alike."""
    ref, port = _open_pair(str(tmp_path), disable_auto_compactions=True)
    for i in range(2000):
        rb, pb = _batch_pair([("put", b"key%05d" % i, b"v" * 50)])
        ref.write(rb)
        port.write(pb)
    for db in (ref, port):
        db.flush()
    number = port.versions.current.files[0][0].number
    _close(ref, port)
    for side in ("ref", "port"):
        path = os.path.join(str(tmp_path), side, f"{number:06d}.sst")
        data = bytearray(open(path, "rb").read())
        data[100] ^= 0xFF  # inside the first data block
        open(path, "wb").write(bytes(data))
    ref, port = _open_pair(str(tmp_path), disable_auto_compactions=True)
    try:
        for key in (b"key00000", b"key00001", b"key01999"):
            r = _outcome(lambda: ref.get(key))
            p = _outcome(lambda: port.get(key))
            assert p == r, (key, p, r)
        assert _outcome(lambda: port.get(b"key00000")) == \
            ("raised", "Corruption")
        r = _outcome(lambda: _scan(ref, RefReadOptions()))
        p = _outcome(lambda: _scan(port, ReadOptions()))
        assert p == r == ("raised", "Corruption")
    finally:
        _close(ref, port)


@pytest.mark.parametrize("planes", ["write", "scan"])
def test_open_refuses_a_plane_without_the_native_library(tmp_path,
                                                         monkeypatch, planes):
    """The native library made unavailable (a monkeypatched loader): a
    plane asked for raises NotSupported naming it, with no file written;
    with both planes off the DB opens on the vector rep and reads through
    the Python chain."""
    monkeypatch.setattr(native, "lib", lambda: None)
    opts = Options(memtable_rep="vector", create_if_missing=True,
                   compaction_executor_factory=(
                       LocalCompactionExecutorFactory()))
    path = str(tmp_path / "db")
    kw = ({"iter_chunk_rows": 0} if planes == "write"
          else {"write_plane": False})
    match = "write plane" if planes == "write" else "scan plane"
    with pytest.raises(NotSupported, match=match):
        dbm.DB.open(path, opts, **kw)
    assert not os.path.exists(path)
    with dbm.DB.open(path, opts, write_plane=False, iter_chunk_rows=0) as db:
        db.put(b"k", b"v")
        db.flush()
        assert db.get(b"k") == b"v"
        assert db._nget_lib is None
        it = db.new_iterator()
        it.seek_to_first()
        assert it._plane is None and list(it.entries()) == [(b"k", b"v")]


def test_port_reads_no_plane_knob():
    """No source of the port names TPULSM_WRITE_PLANE or TPULSM_ITER_CHUNK
    as a string constant (the way an environment lookup would), and none
    reads os.environ or os.getenv in the DB's modules."""
    knobs = {"TPULSM_WRITE_PLANE", "TPULSM_ITER_CHUNK"}
    port = os.path.join(REPO, "toplingdb_tpu_torch")
    seen = 0
    for dirpath, _, names in os.walk(port):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            tree = ast.parse(open(path).read(), filename=path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Constant) and node.value in knobs:
                    pytest.fail(f"{path}:{node.lineno} names {node.value}")
                if (path.endswith(("db/db.py", "ops/scan_plane.py",
                                   "db/db_iter.py"))
                        and isinstance(node, ast.Attribute)
                        and node.attr in ("environ", "getenv")):
                    pytest.fail(f"{path}:{node.lineno} reads os.{node.attr}")
            seen += 1
    assert seen > 50


# ---------------------------------------------------------------------------
# Symbol isolation between the two packages' native libraries
# ---------------------------------------------------------------------------

_ISOLATION = r"""
import ctypes, json, os, sys
order = sys.argv[1]
from toplingdb_tpu import native as rn
from toplingdb_tpu_torch import native as pn


class DlInfo(ctypes.Structure):
    _fields_ = [("fname", ctypes.c_char_p), ("fbase", ctypes.c_void_p),
                ("sname", ctypes.c_char_p), ("saddr", ctypes.c_void_p)]


libc = ctypes.CDLL(None)
libc.dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(DlInfo)]


def where(addr):
    info = DlInfo()
    assert libc.dladdr(ctypes.c_void_p(addr), ctypes.byref(info))
    return os.path.realpath(info.fname.decode())


def load(pkg):
    lib = pkg.lib()
    assert lib is not None and pkg.fastget() is not None
    return lib


libs = {}
for name in (("ref", "port") if order == "ref-first" else ("port", "ref")):
    libs[name] = load(rn if name == "ref" else pn)

from toplingdb_tpu.options import Options as RO
from toplingdb_tpu_torch.compaction.executor import (
    LocalCompactionExecutorFactory)
from toplingdb_tpu_torch.db.db import DB as PDB
from toplingdb_tpu_torch.options import Options as PO
import toplingdb_tpu.db.db as rdbm

root = sys.argv[2]
# Protected DBs: every put is a protected native group commit, every flush
# folds its export through tpulsm_columnar_protect.
port = PDB.open(os.path.join(root, "port"), PO(
    create_if_missing=True, protection_bytes_per_key=8,
    compaction_executor_factory=LocalCompactionExecutorFactory()))
ref = rdbm.DB.open(os.path.join(root, "ref"), RO(
    create_if_missing=True, protection_bytes_per_key=8))
for db, tag in ((port, b"port"), (ref, b"ref")):
    for i in range(300):
        db.put(b"key%04d" % i, tag + b"%d" % i)
    db.flush()
    db.put(b"mem", tag)
got = {"port": [port.get(b"key0007"), port.get(b"mem")],
       "ref": [ref.get(b"key0007"), ref.get(b"mem")]}
from toplingdb_tpu.db.write_batch import WriteBatch as RWB
from toplingdb_tpu.db.write_batch import _native_protect as ref_protect
from toplingdb_tpu_torch.db.write_batch import _native_protect as port_protect
from toplingdb_tpu_torch.utils import protection as pprot

wb = RWB()
for i in range(20):
    wb.put(b"pk%d" % i, b"pv%d" % i)
    wb.delete(b"dk%d" % i)
want = [pprot.truncate(pprot.protect_entry(int(t), k, v or b""), 8)
        for t, k, v in wb.entries()]
prot_names = ("tpulsm_wb_protect", "tpulsm_columnar_protect",
              "tpulsm_skiplist_insert_wb_prot", "tpulsm_wb_group_commit")
state = port._nget_tl.states[0]
fn_addr = ctypes.cast(state.fn, ctypes.c_void_p).value
glob = getattr(ctypes.CDLL(None), "tpulsm_getctx_get", None)
out = {
    "port_so": os.path.realpath(pn._SO),
    "ref_so": os.path.realpath(rn._SO),
    "global": where(ctypes.cast(glob, ctypes.c_void_p).value)
              if glob is not None else None,
    "port_fn": where(fn_addr),
    "port_fast": where(pn._fastget_mod.bound_addr()),
    "port_fast_used": state.fast is not None,
    "ref_fast": where(ctypes.cast(
        libs["ref"].tpulsm_getctx_get, ctypes.c_void_p).value),
    "got": {k: [v.decode() for v in vs] for k, vs in got.items()},
    "prot_where": {k: [where(ctypes.cast(getattr(libs[k], n),
                                         ctypes.c_void_p).value)
                       for n in prot_names] for k in ("port", "ref")},
    "prot_global": [where(ctypes.cast(getattr(ctypes.CDLL(None), n),
                                      ctypes.c_void_p).value)
                    if hasattr(ctypes.CDLL(None), n) else None
                    for n in prot_names],
    "prot_vec": [[int(x) for x in f(wb.data(), 8, False)] == want
                 for f in (port_protect, ref_protect)],
}
port.close()
ref.close()
print(json.dumps(out))
"""


@pytest.mark.parametrize("order", ["ref-first", "port-first"])
def test_native_libraries_stay_isolated(tmp_path, order):
    """Both packages' native libraries and fastget extensions in one
    process, loaded in either order (toplingdb_tpu's fastget promotes its
    library to global scope): the global scope resolves no
    tpulsm_getctx_get from the port's library, the port's get context
    function and its fastget binding lie in the port's library, the
    reference's in its own, and each package's get returns its own
    data. Both DBs run with protection_bytes_per_key=8, so the protected
    group commit, the fused verify+insert and the flush's columnar fold
    run in the same process: each package's protection exports lie in its
    own library, none of the port's is the one the global scope resolves,
    and both compute the vector utils/protection.py computes."""
    import json

    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("TPULSM_WRITE_PLANE", None)
    env.pop("TPULSM_ITER_CHUNK", None)
    out = subprocess.run([sys.executable, "-c", _ISOLATION, order,
                          str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    port_so, ref_so = res["port_so"], res["ref_so"]
    assert port_so != ref_so
    assert res["global"] != port_so
    assert res["port_fn"] == port_so
    assert res["port_fast"] == port_so and res["port_fast_used"]
    assert res["ref_fast"] == ref_so
    assert res["got"] == {"port": ["port7", "port"], "ref": ["ref7", "ref"]}
    assert res["prot_where"] == {"port": [port_so] * 4, "ref": [ref_so] * 4}
    assert port_so not in res["prot_global"]
    assert res["prot_vec"] == [True, True]


_SHIM = r"""
#include <stddef.h>
#include <stdint.h>
uint32_t tpulsm_crc32c_extend(uint32_t c, const uint8_t* d, size_t n) {
  return 0;
}
uint64_t tpulsm_xxh64(const uint8_t* d, size_t n, uint64_t s) { return 0; }
"""

_SHIMMED = r"""
import ctypes, os, sys
ctypes.CDLL(sys.argv[1], mode=ctypes.RTLD_GLOBAL)  # exports tpulsm_* first
from toplingdb_tpu_torch.compaction.executor import (
    LocalCompactionExecutorFactory)
from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.utils import statistics as st

stats = st.Statistics()
opts = Options(create_if_missing=True, statistics=stats,
               compaction_executor_factory=LocalCompactionExecutorFactory())
path = os.path.join(sys.argv[2], "db")
db = DB.open(path, opts)
for i in range(500):
    db.put(b"key%04d" % i, b"v%d" % i)
db.flush()
db.put(b"mem", b"m")
seq = db.versions.last_sequence
cfd = db._cf_data(None)
handled = [db._native_get(cfd, b"key%04d" % i, seq, ReadOptions())[0]
           for i in range(0, 500, 50)]
assert all(handled), handled
assert db.get(b"key0042") == b"v42" and db.get(b"mem") == b"m"
db._compaction_scheduler.shutdown()
db._wal.sync()
db._wal.close()
db._closed = True
db = DB.open(path, opts)  # replays the natively framed WAL
assert db.get(b"mem") == b"m"
db.close()
print(stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS))
"""


def test_port_library_binds_its_own_exports(tmp_path):
    """A library loaded first into global scope exports
    tpulsm_crc32c_extend and tpulsm_xxh64 returning 0 (as toplingdb_tpu's
    library, promoted by its fastget, exports the real ones): the port's
    library, linked -Bsymbolic, still calls its own. Its natively framed
    WAL replays (crc32c), its point reads are decided by the native chain
    (block crc and bloom probes), and the write plane committed every
    put."""
    src = tmp_path / "shim.c"
    src.write_text(_SHIM)
    shim = str(tmp_path / "libshim.so")
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", shim, str(src)],
                   check=True, capture_output=True, timeout=120)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _SHIMMED, shim,
                          str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "501"
