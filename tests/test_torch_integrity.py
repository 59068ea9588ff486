"""The integrity plane of toplingdb_tpu_torch's DB against toplingdb_tpu's,
on the CPU (the port's compactions on DeviceCompactionExecutorFactory(
device="cpu"), the kernels' plain versions, or the host path; the
reference's on JAX's CPU backend or its host path).

- the native protection exports (tpulsm_wb_protect, tpulsm_columnar_protect,
  the protected tpulsm_wb_group_commit in its fill and verify modes, the
  fused verify+insert) against the reference's Python `protect_entry` over
  seeded random batches, pb in {1, 2, 4, 8}, with and without column
  families;
- the cases of tests/test_integrity.py that need no checkpoint, tool or
  HTTP view (:87, :109, :120, :192, :240, :259, :321, :342, :369, :396,
  the soak :427 at a small size, :569 with `write_plane=`,
  `iter_chunk_rows=` and the pipeline standing in for the reference's env
  knobs, :610), each run on both packages with the answers compared: the
  same Corruption at the same record for a tampered batch, a tampered
  memtable entry before a flush and a tampered scan chunk; the same scrub
  reports; the same corrupted read bytes from the same seed;
- protected DBs side by side with protection 8, with and without the
  write plane and the scan plane: equal protection vectors, WAL, SST and
  MANIFEST bytes, level sets, gets and scans, tickers and scrub reports;
- the error handler: `_classify_bg_error` over (error type, reason) against
  the reference's table, escalation only, a compaction's Corruption
  UNRECOVERABLE and resume() refusing it, a retryable compaction error
  auto-recovered on the same executor.

Tolerance: none; vectors, bytes, reports and messages must be equal.
"""

import ctypes
import os
import random
import threading

import numpy as np
import pytest

import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.ops.scan_plane as ref_sp
from toplingdb_tpu.compaction.executor import (
    DeviceCompactionExecutorFactory as RefFactory,
)
from toplingdb_tpu.compaction.picker import (
    LeveledCompactionPicker as RefPicker,
)
from toplingdb_tpu.db.dbformat import InternalKeyComparator as RefICmp
from toplingdb_tpu.db.memtable import MemTable as RefMemTable
from toplingdb_tpu.db.write_batch import WriteBatch as RefWriteBatch
from toplingdb_tpu.env import PosixEnv as RefPosixEnv
from toplingdb_tpu.env.fault_injection import (
    FaultInjectionEnv as RefFaultInjectionEnv,
)
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.utils import protection as ref_prot
from toplingdb_tpu.utils import statistics as ref_st
from toplingdb_tpu.utils import status as ref_status
from toplingdb_tpu.utils.listener import EventListener as RefListener

import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.ops.scan_plane as sp
from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.compaction.picker import LeveledCompactionPicker
from toplingdb_tpu_torch.db import write_batch as wbm
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.memtable import MemTable
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.env.fault_injection import FaultInjectionEnv
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils import status
from toplingdb_tpu_torch.utils.listener import EventListener
from toplingdb_tpu_torch.utils.status import Corruption

from test_torch_db import Twin, pinned_clock  # noqa: F401

PBS = (1, 2, 4, 8)


def _lib():
    lib = native.lib()
    assert lib is not None, "the port's native library did not build"
    return lib


def dump(db, cf=None):
    it = db.new_iterator(cf=cf) if cf is not None else db.new_iterator()
    it.seek_to_first()
    out = []
    while it.valid():
        out.append((it.key(), it.value()))
        it.next()
    return out


def fill(db, n, seed=0, vrep=10):
    rng = random.Random(seed)
    for i in range(n):
        db.put(b"k%06d" % i, (b"v%05d." % rng.randrange(10**5)) * vrep)
    return n


def _ref_open(path, monkeypatch=None, write_plane=True, iter_chunk_rows=None,
              **kw):
    """The reference DB; its planes follow its env knobs."""
    if monkeypatch is not None:
        monkeypatch.setenv("TPULSM_WRITE_PLANE", "1" if write_plane else "0")
        monkeypatch.setenv("TPULSM_ITER_CHUNK", "1" if iter_chunk_rows is None
                           else str(iter_chunk_rows))
    return ref_dbm.DB.open(path, RefOptions(**kw))


def _port_open(path, write_plane=True, iter_chunk_rows=4096, local=False,
               **kw):
    kw.setdefault("compaction_executor_factory",
                  LocalCompactionExecutorFactory() if local
                  else DeviceCompactionExecutorFactory(device="cpu"))
    return dbm.DB.open(path, Options(**kw), write_plane=write_plane,
                       iter_chunk_rows=iter_chunk_rows)


def _corrupt_table_file(dbdir, skip=None):
    """Flip one byte mid-file in the first (or first non-skipped) live
    SST; returns (path, original_bytes)."""
    ssts = sorted(f for f in os.listdir(dbdir) if f.endswith(".sst")
                  and f != skip)
    path = os.path.join(dbdir, ssts[0])
    orig = open(path, "rb").read()
    buf = bytearray(orig)
    buf[len(buf) // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(buf)
    return path, orig


# ---------------------------------------------------------------------------
# The native protection exports against protect_entry
# ---------------------------------------------------------------------------


def _random_batch(rng, n, with_cf):
    """(records, port batch, reference batch): the same seeded records
    in both packages' WriteBatch. A record is (cf, type, key, value)."""
    recs = []
    pb_, rb = WriteBatch(), RefWriteBatch()
    kinds = ["put", "delete", "single_delete", "merge", "delete_range"]
    for _ in range(n):
        kind = kinds[rng.integers(len(kinds))]
        cf = int(rng.integers(1, 5)) if with_cf and rng.random() < 0.5 else 0
        k = rng.bytes(int(rng.integers(0, 40)))
        v = rng.bytes(int(rng.integers(0, 300)))
        args = (k,) if kind in ("delete", "single_delete") else (k, v)
        getattr(pb_, kind)(*args, cf=cf)
        getattr(rb, kind)(*args, cf=cf)
        if rng.random() < 0.05:
            pb_.put_log_data(b"blob")
            rb.put_log_data(b"blob")
    for cf, t, k, v in rb.entries_cf():
        recs.append((cf, int(t), k, v))
    return recs, pb_, rb


def _want(recs, pb, strip):
    out = []
    for cf, t, k, v in recs:
        full = ref_prot.protect_entry(t, k, v, cf)
        if strip:
            full = ref_prot.strip_cf(full, cf)
        out.append(ref_prot.truncate(full, pb))
    return out


@pytest.mark.parametrize("with_cf", [False, True], ids=["default-cf", "cfs"])
@pytest.mark.parametrize("pb", PBS)
def test_wb_protect_matches_protect_entry(pb, with_cf):
    rng = np.random.default_rng(1000 * pb + with_cf)
    for trial in range(20):
        recs, b, rb = _random_batch(rng, int(rng.integers(1, 200)), with_cf)
        assert b.data() == rb.data()
        for strip in (False, True):
            got = wbm._native_protect(b.data(), pb, strip_cf=strip)
            assert got is not None
            assert [int(x) for x in got] == _want(recs, pb, strip), trial
        # The batches' own vectors agree with each other and the table.
        b.attach_protection(pb)
        rb.attach_protection(pb)
        assert [int(x) for x in b._prot] == [int(x) for x in rb._prot] \
            == _want(recs, pb, False)


@pytest.mark.parametrize("pb", PBS)
def test_columnar_protect_matches_protect_entry(pb):
    """tpulsm_columnar_protect's XOR over internal keys (user key + 8-byte
    trailer) equals the fold of protect_entry's CF-0 checksums."""
    lib = _lib()
    rng = np.random.default_rng(pb)
    n = 500
    uks = [rng.bytes(int(rng.integers(0, 30))) for _ in range(n)]
    vals = [rng.bytes(int(rng.integers(0, 200))) for _ in range(n)]
    types = rng.choice([0, 1, 2, 7], size=n).astype(np.int32)
    iks = [k + bytes(8) for k in uks]
    kb = np.frombuffer(b"".join(iks), np.uint8).copy()
    vb = np.frombuffer(b"".join(vals) or b"\0", np.uint8).copy()
    kl = np.array([len(k) for k in iks], np.int32)
    vl = np.array([len(v) for v in vals], np.int32)
    ko = np.concatenate([[0], np.cumsum(kl)[:-1]]).astype(np.int32)
    vo = np.concatenate([[0], np.cumsum(vl)[:-1]]).astype(np.int32)
    out = ctypes.c_uint64()
    rc = lib.tpulsm_columnar_protect(
        native.np_u8p(kb), native.np_i32p(ko), native.np_i32p(kl),
        native.np_u8p(vb), native.np_i32p(vo), native.np_i32p(vl),
        native.np_i32p(types), n, pb, ctypes.byref(out))
    assert rc == n
    want = 0
    for t, k, v in zip(types, uks, vals):
        want ^= ref_prot.truncate(ref_prot.protect_entry(int(t), k, v), pb)
    assert out.value == want


def _group_call(lib, reps, prots, pb, mode, first_seq=100):
    n = len(reps)
    rep_arr = (ctypes.c_char_p * n)(*reps)
    len_arr = (ctypes.c_int64 * n)(*[len(r) for r in reps])
    out = (ctypes.c_int64 * 8)()
    cap = 12 + sum(len(r) for r in reps) * 2 + 64
    wal = (ctypes.c_ubyte * cap)()
    rc = lib.tpulsm_wb_group_commit(None, 0, rep_arr, len_arr, n, first_seq,
                                    prots, len(prots) if prots else 0, pb,
                                    mode, 0, -1, wal, cap, out)
    return rc


@pytest.mark.parametrize("with_cf", [False, True], ids=["default-cf", "cfs"])
@pytest.mark.parametrize("pb", PBS)
def test_group_commit_protection_matches_protect_entry(pb, with_cf):
    """The protected branch of tpulsm_wb_group_commit (WAL framing only):
    FILL (mode 8) writes every record's checksum, VERIFY returns -5 - i at
    the first tampered record i, with nothing framed; a CF-prefixed record
    is refused with -2 (the Python group commit takes it)."""
    lib = _lib()
    rng = np.random.default_rng(10 * pb + with_cf)
    for trial in range(10):
        group = []
        for _ in range(int(rng.integers(1, 5))):
            b = WriteBatch()
            for _ in range(int(rng.integers(1, 40))):
                cf = (int(rng.integers(1, 3))
                      if with_cf and rng.random() < 0.2 else 0)
                k = rng.bytes(int(rng.integers(1, 20)))
                if rng.random() < 0.3:
                    b.delete(k, cf=cf)
                else:
                    b.put(k, rng.bytes(int(rng.integers(0, 100))), cf=cf)
            group.append(b)
        reps = [b.data() for b in group]
        recs = [(cf, int(t), k, v) for b in group
                for cf, t, k, v in RefWriteBatch(b.data()).entries_cf()]
        total = len(recs)
        prots = (ctypes.c_uint64 * total)()
        rc = _group_call(lib, reps, prots, pb, 1 | 8)
        if any(cf for cf, *_ in recs):
            assert rc == -2
            continue
        assert rc == total
        want = _want(recs, pb, False)
        assert list(prots) == want
        assert _group_call(lib, reps, prots, pb, 1) == total
        bad = int(rng.integers(total))
        prots[bad] ^= 1
        assert _group_call(lib, reps, prots, pb, 1) == -5 - bad


@pytest.mark.parametrize("pb", PBS)
def test_fused_insert_rejects_the_whole_batch(pb):
    """tpulsm_skiplist_insert_wb_prot (MemTable.add_encoded with pb > 0):
    a clean vector inserts every record; a tampered one raises Corruption
    naming the record and inserts nothing, in both packages alike."""
    rng = np.random.default_rng(pb)
    b, rb = WriteBatch(), RefWriteBatch()
    for i in range(50):
        k, v = b"key%03d" % i, rng.bytes(20)
        b.put(k, v)
        rb.put(k, v)
    prots = wbm._native_protect(b.data(), pb, strip_cf=True)
    from toplingdb_tpu.db.memtable import create_memtable_rep as ref_rep

    msgs = []
    for m in (MemTable(InternalKeyComparator(), _skiplist(),
                       protection_bytes=pb),
              RefMemTable(RefICmp(), ref_rep("skiplist"),
                          protection_bytes=pb)):
        tampered = np.array(prots, dtype=np.uint64)
        tampered[17] ^= np.uint64(1)
        with pytest.raises(Exception) as ei:
            m.add_encoded(1, b.data(), prots=tampered, pb=pb)
        msgs.append(str(ei.value))
        assert type(ei.value).__name__ == "Corruption"
        assert len(m._rep) == 0 and m.protection_map() == {}
        assert m.add_encoded(1, b.data(), prots=prots, pb=pb) == 50
        assert len(m._rep) == 50 and len(m.protection_map()) == 50
    assert msgs[0] == msgs[1] and "record 17" in msgs[0]


def _skiplist():
    from toplingdb_tpu_torch.db.memtable import create_memtable_rep

    return create_memtable_rep("skiplist")


# ---------------------------------------------------------------------------
# WriteBatch and memtable handoffs (tests/test_integrity.py:87, :109, :120)
# ---------------------------------------------------------------------------


def _tampered_batch(cls):
    b = cls(protection_bytes_per_key=8)
    b.put(b"alpha", b"one")
    b.put(b"beta", b"two")
    b.verify_protection()  # clean batch passes
    raw = bytearray(b._rep)
    raw[raw.index(b"two")] ^= 0x40
    b._rep = raw
    return b


def test_write_batch_detects_tampered_rep():                   # :87
    msgs = []
    for cls, mem in ((WriteBatch, lambda: MemTable(
                          InternalKeyComparator(), protection_bytes=8)),
                     (RefWriteBatch, lambda: RefMemTable(
                          RefICmp(), protection_bytes=8))):
        b = _tampered_batch(cls)
        with pytest.raises(Exception) as e1:
            b.verify_protection()
        with pytest.raises(Exception) as e2:
            b.insert_into(mem(), sequence=1)
        msgs.append((type(e1.value).__name__, str(e1.value),
                     type(e2.value).__name__, str(e2.value)))
    assert msgs[0] == msgs[1]
    assert msgs[0][0] == "Corruption" and "record 1" in msgs[0][1]


@pytest.mark.parametrize("planes", ["native", "python"])
def test_db_write_of_a_tampered_batch_raises_at_the_same_record(
        tmp_path, monkeypatch, planes):
    """A batch whose bytes changed after its vector was computed: DB.write
    raises the same Corruption in both DBs (the group commit's validation
    on the native plane, the memtable-insert handoff on the Python one),
    and nothing of it reaches the WAL or the memtable."""
    native_on = planes == "native"
    ref = _ref_open(str(tmp_path / "ref"), monkeypatch,
                    write_plane=native_on, protection_bytes_per_key=8)
    port = _port_open(str(tmp_path / "port"), write_plane=native_on,
                      protection_bytes_per_key=8)
    try:
        msgs = []
        for db, cls in ((port, WriteBatch), (ref, RefWriteBatch)):
            db.put(b"before", b"x")
            b = _tampered_batch(cls)
            with pytest.raises(Exception) as ei:
                db.write(b)
            msgs.append((type(ei.value).__name__, str(ei.value)))
            assert db.get(b"alpha") is None and db.get(b"beta") is None
            assert db.get(b"before") == b"x"
        assert msgs[0] == msgs[1]
        assert msgs[0][0] == "Corruption" and "record 1" in msgs[0][1]
        assert ("group commit" in msgs[0][1]) == native_on
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("pb", PBS)
def test_wire_loaded_batch_attach_protection(pb):               # :109
    vecs = []
    for cls in (WriteBatch, RefWriteBatch):
        src = cls()
        src.put(b"x", b"1")
        src.delete(b"y")
        src.put(b"z", b"2", cf=3)
        loaded = cls(src.data(), protection_bytes_per_key=pb)
        loaded.verify_protection()
        assert loaded._prot is not None and len(loaded._prot) == 3
        vecs.append([int(x) for x in loaded._prot])
    assert vecs[0] == vecs[1]


def test_flush_detects_memtable_corruption(tmp_path, monkeypatch):  # :120
    ref = _ref_open(str(tmp_path / "ref"), monkeypatch,
                    protection_bytes_per_key=8)
    port = _port_open(str(tmp_path / "port"), protection_bytes_per_key=8)
    msgs, maps = [], []
    for db in (port, ref):
        try:
            for i in range(50):
                db.put(b"k%03d" % i, b"v%03d" % i)
            # The rep silently changes an entry under its recorded
            # checksum: the memtable->flush handoff refuses to emit.
            pmap = db._cfs[0].mem.protection_map()
            assert len(pmap) == 50  # wire-path checksums materialize here
            maps.append(dict(pmap))
            skey = next(iter(pmap))
            pmap[skey] ^= 1
            with pytest.raises(Exception) as ei:
                db.flush()
            msgs.append((type(ei.value).__name__, str(ei.value)))
        finally:
            try:
                db.close()  # close re-flushes and hits the same mismatch
            except Exception as e:  # noqa: BLE001
                assert type(e).__name__ == "Corruption"
    assert maps[0] == maps[1]
    assert msgs[0] == msgs[1] and msgs[0][0] == "Corruption"
    assert not [f for f in os.listdir(tmp_path / "port")
                if f.endswith(".sst")]


# ---------------------------------------------------------------------------
# Whole-file checksums (tests/test_integrity.py:192, :240)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("func", ["crc32c", "xxh64"])
def test_checksums_recorded_and_survive_reopen(tmp_path, func):  # :192
    from toplingdb_tpu.utils import file_checksum as ref_fc

    from toplingdb_tpu_torch.utils import file_checksum as fc

    d = str(tmp_path / "db")
    db = _port_open(d, protection_bytes_per_key=8, file_checksum=func,
                    write_buffer_size=16 * 1024)
    fill(db, 1500, seed=1)
    db.flush()
    db.wait_for_compactions()
    res = db.verify_file_checksums()
    assert res["files_verified"] >= 1 and res["files_skipped"] == 0
    db.close()

    db2 = _port_open(d, file_checksum=func)
    try:
        res2 = db2.verify_file_checksums()
        assert res2["files_verified"] == res["files_verified"]
        metas = [f for cf_id in db2.versions.column_families
                 for _, f in db2.versions.cf_current(cf_id).all_files()]
        assert metas and all(m.file_checksum_func_name == func
                             for m in metas)
    finally:
        db2.close()
    # Offline: the MANIFEST alone yields the digests; the reference's
    # reader of the port's directory agrees.
    rec = fc.manifest_file_checksums(d)
    assert rec and all(name == func for name, _ in rec.values())
    assert rec == ref_fc.manifest_file_checksums(d)
    offline = fc.verify_dir_file_checksums(d)
    assert offline == ref_fc.verify_dir_file_checksums(d)
    assert offline["files_verified"] == res["files_verified"]


def test_checksum_is_taken_from_the_written_bytes(tmp_path, monkeypatch):
    """A table written while every read of tables is damaged: the port
    records the digest of the bytes it wrote (ChecksumTapEnv), so once
    reads are clean again its checksums verify and a scrub finds nothing.
    The reference digests a read-back, records the damaged read's digest,
    and its verification then fails on a sound file (ROADMAP §C)."""
    got = {}
    for name in ("port", "ref"):
        d = str(tmp_path / name)
        if name == "port":
            fe = FaultInjectionEnv(PosixEnv())
            db = dbm.DB.open(d, Options(
                disable_auto_compactions=True,
                compaction_executor_factory=DeviceCompactionExecutorFactory(
                    device="cpu")), env=fe)
        else:
            monkeypatch.setenv("TPULSM_WRITE_PLANE", "1")
            fe = RefFaultInjectionEnv(RefPosixEnv())
            db = ref_dbm.DB.open(d, RefOptions(
                disable_auto_compactions=True), env=fe)
        try:
            fe.corrupt_reads(pattern="*.sst", rate=1e-2, seed=3)
            fill(db, 500, seed=8)
            db.flush()
            fe.clear_corrupt_reads()
            try:
                db.verify_file_checksums()
                got[name] = "verified"
            except Exception as e:  # noqa: BLE001
                got[name] = type(e).__name__
        finally:
            db.close()
    assert got == {"port": "verified", "ref": "Corruption"}


def test_verify_file_checksums_detects_on_disk_corruption(tmp_path,
                                                          monkeypatch):
    # :240
    msgs = []
    for name in ("port", "ref"):
        d = str(tmp_path / name)
        db = (_port_open(d, write_buffer_size=16 * 1024,
                         disable_auto_compactions=True) if name == "port"
              else _ref_open(d, monkeypatch, write_buffer_size=16 * 1024,
                             disable_auto_compactions=True))
        try:
            fill(db, 1200, seed=2)
            db.flush()
            _corrupt_table_file(d)
            with pytest.raises(Exception, match="file checksum mismatch") \
                    as ei:
                db.verify_file_checksums()
            msgs.append(type(ei.value).__name__)
        finally:
            db.close()
    assert msgs == ["Corruption", "Corruption"]


# ---------------------------------------------------------------------------
# The scrubber: detect, quarantine, repair, resume (:259, :321, :342)
# ---------------------------------------------------------------------------


def _both(tmp_path, monkeypatch, **kw):
    """(port, reference) DBs on the same options, the port's jobs on the
    device executor's plain kernels."""
    port = _port_open(str(tmp_path / "port"), **kw)
    ref = _ref_open(str(tmp_path / "ref"), monkeypatch, **kw)
    return port, ref


def _norm_report(rep, d):
    out = dict(rep)
    out.pop("pass_micros")
    out["corruptions"] = [dict(c, path=c["path"].replace(d, "<db>"),
                               error=c["error"].replace(d, "<db>"))
                          for c in rep["corruptions"]]
    return out


def test_scrubber_quarantine_repair_resume(tmp_path, monkeypatch,
                                           pinned_clock):           # :259
    out = {}
    for name in ("port", "ref"):
        pkg_st = st if name == "port" else ref_st
        events = []

        class L(EventListener if name == "port" else RefListener):
            def on_corruption_detected(self, db, info):
                events.append(info)

        d = str(tmp_path / name)
        stats = pkg_st.Statistics()
        kw = dict(protection_bytes_per_key=8, write_buffer_size=16 * 1024,
                  memtable_rep="vector", statistics=stats, listeners=[L()],
                  disable_auto_compactions=True)
        db = (_port_open(d, **kw) if name == "port"
              else _ref_open(d, monkeypatch, **kw))
        try:
            fill(db, 1500, seed=3)
            db.flush()
            expected = dump(db)
            path, orig = _corrupt_table_file(d)
            bad_num = int(os.path.basename(path).split(".")[0])

            rep = db.scrub()
            assert [c["file_number"] for c in rep["corruptions"]] == \
                [bad_num]
            assert rep["quarantined"] == [bad_num]
            assert bad_num in db._quarantined
            assert events and events[0].file_number == bad_num
            assert events[0].recorded_checksum
            t = stats.tickers()
            assert t[pkg_st.INTEGRITY_CORRUPTIONS_DETECTED] == 1
            assert t[pkg_st.INTEGRITY_SCRUB_PASSES] >= 1
            assert stats.get_histogram(
                pkg_st.SCRUB_LATENCY_MICROS).count >= 1
            # HARD (resumable after repair), not FATAL: writes fail now.
            with pytest.raises(Exception) as blocked:
                db.put(b"blocked", b"x")
            # Quarantine excludes the file from every compaction pick.
            picker = (LeveledCompactionPicker if name == "port"
                      else RefPicker)(db.options, db.icmp)
            c = picker.pick_compaction(db.versions.cf_current(0))
            assert c is None or all(
                f.number != bad_num
                for f in c.inputs + c.output_level_inputs)
            # The operator restores the bytes; a clean re-scrub lifts the
            # quarantine, and resume() reopens writes.
            with open(path, "wb") as f:
                f.write(orig)
            rep2 = db.scrub()
            assert not rep2["corruptions"] and rep2["repaired"] == [bad_num]
            assert bad_num not in db._quarantined
            db.resume()
            db.put(b"resumed", b"yes")
            assert db.get(b"resumed") == b"yes"
            assert dump(db) == expected + [(b"resumed", b"yes")]
            out[name] = dict(
                reports=[_norm_report(rep, d), _norm_report(rep2, d)],
                # The latch's text names the repair tool the reference
                # has; up to the quarantine it reads alike.
                blocked=(type(blocked.value).__name__,
                         str(blocked.value).replace(d, "<db>").split(
                             "quarantined")[0]),
                event=(events[0].file_number, events[0].recorded_checksum,
                       events[0].checksum_func_name),
                tickers={k: v for k, v in stats.tickers().items()
                         if k.startswith(("integrity.", "bg."))},
                files=sorted(f for f in os.listdir(d)
                             if f.endswith(".sst")))
        finally:
            db.close()
    for k in out["port"]:
        assert out["port"][k] == out["ref"][k], k


def test_background_scrubber_thread_runs_passes(tmp_path):     # :321
    import time

    d = str(tmp_path / "db")
    db = _port_open(d, protection_bytes_per_key=8,
                    integrity_scrub_period_sec=1,
                    integrity_scrub_bytes_per_sec=0)
    try:
        fill(db, 300, seed=4)
        db.flush()
        assert db._integrity_scrubber is not None
        deadline = time.time() + 10
        while (db._integrity_scrubber.passes == 0
               and time.time() < deadline):
            time.sleep(0.05)
        assert db._integrity_scrubber.passes >= 1
        status_ = db.scrub_status()
        assert status_["running"]
        assert status_["last_report"]["files_scanned"] >= 1
        assert status_["quarantined_files"] == []
    finally:
        db.close()
    assert not [t.name for t in threading.enumerate()
                if t.name == "tpt-integrity-scrubber" and t.is_alive()]


def test_verify_checksum_sweeps_blob_files(tmp_path, monkeypatch):  # :342
    msgs = []
    for name in ("port", "ref"):
        d = str(tmp_path / name)
        kw = dict(enable_blob_files=True, min_blob_size=64,
                  write_buffer_size=1 << 20)
        db = (_port_open(d, **kw) if name == "port"
              else _ref_open(d, monkeypatch, **kw))
        try:
            for i in range(200):
                db.put(b"b%03d" % i, b"B%03d" % i * 40)  # > min_blob_size
            db.flush()
            db.verify_checksum()  # a clean sweep, blob records included
            blobs = [f for f in os.listdir(d) if f.endswith(".blob")]
            assert blobs
            path = os.path.join(d, blobs[0])
            buf = bytearray(open(path, "rb").read())
            buf[len(buf) // 2] ^= 0x10
            with open(path, "wb") as f:
                f.write(buf)
            with pytest.raises(Exception) as ei:
                db.verify_checksum()
            msgs.append((type(ei.value).__name__,
                         str(ei.value).replace(d, "<db>")))
        finally:
            db.close()
    assert msgs[0] == msgs[1] and msgs[0][0] == "Corruption"


# ---------------------------------------------------------------------------
# The error handler
# ---------------------------------------------------------------------------


def _errors(pkg_status):
    import errno

    return {
        "corruption": lambda: pkg_status.Corruption("bad block"),
        "io": lambda: pkg_status.IOError_("io"),
        "io-retryable": lambda: pkg_status.IOError_("io", retryable=True),
        "no-space": lambda: pkg_status.NoSpace("full"),
        "enospc": lambda: OSError(errno.ENOSPC, "No space left on device"),
        "runtime": lambda: RuntimeError("boom"),
    }


REASONS = ["compaction", "flush", "scrub", "manifest", "no_space", "wal"]


@pytest.mark.parametrize("reason", REASONS)
@pytest.mark.parametrize("kind", sorted(_errors(status)))
def test_classify_bg_error_matches_reference(kind, reason):
    got = dbm.DB._classify_bg_error(None, _errors(status)[kind](), reason)
    want = ref_dbm.DB._classify_bg_error(
        None, _errors(ref_status)[kind](), reason)
    assert got.name == want.name and int(got) == int(want)


def test_background_error_escalates_and_resumes(tmp_path, monkeypatch):
    """The same sequence of latches through both DBs: HARD blocks writes
    and resume() clears it; a lower severity never replaces a higher one;
    a raw ENOSPC is re-reasoned no_space; a compaction's Corruption is
    UNRECOVERABLE and resume() refuses it. Each DB's listener hears the
    same errors and recoveries."""
    import errno

    port, ref = _both(tmp_path, monkeypatch, disable_auto_compactions=True)
    seen = {}
    try:
        for db, pkg_status, lst in ((port, status, EventListener),
                                    (ref, ref_status, RefListener)):
            log = []

            class L(lst):
                def on_background_error(self, db, e):
                    log.append(("bg", type(e).__name__))

                def on_error_recovery_completed(self, db, info):
                    log.append(("recovered", info.reason, info.auto))

            db.options.listeners = [L()]

            def state():
                try:
                    db.put(b"k", b"v")
                    w = "ok"
                except Exception as e:  # noqa: BLE001
                    w = type(e).__name__
                return (db._bg_error_severity.name, db._bg_error_reason, w)

            db._set_background_error(pkg_status.IOError_("disk"),
                                     reason="flush")
            log.append(state())
            # Lower than HARD: ignored (no listener call, no thread).
            db._set_background_error(pkg_status.IOError_("t"),
                                     reason="scrub")
            log.append(state())
            db.resume()
            log.append(state())
            db._set_background_error(
                pkg_status.Corruption("scrubbed"), reason="scrub")
            log.append(state())
            db._set_background_error(
                pkg_status.Corruption("in a job"), reason="compaction")
            log.append(state())
            with pytest.raises(Exception) as ei:
                db.resume()
            log.append(("resume", type(ei.value).__name__))
            e = OSError(errno.ENOSPC, "No space left on device")
            db._set_background_error(e, reason="flush")  # below: ignored
            log.append((state(), getattr(e, "_bg_reason", None)))
            seen[db is port] = log
    finally:
        port._bg_error = ref._bg_error = None  # let close flush
        port.close()
        ref.close()
    assert seen[True] == seen[False]
    assert seen[True][:2] == [("bg", "IOError_"),
                              ("HARD_ERROR", "flush", "IOError_")]
    assert ("resume", "IOError_") in seen[True]


def test_compaction_corruption_is_unrecoverable(tmp_path, monkeypatch):
    """A card job that raises Corruption latches UNRECOVERABLE through the
    scheduler (reason "compaction"): writes raise, resume() refuses, and
    no output of the job is installed."""
    import toplingdb_tpu_torch.ops.device_compaction as dc

    def corrupt(*a, **k):
        raise Corruption("block checksum mismatch in a job input")

    monkeypatch.setattr(dc, "run_device_compaction", corrupt)
    d = str(tmp_path / "db")
    db = _port_open(d, protection_bytes_per_key=8,
                    level0_file_num_compaction_trigger=2)
    try:
        for r in range(3):
            for i in range(100):
                db.put(b"k%04d" % (i * 3 + r), b"v")
            db.flush()
        with pytest.raises(Exception):
            db.wait_for_compactions()
        assert db._bg_error_severity.name == "UNRECOVERABLE"
        assert db._bg_error_reason == "compaction"
        with pytest.raises(Exception, match="background error pending"):
            db.put(b"x", b"y")
        with pytest.raises(Exception, match="not resumable"):
            db.resume()
        assert len(db.versions.cf_current(0).files[0]) == 3
    finally:
        db._bg_error = None
        db.close()


def test_retryable_job_error_auto_recovers_on_the_same_executor(
        tmp_path, monkeypatch):
    """A retryable IO error out of a card job latches SOFT: writes go on,
    the auto-recover thread resumes and the job reruns on the same device
    executor (no host job), and the listener hears an automatic
    recovery."""
    import time

    import toplingdb_tpu_torch.ops.device_compaction as dc

    from toplingdb_tpu_torch.compaction.resilience import DcompactOptions

    real = dc.run_device_compaction
    calls = []
    policy = DcompactOptions(max_attempts=2)

    def flaky(*a, **k):
        # Every attempt of the first run fails (Options.dcompact's retries
        # run out, then the error latches); the rerun succeeds.
        calls.append(1)
        if len(calls) <= policy.max_attempts:
            raise status.IOError_("transient", retryable=True)
        return real(*a, **k)

    monkeypatch.setattr(dc, "run_device_compaction", flaky)
    recovered = []

    class L(EventListener):
        def on_error_recovery_completed(self, db, info):
            recovered.append((info.reason, info.auto))

    factory = DeviceCompactionExecutorFactory(device="cpu")
    d = str(tmp_path / "db")
    db = _port_open(d, protection_bytes_per_key=8, listeners=[L()],
                    level0_file_num_compaction_trigger=2, dcompact=policy,
                    compaction_executor_factory=factory)
    try:
        for r in range(2):
            for i in range(200):
                db.put(b"k%04d" % (i * 2 + r), b"v%d" % r)
            db.flush()
        deadline = time.time() + 20
        while not recovered and time.time() < deadline:
            db.put(b"after", b"ok")  # a SOFT latch does not block writes
            time.sleep(0.05)
        assert recovered == [("compaction", True)]
        db.wait_for_compactions()
        assert db._bg_error is None
        assert len(calls) == policy.max_attempts + 1
        assert len(factory.jobs) == 1
        assert db._compaction_scheduler.num_local_jobs == 0
        assert db.get(b"k0007") == b"v1" and db.get(b"after") == b"ok"
    finally:
        db.close()


# ---------------------------------------------------------------------------
# Read-side corruption injection (:369, :396)
# ---------------------------------------------------------------------------


def test_corrupt_read_is_deterministic_and_targeted(tmp_path):  # :369
    p_sst = str(tmp_path / "000001.sst")
    p_log = str(tmp_path / "000002.log")
    payload = bytes(range(256)) * 64
    for p in (p_sst, p_log):
        with open(p, "wb") as f:
            f.write(payload)
    got = []
    for fe in (FaultInjectionEnv(PosixEnv()),
               RefFaultInjectionEnv(RefPosixEnv())):
        fe.corrupt_reads(pattern="*.sst", rate=1e-2, seed=42)

        def read_all(path):
            f = fe.new_random_access_file(path)
            try:
                return f.read(0, len(payload))
            finally:
                f.close()

        a, b = read_all(p_sst), read_all(p_sst)
        assert a == b  # seeded: the same read corrupts identically
        assert a != payload
        assert fe.corruptions_injected
        assert read_all(p_log) == payload  # pattern-targeted
        fe.clear_corrupt_reads()
        assert read_all(p_sst) == payload  # disk was never touched
        got.append((a, list(fe.corruptions_injected)))
    assert got[0] == got[1]  # the same damage from the same seed


def test_corrupted_wal_reads_fail_recovery_not_serve_garbage(
        tmp_path, monkeypatch):                                      # :396
    import shutil

    msgs = []
    for name in ("port", "ref"):
        d = str(tmp_path / name)
        opener = (_port_open if name == "port"
                  else lambda p, **kw: _ref_open(p, monkeypatch, **kw))
        db = opener(d, protection_bytes_per_key=8)
        for i in range(2000):
            db.put(b"w%04d" % i, b"v%04d" % i * 8)
        db._wal.sync()
        # A crash: copy the live dir (the WAL holds every write) and
        # recover from the copy.
        crashed = str(tmp_path / (name + "-crashed"))
        shutil.copytree(d, crashed)
        db.close()
        if name == "port":
            fe = FaultInjectionEnv(PosixEnv())
            fe.corrupt_reads(pattern="*.log", rate=1e-3, seed=9)
            with pytest.raises(Exception) as ei:
                dbm.DB.open(crashed, Options(
                    protection_bytes_per_key=8,
                    compaction_executor_factory=(
                        DeviceCompactionExecutorFactory(device="cpu"))),
                    env=fe)
        else:
            fe = RefFaultInjectionEnv(RefPosixEnv())
            fe.corrupt_reads(pattern="*.log", rate=1e-3, seed=9)
            with pytest.raises(Exception) as ei:
                ref_dbm.DB.open(crashed, RefOptions(
                    protection_bytes_per_key=8), env=fe)
        assert fe.corruptions_injected  # the injector hit the WAL
        msgs.append((type(ei.value).__name__, str(ei.value)))
        # Uncorrupted recovery from the same image replays everything.
        db2 = opener(crashed, protection_bytes_per_key=8)
        try:
            assert db2.get(b"w0007") == b"v0007" * 8
            assert db2.get(b"w1999") == b"v1999" * 8
        finally:
            db2.close()
    assert msgs[0][0] == msgs[1][0] == "Corruption"


# ---------------------------------------------------------------------------
# The scan plane's protection bank (:610, a tampered chunk)
# ---------------------------------------------------------------------------


def test_scan_plane_emission_verification_catches_tampering(
        tmp_path, monkeypatch):                                      # :610
    """White-box: served bytes that re-hash to a checksum absent from the
    source-side bank raise at chunk emission and tick the mismatch
    counter; a banked row passes. Both packages alike."""
    out = []
    for name in ("port", "ref"):
        pkg_st = st if name == "port" else ref_st
        stats = pkg_st.Statistics()
        d = str(tmp_path / name)
        kw = dict(protection_bytes_per_key=8, write_buffer_size=16 * 1024,
                  statistics=stats)
        db = (_port_open(d, **kw) if name == "port"
              else _ref_open(d, monkeypatch, **kw))
        try:
            fill(db, 2000, seed=6)
            db.flush()
            it = db.new_iterator()
            plane = getattr(it, "_plane", None)
            assert plane is not None and plane._prot_bank is not None
            it.seek_to_first()
            n = 0
            while it.valid():
                n += 1
                it.next()
            assert n == 2000  # a clean protected chunked scan
            assert stats.tickers()[pkg_st.ITER_CHUNK_REFILLS] >= 1
            with pytest.raises(Exception, match="protection mismatch") as ei:
                plane._verify_emission(b"fabricated-key",
                                       b"fabricated-value")
            assert stats.tickers()[
                pkg_st.INTEGRITY_PROTECTION_MISMATCHES] == 1
            uk = b"k000000"
            plane._verify_emission(uk, db.get(uk))  # a banked row passes
            out.append((type(ei.value).__name__, str(ei.value), len(
                plane._prot_bank)))
        finally:
            db.close()
    assert out[0] == out[1]


TARGET = b"k000777"


def _flip_after_banking(orig):
    """_bank_rows, then one bit of TARGET's value flipped in the decoded
    buffer: memory corruption between the block decode and emission."""
    def bank_then_flip(bank, pb, kb, ko, kl, vb, vo, vl, start, n):
        orig(bank, pb, kb, ko, kl, vb, vo, vl, start, n)
        for i in range(start, n):
            o = int(ko[i])
            if kb[o:o + int(kl[i]) - 8].tobytes() == TARGET:
                vb[int(vo[i])] ^= 1
    return bank_then_flip


def test_tampered_scan_chunk_raises_at_the_same_key(tmp_path, monkeypatch):
    monkeypatch.setattr(sp, "_bank_rows", _flip_after_banking(sp._bank_rows))
    monkeypatch.setattr(ref_sp, "_bank_rows",
                        _flip_after_banking(ref_sp._bank_rows))
    out = []
    for name in ("port", "ref"):
        pkg_st = st if name == "port" else ref_st
        stats = pkg_st.Statistics()
        d = str(tmp_path / name)
        kw = dict(protection_bytes_per_key=8, statistics=stats,
                  disable_auto_compactions=True)
        db = (_port_open(d, iter_chunk_rows=256, **kw) if name == "port"
              else _ref_open(d, monkeypatch, iter_chunk_rows=256, **kw))
        try:
            fill(db, 2000, seed=7)
            db.flush()
            it = db.new_iterator()
            it.seek_to_first()
            served = []
            with pytest.raises(Exception) as ei:
                while it.valid():
                    served.append(it.key())
                    it.next()
            # Nothing at or after the tampered row was served.
            assert served and served[-1] < TARGET
            out.append((type(ei.value).__name__, str(ei.value),
                        stats.tickers()[
                            pkg_st.INTEGRITY_PROTECTION_MISMATCHES]))
        finally:
            db.close()
    assert out[0] == out[1]
    assert out[0][0] == "Corruption" and repr(TARGET) in out[0][1]


# ---------------------------------------------------------------------------
# Protection through the data planes (:569)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", ["pipeline", "iter_chunk"])
def test_protected_parity_with_data_planes(tmp_path, monkeypatch, plane):
    """Protection on, through the pipelined compaction plane or the
    chunked scan plane, gives the results of the unprotected run with the
    plane off, and of the reference's protected run with the plane on:
    the handoff checks are pure verification."""
    import functools

    import toplingdb_tpu.ops.pipeline as ref_pl

    import toplingdb_tpu_torch.ops.device_compaction as dc
    import toplingdb_tpu_torch.ops.pipeline as pl

    real = dc.run_device_compaction
    if plane == "pipeline":
        monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
        monkeypatch.setattr(ref_pl, "MIN_PIPELINE_ROWS", 256)
        monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "4")
        monkeypatch.setenv("TPULSM_PIPELINE", "1")

    def build(d, pb, on):
        factory = DeviceCompactionExecutorFactory(device="cpu")
        if plane == "pipeline":
            monkeypatch.setattr(dc, "run_device_compaction", functools.partial(
                real, pipeline=on, pipeline_shards=4))
        db = _port_open(d, protection_bytes_per_key=pb,
                        iter_chunk_rows=4096 if (on or plane == "pipeline")
                        else 0,
                        write_buffer_size=24 * 1024,
                        level0_file_num_compaction_trigger=3,
                        compaction_executor_factory=factory)
        rng = random.Random(5)
        for i in range(3000):
            db.put(b"p%05d" % rng.randrange(1200),
                   b"val%06d" % rng.randrange(10**6) * 4)
        db.flush()
        db.compact_range()
        return db, factory

    db_p, fp = build(str(tmp_path / "prot"), 8, True)
    db_o, _ = build(str(tmp_path / "off"), 0, False)
    ref = _ref_open(str(tmp_path / "ref"), monkeypatch,
                    protection_bytes_per_key=8, write_buffer_size=24 * 1024,
                    level0_file_num_compaction_trigger=3,
                    compaction_executor_factory=RefFactory(device="cpu-jax"))
    try:
        rng = random.Random(5)
        for i in range(3000):
            ref.put(b"p%05d" % rng.randrange(1200),
                    b"val%06d" % rng.randrange(10**6) * 4)
        ref.flush()
        ref.compact_range()
        got = dump(db_p)
        assert got == dump(db_o) == dump(ref)
        assert db_p.verify_file_checksums()["files_verified"] >= 1
        assert fp.jobs and all(j["rows"] for j in fp.jobs)
        if plane == "pipeline":
            assert any(j["pipelined"] for j in fp.jobs)
        else:
            assert db_p.new_iterator()._plane is not None
            assert db_o.new_iterator()._plane is None
    finally:
        for db in (db_p, db_o, ref):
            db.close()


# ---------------------------------------------------------------------------
# Protected DBs side by side
# ---------------------------------------------------------------------------


class ProtTwin(Twin):
    """Twin with protection 8 on both sides, each side's own Statistics,
    and the host planes switched alike: the port's by DB.open arguments,
    the reference's by its env knobs."""

    def __init__(self, root, executor, monkeypatch, native_planes, scan):
        self.mp = monkeypatch
        self.native_planes = native_planes
        self.scan = scan
        self.ref_stats = ref_st.Statistics()
        self.port_stats = st.Statistics()
        super().__init__(root, executor, byte_parity=True,
                         protection_bytes_per_key=8)

    def open(self):
        ro, po = self._options()
        ro.statistics, po.statistics = self.ref_stats, self.port_stats
        self.mp.setenv("TPULSM_WRITE_PLANE", "1" if self.native_planes
                       else "0")
        self.mp.setenv("TPULSM_ITER_CHUNK", "1" if self.scan else "0")
        self.ref = ref_dbm.DB.open(self.ref_dir, ro)
        self.port = dbm.DB.open(self.dir, po,
                                write_plane=self.native_planes,
                                iter_chunk_rows=4096 if self.scan else 0)

    def check(self, snap=None):
        out = super().check(snap)
        # Twin scans the port backward too; the reference's backward scan
        # here keeps the two sides' iterator tickers comparable.
        views = {cf: self._scan(self.ref, reverse=True, cf=self._h(cf)[0])
                 for cf in self.keys}
        assert views[None] == list(reversed(out))
        return out

    def check_protection(self):
        for h in self.port.list_column_families():
            r = self.ref.get_column_family(h.name)
            pm = self.port._cfs[h.id].mem.protection_map()
            rm = self.ref._cfs[r.id].mem.protection_map()
            assert pm is not None and pm == rm, h.name


def _random_ops(t, rng, n):
    for _ in range(n):
        r = rng.random()
        k = b"key%04d" % rng.randrange(400)
        v = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 60)))
        if r < 0.55:
            t.put(k, v)
        elif r < 0.65:
            t.delete(k)
        elif r < 0.7:
            a = rng.randrange(400)
            t.delete_range(b"key%04d" % a, b"key%04d" % (a + 5))
        elif r < 0.8:
            t.put(k, v, cf="meta")
        else:
            t.write([("put", b"key%04d" % rng.randrange(400), v),
                     ("delete", b"key%04d" % rng.randrange(400)),
                     ("put", k, v[::-1])])


@pytest.mark.parametrize("executor", ["device", "local"])
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "noscan"])
@pytest.mark.parametrize("native_planes", [True, False],
                         ids=["native", "python"])
def test_protected_twin_parity(tmp_path, pinned_clock, monkeypatch,
                               native_planes, scan, executor):
    """The same seeded ops through both DBs with protection 8: equal
    carried protection vectors before every flush; equal gets, scans,
    WAL, SST and MANIFEST bytes and level sets (Twin.check); equal
    tickers (both named "cpu" with the host path: ROADMAP §C); equal
    scrub reports; and after a reopen (WAL replay attaching protection)
    all of it again."""
    t = ProtTwin(str(tmp_path), executor, monkeypatch, native_planes, scan)
    try:
        t.create_cf("meta")
        rng = random.Random(1234)
        for rnd in range(3):
            _random_ops(t, rng, 150)
            t.check_protection()
            t.flush()
            t.check()
        _random_ops(t, rng, 100)
        t.check_protection()
        t.compact_range()
        t.check()
        reps = [_norm_report(t.port.scrub(), t.dir),
                _norm_report(t.ref.scrub(), t.ref_dir)]
        assert reps[0] == reps[1] and reps[0]["files_scanned"] >= 1
        assert not reps[0]["corruptions"]
        _random_ops(t, rng, 80)
        t.port._wal.sync()
        t.ref._wal.sync()
        t.reopen()
        t.check_protection()
        pt, rt = t.port_stats.tickers(), t.ref_stats.tickers()
        if executor == "local":
            skip = {st.WRITE_GROUP_FOLLOWERS, st.WRITE_DONE_BY_OTHER,
                    st.STALL_MICROS}
            diff = {k: (pt.get(k), rt.get(k)) for k in set(pt) | set(rt)
                    if k not in skip and pt.get(k, 0) != rt.get(k, 0)}
            assert not diff
        native_commits = pt.get(st.WRITE_GROUP_NATIVE_COMMITS, 0)
        assert (native_commits > 0) == native_planes
        assert pt.get(st.INTEGRITY_PROTECTION_MISMATCHES, 0) == 0
        assert (pt.get(st.ITER_CHUNK_REFILLS, 0) > 0) == scan
    finally:
        t.close()


# ---------------------------------------------------------------------------
# The corruption soak (:427, at a small size)
# ---------------------------------------------------------------------------


def test_corruption_soak_zero_wrong_bytes_and_twin_parity(tmp_path,
                                                          monkeypatch):
    """Concurrent reads and writes, flushes and card compactions (plain
    kernels) with seeded transient read-side bit flips over SST and blob
    reads, protection 8: every served read is right or an error, never
    silently wrong; after the faults clear, a reopen, a clean scrub and
    resume(), the DB equals an unfaulted twin and the reference DB fed the
    same ops."""
    rng = random.Random(1234)
    ops = []
    for i in range(1200):
        k = b"s%05d" % rng.randrange(500)
        if rng.random() < 0.12:
            ops.append(("del", k, None))
        else:
            ops.append(("put", k, b"V%07d." % rng.randrange(10**7) * 6))
    kw = dict(protection_bytes_per_key=8, write_buffer_size=24 * 1024,
              level0_file_num_compaction_trigger=3,
              enable_blob_files=True, min_blob_size=40)

    def build(dbdir, env=None):
        return dbm.DB.open(dbdir, Options(
            compaction_executor_factory=DeviceCompactionExecutorFactory(
                device="cpu"), **kw), env=env)

    fe = FaultInjectionEnv(PosixEnv())
    dbdir = str(tmp_path / "db")
    holder = {"db": build(dbdir, env=fe)}
    twin = build(str(tmp_path / "twin"))
    ref = _ref_open(str(tmp_path / "ref"), monkeypatch, **kw)
    model = {}
    wrong = []
    stop = threading.Event()
    gen = [0]  # recovery generation: reads racing a swap aren't "wrong"
    pending = {}

    def recover():
        try:
            holder["db"].resume()
            return
        except Exception:  # noqa: BLE001 - not resumable: reopen
            pass
        gen[0] += 1
        old = holder["db"]
        try:
            old._wal.sync()
        except Exception:  # noqa: BLE001
            pass
        try:
            old.close()
        except Exception:  # noqa: BLE001
            pass
        holder["db"] = build(dbdir, env=fe)

    def reader():
        r = random.Random(99)
        while not stop.is_set():
            k = b"s%05d" % r.randrange(500)
            g0 = gen[0]
            exp = model.get(k)
            p0 = pending.get(k)
            try:
                got = holder["db"].get(k)
            except Exception:  # noqa: BLE001 - detected or mid-recovery
                continue
            if (exp is not None and got is not None and got != exp
                    and got != model.get(k) and got != p0
                    and got != pending.get(k) and gen[0] == g0):
                wrong.append((k, got))

    t = threading.Thread(target=reader)
    t.start()
    try:
        for i, (op, k, v) in enumerate(ops):
            if op == "put":
                pending[k] = v
            for _attempt in range(10):
                try:
                    if op == "put":
                        holder["db"].put(k, v)
                    else:
                        holder["db"].delete(k)
                    break
                except Exception:  # noqa: BLE001
                    recover()
            else:
                raise AssertionError("op never recovered")
            for db in (twin, ref):
                if op == "put":
                    db.put(k, v)
                else:
                    db.delete(k)
            if op == "put":
                model[k] = v
                pending.pop(k, None)
            else:
                model.pop(k, None)
            if i == len(ops) // 3:
                fe.corrupt_reads(pattern="*.sst", rate=1e-4, seed=77,
                                 transient=True)
                fe.corrupt_reads(pattern="*.blob", rate=1e-4, seed=78,
                                 transient=True)
    finally:
        stop.set()
        t.join()
    assert not wrong, wrong[:3]  # ZERO corrupted bytes ever served
    assert fe.corruptions_injected  # the injector really fired
    fe.clear_corrupt_reads()
    recover()
    db = holder["db"]
    try:
        db.wait_for_compactions()
    except Exception:  # noqa: BLE001 - a latched read fault: resume below
        pass
    rep = db.scrub()
    assert not rep["corruptions"]  # the disk was never damaged
    try:
        db.resume()
    except Exception:  # noqa: BLE001
        pass
    twin.wait_for_compactions()
    assert dump(db) == dump(twin) == dump(ref)
    for d2 in (db, twin, ref):
        d2.close()
