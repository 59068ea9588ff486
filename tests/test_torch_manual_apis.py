"""The DB's manual and introspection entry points of toplingdb_tpu_torch
against toplingdb_tpu's, on the CPU.

- every case of tests/test_manual_compaction_apis.py that touches the DB
  (:26, :42, :69, :80, :94) and the cases of tests/test_db.py at :167,
  :597, :612, :633, :667, :684, :700, :733 and :846, as cases of one
  parametrised test: each scenario runs once on each package, asserts
  what the reference's test asserts, and the two packages' observations
  (values, properties, sizes, level sets, file lists, errors) must be
  equal. The port's jobs run on DeviceCompactionExecutorFactory("cpu"),
  the reference's on its host path;
- write_stall_state (tests/test_sharding.py:223, :263), the thread-status
  registry (tests/test_utilities.py:1443) and latest_sequence_number,
  key_exists and flush_wal the same way;
- get_approximate_sizes on every table format: equal sizes (plain and
  cuckoo answer through SingleFastTableReader in both packages);
- Twin byte parity (tests/test_torch_db.py) of compact_files,
  suggest_compact_range with the pick that follows set_options(
  {"disable_auto_compactions": False}), promote_l0 and
  delete_files_in_range: SSTs, MANIFEST, WALs and level sets equal, both
  DBs' jobs on device executors named "cpu";
- the port's own rules: set_options refuses a field still in
  options.UNPORTED, compact_files runs in the caller's thread with its
  spans and listeners, and a failed job raises, latches the background
  error and leaves no output.

Tolerance: none.
"""

import json
import os
import shutil
import threading
import time

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.table.builder import TableOptions as RefTO
from toplingdb_tpu.utils import merge_operator as ref_mo
from toplingdb_tpu.utils import slice_transform as ref_stf
from toplingdb_tpu.utils import statistics as ref_st
from toplingdb_tpu.utils import status as ref_status
from toplingdb_tpu.utils import thread_status as ref_thread_status
from toplingdb_tpu.utils.config import load_latest_options

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.table.builder import TableOptions
from toplingdb_tpu_torch.utils import merge_operator as mo
from toplingdb_tpu_torch.utils import slice_transform as stf
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils import status
from toplingdb_tpu_torch.utils.listener import EventListener
from toplingdb_tpu_torch.utils import thread_status
from toplingdb_tpu_torch.utils.config import (
    load_latest_options as port_load_latest_options,
)

from test_torch_db import Twin, pinned_clock  # noqa: F401


class Side:
    """One package's names, so a scenario is written once and run on
    both."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.Options = RefOptions if ref else Options
        self.ReadOptions = RefReadOptions if ref else ReadOptions
        self.TableOptions = RefTO if ref else TableOptions
        self.mo = ref_mo if ref else mo
        self.stf = ref_stf if ref else stf
        self.st = ref_st if ref else st
        self.status = ref_status if ref else status
        self.thread_status = ref_thread_status if ref else thread_status

    def options(self, **kw):
        """Options with the port's jobs on its device executor on "cpu"
        (the reference's default host path on its side)."""
        if not self.ref:
            kw.setdefault("compaction_executor_factory",
                          DeviceCompactionExecutorFactory(device="cpu"))
        return self.Options(**kw)

    def opts(self, **kw):
        """tests/test_db.py's opts(): a 32 KiB write buffer; here with the
        vector rep, whose memory accounting, and so the flush cut points,
        does not depend on the process's history (the skiplist's random
        heights do), so both packages' files hold the same keys."""
        kw.setdefault("write_buffer_size", 32 * 1024)
        kw.setdefault("memtable_rep", "vector")
        return self.options(**kw)


def _levels(db, cf_id=0):
    return [[(f.number, f.smallest, f.largest, f.num_entries)
             for f in fl] for fl in db.versions.cf_current(cf_id).files]


def _raises(fn, exc):
    with pytest.raises(exc) as ei:
        fn()
    return type(ei.value).__name__


# ---------------------------------------------------------------------------
# tests/test_manual_compaction_apis.py
# ---------------------------------------------------------------------------


def _db_with_l0_files(s, path, n_files=3, overlap=True):
    db = s.DB.open(path, s.options(
        level0_file_num_compaction_trigger=100))  # no auto compaction
    for i in range(n_files):
        lo = 0 if overlap else i * 100
        for j in range(lo, lo + 100):
            db.put(b"key%06d" % j, b"f%d-%d" % (i, j))
        db.flush()
    return db


def sc_compact_files(s, path, obs):                                # :26
    db = _db_with_l0_files(s, path)
    version = db.versions.cf_current(0)
    nums = [f.number for f in version.files[0]]
    assert len(nums) == 3
    db.compact_files(nums, output_level=2)
    version = db.versions.cf_current(0)
    assert not version.files[0]
    assert version.files[2]
    for j in range(100):
        assert db.get(b"key%06d" % j) == b"f2-%d" % j  # newest file wins
    obs.append(_levels(db))
    obs.append(_raises(lambda: db.compact_files([999999], output_level=2),
                       s.status.InvalidArgument))
    db.close()


def sc_compact_files_level_validation(s, path, obs):               # :42
    db = _db_with_l0_files(s, path)
    version = db.versions.cf_current(0)
    nums = [f.number for f in version.files[0]]  # newest-first
    # The OLDEST L0 file alone moves by itself.
    db.compact_files(nums[-1:], output_level=1)
    version = db.versions.cf_current(0)
    assert len(version.files[0]) == 2 and len(version.files[1]) == 1
    obs.append(_levels(db))
    # The NEWEST remaining L0 file: the older L0 file and the overlapping
    # L1 file are auto-included.
    db.compact_files([version.files[0][0].number], output_level=1)
    version = db.versions.cf_current(0)
    assert not version.files[0] and version.files[1]
    for j in range(100):
        assert db.get(b"key%06d" % j) == b"f2-%d" % j
    obs.append(_levels(db))
    obs.append(_raises(lambda: db.compact_files(
        [version.files[1][0].number], output_level=0),
        s.status.InvalidArgument))  # compacting upward is rejected
    db.close()


def sc_suggest_compact_range(s, path, obs):                        # :69
    db = _db_with_l0_files(s, path, overlap=False)
    marked = db.suggest_compact_range(b"key000150", b"key000250")
    version = db.versions.cf_current(0)
    flagged = [f.number for _, f in version.all_files()
               if f.marked_for_compaction]
    assert marked == len(flagged) and 1 <= marked <= 2
    assert db.suggest_compact_range(b"key000150", b"key000250") == 0
    obs.append((marked, flagged))
    db.close()


def sc_promote_l0(s, path, obs):                                   # :80
    db = _db_with_l0_files(s, path, overlap=False)  # disjoint L0 files
    db.promote_l0(target_level=2)
    version = db.versions.cf_current(0)
    assert not version.files[0] and len(version.files[2]) == 3
    for j in range(250, 260):
        assert db.get(b"key%06d" % j) == b"f2-%d" % j
    obs.append(_levels(db))
    db.close()
    # Survives reopen: the metadata-only move went through the MANIFEST.
    db = s.DB.open(path, s.options())
    assert db.get(b"key000000") == b"f0-0"
    obs.append(_levels(db))
    db.close()


def sc_promote_l0_rejects_overlap(s, path, obs):                   # :94
    db = _db_with_l0_files(s, path, overlap=True)
    obs.append(_raises(db.promote_l0, s.status.InvalidArgument))
    db.close()


# ---------------------------------------------------------------------------
# tests/test_db.py
# ---------------------------------------------------------------------------


def sc_get_property(s, path, obs):                                 # :167
    with s.DB.open(path, s.opts()) as db:
        db.put(b"a", b"1")
        db.flush()
        assert "L0: 1 files" in db.get_property("tpulsm.stats")
        assert db.get_property("tpulsm.num-files-at-level0") == "1"
        obs.append([db.get_property(n) for n in (
            "tpulsm.stats", "tpulsm.levelstats", "tpulsm.num-files",
            "tpulsm.num-files-at-level0", "tpulsm.num-files-at-level9",
            "tpulsm.num-files-at-levelx", "tpulsm.bg-error-severity",
            "tpulsm.no-such-property")])


def sc_get_approximate_sizes(s, path, obs):                        # :597
    with s.DB.open(path, s.opts(disable_auto_compactions=True)) as db:
        for i in range(3000):
            db.put(b"key%05d" % i, b"v" * 64)
        db.flush()
        sizes = db.get_approximate_sizes(
            [(b"key00000", b"key03000"), (b"key01000", b"key01100"),
             (b"zz", b"zzz")]
        )
        assert sizes[0] > sizes[1] > 0
        assert sizes[2] == 0
        total = sum(f.file_size for _, f in db.versions.current.all_files())
        assert sizes[0] <= total * 1.2
        obs.append(sizes)


def sc_delete_files_in_range(s, path, obs):                        # :612
    with s.DB.open(path, s.opts(write_buffer_size=8 * 1024,
                                target_file_size_base=16 * 1024,
                                disable_auto_compactions=True)) as db:
        for i in range(4000):
            db.put(b"key%05d" % i, b"x" * 40)
        db.flush()
        db.compact_range()  # push everything to L1+ (multiple files)
        v = db.versions.current
        n_before = v.num_files()
        assert n_before > 2
        dropped = db.delete_files_in_range(b"key00500", b"key03500")
        assert dropped > 0
        assert db.get(b"key00000") is not None
        assert db.get(b"key03999") is not None
        assert db.versions.current.num_files() == n_before - dropped
        obs.append((n_before, dropped, db.get(b"key02000")))
    with s.DB.open(path, s.opts()) as db:
        assert db.get(b"key00000") is not None
        obs.append(sorted(n for n in os.listdir(path) if n.endswith(".sst")))


def sc_pause_continue_background_work(s, path, obs):               # :633
    with s.DB.open(path, s.opts(write_buffer_size=4 * 1024,
                                level0_file_num_compaction_trigger=2)) as db:
        db.pause_background_work()
        for i in range(600):
            db.put(b"key%05d" % i, b"x" * 30)
        n_l0 = len(db.versions.current.files[0])
        assert n_l0 >= 2, "L0 should pile up while paused"
        state = db.write_stall_state()
        assert state["drainable"] is False and state["state"] == "none"
        db.continue_background_work()
        db.wait_for_compactions()
        assert db.get(b"key00001") == b"x" * 30
        obs.append((state["drainable"], db.write_stall_state()["drainable"],
                    db.get(b"key00599")))


def sc_extended_properties(s, path, obs):                          # :667
    with s.DB.open(path, s.opts(disable_auto_compactions=True)) as db:
        for i in range(200):
            db.put(b"k%04d" % i, b"v")
        db.flush()
        for i in range(100, 300):
            db.put(b"k%04d" % i, b"v")
        snap = db.get_snapshot()
        assert int(db.get_property("tpulsm.estimate-num-keys")) >= 200
        assert int(db.get_property("tpulsm.cur-size-all-mem-tables")) > 0
        assert db.get_property("tpulsm.num-snapshots") == "1"
        assert int(db.get_property("tpulsm.estimate-live-data-size")) > 0
        assert db.get_property("tpulsm.background-errors") == "0"
        assert db.get_property("tpulsm.num-running-compactions") == "0"
        obs.append([db.get_property(n) for n in (
            "tpulsm.estimate-num-keys", "tpulsm.num-snapshots",
            "tpulsm.estimate-live-data-size", "tpulsm.background-errors",
            "tpulsm.num-running-compactions")])
        snap.release()
        obs.append(db.get_property("tpulsm.num-snapshots"))


def sc_get_merge_operands(s, path, obs):                           # :684
    with s.DB.open(path, s.opts(
            merge_operator=s.mo.StringAppendOperator())) as db:
        db.put(b"k", b"base")
        db.merge(b"k", b"a")
        db.flush()
        db.merge(b"k", b"b")
        assert db.get_merge_operands(b"k") == [b"base", b"a", b"b"]
        assert db.get(b"k") == b"base,a,b"
        db.put(b"plain", b"v")
        assert db.get_merge_operands(b"plain") == [b"v"]
        assert db.get_merge_operands(b"missing") == []
        db.delete(b"k")
        db.merge(b"k", b"after")
        assert db.get_merge_operands(b"k") == [b"after"]
        obs.append([db.get_merge_operands(k) for k in (b"k", b"plain")])


def sc_get_merge_operands_snapshot_and_zeroed(s, path, obs):       # :700
    with s.DB.open(path, s.opts(merge_operator=s.mo.StringAppendOperator(),
                                disable_auto_compactions=True)) as db:
        db.put(b"k", b"base")
        db.merge(b"k", b"a")
        snap = db.get_snapshot()
        db.delete_range(b"a", b"z")
        db.flush()
        assert db.get_merge_operands(b"k") == []  # covered now
        assert db.get_merge_operands(
            b"k", s.ReadOptions(snapshot=snap)) == [b"base", b"a"]
        snap.release()
        # A seqno-zeroed value after a bottommost compaction stays visible.
        db.put(b"z2", b"zv")
        db.compact_range()
        assert db.get_merge_operands(b"z2") == [b"zv"]
        obs.append(_levels(db))


def _options_read_back(s, path):
    """The values of the newest OPTIONS file, as each package reads it
    back through its own utils/config.py (both write toplingdb_tpu's
    format)."""
    load = load_latest_options if s.ref else port_load_latest_options
    loaded = load(path)
    return loaded.write_buffer_size, loaded.disable_auto_compactions


def sc_set_options_dynamic(s, path, obs):                          # :733
    with s.DB.open(path, s.opts()) as db:
        db.set_options({"write_buffer_size": 999_999,
                        "disable_auto_compactions": True})
        assert db.options.write_buffer_size == 999_999
        obs.append(_raises(lambda: db.set_options({"num_levels": 3}),
                           s.status.InvalidArgument))  # immutable
        obs.append(_raises(lambda: db.set_options({"no_such_option": 1}),
                           s.status.InvalidArgument))
        obs.append(_raises(lambda: db.set_options(
            {"max_subcompactions": "2"}), s.status.InvalidArgument))
        assert _options_read_back(s, path) == (999_999, True)
        n_opts = [f for f in os.listdir(path) if f.startswith("OPTIONS-")]
        assert len(n_opts) == 1, "old OPTIONS file not rolled"
        obs.append(n_opts)
        db.set_options({"write_buffer_size": 4 * 1024,
                        "disable_auto_compactions": False,
                        "level0_file_num_compaction_trigger": 2})
        for i in range(800):
            db.put(b"key%05d" % i, b"x" * 30)
        db.wait_for_compactions()
        # The new values are read live: memtables switch at 4 KiB and
        # compactions run again.
        assert db.versions.current.num_files() > 0
        assert not db.versions.current.files[0] or \
            len(db.versions.current.files[0]) < 8
        obs.append(_options_read_back(s, path))
        obs.append(len([f for f in os.listdir(path)
                        if f.startswith("OPTIONS-")]))


def sc_get_live_files_and_wal_files(s, path, obs):                 # :846
    with s.DB.open(path, s.opts(enable_blob_files=True, min_blob_size=64,
                                disable_auto_compactions=True)) as db:
        for i in range(300):
            db.put(b"k%04d" % i, b"V" * (100 if i % 3 else 10))
        db.disable_file_deletions()
        try:
            files, manifest_size = db.get_live_files()
            wals = db.get_sorted_wal_files()
            assert any(f.endswith(".sst") for f in files)
            assert any(f.endswith(".blob") for f in files)
            assert "CURRENT" in files
            assert manifest_size > 0
            obs.append((files, manifest_size, wals))
            dst = path + "_copy"
            os.makedirs(dst)
            for f in files + wals:
                shutil.copy2(os.path.join(path, f), os.path.join(dst, f))
                if f.startswith("MANIFEST-"):
                    # Truncate at the snapshot point.
                    with open(os.path.join(dst, f), "r+b") as mf:
                        mf.truncate(manifest_size)
        finally:
            db.enable_file_deletions()
    with s.DB.open(dst, s.opts(enable_blob_files=True,
                               min_blob_size=64)) as db2:
        assert db2.get(b"k0100") == b"V" * 100
        assert db2.get(b"k0000") == b"V" * 10
        obs.append(_levels(db2))


# ---------------------------------------------------------------------------
# The rest of the slice's entry points
# ---------------------------------------------------------------------------


def sc_write_stall_state(s, path, obs):           # test_sharding.py:223
    stats = s.st.Statistics()
    with s.DB.open(path, s.opts(
            statistics=stats, level0_slowdown_writes_trigger=1,
            level0_stop_writes_trigger=100,
            level0_file_num_compaction_trigger=64)) as db:
        assert db.write_stall_state()["state"] == "none"
        db.put(b"a", b"1")
        db.flush()
        db.put(b"b", b"2")
        db.flush()
        state = db.write_stall_state()
        assert state["state"] == "delayed" and state["l0_files"] >= 1
        assert state["drainable"] is True
        db.put(b"c", b"3")  # rides the delay ramp
        assert stats.get_ticker_count(s.st.STALL_MICROS) > 0
        assert stats.get_ticker_count(s.st.WRITE_STALL_COUNT) >= 1
        assert stats.get_histogram(s.st.WRITE_STALL_MICROS_HIST).count >= 1
        after = db.write_stall_state()
        assert after["stalls"] >= 1 and after["last_state"] == "delayed"
        keep = ("state", "l0_files", "drainable", "slowdown_trigger",
                "stop_trigger", "stalls", "last_state")
        obs.append([{k: x[k] for k in keep} for x in (state, after)])


def sc_stall_state_not_drainable(s, path, obs):   # test_sharding.py:263
    with s.DB.open(path, s.opts(disable_auto_compactions=True,
                                level0_slowdown_writes_trigger=1)) as db:
        db.put(b"a", b"1")
        db.flush()
        db.put(b"b", b"2")
        db.flush()
        state = db.write_stall_state()
        assert state["drainable"] is False and state["state"] == "none"
        obs.append(sorted(state.items()))


def sc_sequence_key_exists_flush_wal(s, path, obs):
    with s.DB.open(path, s.opts()) as db:
        obs.append(db.latest_sequence_number())
        db.put(b"a", b"1")
        db.delete(b"b")
        db.put(b"c", b"3")
        obs.append(db.latest_sequence_number())
        obs.append([db.key_exists(k) for k in (b"a", b"b", b"c", b"d")])
        db.flush_wal()
        db.flush_wal(sync=True)
        wal = max(n for n in os.listdir(path) if n.endswith(".log"))
        obs.append(os.path.getsize(os.path.join(path, wal)))
    with s.DB.open(path, s.opts()) as db:
        obs.append(db.latest_sequence_number())


def sc_thread_status(s, path, obs):              # test_utilities.py:1443
    with s.DB.open(path, s.opts(disable_auto_compactions=True)) as db:
        for i in range(300):
            db.put(b"k%03d" % i, b"v")
        db.flush()
        db.put(b"k999", b"v")
        seen = []
        stamp = db._stamp_file_checksums

        def spy(metas):  # runs inside the flush and the job
            seen.append([(r["operation"], r["stage"], r["db"] == path)
                         for r in s.thread_status.get_thread_list()
                         if r["thread_id"] == threading.get_ident()])
            return stamp(metas)

        db._stamp_file_checksums = spy
        db.compact_range()

        def strip(rows):
            return [{k: v for k, v in r.items() if k != "elapsed_s"}
                    for r in rows]

        assert strip(json.loads(db.get_property("tpulsm.threads"))) == \
            strip(s.thread_status.get_thread_list())
        obs.append(seen)


SCENARIOS = [
    sc_compact_files, sc_compact_files_level_validation,
    sc_suggest_compact_range, sc_promote_l0, sc_promote_l0_rejects_overlap,
    sc_get_property, sc_get_approximate_sizes, sc_delete_files_in_range,
    sc_pause_continue_background_work, sc_extended_properties,
    sc_get_merge_operands, sc_get_merge_operands_snapshot_and_zeroed,
    sc_set_options_dynamic, sc_get_live_files_and_wal_files,
    sc_write_stall_state, sc_stall_state_not_drainable,
    sc_sequence_key_exists_flush_wal, sc_thread_status,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_entry_point_against_reference(tmp_path, pinned_clock,  # noqa: F811
                                       scenario):
    seen = {}
    for name in ("ref", "port"):
        obs = []
        scenario(Side(name == "ref"), str(tmp_path / name), obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]


FORMATS = ["block", "single_fast", "plain", "cuckoo", "zip"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_approximate_sizes_every_format(tmp_path, fmt):
    """get_approximate_sizes over each table format: equal sizes from both
    packages (plain and cuckoo tables answer through their
    SingleFastTableReader base in both)."""
    got = {}
    for name in ("ref", "port"):
        s = Side(name == "ref")
        kw = dict(table_options=s.TableOptions(format=fmt),
                  disable_auto_compactions=True)
        if fmt == "plain":
            kw["prefix_extractor"] = s.stf.FixedPrefixTransform(3)
        with s.DB.open(str(tmp_path / name), s.opts(**kw)) as db:
            for i in range(600):
                db.put(b"key%05d" % i, b"v" * 24)
            db.flush()
            got[name] = db.get_approximate_sizes(
                [(b"key00000", b"key00600"), (b"key00100", b"key00150"),
                 (b"key00590", b"zz"), (b"a", b"b")])
    assert got["port"] == got["ref"]
    assert got["port"][3] == 0
    if fmt != "zip":  # zip tables place offsets by value groups
        assert got["port"][0] > got["port"][1] > 0


# ---------------------------------------------------------------------------
# Byte parity (Twin)
# ---------------------------------------------------------------------------


def _both(t, method, *args, **kw):
    r = getattr(t.ref, method)(*args, **kw)
    p = getattr(t.port, method)(*args, **kw)
    assert p == r, (method, p, r)
    return p


def _fill(t, lo, hi, tag, step=1):
    for i in range(lo, hi, step):
        t.put(b"key%06d" % i, b"%s-%06d" % (tag, i) + b"x" * 24)


def case_compact_files(t):
    for r in range(4):
        _fill(t, r * 300, r * 300 + 900, b"r%d" % r, step=2 + r % 2)
        t.flush()
    t.check()
    l0 = [f.number for f in t.port.versions.current.files[0]]
    _both(t, "compact_files", l0[2:3], 1)  # pulls in the oldest file too
    t.check()
    _both(t, "compact_files", l0[:1], 1)   # the rest of L0 and L1's files
    t.check()
    l1 = [f.number for f in t.port.versions.current.files[1]]
    assert len(l1) >= 3, l1
    _both(t, "compact_files", l1[1:3], 3)  # a subset of L1 into L3
    t.check()
    _fill(t, 100, 700, b"late", step=3)
    t.flush()
    l0 = [f.number for f in t.port.versions.current.files[0]]
    l1 = [f.number for f in t.port.versions.current.files[1]]
    _both(t, "compact_files", l0 + l1[:1], 1)
    t.check()
    reasons = [j["reason"] for j in
               t.port.options.compaction_executor_factory.jobs]
    assert reasons and set(reasons) == {"compact_files"}, reasons


def case_suggest_then_pick(t):
    for r in range(3):
        _fill(t, r * 500, r * 500 + 1500, b"r%d" % r, step=3)
        t.flush()
    t.compact_range()
    _fill(t, 0, 1500, b"top", step=7)
    t.flush()
    t.check()
    jobs = t.port.options.compaction_executor_factory.jobs
    n0 = len(jobs)
    assert _both(t, "suggest_compact_range", b"key000500",
                 b"key001000") > 0
    t.check()  # marking alone runs nothing with auto compactions off
    assert len(jobs) == n0
    _both(t, "set_options", {"disable_auto_compactions": False})
    t.wait()
    t.check()
    assert "bottommost marked" in [j["reason"] for j in jobs[n0:]], jobs
    assert not any(f.marked_for_compaction for _, f in
                   t.port.versions.current.all_files())


def case_promote_l0(t):
    for r in range(5):
        _fill(t, r * 200, r * 200 + 200, b"r%d" % r)
        t.flush()
    _both(t, "promote_l0", 2)
    t.check()
    _fill(t, 50, 450, b"over", step=4)
    t.flush()
    t.compact_range()
    t.check()


def case_delete_files_in_range(t):
    _fill(t, 0, 3000, b"a")
    t.flush()
    t.compact_range()
    t.delete_range(b"key000600", b"key002400")
    assert _both(t, "delete_files_in_range", b"key000600",
                 b"key002400") > 0
    t.check()
    t.flush()
    t.compact_range()
    t.check()


TWIN_CASES = [
    (case_compact_files, dict(target_file_size_base=16 * 1024)),
    (case_suggest_then_pick, dict(target_file_size_base=16 * 1024,
                                  max_background_jobs=1)),
    (case_promote_l0, {}),
    (case_delete_files_in_range, dict(target_file_size_base=16 * 1024)),
]


@pytest.mark.parametrize("case,kw", TWIN_CASES,
                         ids=[c[0].__name__[5:] for c in TWIN_CASES])
def test_byte_parity(tmp_path, pinned_clock, case, kw):  # noqa: F811
    t = Twin(str(tmp_path), "device", True, **kw)
    try:
        case(t)
        t.reopen()
    finally:
        t.close()


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------


def test_set_options_refuses_unported_field(tmp_path):
    """No mutable option of toplingdb_tpu's set is unported any more:
    seqno_time_sample_period_sec, the last one, is accepted and applied
    (the next write after the new period samples the mapping) and
    persisted to a fresh OPTIONS file."""
    with dbm.DB.open(str(tmp_path / "db"), Side(False).opts()) as db:
        db.put(b"a", b"1")
        assert len(db.seqno_to_time) == 1  # the first write samples
        before = sorted(n for n in os.listdir(db.dbname)
                        if n.startswith("OPTIONS-"))
        db.set_options({"seqno_time_sample_period_sec": 5,
                        "write_buffer_size": 1 << 16})
        assert db.options.seqno_time_sample_period_sec == 5
        assert db.options.write_buffer_size == 1 << 16
        after = sorted(n for n in os.listdir(db.dbname)
                       if n.startswith("OPTIONS-"))
        assert after != before and len(after) == 1
        with open(os.path.join(db.dbname, after[0])) as f:
            assert json.load(f)["seqno_time_sample_period_sec"] == 5
        db._last_seqno_time_sample = time.time() - 6
        db.put(b"b", b"2")
        assert len(db.seqno_to_time) == 2
        db.set_options({"seqno_time_sample_period_sec": 0})
        db._last_seqno_time_sample = 0.0
        db.put(b"c", b"3")  # period 0: manual only
        assert len(db.seqno_to_time) == 2


class _Recorder(EventListener):
    def __init__(self):
        self.jobs = []

    def on_compaction_completed(self, db, info):
        self.jobs.append((info.reason, info.device, threading.get_ident()))


def test_compact_files_in_callers_thread(tmp_path):
    """compact_files runs the job in the caller's thread, with its
    listener call, its statistics and its span, and clears being_compacted
    after it."""
    stats = st.Statistics()
    rec = _Recorder()
    s = Side(False)
    db = _db_with_l0_files(s, str(tmp_path / "db"))
    db.close()
    with dbm.DB.open(str(tmp_path / "db"), s.options(
            statistics=stats, listeners=[rec], trace_sample_every=1,
            level0_file_num_compaction_trigger=100)) as db:
        nums = [f.number for f in db.versions.current.files[0]]
        db.compact_files(nums, 1)
        assert rec.jobs == [("compact_files", "cpu", threading.get_ident())]
        assert stats.get_ticker_count(st.COMPACT_WRITE_BYTES) > 0
        assert any(tr.name == "compaction" for tr in db.tracer.finished())
        assert not any(f.being_compacted
                       for _, f in db.versions.current.all_files())
        assert all(r["thread_id"] != threading.get_ident()
                   for r in thread_status.get_thread_list())


def test_compact_files_failed_job(tmp_path, monkeypatch):
    """A failed device job raises to compact_files' caller, latches the
    background error and leaves no output file."""
    from toplingdb_tpu_torch.ops import device_compaction

    s = Side(False)
    db = _db_with_l0_files(s, str(tmp_path / "db"))
    ssts = sorted(n for n in os.listdir(db.dbname) if n.endswith(".sst"))

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(device_compaction, "run_device_compaction", boom)
    nums = [f.number for f in db.versions.current.files[0]]
    with pytest.raises(RuntimeError, match="injected"):
        db.compact_files(nums, 1)
    assert db._bg_error is not None
    assert db._compaction_scheduler.last_error is not None
    assert db.get_property("tpulsm.background-errors") == "1"
    assert sorted(n for n in os.listdir(db.dbname)
                  if n.endswith(".sst")) == ssts
    assert not any(f.being_compacted
                   for _, f in db.versions.current.all_files())
    assert [f.number for f in db.versions.current.files[0]] == nums
    db.close()
