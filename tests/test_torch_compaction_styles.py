"""The universal and FIFO compaction styles and the periodic trigger of
toplingdb_tpu_torch's DB against toplingdb_tpu's, on the CPU:

- picker parity on random versions: the universal and FIFO pickers give
  the same scores and pick the same files, reasons, output levels,
  `bottommost` and output size cap as the reference's, with busy files
  and with up to 14 runs in L0;
- an unknown style raises InvalidArgument in both packages, and each
  field of the styles and of the periodic trigger opens the port's DB;
- the reference's scenarios (tests/test_compaction.py:128, 143 and 340:
  universal correctness, FIFO drops the oldest files, FIFO TTL under a
  moved clock), the periodic marking (:362), a manual universal
  compaction into the last level, the size-amplification trigger, a
  universal merge of 12 runs on the device route (its shard program runs
  the merge's plain version over 16 runs, 4 of them empty), and the L0
  order after a universal output that must sort behind a newer run
  (db/version_set.py:214-219), each through both DBs in
  tests/test_torch_db.py's `Twin` with the device executor ("cpu"
  against "cpu-jax") and the host path: views, and where flushes are
  explicit the SST, WAL and MANIFEST bytes and the level sets;
- seeded random op sequences in universal and FIFO DBs, with bytes;
- the files a background job makes obsolete leave the disk once the job
  is done (the port's scheduler sweeps again after it releases the
  job's Version).

Compactions run in the background here; a byte-parity case waits for
both DBs after every flush, so both pick from the same versions.
Tolerance: none.
"""

import dataclasses
import json
import os
import random
import time

import pytest
from test_torch_db import Twin, pinned_clock  # noqa: F401

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.compaction import picker as ref_picker
from toplingdb_tpu.db import dbformat as ref_dbf
from toplingdb_tpu.db import version_edit as ref_ve
from toplingdb_tpu.db import version_set as ref_vs
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.utils.status import InvalidArgument as RefInvalidArgument

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch import options as popts
from toplingdb_tpu_torch.compaction import picker
from toplingdb_tpu_torch.compaction.executor import (
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db import dbformat, version_edit, version_set
from toplingdb_tpu_torch.ops import compaction_kernels as ck
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils.status import InvalidArgument

NOW = 1_700_000_000


# ---------------------------------------------------------------------------
# The pickers on random versions
# ---------------------------------------------------------------------------


def _meta_pair(**kw):
    return ref_ve.FileMetaData(**kw), version_edit.FileMetaData(**kw)


def _random_versions(rng, n_runs, n_base, mid_level):
    """The same Version in both packages: n_runs L0 runs (newest first,
    overlapping keys), n_base files in the last level, and with
    `mid_level` one file at L3; sizes drawn so that size-ratio runs and
    size-amplification both happen; ~15% of the files busy."""
    rv = ref_vs.Version(ref_dbf.InternalKeyComparator(), 7)
    pv = version_set.Version(dbformat.InternalKeyComparator(), 7)
    n, seq = 1, 1

    def add(level, a, b, size):
        nonlocal n, seq
        r, p = _meta_pair(number=n, file_size=size,
                          smallest=b"%06d" % a + bytes(8),
                          largest=b"%06d" % b + bytes(8),
                          smallest_seqno=seq, largest_seqno=seq + 9)
        if rng.random() < 0.15:
            r.being_compacted = p.being_compacted = True
        rv.files[level].append(r)
        pv.files[level].append(p)
        n += 1
        seq += 10

    lo = 0
    for _ in range(n_base):
        hi = lo + rng.randrange(50, 300)
        add(6, lo, hi, rng.randrange(1, 64) << 20)
        lo = hi + 1
    if mid_level:
        add(3, rng.randrange(0, 500), rng.randrange(500, 1000),
            rng.randrange(1, 16) << 20)
    base = rng.choice([1 << 20, 4 << 20, 16 << 20])
    for _ in range(n_runs):  # oldest first
        size = base + rng.randrange(0, base // 2) if rng.random() < 0.7 \
            else rng.randrange(1, 80) << 20
        add(0, rng.randrange(0, 500), rng.randrange(500, 1000), size)
    rv.files[0].reverse()
    pv.files[0].reverse()
    return rv, pv


def _shape(c):
    if c is None:
        return None
    return (c.level, c.output_level, [f.number for f in c.inputs],
            [f.number for f in c.output_level_inputs], c.bottommost,
            c.reason, c.max_output_file_size)


def _pickers(**kw):
    return (ref_picker.create_picker(RefOptions(**kw),
                                     ref_dbf.InternalKeyComparator()),
            picker.create_picker(Options(**kw),
                                 dbformat.InternalKeyComparator()))


@pytest.mark.parametrize("seed", range(8))
def test_universal_picker_picks_the_same(seed):
    rng = random.Random(seed)
    reasons = set()
    for _ in range(60):
        kw = dict(
            compaction_style="universal",
            level0_file_num_compaction_trigger=rng.choice([2, 3, 4, 8]),
            universal_size_ratio=rng.choice([0, 1, 10, 50]),
            universal_min_merge_width=rng.choice([2, 3]),
            universal_max_merge_width=rng.choice([2, 4, 2**31 - 1]),
            universal_max_size_amplification_percent=rng.choice(
                [25, 100, 200]))
        rp, pp = _pickers(**kw)
        assert isinstance(pp, picker.UniversalCompactionPicker)
        rv, pv = _random_versions(rng, rng.randrange(0, 15),
                                  rng.choice([0, 0, 1, 3]),
                                  rng.random() < 0.2)
        assert pp.compaction_score(pv) == rp.compaction_score(rv)
        rc, pc = rp.pick_compaction(rv), pp.pick_compaction(pv)
        assert _shape(pc) == _shape(rc), kw
        if pc is not None:
            reasons.add(pc.reason)
    assert reasons, "no pick at all"


@pytest.mark.parametrize("seed", range(8))
def test_fifo_picker_picks_the_same(seed, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: float(NOW))
    rng = random.Random(100 + seed)
    reasons = set()
    for _ in range(60):
        kw = dict(compaction_style="fifo",
                  fifo_max_table_files_size=rng.choice([8, 40, 200]) << 20,
                  fifo_ttl_seconds=rng.choice([0, 100, 1000]))
        rp, pp = _pickers(**kw)
        assert isinstance(pp, picker.FIFOCompactionPicker)
        rv, pv = _random_versions(rng, rng.randrange(0, 15), 0, False)
        ages = {f.number: rng.choice([None, 0, 50, 500, 5000])
                for f in pv.files[0]}

        def ct(f):
            a = ages[f.number]
            return None if a is None else NOW - a

        rp.creation_time_fn = pp.creation_time_fn = ct
        assert pp.compaction_score(pv) == rp.compaction_score(rv)
        rc, pc = rp.pick_compaction(rv), pp.pick_compaction(pv)
        assert _shape(pc) == _shape(rc), kw
        if pc is not None:
            reasons.add(pc.reason)
    assert reasons, "no pick at all"


def test_unknown_style_raises_invalid_argument(tmp_path):
    for side, opts_cls, err, db_mod in (
            ("ref", RefOptions, RefInvalidArgument, ref_dbm),
            ("port", Options, InvalidArgument, dbm)):
        kw = dict(compaction_style="tiered")
        if side == "port":
            kw["compaction_executor_factory"] = \
                LocalCompactionExecutorFactory()
        with pytest.raises(err, match="tiered"):
            db_mod.DB.open(str(tmp_path / side), opts_cls(**kw))
    with pytest.raises(InvalidArgument):
        picker.create_picker(Options(compaction_style="tiered"),
                             dbformat.InternalKeyComparator())


# Each field of the styles and the periodic trigger, set away from its
# default (with the style that reads it), opens the port's DB.
NOW_OPEN = {
    "universal_size_ratio": dict(compaction_style="universal",
                                 universal_size_ratio=10),
    "universal_min_merge_width": dict(compaction_style="universal",
                                      universal_min_merge_width=3),
    "universal_max_merge_width": dict(compaction_style="universal",
                                      universal_max_merge_width=8),
    "universal_max_size_amplification_percent": dict(
        compaction_style="universal",
        universal_max_size_amplification_percent=50),
    "fifo_max_table_files_size": dict(compaction_style="fifo",
                                      fifo_max_table_files_size=1 << 20),
    "fifo_ttl_seconds": dict(compaction_style="fifo", fifo_ttl_seconds=60),
    "periodic_compaction_seconds": dict(periodic_compaction_seconds=3600),
}


@pytest.mark.parametrize("name", sorted(NOW_OPEN))
def test_ported_option_opens(tmp_path, name):
    assert name not in popts.UNPORTED
    opts = Options(compaction_executor_factory=(
        LocalCompactionExecutorFactory()), **NOW_OPEN[name])
    assert popts.unported_fields(opts) == []
    with dbm.DB.open(str(tmp_path / "db"), opts) as db:
        for i in range(3):
            db.put(b"k%d" % i, b"v%d" % i)
            db.flush()
        db.wait_for_compactions()
        assert db.get(b"k1") == b"v1"
        assert db._compaction_scheduler.last_error is None


# ---------------------------------------------------------------------------
# Scenarios through both DBs
# ---------------------------------------------------------------------------


def _levels(db):
    return [[f.number for f in fl] for fl in db.versions.current.files]


def _jobs(t):
    """The rewriting jobs both closed DBs logged (`compaction_finished`
    events of <db>/LOG): level pair, reason, input and output records;
    equal on both sides."""
    out = []
    for d in (t.dir, t.ref_dir):
        with open(os.path.join(d, "LOG")) as f:
            ev = [json.loads(line) for line in f]
        out.append([(e["input_level"], e["output_level"], e["reason"],
                     e["input_records"], e["output_records"])
                    for e in ev if e["event"] == "compaction_finished"])
    assert out[0] == out[1]
    return out[0]


def case_universal_correctness(t):                         # :128
    for round_ in range(6):
        for i in range(300):
            t.put(b"key%04d" % i, b"r%d" % round_)
        t.flush()
    t.wait()
    for i in range(0, 300, 7):
        assert t.get(b"key%04d" % i) == b"r5"
    assert len(t.check()) == 300
    assert _levels(t.port) == _levels(t.ref)


def case_universal_manual_into_last_level(t):
    for round_ in range(3):
        for i in range(round_, 400, 2):
            t.put(b"key%04d" % i, b"m%d-%d" % (round_, i))
        t.delete(b"key%04d" % (round_ * 10))
        t.flush()
    t.check()
    t.compact_range()
    t.check()
    levels = _levels(t.port)
    assert not levels[0] and len(levels[-1]) == 1, levels
    assert not any(levels[1:-1]), levels


def case_universal_size_amp(t):
    for i in range(300):
        t.put(b"key%04d" % i, b"base%d" % i)
    t.flush()
    t.compact_range()  # the base run in the last level
    for round_ in range(4):  # younger runs: 4x the base, over 200%
        for i in range(round_, 300, 1):
            t.put(b"key%04d" % i, b"y%d-%d" % (round_, i))
        t.flush()
    t.wait()
    levels = _levels(t.port)
    assert not levels[0] and len(levels[-1]) == 1, levels
    t.check()


def case_universal_l0_order_after_output(t):
    """Three small old runs merge (size ratio) into one L0 output with a
    new file number but old seqnos; the newer big run must stay first."""
    for round_ in range(3):
        for i in range(100):
            t.put(b"key%04d" % i, b"old%d" % round_)
        t.flush()
    for i in range(2000):
        t.put(b"key%04d" % i, b"new%d" % i)
    t.flush()  # the fourth run triggers the job
    t.wait()
    l0 = t.port.versions.current.files[0]
    assert len(l0) == 2, _levels(t.port)
    newest, merged = l0
    assert merged.number > newest.number
    assert newest.largest_seqno > merged.largest_seqno
    assert [f.number for f in l0] == [
        f.number for f in t.ref.versions.current.files[0]]
    assert t.get(b"key0005") == b"new5"
    t.check()


def case_fifo_drops_oldest_explicit(t):
    for round_ in range(10):
        for i in range(400):
            t.put(b"key%06d" % (round_ * 400 + i), b"x" * 40)
        t.flush()
    t.wait()
    v = t.port.versions.current
    assert v.total_bytes(0) <= 40 * 1024
    assert t.get(b"key%06d" % 3999) == b"x" * 40
    assert t.get(b"key%06d" % 0) is None
    t.check()


# (case, options, the reasons of its rewriting jobs, in order)
CASES = [
    (case_universal_correctness,
     dict(compaction_style="universal",
          level0_file_num_compaction_trigger=3),
     ["universal size-ratio"] * 2),
    (case_universal_manual_into_last_level,
     dict(compaction_style="universal",
          level0_file_num_compaction_trigger=8),
     ["manual universal"]),
    (case_universal_size_amp,
     dict(compaction_style="universal",
          level0_file_num_compaction_trigger=4),
     ["manual universal", "universal size-amp"]),
    (case_universal_l0_order_after_output,
     dict(compaction_style="universal",
          level0_file_num_compaction_trigger=4),
     ["universal size-ratio"]),
    (case_fifo_drops_oldest_explicit,
     dict(compaction_style="fifo", fifo_max_table_files_size=40 * 1024),
     []),
]


@pytest.mark.parametrize("executor", ["device", "cpu"])
@pytest.mark.parametrize("case,kw,reasons", CASES,
                         ids=[c[0].__name__[5:] for c in CASES])
def test_style_scenario(tmp_path, pinned_clock, case, kw,  # noqa: F811
                        reasons, executor):
    t = Twin(str(tmp_path), executor, True, auto=True, **kw)
    try:
        case(t)
        t.check()
        if executor == "device":
            jobs = t.port.options.compaction_executor_factory.jobs
            assert [j["reason"] for j in jobs] == reasons
        t.close()  # the event logs are complete once closed
        assert [j[2] for j in _jobs(t)] == reasons
        t.open()
        t.check()
    finally:
        t.close()


@pytest.mark.parametrize("executor", ["device", "cpu"])
def test_fifo_drops_oldest_on_memory_flushes(tmp_path, pinned_clock,  # noqa: F811
                                             executor):
    """tests/test_compaction.py:143 as written: flushes on memory use of
    an 8 KiB write buffer (the vector rep, whose accounting does not
    depend on the process's history), auto compactions on: the views."""
    t = Twin(str(tmp_path), executor, False, compaction_style="fifo",
             fifo_max_table_files_size=40 * 1024,
             write_buffer_size=8 * 1024, memtable_rep="vector")
    try:
        for i in range(4000):
            t.put(b"key%06d" % i, b"x" * 40)
        t.flush()
        t.wait()
        assert t.port.versions.current.total_bytes(0) <= 60 * 1024
        assert t.get(b"key%06d" % 3999) is not None
        t.check()
        assert _levels(t.port) == _levels(t.ref)
    finally:
        t.close()


@pytest.mark.parametrize("style", ["fifo", "universal", "leveled"])
def test_a_jobs_obsolete_files_leave_with_its_own_sweep(tmp_path, style):
    """The files a background job makes obsolete leave the disk once the
    job is done: the scheduler sweeps again after it releases the Version
    the job was picked from. (toplingdb_tpu's scheduler sweeps only while
    that Version is held, so the last FIFO drop's file stays on disk until
    the next flush or job.)"""
    kw = dict(fifo=dict(fifo_max_table_files_size=40 * 1024),
              universal=dict(level0_file_num_compaction_trigger=3),
              leveled=dict(level0_file_num_compaction_trigger=3))[style]
    opts = Options(compaction_style=style, compaction_executor_factory=(
        LocalCompactionExecutorFactory()), **kw)
    with dbm.DB.open(str(tmp_path / "db"), opts) as db:
        for r in range(10):
            for i in range(400):
                db.put(b"key%06d" % (r * 400 + i), b"x" * 40)
            db.flush()
            db.wait_for_compactions()
            live = sorted(f.number for _, f in db.versions.current.all_files())
            on_disk = sorted(int(n[:6]) for n in os.listdir(db.dbname)
                             if n.endswith(".sst"))
            assert on_disk == live, (r, on_disk, live)
        assert db._compaction_scheduler.num_completed > 0


class _Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


@pytest.fixture
def moving_clock(monkeypatch):
    """time.time() of every module of both packages, set by the test."""
    clock = _Clock(1_000_000.0)
    monkeypatch.setattr(time, "time", clock)
    return clock


def _schedule(t):
    for db in (t.ref, t.port):
        db.options.disable_auto_compactions = False
        db._maybe_schedule_compaction()
    t.wait()


@pytest.mark.parametrize("executor", ["device", "cpu"])
def test_fifo_ttl_drops_old_files(tmp_path, moving_clock, executor):
    """tests/test_compaction.py:340: a file older than fifo_ttl_seconds is
    dropped under the size budget."""
    t = Twin(str(tmp_path), executor, True, compaction_style="fifo",
             fifo_ttl_seconds=100, fifo_max_table_files_size=1 << 30)
    try:
        for i in range(100):
            t.put(b"old%03d" % i, b"v")
        t.flush()
        moving_clock.now += 200  # the first file expires
        for i in range(100):
            t.put(b"new%03d" % i, b"v")
        t.flush()
        _schedule(t)
        assert t.get(b"old050") is None, "expired file kept"
        assert t.get(b"new050") == b"v"
        assert len(t.port.versions.current.files[0]) == 1
        t.check()
    finally:
        t.close()


@pytest.mark.parametrize("executor", ["device", "cpu"])
def test_periodic_compaction_rewrites_old_files(tmp_path, moving_clock,
                                                executor):
    """tests/test_compaction.py:362: an aged file is marked and rewritten
    (a fresh creation_time) without data loss, and not picked again."""
    t = Twin(str(tmp_path), executor, True, periodic_compaction_seconds=500,
             level0_file_num_compaction_trigger=100)
    try:
        for i in range(200):
            t.put(b"k%03d" % i, b"v%03d" % i)
        t.flush()
        before = {f.number for _, f in t.port.versions.current.all_files()}
        moving_clock.now += 1000  # age past the threshold
        _schedule(t)
        after = {f.number for _, f in t.port.versions.current.all_files()}
        assert after and after != before, "aged file never rewritten"
        assert t.get(b"k100") == b"v100"
        sched = t.port._compaction_scheduler
        n = sched.num_completed
        assert n == t.ref._compaction_scheduler.num_completed >= 1
        t.port._maybe_schedule_compaction()
        t.port.wait_for_compactions()
        assert sched.num_completed - n <= 1, "periodic rewrite loop"
        t.check()
    finally:
        t.close()


@pytest.mark.parametrize("executor", ["device", "cpu"])
def test_periodic_marking_leaves_other_styles_alone(tmp_path, moving_clock,
                                                    executor):
    """The periodic trigger marks files of a leveled DB only."""
    t = Twin(str(tmp_path), executor, True, compaction_style="universal",
             periodic_compaction_seconds=500,
             level0_file_num_compaction_trigger=100)
    try:
        for i in range(50):
            t.put(b"k%03d" % i, b"v")
        t.flush()
        moving_clock.now += 1000
        _schedule(t)
        for db in (t.port, t.ref):
            assert not any(f.marked_for_compaction
                           for _, f in db.versions.current.all_files())
        assert t.port._compaction_scheduler.num_completed == 0
        t.check()
    finally:
        t.close()


def test_universal_merge_of_12_runs_on_the_device_route(tmp_path,
                                                       pinned_clock,  # noqa: F811
                                                       monkeypatch):
    """Twelve L0 runs merged in one universal job on the device executor:
    the shard program runs the merge (its plain version here) over the
    runs padded to 16, and the bytes equal the reference's."""
    runs = []
    real = ck.shard_merge_mode

    def merge_on_cpu(h):
        runs.append((h["n_chunks"], h["run_starts"].shape[0] - 1))
        return "merge" if real(h) == "sort" else real(h)

    monkeypatch.setattr(ck, "shard_merge_mode", merge_on_cpu)
    t = Twin(str(tmp_path), "device", True, auto=True,
             compaction_style="universal",
             level0_file_num_compaction_trigger=12)
    try:
        rng = random.Random(12)
        for round_ in range(12):
            for _ in range(150):
                t.put(b"key%05d" % rng.randrange(1000), b"r%d" % round_)
            t.delete(b"key%05d" % rng.randrange(1000))
            t.flush()
        jobs = t.port.options.compaction_executor_factory.jobs
        assert [(j["input_files"], j["reason"]) for j in jobs] == [
            (12, "universal size-ratio")], jobs
        assert (12, 16) in runs, runs
        assert len(t.port.versions.current.files[0]) == 1
        t.check()
    finally:
        t.close()


# ---------------------------------------------------------------------------
# Random op sequences
# ---------------------------------------------------------------------------


def _random_sequence(t, seed):
    rng = random.Random(seed)
    snaps = []
    for step in range(14):
        for _ in range(rng.randrange(20, 200)):
            k = b"k%04d" % rng.randrange(600)
            r = rng.random()
            if r < 0.8:
                t.put(k, b"v%d-" % step * rng.randrange(1, 6))
            elif r < 0.95:
                t.delete(k)
            else:
                a = rng.randrange(600)
                t.delete_range(b"k%04d" % a, b"k%04d" % (a + 5))
        if rng.random() < 0.2:
            snaps.append(t.snapshot())
        t.flush()
        if rng.random() < 0.15:
            t.compact_range()
    t.check()
    for s in snaps:
        t.check(snap=s)


@pytest.mark.parametrize("executor", ["device", "cpu"])
@pytest.mark.parametrize("style,kw", [
    ("universal", dict(level0_file_num_compaction_trigger=3)),
    ("universal", dict(level0_file_num_compaction_trigger=4,
                       universal_size_ratio=20,
                       universal_max_merge_width=3,
                       universal_max_size_amplification_percent=50)),
    ("fifo", dict(fifo_max_table_files_size=24 * 1024)),
], ids=["universal", "universal-tuned", "fifo"])
@pytest.mark.parametrize("seed", range(2))
def test_random_sequence(tmp_path, pinned_clock, style, kw,  # noqa: F811
                         seed, executor):
    t = Twin(str(tmp_path), executor, True, auto=True,
             compaction_style=style, **kw)
    try:
        _random_sequence(t, seed)
        t.reopen()
    finally:
        t.close()


def test_style_options_have_the_reference_defaults():
    ref, port = RefOptions(), Options()
    for f in dataclasses.fields(Options):
        if f.name.startswith(("universal_", "fifo_")) or f.name in (
                "compaction_style", "periodic_compaction_seconds"):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
