"""Column families in the port's DB against toplingdb_tpu's, on the CPU
(the port's DeviceCompactionExecutorFactory(device="cpu") runs its kernels'
plain versions, the reference's factory device="cpu-jax"; the host
compaction path is the reference with no executor and the port with
LocalCompactionExecutorFactory).

- the scenarios of tests/test_column_families.py as cases of one
  parametrised test through tests/test_torch_db.py's Twin: isolation, an
  atomic batch across CFs, reopen after a flush and after a crash (WAL
  replay), per-CF iterators and their refresh, independent compaction
  (explicit, and on background flushes and compactions), drop, name
  reuse after a drop, an edit installed after its CF was dropped, and a
  double drop. Where
  flushes are explicit, every CF's SSTs are byte-identical by file number,
  the per-CF level sets equal and the WAL and MANIFEST bytes equal;
- seeded random sequences over up to four CFs (put, delete, merge,
  delete_range, mixed-CF batches, snapshots, flush, compact_range, create,
  drop, name reuse and reopen), with the device executors and with the
  host path, held to the same byte parity at every check;
- a DB with CFs made by the reference opened by the port, and the
  reverse;
- a compaction of a non-default CF through each package's in-process HTTP
  worker service on "cpu-jax": the SST bytes, by file number, equal the
  reference's, and every output's properties name the CF;
- a device job of a CF held in flight while the CF is dropped: on release
  it raises nothing, latches no background error, installs no edit, and
  no output of it is left after the next obsolete-file pass.

tests/test_column_families.py's checkpoint and read-only cases wait for
the port's checkpoint and read-only opens (ROADMAP A13 and A9).
`time.time()` is pinned in both packages' modules that stamp
creation_time. Tolerance: none.
"""

import os
import random
import threading
import time

import pytest
from test_torch_db import Twin, pinned_clock  # noqa: F401

import toplingdb_tpu.compaction.dcompact_service as ref_svc
import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.db.version_edit import VersionEdit as RefVersionEdit
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.utils.status import InvalidArgument as RefInvalidArgument

import toplingdb_tpu_torch.compaction.dcompact_service as svc_mod
import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.ops.device_compaction as dc
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.version_edit import VersionEdit
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.table.factory import open_table
from toplingdb_tpu_torch.utils.status import Corruption, InvalidArgument


def _crash(t):
    """Drop both handles without close() (no flush), as a killed process
    leaves them, then open both again."""
    for db in (t.ref, t.port):
        db._compaction_scheduler.shutdown()
        db._wal.sync()
        db._wal.close()
        db._closed = True
    t.open()


# ---------------------------------------------------------------------------
# The scenarios of tests/test_column_families.py (line numbers of that file)
# ---------------------------------------------------------------------------


def case_isolation(t):                                      # :17
    t.create_cf("users")
    t.create_cf("posts")
    t.put(b"k", b"default-v")
    t.put(b"k", b"users-v", cf="users")
    t.put(b"k", b"posts-v", cf="posts")
    assert t.get(b"k") == b"default-v"
    assert t.get(b"k", cf="users") == b"users-v"
    assert t.get(b"k", cf="posts") == b"posts-v"
    t.delete(b"k", cf="users")
    assert t.get(b"k", cf="users") is None
    assert t.get(b"k") == b"default-v"
    t.check()
    t.flush()
    t.check()


def case_atomic_batch(t):                                   # :32
    t.create_cf("a")
    t.write([("put", b"x", b"1"), ("put", b"y", b"2", "a"),
             ("delete", b"x", "a")])
    assert t.get(b"x") == b"1"
    assert t.get(b"y", cf="a") == b"2"
    assert t.get(b"x", cf="a") is None
    t.check()
    t.flush()
    t.compact_range()
    t.check()


def case_survive_reopen_with_flush_and_wal(t):              # :45
    t.create_cf("logs")
    for i in range(500):
        t.put(b"k%04d" % i, b"d%04d" % i)
        t.put(b"k%04d" % i, b"l%04d" % i, cf="logs")
    t.flush()
    t.put(b"wal-only", b"dv")
    t.put(b"wal-only", b"lv", cf="logs")
    _crash(t)
    assert t.get(b"k0100") == b"d0100"
    assert t.get(b"k0100", cf="logs") == b"l0100"
    assert t.get(b"wal-only") == b"dv"
    assert t.get(b"wal-only", cf="logs") == b"lv"
    t.check()


def case_iterators_are_per_cf(t):                           # :66
    t.create_cf("aux")
    t.put(b"d1", b"1")
    t.put(b"a1", b"2", cf="aux")
    assert [k for k, _ in Twin._scan(t.port)] == [b"d1"]
    aux = t.port.get_column_family("aux")
    assert [k for k, _ in Twin._scan(t.port, cf=aux)] == [b"a1"]
    # Iterator::Refresh rebinds to the CF's current state.
    its = [db.new_iterator(cf=h) for db, h in zip((t.ref, t.port),
                                                   t._h("aux"))]
    t.put(b"a2", b"3", cf="aux")
    t.flush()
    t.put(b"a0", b"4", cf="aux")
    t.put(b"d2", b"5")
    views = []
    for it in its:
        it.refresh()
        it.seek_to_first()
        views.append(list(it.entries()))
    assert views[1] == views[0] == [(b"a0", b"4"), (b"a1", b"2"),
                                    (b"a2", b"3")]
    t.check()


def case_compaction_independent(t):                         # :79
    t.create_cf("big")
    for i in range(4000):
        t.put(b"key%05d" % (i % 1000), b"v%07d" % i, cf="big")
    t.put(b"small", b"1")
    t.flush()
    t.compact_range()
    t.wait()
    assert t.get(b"small") == b"1"
    for k in range(0, 1000, 83):
        last = max(i for i in range(k, 4000, 1000))
        assert t.get(b"key%05d" % k, cf="big") == b"v%07d" % last
    big = t.port.get_column_family("big")
    vbig = t.port.versions.cf_current(big.id)
    assert sum(f.num_entries for _, f in vbig.all_files()) == 1000
    t.check()


def case_drop(t):                                           # :96
    t.create_cf("tmp")
    t.put(b"k", b"v", cf="tmp")
    t.flush()
    r, p = t._h("tmp")
    files = {db: [f.number for _, f in db.versions.cf_current(h.id)
                  .all_files()] for db, h in ((t.ref, r), (t.port, p))}
    assert files[t.port] == files[t.ref] and files[t.port]
    t.drop_cf("tmp")
    with pytest.raises(RefInvalidArgument):
        t.ref.get(b"k", cf=r)
    with pytest.raises(InvalidArgument):
        t.port.get(b"k", cf=p)
    with pytest.raises(InvalidArgument):
        t.port.new_iterator(cf=p)
    # The port's drop released its own read state: the files are gone.
    assert not [n for n in files[t.port]
                if os.path.exists(os.path.join(t.dir, "%06d.sst" % n))]
    t.reopen()
    assert t.port.get_column_family("tmp") is None
    assert t.ref.get_column_family("tmp") is None


def case_name_reuse_after_drop(t):                          # :107
    t.create_cf("c")
    c1 = t.port.get_column_family("c")
    t.put(b"k", b"old", cf="c")
    t.flush()
    t.drop_cf("c")
    t.create_cf("c")
    c2 = t.port.get_column_family("c")
    assert c2.id != c1.id
    assert t.get(b"k", cf="c") is None  # a fresh keyspace
    t.check()
    t.reopen()
    assert t.get(b"k", cf="c") is None


def case_inflight_edit_after_drop(t):                       # :150
    t.create_cf("aux")
    t.put(b"x", b"1", cf="aux")
    t.flush()
    cf_id = t.port.get_column_family("aux").id
    t.drop_cf("aux")
    # A job's install after the drop is discarded, not a KeyError.
    t.ref.versions.log_and_apply(RefVersionEdit(column_family=cf_id))
    t.port.versions.log_and_apply(VersionEdit(column_family=cf_id))
    t.put(b"ok", b"1")
    assert t.get(b"ok") == b"1"
    t.check()


def case_double_drop(t):                                    # :167
    t.create_cf("aux")
    cf_id = t.port.get_column_family("aux").id
    t.drop_cf("aux")
    with pytest.raises(RefInvalidArgument):
        t.ref.versions.drop_column_family(cf_id)
    with pytest.raises(InvalidArgument):
        t.port.versions.drop_column_family(cf_id)
    with pytest.raises(Corruption):
        t.port.versions.drop_column_family(0)
    t.check()


# (case, options, byte parity)
CASES = [
    (case_isolation, {}, True),
    (case_atomic_batch, {}, True),
    (case_survive_reopen_with_flush_and_wal, {}, True),
    (case_iterators_are_per_cf, {}, True),
    (case_compaction_independent, {}, True),
    (case_compaction_independent, {"write_buffer_size": 8 * 1024}, False),
    (case_drop, {}, True),
    (case_name_reuse_after_drop, {}, True),
    (case_inflight_edit_after_drop, {}, True),
    (case_double_drop, {}, True),
]


@pytest.mark.parametrize("executor", ["device", "cpu"])
@pytest.mark.parametrize(
    "case,kw,byte_parity", CASES,
    ids=[c[0].__name__[5:] + ("" if c[2] else "-auto") for c in CASES])
def test_cf_scenario(tmp_path, pinned_clock, case, kw,  # noqa: F811
                     byte_parity, executor):
    t = Twin(str(tmp_path), executor, byte_parity, **kw)
    try:
        case(t)
        t.check()
        t.reopen()
    finally:
        t.close()


# ---------------------------------------------------------------------------
# Seeded random multi-CF sequences
# ---------------------------------------------------------------------------


def _random_sequence(t, seed, n_ops):
    rng = random.Random(seed)
    live, dropped = [None], []
    made = 0
    snaps = []
    single = 0

    def key():
        return b"k%04d" % rng.randrange(150)

    def release():
        for pair in snaps:
            for s in pair:
                s.release()
        snaps.clear()

    for i in range(n_ops):
        r = rng.random()
        cf = rng.choice(live)
        if r < 0.30:
            t.put(key(), b"v%d-" % i * rng.randrange(1, 4), cf=cf)
        elif r < 0.38:
            t.delete(key(), cf=cf)
        elif r < 0.46:
            t.merge(key(), b"m%d" % i, cf=cf)
        elif r < 0.49:
            a = rng.randrange(145)
            t.delete_range(b"k%04d" % a, b"k%04d" % (a + rng.randrange(1, 6)),
                           cf=cf)
        elif r < 0.62:
            ops = []
            for _ in range(rng.randrange(2, 7)):
                c = rng.choice(live)
                tail = () if c is None else (c,)
                kind = rng.random()
                if kind < 0.5:
                    ops.append(("put", key(), b"b%d" % i) + tail)
                elif kind < 0.7:
                    ops.append(("delete", key()) + tail)
                elif kind < 0.9:
                    ops.append(("merge", key(), b"bm%d" % i) + tail)
                else:
                    # SingleDelete a key put once only.
                    sk = b"sd%05d" % single
                    single += 1
                    ops.append(("put", sk, b"once") + tail)
                    ops.append(("single_delete", sk) + tail)
            t.write(ops)
        elif r < 0.66:
            if len(live) < 4:
                if dropped and rng.random() < 0.5:
                    name = dropped.pop(rng.randrange(len(dropped)))
                else:
                    made += 1
                    name = "cf%d" % made
                t.create_cf(name)
                live.append(name)
        elif r < 0.68:
            if len(live) > 1:
                name = live.pop(rng.randrange(1, len(live)))
                t.drop_cf(name)
                dropped.append(name)
        elif r < 0.73:
            if len(snaps) < 3:
                snaps.append(t.snapshot())
            t.check(rng.choice(snaps))
        elif r < 0.82:
            t.flush()
        elif r < 0.86:
            t.compact_range()
        elif r < 0.88:
            release()
            t.reopen()
        else:
            t.check()
    t.check()
    release()
    t.flush()
    t.compact_range()
    t.check()
    t.reopen()


@pytest.mark.parametrize("executor", ["device", "cpu"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_multi_cf_sequence(tmp_path, pinned_clock,  # noqa: F811
                                  seed, executor):
    t = Twin(str(tmp_path), executor, True,
             merge_operator="StringAppendOperator")
    try:
        _random_sequence(t, seed, 260)
    finally:
        t.close()


# ---------------------------------------------------------------------------
# Interop: either package opens the other's DB with column families
# ---------------------------------------------------------------------------


def _fill_cfs(db, tag):
    """Three CFs besides the default one, one of them dropped, one with
    data only in the WAL; returns the expected views by CF name."""
    want = {}
    a = db.create_column_family("a")
    b = db.create_column_family("b")
    gone = db.create_column_family("gone")
    for name, h in (("default", None), ("a", a), ("b", b)):
        want[name] = {}
        for i in range(120):
            k, v = b"%s%04d" % (name.encode(), i), tag + b"%d" % i
            db.put(k, v, cf=h)
            want[name][k] = v
    db.put(b"g", b"x", cf=gone)
    db.flush()
    db.drop_column_family(gone)
    for i in range(0, 120, 7):
        k = b"a%04d" % i
        db.delete(k, cf=a)
        del want["a"][k]
    db.put(b"wal-only", tag, cf=b)
    want["b"][b"wal-only"] = tag
    return want


def _views(db):
    return {h.name: dict(Twin._scan(db, cf=h))
            for h in db.list_column_families()}


@pytest.mark.parametrize("maker", ["ref", "port"])
def test_cf_db_opens_in_the_other_package(tmp_path, maker):
    path = str(tmp_path / "db")
    pkgs = {"ref": (ref_dbm.DB, RefOptions, {}),
            "port": (dbm.DB, Options, {"compaction_executor_factory":
                                       LocalCompactionExecutorFactory()})}
    other = "port" if maker == "ref" else "ref"
    DB, Opts, extra = pkgs[maker]
    db = DB.open(path, Opts(**extra))
    want = _fill_cfs(db, maker.encode())
    db._wal.sync()  # the WAL-only write survives the crash below
    db._compaction_scheduler.shutdown()
    db._wal.close()
    db._closed = True
    DB, Opts, extra = pkgs[other]
    with DB.open(path, Opts(**extra)) as db:
        assert [h.name for h in db.list_column_families()] == \
            ["default", "a", "b"]
        assert _views(db) == want
        assert db.get(b"a0001", cf=db.get_column_family("a")) == \
            maker.encode() + b"1"
        c = db.create_column_family("c")
        db.put(b"c-key", b"c", cf=c)
        want["c"] = {b"c-key": b"c"}
        db.compact_range()
    DB, Opts, extra = pkgs[maker]
    with DB.open(path, Opts(**extra)) as db:
        assert _views(db) == want


# ---------------------------------------------------------------------------
# A non-default CF's job through the HTTP transport
# ---------------------------------------------------------------------------


def _remote_cf_db(path, factory, DB, Opts):
    """Writes to CF "aux" (and a little to the default CF), explicit
    flushes, then compact_range: one remote L0->L1 job per CF. Returns
    aux's live SSTs by file number and its level files."""
    db = DB.open(path, Opts(write_buffer_size=1 << 20,
                            disable_auto_compactions=True,
                            compaction_executor_factory=factory))
    try:
        aux = db.create_column_family("aux")
        for i in range(1200):
            db.put(b"mk%05d" % (i % 400), b"mv%07d" % i, cf=aux)
            if i % 300 == 299:
                db.put(b"d%d" % i, b"x")
                db.flush()
        db.compact_range()
        assert db._bg_error is None
        assert db.get(b"mk00399", cf=aux) == b"mv%07d" % 1199
        v = db.versions.cf_current(aux.id)
        levels = [[(f.number, f.smallest, f.largest) for f in lvl]
                  for lvl in v.files]
        ssts = {f.number: open(os.path.join(path, "%06d.sst" % f.number),
                               "rb").read()
                for lvl in v.files for f in lvl}
        return aux.id, levels, ssts
    finally:
        db.close()


def test_remote_job_of_a_cf_over_http_matches_reference(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    ref = ref_svc.DcompactWorkerService(device="cpu-jax")
    port = svc_mod.DcompactWorkerService(device="cpu-jax")
    try:
        want = _remote_cf_db(
            str(tmp_path / "ref"), ref_svc.HttpCompactionExecutorFactory(
                [f"http://127.0.0.1:{ref.start()}"], device="cpu-jax",
                allow_fallback=False), ref_dbm.DB, RefOptions)
        got = _remote_cf_db(
            str(tmp_path / "port"), svc_mod.HttpCompactionExecutorFactory(
                [f"http://127.0.0.1:{port.start()}"], device="cpu-jax"),
            dbm.DB, Options)
    finally:
        ref.stop()
        port.stop()
    assert port.jobs_done >= 1 and port.jobs_failed == 0
    assert got == want
    cf_id, levels, ssts = got
    assert cf_id == 1 and not levels[0] and sum(map(bool, levels)) == 1
    env = PosixEnv()
    for number in ssts:
        path = os.path.join(str(tmp_path / "port"), "%06d.sst" % number)
        props = open_table(env.new_random_access_file(path),
                           InternalKeyComparator()).properties
        assert (props.column_family_id, props.column_family_name) == \
            (1, "aux")


# ---------------------------------------------------------------------------
# A CF dropped while its device job is in flight
# ---------------------------------------------------------------------------


def test_drop_with_a_device_job_in_flight(tmp_path, monkeypatch):
    entered, release = threading.Event(), threading.Event()
    real = dc.run_device_compaction
    held = []

    def hook(*a, **k):
        if k["column_family"][1] == "aux":
            held.append(k["column_family"])
            entered.set()
            assert release.wait(60)
        return real(*a, **k)

    monkeypatch.setattr(dc, "run_device_compaction", hook)
    factory = DeviceCompactionExecutorFactory(device="cpu")
    path = str(tmp_path / "db")
    db = dbm.DB.open(path, Options(
        write_buffer_size=1 << 20, level0_file_num_compaction_trigger=2,
        compaction_executor_factory=factory))
    try:
        aux = db.create_column_family("aux")
        before = db.versions.manifest_file_number
        for r in range(2):
            for i in range(300):
                db.put(b"k%05d" % (i * 2 + r), b"v%d" % r, cf=aux)
            db.flush()
        assert entered.wait(60), "no device job of aux started"
        inputs = [f.number for _, f in
                  db.versions.cf_current(aux.id).all_files()]
        manifest = os.path.join(path, "MANIFEST-%06d" % before)
        size = os.path.getsize(manifest)
        db.drop_column_family(aux)
        size_after_drop = os.path.getsize(manifest)
        assert size_after_drop > size  # the drop record
        release.set()
        db.wait_for_compactions()  # raises on a latched error
        assert db._bg_error is None
        assert db._compaction_scheduler.last_error is None
        assert held == [(aux.id, "aux")]
        assert len(factory.jobs) == 1 and factory.jobs[0]["cf_id"] == aux.id
        # No edit was installed: the MANIFEST holds nothing past the drop.
        assert os.path.getsize(manifest) == size_after_drop
        db.put(b"after", b"1")
        db.flush()  # the next obsolete-file pass
        live = {f.number for _, f in db.versions.current.all_files()}
        left = sorted(int(n[:-4]) for n in os.listdir(path)
                      if n.endswith(".sst"))
        assert left == sorted(live), (left, inputs)
        assert db.get(b"after") == b"1"
    finally:
        release.set()
        db.close()
    with dbm.DB.open(path, Options(
            compaction_executor_factory=factory)) as db:
        assert [h.name for h in db.list_column_families()] == ["default"]
