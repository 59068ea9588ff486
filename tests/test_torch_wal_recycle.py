"""WAL recycling (`recycle_log_file_num`) and WAL archiving
(`wal_ttl_seconds`) in toplingdb_tpu_torch's DB against toplingdb_tpu's,
on the CPU.

- tests/test_wal_recycle.py:15, :41 and :66 run on each package, with
  what the reference's test asserts and the observations of both
  packages equal (:91 needs `ldb`, which the port does not have yet);
- recycled WAL bytes: the same writes through both DBs with
  recycle_log_file_num=2 and explicit flushes, in the default, pipelined
  and pipelined + async WAL write modes: every .log file on disk (live,
  pooled and reused, each with the stale tail of its previous life) is
  byte-identical, the SSTs, MANIFEST and views are (Twin.check), as many
  files were reused on each side, and a crash's recovery reads the
  recycled WALs to the same views;
- a DB whose WALs either package recycled, dropped without a flush,
  recovers in the other package to the writes' oracle;
- every env wrapper of the port passes reuse_writable_file and
  get_file_mtime through.

Tolerance: none.
"""

import os
import random
import shutil

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.db import log as ref_log
from toplingdb_tpu.env import default_env as ref_env
from toplingdb_tpu.options import Options as RefOptions

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db import log
from toplingdb_tpu_torch.env import default_env
from toplingdb_tpu_torch.env.fault_injection import (
    DelayedReadEnv,
    FaultInjectionEnv,
)
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils.file_checksum import (
    ChecksumTapEnv,
    factory_for,
)

from test_torch_db import Twin, pinned_clock  # noqa: F401


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.log = ref_log if ref else log
        self.env = ref_env() if ref else default_env()

    def options(self, **kw):
        if self.ref:
            return RefOptions(**kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)


def _wal_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".log"))


def sc_recycled_wal_reused_and_recovery_clean(s, d, obs):         # :15
    opts = s.options(create_if_missing=True, write_buffer_size=4 * 1024,
                     recycle_log_file_num=2)
    with s.DB.open(d, opts) as db:
        # Several memtable switches: several WAL generations; obsolete
        # ones enter the recycle pool instead of being deleted.
        for i in range(4000):
            db.put(b"key%05d" % i, b"val%06d" % i)
        db.flush()
        pool = list(db._recycle_wals)
        assert pool, "no WALs were recycled"
        assert len(pool) <= 2
        # Write more: a pooled file gets REUSED (its number leaves the
        # pool, its bytes are overwritten in place).
        for i in range(4000, 5000):
            db.put(b"key%05d" % i, b"val%06d" % i)
        reused = [n for n in pool if n not in db._recycle_wals]
        assert reused, "no pooled WAL was reused"
        obs.append((bool(pool), bool(reused)))
    # Recovery: the reused WAL's stale tail reads as the end of the log.
    with s.DB.open(d, opts) as db2:
        for i in range(0, 5000, 97):
            assert db2.get(b"key%05d" % i) == b"val%06d" % i
        it = db2.new_iterator()
        it.seek_to_first()
        n = sum(1 for _ in it.entries())
        assert n == 5000
        obs.append(n)


def sc_recycled_stale_tail_longer_than_new_life(s, d, obs):       # :41
    os.makedirs(d)
    env = s.env
    p1 = os.path.join(d, "000007.log")
    lw = s.log.LogWriter(env.new_writable_file(p1), log_number=7,
                         recycled=True)
    for i in range(2000):  # several 32 KiB blocks: the stale tail spans
        lw.add_record(b"old-record-%04d" % i * 10)  # block boundaries
    lw.close()
    p2 = os.path.join(d, "000009.log")
    w2 = env.reuse_writable_file(p1, p2)
    lw2 = s.log.LogWriter(w2, log_number=9, recycled=True)
    lw2.add_record(b"new-a")
    lw2.add_record(b"new-b")
    lw2.flush()
    lw2.close()
    assert not os.path.exists(p1)
    r = s.log.LogReader(env.new_sequential_file(p2), log_number=9)
    recs = list(r.records())
    assert recs == [b"new-a", b"new-b"]
    obs.append(recs)
    with open(p2, "rb") as f:
        obs.append(f.read())  # the new life over the old one's tail


def sc_wal_archival_and_ttl(s, d, obs):                           # :66
    opts = s.options(create_if_missing=True, write_buffer_size=4 * 1024,
                     wal_ttl_seconds=3600.0)
    with s.DB.open(d, opts) as db:
        for i in range(4000):
            db.put(b"key%05d" % i, b"v%05d" % i)
        db.flush()
        arch = os.path.join(d, "archive")
        assert os.path.isdir(arch) and os.listdir(arch), "no archived WALs"
        files = db.get_wal_files()
        assert any(a for _n, _p, a in files), "archived WALs not listed"
        assert any(not a for _n, _p, a in files), "live WAL not listed"
        assert [p for _n, p, a in files if a] == sorted(
            os.path.join(arch, f) for f in os.listdir(arch))
        obs.append(all(n == int(os.path.basename(p)[:-4])
                       for n, p, _a in files))
        # Age the archived files past the TTL: the next archival purges
        # them.
        aged = os.listdir(arch)
        for f in aged:
            os.utime(os.path.join(arch, f), (1, 1))
        for i in range(4000, 9000):
            db.put(b"key%05d" % i, b"v%05d" % i)
        db.flush()
        old = [f for f in os.listdir(arch)
               if os.path.getmtime(os.path.join(arch, f)) < 1000]
        assert not old, "TTL-expired archived WALs survived"
        assert not set(aged) & set(os.listdir(arch))
        obs.append(bool(os.listdir(arch)))
    with s.DB.open(d, opts) as db:
        assert db.get(b"key08999") == b"v08999"


SCENARIOS = [sc_recycled_wal_reused_and_recovery_clean,
             sc_recycled_stale_tail_longer_than_new_life,
             sc_wal_archival_and_ttl]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_wal_plane_against_reference(tmp_path, scenario):
    seen = {}
    for name in ("ref", "port"):
        obs = []
        scenario(Side(name == "ref"), str(tmp_path / name), obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------------------
# Recycled WAL bytes, per write mode
# ---------------------------------------------------------------------------


MODES = {
    "default": {},
    "pipelined": dict(enable_pipelined_write=True),
    "pipelined+async": dict(enable_pipelined_write=True,
                            enable_async_wal=True),
}


class _Reuses:
    """Counts an env's reuse_writable_file calls (set on the instance)."""

    def __init__(self, env):
        self.n = 0
        self._fn = env.reuse_writable_file
        env.reuse_writable_file = self

    def __call__(self, old, new):
        self.n += 1
        return self._fn(old, new)


class RecycleTwin(Twin):
    def open(self):
        super().open()
        self.reuses = (_Reuses(self.ref.env), _Reuses(self.port.env))


def _round(t, rng, n, tag):
    for _ in range(n):
        k = b"key%04d" % rng.randrange(400)
        if rng.random() < 0.85:
            t.put(k, tag + bytes(rng.randrange(97, 123)
                                 for _ in range(rng.randrange(1, 120))))
        else:
            t.delete(k)


def _all_logs_equal(t):
    names = _wal_files(t.dir)
    assert names == _wal_files(t.ref_dir)
    for n in names:
        with open(os.path.join(t.dir, n), "rb") as a, \
                open(os.path.join(t.ref_dir, n), "rb") as b:
            assert a.read() == b.read(), n
    return names


@pytest.mark.parametrize("mode", sorted(MODES))
def test_recycled_wal_bytes(tmp_path, pinned_clock, mode):  # noqa: F811
    t = RecycleTwin(str(tmp_path), "device", True, recycle_log_file_num=2,
                    **MODES[mode])
    try:
        rng = random.Random(17)
        # Rounds of falling size: each new life is shorter than the old
        # one, so reused files keep a stale tail.
        for r, n in enumerate((300, 260, 120, 90, 40)):
            _round(t, rng, n, b"r%d-" % r)
            t.flush()
            t.check()
            _all_logs_equal(t)
            assert t.port._recycle_wals == t.ref._recycle_wals
        assert t.reuses[1].n == t.reuses[0].n >= 2
        _round(t, rng, 30, b"tail-")  # unflushed, in a reused WAL
        t.check()
        names = _all_logs_equal(t)
        live = os.path.join(t.dir, "%06d.log" % t.port._wal_number)
        assert os.path.getsize(live) > 0 and len(names) >= 2
        # Crash: no flush; the reopen replays the recycled WAL.
        for db in (t.ref, t.port):
            db._compaction_scheduler.shutdown()
            db._wal.sync()
            db._wal.close()
            db._closed = True
        t.open()
        t.check()
        t.reopen()
    finally:
        t.close()


# ---------------------------------------------------------------------------
# Recovery across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_recycled_wals_recover_in_the_other_package(tmp_path, writer):
    """A DB whose WALs `writer` recycled, dropped without a flush, opened
    by the other package: every key equals the oracle."""
    w, r = Side(writer == "ref"), Side(writer != "ref")
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    oracle = {}
    db = w.DB.open(src, w.options(recycle_log_file_num=2,
                                  disable_auto_compactions=True))
    rng = random.Random(5)
    for r_ in range(4):
        for _ in range(400 - 80 * r_):
            k = b"key%04d" % rng.randrange(500)
            v = b"%d-" % r_ + bytes(rng.randrange(97, 123)
                                    for _ in range(rng.randrange(1, 80)))
            db.put(k, v)
            oracle[k] = v
        db.flush()
    for i in range(50):  # the unflushed tail, in a reused WAL
        k = b"key%04d" % i
        db.put(k, b"tail-%d" % i)
        oracle[k] = b"tail-%d" % i
    assert any(n not in db._recycle_wals
               for n in db._recyclable_written if n != db._wal_number)
    db._compaction_scheduler.shutdown()
    db._wal.sync()
    shutil.copytree(src, dst)
    db._wal.close()
    db._closed = True
    with r.DB.open(dst, r.options()) as other:
        for k, v in oracle.items():
            assert other.get(k) == v, k
        it = other.new_iterator()
        it.seek_to_first()
        assert list(it.entries()) == sorted(oracle.items())


# ---------------------------------------------------------------------------
# The env wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wrapper", ["fault_injection", "delayed_read",
                                     "checksum_tap"])
def test_env_wrappers_pass_reuse_and_mtime_through(tmp_path, wrapper):
    base = default_env()
    env = {
        "fault_injection": lambda: FaultInjectionEnv(base),
        "delayed_read": lambda: DelayedReadEnv(base, delay_sec=0.0),
        "checksum_tap": lambda: ChecksumTapEnv(base, factory_for(Options(
            file_checksum="crc32c"))),
    }[wrapper]()
    p1, p2 = str(tmp_path / "000003.log"), str(tmp_path / "000005.log")
    f = env.new_writable_file(p1)
    f.append(b"x" * 100)
    f.close()
    os.utime(p1, (1000, 1000))
    assert env.get_file_mtime(p1) == 1000
    f = env.reuse_writable_file(p1, p2)
    f.append(b"y" * 10)
    f.close()
    assert not os.path.exists(p1)
    with open(p2, "rb") as fh:
        assert fh.read() == b"y" * 10 + b"x" * 90  # overwritten in place
