"""repair_db in toplingdb_tpu_torch against toplingdb_tpu's, on the CPU.

- tests/test_db.py:311 (a crashed DB's MANIFEST and CURRENT deleted:
  repair keeps the tables, replays the WAL, and the DB reopens with every
  key) and :513 (column families rebuilt from the tables' properties and
  the WAL's CF records) run on each package, with the reference tests'
  assertions and equal reports; the repaired DBs' rows (every CF, every
  key) are equal on both sides;
- a table with a flipped byte is set aside in lost/ by both packages with
  the same report, and the DB reopens without it;
- the port's repaired DB compacts on the "cpu" device executor and keeps
  its rows;
- a repaired DB whose L0 file and its L1 output hold the same merge
  operand (a live iterator pinned the compacted file): get, multi_get,
  get_merge_operands and an iterator read the same values on both sides.

Tolerance: none.
"""

import os

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.compaction.executor import (
    DeviceCompactionExecutorFactory as RefFactory,
)
from toplingdb_tpu.db import repair as ref_repair
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.utils import merge_operator as ref_mo

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db import repair
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils import merge_operator as mo

from test_torch_db import pinned_clock  # noqa: F401


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.repair_db = (ref_repair if ref else repair).repair_db

    def options(self, **kw):
        if self.ref:
            return RefOptions(**kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)

    def device_options(self, **kw):
        """Both packages' device executors on the CPU."""
        if self.ref:
            return RefOptions(compaction_executor_factory=RefFactory(
                device="cpu-jax"), **kw)
        return self.options(**kw)

    def string_append(self):
        return (ref_mo if self.ref else mo).StringAppendOperator()


def _lose_manifest(d):
    for f in os.listdir(d):
        if f.startswith("MANIFEST") or f == "CURRENT":
            os.remove(os.path.join(d, f))


def _rows(db):
    """Every CF's rows, by CF name."""
    out = {}
    for h in db.list_column_families():
        it = db.new_iterator(cf=h)
        it.seek_to_first()
        out[h.name] = list(it.entries())
    return out


def both(scenario, tmp_path):
    seen = {}
    for name in ("ref", "port"):
        obs = []
        scenario(Side(name == "ref"), str(tmp_path / name), obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]
    return seen["port"]


def test_repair_db(tmp_path, pinned_clock):  # noqa: F811 - test_db.py:311
    def sc(s, d, obs):
        # The vector rep and no background compactions: both packages cut
        # the same tables (a skiplist's flush points depend on the
        # process's history).
        with s.DB.open(d, s.options(write_buffer_size=8 * 1024,
                                    memtable_rep="vector",
                                    disable_auto_compactions=True)) as db:
            for i in range(1500):
                db.put(b"key%05d" % i, b"v%05d" % i)
            db.flush()
            db.put(b"wal-only", b"yes")
            db._wal.sync()
            db._closed = True  # crash
        _lose_manifest(d)
        report = s.repair_db(d, s.options(write_buffer_size=32 * 1024))
        assert report["tables_kept"] >= 1
        obs.append(report)
        with s.DB.open(d, s.options(write_buffer_size=32 * 1024)) as db:
            obs += [db.get(b"key00750"), db.get(b"wal-only"), _rows(db)]

    obs = both(sc, tmp_path)
    assert obs[1:3] == [b"v00750", b"yes"]
    assert len(obs[3]["default"]) == 1501


def test_repair_db_multi_cf(tmp_path, pinned_clock):  # noqa: F811 - :513
    def sc(s, d, obs):
        with s.DB.open(d, s.options(write_buffer_size=32 * 1024,
                                    memtable_rep="vector")) as db:
            cf = db.create_column_family("meta")
            db.put(b"dk", b"dv")
            db.put(b"mk", b"mv", cf=cf)
            db.flush()
            db.put(b"wal-d", b"1")
            db.put(b"wal-m", b"2", cf=cf)
            db._wal.sync()
            db._closed = True  # crash
        _lose_manifest(d)
        report = s.repair_db(d, s.options(write_buffer_size=32 * 1024))
        assert "meta" in report["column_families"].values()
        obs.append(report)
        with s.DB.open(d, s.options(write_buffer_size=32 * 1024)) as db:
            cf = db.get_column_family("meta")
            assert cf is not None
            obs += [db.get(b"dk"), db.get(b"mk", cf=cf), db.get(b"wal-d"),
                    db.get(b"wal-m", cf=cf), db.get(b"mk"), _rows(db)]

    obs = both(sc, tmp_path)
    assert obs[1:6] == [b"dv", b"mv", b"1", b"2", None]


def test_repair_sets_a_damaged_table_aside(tmp_path, pinned_clock):  # noqa: F811
    def sc(s, d, obs):
        with s.DB.open(d, s.options(write_buffer_size=1 << 20)) as db:
            for t in range(3):
                for i in range(300):
                    db.put(b"t%d-%04d" % (t, i), b"x" * 30)
                db.flush()
            tables = sorted(f for f in os.listdir(d) if f.endswith(".sst"))
        victim = os.path.join(d, tables[1])
        raw = bytearray(open(victim, "rb").read())
        raw[100] ^= 0xFF
        open(victim, "wb").write(bytes(raw))
        _lose_manifest(d)
        report = s.repair_db(d, s.options())
        obs.append(report)
        obs.append(sorted(os.listdir(os.path.join(d, "lost"))))
        with s.DB.open(d, s.options()) as db:
            obs.append({k: len(v) for k, v in _rows(db).items()})
            if not s.ref:
                db.compact_range()
                obs.append({k: len(v) for k, v in _rows(db).items()})
                assert db.options.compaction_executor_factory.jobs
            else:
                obs.append(obs[-1])

    obs = both(sc, tmp_path)
    assert obs[0]["tables_dropped"] == 1 and obs[0]["tables_kept"] == 2
    assert obs[2] == obs[3] == {"default": 600}


def test_repaired_duplicate_operand_reads_like_the_reference(
        tmp_path, pinned_clock):  # noqa: F811
    """A duplicated merge operand after repair: an iterator pins the L0
    file that compact_files rewrote into L1, so after close and a lost
    MANIFEST, repair_db keeps both tables, which hold the same (key,
    seqno) merge operand. Every read of both packages then folds it
    twice: get, multi_get and the iterator read B,X,X and
    get_merge_operands [B, X, X]."""
    def sc(s, d, obs):
        opts = dict(merge_operator=s.string_append(),
                    disable_auto_compactions=True)
        db = s.DB.open(d, s.device_options(**opts))
        db.put(b"k", b"B")
        db.flush()
        db.compact_range()
        db.merge(b"k", b"X")
        db.flush()
        it = db.new_iterator()
        it.seek_to_first()
        l0 = [f.number for f in db.versions.current.files[0]]
        db.compact_files(l0, 1)
        db.close()
        _lose_manifest(d)
        obs.append(s.repair_db(d, s.options(**opts))["tables_kept"])
        del it
        with s.DB.open(d, s.device_options(**opts)) as db:
            obs.append(db.get(b"k"))
            obs.append(db.multi_get([b"k", b"absent"]))
            obs.append(db.get_merge_operands(b"k"))
            it2 = db.new_iterator()
            it2.seek_to_first()
            obs.append(list(it2.entries()))
    seen = both(sc, tmp_path)
    assert seen == [3, b"B,X,X", [b"B,X,X", None], [b"B", b"X", b"X"],
                        [(b"k", b"B,X,X")]]
