"""Read-only and secondary opens and prefix-mode iteration in
toplingdb_tpu_torch's DB against toplingdb_tpu's, on the CPU.

- tests/test_utilities.py:417 (a read-only open replays the WAL, refuses
  writes and leaves the primary openable) and :438 (a secondary catches up
  with a flush), tests/test_column_families.py:139 (read-only WAL replay
  keeps column families apart), tests/test_replication.py:466 (a secondary
  follows CFs the primary created and dropped) and :491 (deleted WALs are
  skipped and stale memtable entries dropped) run on each package, with
  the reference tests' assertions and equal observations;
- a primary compacts away a table its secondary's version still names:
  both packages' secondaries then fail the read the same way, and a
  catch-up and read inside pause_background_work /
  continue_background_work are served;
- Options(read_only=True) through DB.open starts no LOG file and no async
  WAL ring, in both packages;
- the prefix_same_as_start cases of tests/test_plain_table.py:149
  (:168-176, with total_order_seek) and :237 (seek_to_first stays total
  order, a seek arms prefix mode), and a backward walk in prefix mode.

Tolerance: none.
"""

import os

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.db import db_readonly as ref_ro
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.table.builder import TableOptions as RefTableOptions
from toplingdb_tpu.utils import slice_transform as ref_st
from toplingdb_tpu.utils import status as ref_status

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db import db_readonly as ro
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.table.builder import TableOptions
from toplingdb_tpu_torch.utils import slice_transform as st
from toplingdb_tpu_torch.utils import status


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.ro = ref_ro if ref else ro
        self.ReadOptions = RefReadOptions if ref else ReadOptions
        self.TableOptions = RefTableOptions if ref else TableOptions
        self.st = ref_st if ref else st
        self.status = ref_status if ref else status

    def options(self, **kw):
        if self.ref:
            return RefOptions(**kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)


def both(scenario, tmp_path):
    seen = {}
    for name in ("ref", "port"):
        d = str(tmp_path / name)
        os.makedirs(d)
        obs = []
        scenario(Side(name == "ref"), os.path.join(d, "db"), obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]
    return seen["port"]


def sc_readonly_db(s, src, obs):                      # test_utilities:417
    with s.DB.open(src, s.options(write_buffer_size=16 * 1024)) as db:
        for i in range(100):
            db.put(b"k%03d" % i, b"v%03d" % i)
        db.flush()
        db.put(b"unflushed", b"wal-only")
    r = s.ro.ReadOnlyDB.open(src)
    obs += [r.get(b"k050"), r.get(b"unflushed")]  # the WAL replayed
    with pytest.raises(s.status.NotSupported):
        r.put(b"x", b"y")
    it = r.new_iterator()
    it.seek_to_first()
    obs.append(len(list(it.entries())))
    r.close()
    with s.DB.open(src, s.options(write_buffer_size=16 * 1024)) as db:
        obs.append(db.get(b"k050"))
    assert obs == [b"v050", b"wal-only", 101, b"v050"]


def sc_secondary_catches_up(s, src, obs):             # test_utilities:438
    db = s.DB.open(src, s.options(write_buffer_size=16 * 1024))
    db.put(b"a", b"1")
    db.flush()
    sec = s.ro.SecondaryDB.open(src)
    obs.append(sec.get(b"a"))
    db.put(b"b", b"2")
    db.flush()
    obs.append(sec.get(b"b"))  # not caught up yet
    sec.try_catch_up_with_primary()
    obs.append(sec.get(b"b"))
    sec.close()
    db.close()
    assert obs == [b"1", None, b"2"]


def sc_readonly_db_respects_cfs(s, src, obs):         # test_column_families:139
    with s.DB.open(src, s.options(write_buffer_size=8 * 1024)) as db:
        aux = db.create_column_family("aux")
        db.put(b"k", b"default-v")
        db.put(b"k", b"aux-v", cf=aux)
    r = s.ro.ReadOnlyDB.open(src)
    obs.append(r.get(b"k"))
    aux_ro = r.get_column_family("aux")
    obs.append(r.get(b"k", cf=aux_ro))
    r.close()
    assert obs == [b"default-v", b"aux-v"]


def sc_secondary_catchup_cf_created_and_dropped(s, src, obs):  # repl:466
    db = s.DB.open(src, s.options(write_buffer_size=1 << 20,
                                  create_if_missing=True))
    doomed = db.create_column_family("doomed")
    db.put(b"d", b"1", cf=doomed)
    db.put(b"k", b"v")
    db.flush()
    sec = s.ro.SecondaryDB.open(src)
    obs += [sec.get(b"k"), sec.get(b"d", cf=1)]
    db.drop_column_family(doomed)
    newcf = db.create_column_family("fresh")
    db.put(b"f", b"2", cf=newcf)
    sec.try_catch_up_with_primary()
    names = sorted(h.name for h in sec.list_column_families())
    obs.append(names)
    obs.append(sec.get(b"f", cf=sec.get_column_family("fresh")))
    sec.close()
    db.close()
    assert obs == [b"v", b"1", ["default", "fresh"], b"2"]


def sc_secondary_survives_wal_gc(s, src, obs):        # test_replication:491
    db = s.DB.open(src, s.options(write_buffer_size=1 << 20,
                                  create_if_missing=True))
    db.put(b"k", b"old")
    sec = s.ro.SecondaryDB.open(src)
    obs.append(sec.get(b"k"))
    db.put(b"k", b"mid")
    db.delete(b"k")
    db.flush()          # the WAL holding old / mid / the delete goes
    db.compact_range()  # the tombstone compacts away
    sec.try_catch_up_with_primary()
    obs.append(sec.get(b"k"))  # a stale memtable would resurrect a value
    db.put(b"k", b"new")
    sec.try_catch_up_with_primary()
    obs.append(sec.get(b"k"))
    sec.close()
    db.close()
    assert obs == [b"old", None, b"new"]


SCENARIOS = [
    sc_readonly_db,
    sc_secondary_catches_up,
    sc_readonly_db_respects_cfs,
    sc_secondary_catchup_cf_created_and_dropped,
    sc_secondary_survives_wal_gc,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_read_only_against_reference(tmp_path, scenario):
    both(scenario, tmp_path)


def test_secondary_meets_a_deleted_table_unless_paused(tmp_path):
    """A secondary pins none of the primary's files: after a catch-up the
    primary's compaction deletes the tables the secondary's version names,
    and a read that opens one fails on both packages. Paused background
    work around the catch-up and the read serves it."""

    def sc(s, src, obs):
        db = s.DB.open(src, s.options(write_buffer_size=1 << 20,
                                      disable_auto_compactions=True))
        for r in range(2):
            for i in range(200):
                db.put(b"k%04d" % i, b"r%d" % r)
            db.flush()
        sec = s.ro.SecondaryDB.open(src)
        db.compact_range()  # the two L0 tables the secondary names go
        try:
            obs.append(sec.get(b"k0007"))
        except Exception as e:  # noqa: BLE001 - compared by type name
            obs.append(type(e).__name__)
        db.pause_background_work()
        try:
            sec.try_catch_up_with_primary()
            obs.append(sec.get(b"k0007"))
        finally:
            db.continue_background_work()
        sec.close()
        db.close()

    obs = both(sc, tmp_path)
    assert obs[0] in ("NotFound", "IOError", "IOError_"), obs
    assert obs[1] == b"r1"


@pytest.mark.parametrize("async_wal", [False, True])
def test_read_only_option_through_open(tmp_path, async_wal):
    def sc(s, src, obs):
        db = s.DB.open(src, s.options(read_only=True,
                                      enable_async_wal=async_wal))
        db.put(b"k", b"v")
        obs += [db.get(b"k"), db._wal_ring is None, db._log_file is None,
                os.path.exists(os.path.join(src, "LOG"))]
        db.close()

    assert both(sc, tmp_path) == [b"v", True, True, False]


# ---------------------------------------------------------------------------
# prefix_same_as_start (tests/test_plain_table.py)
# ---------------------------------------------------------------------------


def test_plain_format_prefix_iteration(tmp_path):     # test_plain_table:149
    def sc(s, d, obs):
        db = s.DB.open(d, s.options(
            prefix_extractor=s.st.FixedPrefixTransform(4),
            table_options=s.TableOptions(format="plain"),
            write_buffer_size=1 << 20, memtable_rep="hash_skiplist:4"))
        for g in (b"user", b"item", b"sess"):
            for i in range(30):
                db.put(g + b"%03d" % i, b"val-" + g + b"%03d" % i)
        db.flush()
        db.put(b"user001", b"overwritten")
        obs += [db.get(b"user005"), db.get(b"user001"), db.get(b"none999")]
        it = db.new_iterator(s.ReadOptions(prefix_same_as_start=True))
        it.seek(b"item010")
        obs.append([k for k, _ in it.entries()])
        it = db.new_iterator(s.ReadOptions(prefix_same_as_start=True,
                                           total_order_seek=True))
        it.seek(b"item010")
        obs.append([k for k, _ in it.entries()])
        # A backward walk stops at the start of the prefix group too.
        it = db.new_iterator(s.ReadOptions(prefix_same_as_start=True))
        it.seek_for_prev(b"sess005")
        back = []
        while it.valid():
            back.append(it.key())
            it.prev()
        obs.append(back)
        db.close()

    obs = both(sc, tmp_path)
    assert obs[:3] == [b"val-user005", b"overwritten", None]
    assert obs[3] == [b"item%03d" % i for i in range(10, 30)]
    assert obs[4][-1] == b"user029" and len(obs[4]) == 20 + 30 + 30
    assert obs[5] == [b"sess%03d" % i for i in range(5, -1, -1)]


def test_seek_to_first_with_lower_bound_is_total_order(tmp_path):  # :237
    def sc(s, d, obs):
        db = s.DB.open(d, s.options(
            prefix_extractor=s.st.FixedPrefixTransform(2)))
        db.put(b"aab", b"1")
        db.put(b"ac1", b"2")
        it = db.new_iterator(s.ReadOptions(prefix_same_as_start=True,
                                           iterate_lower_bound=b"aa"))
        it.seek_to_first()
        obs.append([k for k, _ in it.entries()])
        it = db.new_iterator(s.ReadOptions(prefix_same_as_start=True))
        it.seek(b"aa")
        obs.append([k for k, _ in it.entries()])
        db.close()

    assert both(sc, tmp_path) == [[b"aab", b"ac1"], [b"aab"]]


def test_prefix_seeks_on_block_tables(tmp_path):
    """1-in-3 keys of 8-byte prefixes over flushed, compacted and
    memtable data: every prefix seek stops at the end of its prefix, on
    the scan plane's DB (the plane declines prefix mode)."""

    def sc(s, d, obs):
        db = s.DB.open(d, s.options(
            prefix_extractor=s.st.FixedPrefixTransform(8),
            write_buffer_size=32 << 10))
        for p in range(40):
            for j in range(0, 9, 3):
                db.put(b"%08d%04d" % (p, j), b"v%d.%d" % (p, j))
            if p == 20:
                db.flush()
                db.compact_range()
        for p in range(0, 40, 3):
            it = db.new_iterator(s.ReadOptions(prefix_same_as_start=True))
            it.seek(b"%08d0001" % p)
            obs.append([k for k, _ in it.entries()])
        db.close()

    obs = both(sc, tmp_path)
    assert obs[0] == [b"000000000003", b"000000000006"]
    assert all(len(ks) == 2 for ks in obs)
