"""The utilities of toplingdb_tpu_torch against toplingdb_tpu's, on the CPU.

Each scenario runs as one op script on each package, with the reference
tests' assertions, and the observations (reads, scans, error types) must
be equal:
- checkpoints: tests/test_utilities.py:23 (openable) and :619 (a MemEnv),
  tests/test_column_families.py:122 (every CF), tests/test_db.py:223
  (blob files), tests/test_integrity.py:657 (a corrupt SST is refused),
  Checkpoint.verify / restore_to, and a checkpoint compacted on the device
  executor ("cpu": the kernels' plain versions);
- backups: :38 (restore and purge), :581 (double-digit ids), :1755
  (depth: metadata, verify, delete, garbage collection);
- SstFileWriter: :62 (write, read, ingest under a snapshot), :91 (out of
  order); its files are byte-equal to the reference's for the same
  entries; ingestion reaches a listener;
- TTL: :105, and a TtlDB whose job runs on the device executor's
  per-entry route (expired keys gone, survivors equal);
- WriteBatchWithIndex: :124, :144, :156 and :1481 (the skiplist rep equals
  the list rep, and the reference's);
- option migration: :1330;
- RateLimiter (:510, :635), WriteController and WriteBufferManager (:524).

Tolerance: none (timing assertions are the reference tests' lower bounds).
"""

import json
import os
import random
import struct
import threading
import time

import pytest

import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.utilities.backup_engine as ref_backup
import toplingdb_tpu.utilities.checkpoint as ref_ckpt
import toplingdb_tpu.utilities.option_migration as ref_mig
import toplingdb_tpu.utilities.sst_file_writer as ref_sfw
import toplingdb_tpu.utilities.ttl as ref_ttl
import toplingdb_tpu.utilities.write_batch_with_index as ref_wbwi
from toplingdb_tpu import env as ref_env
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.utils import listener as ref_listener
from toplingdb_tpu.utils import merge_operator as ref_mo
from toplingdb_tpu.utils import rate_limiter as ref_rl
from toplingdb_tpu.utils import status as ref_status

import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.utilities.backup_engine as backup
import toplingdb_tpu_torch.utilities.checkpoint as ckpt
import toplingdb_tpu_torch.utilities.option_migration as mig
import toplingdb_tpu_torch.utilities.sst_file_writer as sfw
import toplingdb_tpu_torch.utilities.ttl as ttl
import toplingdb_tpu_torch.utilities.write_batch_with_index as wbwi
from toplingdb_tpu_torch import env as port_env
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.utils import listener
from toplingdb_tpu_torch.utils import merge_operator as mo
from toplingdb_tpu_torch.utils import rate_limiter as rl
from toplingdb_tpu_torch.utils import status


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.ckpt = ref_ckpt if ref else ckpt
        self.backup = ref_backup if ref else backup
        self.sfw = ref_sfw if ref else sfw
        self.ttl = ref_ttl if ref else ttl
        self.wbwi = ref_wbwi if ref else wbwi
        self.mig = ref_mig if ref else mig
        self.env = ref_env if ref else port_env
        self.mo = ref_mo if ref else mo
        self.listener = ref_listener if ref else listener
        self.rl = ref_rl if ref else rl
        self.ReadOptions = RefReadOptions if ref else ReadOptions
        self.status = ref_status if ref else status

    def options(self, **kw):
        kw.setdefault("write_buffer_size", 16 * 1024)
        if self.ref:
            return RefOptions(**kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)

    def raises(self, obs, exc_name, fn, *a, **kw):
        with pytest.raises(getattr(self.status, exc_name)) as ei:
            fn(*a, **kw)
        obs.append(("raised", type(ei.value).__name__))


def both(scenario, tmp_path):
    seen = {}
    for name in ("ref", "port"):
        d = str(tmp_path / name)
        os.makedirs(d)
        obs = []
        scenario(Side(name == "ref"), d, obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]
    return seen["port"]


def scan(db, cf=None):
    it = db.new_iterator(cf=cf) if cf is not None else db.new_iterator()
    it.seek_to_first()
    return list(it.entries())


# -- checkpoints --------------------------------------------------------------


def sc_checkpoint_openable(s, d, obs):              # test_utilities:23
    src, dst = f"{d}/src", f"{d}/ckpt"
    with s.DB.open(src, s.options()) as db:
        for i in range(500):
            db.put(b"k%04d" % i, b"v%04d" % i)
        s.ckpt.create_checkpoint(db, dst)
        db.put(b"after", b"x")
        s.raises(obs, "InvalidArgument", s.ckpt.create_checkpoint, db, dst)
    with s.DB.open(dst, s.options()) as db2:
        obs.append((db2.get(b"k0123"), db2.get(b"after")))
        obs.append(len(scan(db2)))
        # The checkpoint compacts on its own (the port: on the device
        # executor) and reads the same.
        db2.compact_range()
        obs.append(scan(db2) == [(b"k%04d" % i, b"v%04d" % i)
                                 for i in range(500)])
    assert obs[1:] == [(b"v0123", None), 500, True]


def sc_checkpoint_all_cfs(s, d, obs):               # test_column_families:122
    with s.DB.open(f"{d}/db", s.options()) as db:
        aux = db.create_column_family("aux")
        db.put(b"d", b"1")
        db.put(b"a", b"2", cf=aux)
        s.ckpt.create_checkpoint(db, f"{d}/ckpt")
    with s.DB.open(f"{d}/ckpt", s.options()) as db2:
        aux2 = db2.get_column_family("aux")
        obs.append((aux2 is not None, db2.get(b"d"), db2.get(b"a", cf=aux2)))
        obs.append(sorted(
            getattr(h, "name", h) for h in db2.list_column_families()))
    assert obs[0] == (True, b"1", b"2")


def sc_checkpoint_blob_files(s, d, obs):            # test_db:223
    o = dict(enable_blob_files=True, min_blob_size=100)
    with s.DB.open(f"{d}/db", s.options(**o)) as db:
        db.put(b"k", b"B" * 500)
        db.flush()
        s.ckpt.create_checkpoint(db, f"{d}/ckpt")
    obs.append(sorted(f for f in os.listdir(f"{d}/ckpt")
                      if f.endswith(".blob")))
    with s.DB.open(f"{d}/ckpt", s.options(**o)) as db2:
        obs.append(db2.get(b"k"))
    assert obs[-1] == b"B" * 500 and obs[0]


def sc_checkpoint_refuses_corruption(s, d, obs):    # test_integrity:657
    src = f"{d}/db"
    db = s.DB.open(src, s.options(disable_auto_compactions=True))
    try:
        rng = random.Random(7)
        for i in range(1200):
            db.put(b"k%06d" % i, (b"v%05d." % rng.randrange(10 ** 5)) * 10)
        db.flush()
        s.ckpt.create_checkpoint(db, f"{d}/ck_good")
        verify = (
            __import__("toplingdb_tpu.utils.file_checksum",
                       fromlist=["x"]) if s.ref else
            __import__("toplingdb_tpu_torch.utils.file_checksum",
                       fromlist=["x"])).verify_dir_file_checksums
        obs.append(verify(f"{d}/ck_good")["files_verified"] >= 1)
        ssts = sorted(f for f in os.listdir(src) if f.endswith(".sst"))
        path = os.path.join(src, ssts[0])
        buf = bytearray(open(path, "rb").read())
        buf[len(buf) // 2] ^= 0x01
        with open(path, "wb") as f:
            f.write(buf)
        s.raises(obs, "Corruption", s.ckpt.create_checkpoint, db,
                 f"{d}/ck_bad")
        obs.append(os.path.exists(f"{d}/ck_bad/CURRENT"))
    finally:
        db.close()
    assert obs == [True, ("raised", "Corruption"), False]


def sc_checkpoint_mem_env(s, d, obs):               # test_utilities:619
    env = s.env.MemEnv()
    db = s.DB.open("/db", s.options(), env=env)
    for i in range(50):
        db.put(b"k%02d" % i, b"v%02d" % i)
    s.ckpt.create_checkpoint(db, "/ckpt")
    db.close()
    db2 = s.DB.open("/ckpt", s.options(), env=env)
    obs.append((db2.get(b"k25"), len(scan(db2))))
    db2.close()
    assert obs == [(b"v25", 50)]


def sc_checkpoint_verify_restore(s, d, obs):
    with s.DB.open(f"{d}/db", s.options()) as db:
        for i in range(300):
            db.put(b"r%03d" % i, b"v" * 30)
        c = s.ckpt.Checkpoint.create(db, f"{d}/ckpt")
    c.verify()
    out = c.restore_to(f"{d}/restored")
    with s.DB.open(out, s.options()) as db2:
        obs.append(len(scan(db2)))
    os.makedirs(f"{d}/partial")
    open(f"{d}/partial/MANIFEST-000001", "wb").write(b"x")
    s.raises(obs, "InvalidArgument",
             s.ckpt.Checkpoint(f"{d}/partial").verify)
    s.raises(obs, "InvalidArgument", c.restore_to, f"{d}/restored")
    assert obs[0] == 300


CKPT_SCENARIOS = [sc_checkpoint_openable, sc_checkpoint_all_cfs,
                  sc_checkpoint_blob_files, sc_checkpoint_refuses_corruption,
                  sc_checkpoint_mem_env, sc_checkpoint_verify_restore]


@pytest.mark.parametrize("scenario", CKPT_SCENARIOS,
                         ids=[f.__name__[3:] for f in CKPT_SCENARIOS])
def test_checkpoint_scenarios_match_reference(tmp_path, scenario):
    both(scenario, tmp_path)


def test_checkpoint_links_only_on_posix_env(tmp_path):
    """Hard links on PosixEnv; through any wrapper Env the bytes are copied
    (and read back through the wrapper)."""
    from toplingdb_tpu_torch.env import PosixEnv
    from toplingdb_tpu_torch.env.fault_injection import FaultInjectionEnv

    s = Side(False)
    for tag, env in (("posix", PosixEnv()),
                     ("fi", FaultInjectionEnv(PosixEnv()))):
        src = str(tmp_path / f"{tag}-db")
        db = dbm.DB.open(src, s.options(), env=env)
        for i in range(200):
            db.put(b"k%03d" % i, b"v")
        ckpt.create_checkpoint(db, str(tmp_path / f"{tag}-ckpt"))
        n = [f for f in os.listdir(str(tmp_path / f"{tag}-ckpt"))
             if f.endswith(".sst")]
        links = {os.stat(os.path.join(str(tmp_path / f"{tag}-ckpt"),
                                      f)).st_nlink for f in n}
        assert n and links == ({2} if tag == "posix" else {1}), (tag, links)
        if tag == "fi":
            assert env.io_counts.get("read", 0) > 0
        db.close()


# -- backups ------------------------------------------------------------------


def sc_backup_restore_and_purge(s, d, obs):         # test_utilities:38
    be = s.backup.BackupEngine(f"{d}/backups")
    with s.DB.open(f"{d}/src", s.options()) as db:
        db.put(b"a", b"1")
        b1 = be.create_backup(db)
        db.put(b"b", b"2")
        b2 = be.create_backup(db)
    obs.append([i["backup_id"] for i in be.get_backup_info()])
    be.restore_db_from_backup(b1, f"{d}/restored")
    with s.DB.open(f"{d}/restored", s.options()) as db2:
        obs.append((db2.get(b"a"), db2.get(b"b")))
    be.purge_old_backups(1)
    obs.append([i["backup_id"] for i in be.get_backup_info()])
    assert obs == [[b1, b2], (b"1", None), [b2]]


def sc_backup_double_digit_ids(s, d, obs):          # test_utilities:581
    be = s.backup.BackupEngine(f"{d}/backups")
    ids = []
    with s.DB.open(f"{d}/src", s.options()) as db:
        for i in range(11):
            db.put(b"k%02d" % i, b"v")
            ids.append(be.create_backup(db))
    be.purge_old_backups(2)
    kept = [i["backup_id"] for i in be.get_backup_info()]
    obs.append(kept)
    be.restore_db_from_backup(kept[-1], f"{d}/restored")
    with s.DB.open(f"{d}/restored", s.options()) as db2:
        obs.append(db2.get(b"k10"))
    assert obs == [ids[-2:], b"v"]


def sc_backup_depth(s, d, obs):                     # test_utilities:1755
    be = s.backup.BackupEngine(f"{d}/backups")
    with s.DB.open(f"{d}/db", s.options(write_buffer_size=1 << 20)) as db:
        for i in range(300):
            db.put(b"k%04d" % i, b"v" * 40)
        db.flush()
        b1 = be.create_backup(db, app_metadata="first")
        for i in range(300, 600):
            db.put(b"k%04d" % i, b"v" * 40)
        db.flush()
        b2 = be.create_backup(db)
    infos = be.get_backup_info()
    obs.append([(i["backup_id"], i["num_files"], i["app_metadata"])
                for i in infos])
    be.verify_backup(b1)
    be.verify_backup(b2)
    with open(f"{d}/backups/meta/{b1}.json") as f:
        victim = f"{d}/backups/shared/" + json.load(f)["files"][0]["shared"]
    blob = bytearray(open(victim, "rb").read())
    blob[30] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    s.raises(obs, "Corruption", be.verify_backup, b1)
    blob[30] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    be.verify_backup(b1)
    be.delete_backup(b1)
    s.raises(obs, "NotFound", be.verify_backup, b1)
    be.restore_db_from_backup(b2, f"{d}/restored")
    with s.DB.open(f"{d}/restored", s.options()) as db2:
        obs.append((db2.get(b"k0000"), db2.get(b"k0599"), len(scan(db2))))
    orphan = f"{d}/backups/shared/999_deadbeef_000001.sst"
    open(orphan, "wb").write(b"junk")
    obs.append((be.garbage_collect(), os.path.exists(orphan)))
    assert obs[-1] == (1, False)


BACKUP_SCENARIOS = [sc_backup_restore_and_purge, sc_backup_double_digit_ids,
                    sc_backup_depth]


@pytest.mark.parametrize("scenario", BACKUP_SCENARIOS,
                         ids=[f.__name__[3:] for f in BACKUP_SCENARIOS])
def test_backup_scenarios_match_reference(tmp_path, scenario):
    both(scenario, tmp_path)


# -- SstFileWriter and ingestion -------------------------------------------


def sc_sst_writer_and_ingest(s, d, obs):            # test_utilities:62
    ext = f"{d}/ext.sst"
    w = s.sfw.SstFileWriter()
    w.open(ext)
    for i in range(100):
        w.put(b"ing%04d" % i, b"x%04d" % i)
    w.finish()
    r = s.sfw.SstFileReader(ext)
    obs.append(r.properties.num_entries)
    obs.append([(k, q, int(t), v) for k, q, t, v in r.iterate()][:3])
    r.verify_checksums()
    events = []

    class L(s.listener.EventListener):
        def on_external_file_ingested(self, db, info):
            events.append((info.external_file_path == ext, info.level))

    dbdir = f"{d}/db"
    with s.DB.open(dbdir, s.options(listeners=[L()])) as db:
        db.put(b"existing", b"1")
        snap = db.get_snapshot()
        obs.append(s.sfw.ingest_external_file(db, ext))
        obs.append((db.get(b"ing0050"), db.get(b"existing")))
        obs.append(db.get(b"ing0050", s.ReadOptions(snapshot=snap)))
        snap.release()
        obs.append(events)
        empty = f"{d}/empty.sst"
        w2 = s.sfw.SstFileWriter()
        w2.open(empty)
        w2.finish()
        s.raises(obs, "InvalidArgument", s.sfw.ingest_external_file, db,
                 empty)
    with s.DB.open(dbdir, s.options()) as db:
        obs.append(db.get(b"ing0099"))
        obs.append(len(scan(db)))
    assert obs[0] == 100 and obs[-2] == b"x0099"


def sc_sst_writer_rejects_out_of_order(s, d, obs):  # test_utilities:91
    w = s.sfw.SstFileWriter()
    w.open(f"{d}/x.sst")
    w.put(b"b", b"1")
    s.raises(obs, "InvalidArgument", w.put, b"a", b"2")
    s.raises(obs, "InvalidArgument", w.put, b"b", b"2")
    s.raises(obs, "InvalidArgument", s.sfw.SstFileWriter().put, b"a", b"1")


def sc_ingest_overlapping_and_move(s, d, obs):
    """Ingested values win over older ones, the file lands at the lowest
    level with no overlap, and move=True removes the external file."""
    with s.DB.open(f"{d}/db", s.options(disable_auto_compactions=True)) \
            as db:
        for i in range(0, 400, 2):
            db.put(b"k%04d" % i, b"old")
        db.compact_range()
        levels = []
        for j, (lo, hi) in enumerate(((100, 200), (1000, 1100))):
            ext = f"{d}/e{j}.sst"
            w = s.sfw.SstFileWriter()
            w.open(ext)
            for i in range(lo, hi):
                w.put(b"k%04d" % i, b"new%d" % j)
            w.delete_range(b"k%04d" % (hi + 10), b"k%04d" % (hi + 20))
            w.finish()
            levels.append(s.sfw.ingest_external_file(db, ext, move=j == 1))
        obs.append(levels)
        obs.append((os.path.exists(f"{d}/e0.sst"),
                    os.path.exists(f"{d}/e1.sst")))
        obs.append([db.get(b"k%04d" % i) for i in (98, 100, 150, 199, 250,
                                                   1050)])
        db.compact_range()
        obs.append(scan(db))


SST_SCENARIOS = [sc_sst_writer_and_ingest, sc_sst_writer_rejects_out_of_order,
                 sc_ingest_overlapping_and_move]


@pytest.mark.parametrize("scenario", SST_SCENARIOS,
                         ids=[f.__name__[3:] for f in SST_SCENARIOS])
def test_sst_file_writer_scenarios_match_reference(tmp_path, scenario):
    both(scenario, tmp_path)


def test_sst_file_writer_bytes_equal_reference(tmp_path):
    """The same entries through both packages' SstFileWriter give the same
    file bytes (puts, merges, deletes and a range deletion)."""
    rng = random.Random(11)
    keys = sorted({b"key%06d" % rng.randrange(10 ** 6) for _ in range(3000)})
    files = {}
    for name, mod in (("ref", ref_sfw), ("port", sfw)):
        path = str(tmp_path / f"{name}.sst")
        w = mod.SstFileWriter()
        w.open(path)
        for i, k in enumerate(keys):
            if i % 7 == 0:
                w.delete(k)
            elif i % 5 == 0:
                w.merge(k, b"m%d" % i)
            else:
                w.put(k, b"value-%d" % i * (1 + i % 3))
        w.delete_range(keys[10], keys[20])
        props, smallest, largest = w.finish()
        files[name] = (open(path, "rb").read(), smallest, largest,
                       props.num_entries)
    assert files["port"] == files["ref"]


# -- TTL ----------------------------------------------------------------------


def sc_ttl_db(s, d, obs):                           # test_utilities:105
    clock = [1000.0]
    with s.ttl.TtlDB.open(f"{d}/db", ttl=100, options=s.options(),
                          clock=lambda: clock[0]) as db:
        db.put(b"k", b"v")
        obs.append(db.get(b"k"))
        clock[0] += 200
        obs.append(db.get(b"k"))
        db.flush()
        db.compact_range()
        v = db.db.versions.current
        obs.append(sum(f.num_entries for _, f in v.all_files()))
        db.db.put(b"raw", b"ab")
        s.raises(obs, "Corruption", db.get, b"raw")
    assert obs[:3] == [b"v", None, 0]


def sc_ttl_device_job(s, d, obs):
    """Half the keys expire; the compaction filter drops exactly them (on
    the port: the device executor's per-entry route)."""
    clock = [5000.0]
    o = s.options(disable_auto_compactions=True, write_buffer_size=1 << 20)
    with s.ttl.TtlDB.open(f"{d}/db", ttl=50, options=o,
                          clock=lambda: clock[0]) as db:
        for i in range(2000):
            if i == 1000:
                clock[0] += 40
            db.put(b"t%05d" % i, b"v%05d" % i)
        db.flush()
        clock[0] += 20            # the first half is 60 s old now
        db.compact_range()
        rows = scan(db.db)
        obs.append(len(rows))
        obs.append(rows[0][0])
        obs.append([db.get(b"t%05d" % i) for i in (0, 999, 1000, 1999)])
    assert obs[0] == 1000 and obs[1] == b"t01000"


def test_ttl_scenarios_match_reference(tmp_path):
    both(sc_ttl_db, tmp_path / "a")
    both(sc_ttl_device_job, tmp_path / "b")


def test_ttl_job_takes_the_per_entry_device_route(tmp_path, monkeypatch):
    """A TtlDB's job carries a compaction filter: the port's device
    executor runs it through collect_raw_entries → device_gc_entries."""
    from toplingdb_tpu_torch.ops import device_compaction as dc

    calls = []
    real = dc.device_gc_entries

    def spy(*a, **k):
        calls.append(k.get("device_name"))
        return real(*a, **k)

    monkeypatch.setattr(dc, "device_gc_entries", spy)
    clock = [100.0]
    s = Side(False)
    with ttl.TtlDB.open(str(tmp_path / "db"), ttl=10,
                        options=s.options(disable_auto_compactions=True),
                        clock=lambda: clock[0]) as db:
        for i in range(300):
            db.put(b"x%03d" % i, b"v")
        db.flush()
        clock[0] += 20
        db.compact_range()
        assert calls == ["cpu"], calls
        assert scan(db.db) == []


# -- WriteBatchWithIndex ----------------------------------------------------


def sc_wbwi(s, d, obs):                     # test_utilities:124, :144, :156
    with s.DB.open(f"{d}/db", s.options()) as db:
        db.put(b"base", b"db-val")
        db.put(b"gone", b"x")
        w = s.wbwi.WriteBatchWithIndex()
        w.put(b"new", b"batch-val")
        w.delete(b"gone")
        w.put(b"base", b"overridden")
        obs.append([w.get_from_batch_and_db(db, k) for k in
                    (b"new", b"gone", b"base", b"missing")])
        obs.append((w.count(), w.key_set()))
        db.write(w.batch)
        obs.append((db.get(b"base"), db.get(b"gone")))
    op = s.mo.UInt64AddOperator()
    with s.DB.open(f"{d}/db2", s.options(merge_operator=op)) as db:
        db.put(b"c", struct.pack("<Q", 10))
        w = s.wbwi.WriteBatchWithIndex(op)
        w.merge(b"c", struct.pack("<Q", 5))
        w.merge(b"n", struct.pack("<Q", 2))
        obs.append(struct.unpack("<Q", w.get_from_batch_and_db(db, b"c"))[0])
        obs.append(w.get_from_batch_and_db(db, b"n"))
        obs.append(w.iterator_with_base(db))
    with s.DB.open(f"{d}/db3", s.options()) as db:
        db.put(b"a", b"1")
        db.put(b"c", b"3")
        w = s.wbwi.WriteBatchWithIndex()
        w.put(b"b", b"2")
        w.delete(b"c")
        w.put(b"d", b"4")
        obs.append(w.iterator_with_base(db))
        w.clear()
        obs.append((w.count(), w.key_set(), w.iterator_with_base(db)))
    w = s.wbwi.WriteBatchWithIndex()
    w.put(b"m", b"base")
    w.merge(b"m", b"x")
    s.raises(obs, "MergeInProgress", w.get_from_batch, b"m")
    s.raises(obs, "InvalidArgument", s.wbwi.WriteBatchWithIndex, rep="bogus")
    assert obs[0] == [b"batch-val", None, b"overridden", None]
    assert obs[3] == 15


def test_wbwi_scenarios_match_reference(tmp_path):
    both(sc_wbwi, tmp_path)


def test_wbwi_skiplist_rep_matches_list_rep_and_reference():
    """tests/test_utilities.py:1481 on both packages: 3,000 seeded puts,
    deletes and merges give the same views in every rep."""
    from toplingdb_tpu_torch import native

    if native.lib() is None:
        pytest.skip("the native library did not build")
    rng = random.Random(2)
    ops = [(rng.choice("PPDMS"), b"k%03d" % rng.randrange(150),
            b"v%04d" % i) for i in range(3000)]
    views = {}
    for pkg, mod, mop in (("ref", ref_wbwi, ref_mo), ("port", wbwi, mo)):
        for rep in ("list", "skiplist"):
            w = mod.WriteBatchWithIndex(mop.StringAppendOperator(), rep=rep)
            for op, k, v in ops:
                if op == "P":
                    w.put(k, v)
                elif op == "D":
                    w.delete(k)
                elif op == "S":
                    w.single_delete(k)
                else:
                    w.merge(k, v)
            views[(pkg, rep)] = ({k: w.get_from_batch(k)
                                  for k in w.key_set()}, w.key_set(),
                                 w.batch.data())
    first = views[("ref", "list")]
    assert all(v == first for v in views.values())


# -- option migration -------------------------------------------------------


def sc_option_migration(s, d, obs):                 # test_utilities:1330
    path = f"{d}/db"
    leveled = s.options(compaction_style="leveled",
                        disable_auto_compactions=True)
    with s.DB.open(path, leveled) as db:
        for i in range(3000):
            db.put(b"key%05d" % i, b"v%05d" % i)
        db.flush()
        db.compact_range()
    fifo = s.options(compaction_style="fifo", disable_auto_compactions=True)
    s.mig.migrate_options(path, leveled, fifo)
    with s.DB.open(path, fifo) as db:
        v = db.versions.current
        obs.append([len(v.files[lvl]) > 0 for lvl in range(v.num_levels)])
        obs.append(db.get(b"key01500"))
    uni = s.options(compaction_style="universal",
                    disable_auto_compactions=True)
    s.mig.migrate_options(path, fifo, uni)
    with s.DB.open(path, uni) as db:
        obs.append((db.get(b"key02999"), len(scan(db))))
    assert obs[0][0] and not any(obs[0][1:])
    assert obs[1:] == [b"v01500", (b"v02999", 3000)]


def test_option_migration_matches_reference(tmp_path):
    both(sc_option_migration, tmp_path)


# -- flow control -------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_rate_limiter_enforces_rate(pkg):           # test_utilities:510, :635
    mod = ref_rl if pkg == "ref" else rl
    r = mod.RateLimiter(1_000_000)
    t0 = time.monotonic()
    for _ in range(5):
        r.request(100_000)
    assert r.total_through == 500_000
    assert time.monotonic() - t0 >= 0.25
    r2 = mod.RateLimiter(1_000_000, refill_period_us=50_000)
    t0 = time.monotonic()
    r2.request(500_000)
    assert time.monotonic() - t0 >= 0.3
    # try_request: admits against the accumulated budget and carries debt.
    r3 = mod.RateLimiter(100_000, refill_period_us=100_000)
    assert r3.try_request(20_000, timeout=0.0) is True
    assert r3._available < 0
    assert r3.try_request(5_000, timeout=0.0) is False
    assert r3.try_request(5_000, timeout=1.0) is True
    assert r3.total_through == 25_000


def test_rate_limiter_and_controller_match_reference():
    """The same sequence of calls leaves both packages' objects in the same
    state (budgets, counts, stop / delay flags)."""
    states = {}
    for pkg, mod in (("ref", ref_rl), ("port", rl)):
        r = mod.RateLimiter(10_000_000, refill_period_us=10_000)
        r.request(250_000)
        got = [r.total_through, r.rate, r._period]
        wc = mod.WriteController()
        wc.stop_writes()
        out = []

        def waiter(wc=wc, out=out):
            wc.wait_if_stalled(0, timeout=5.0)
            out.append("resumed")

        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.1)
        got.append(list(out))
        wc.resume_writes()
        th.join()
        got.append(list(out))
        got.append(wc.total_stall_micros > 50_000)
        wc.set_delay(1_000_000)
        t0 = time.monotonic()
        wc.wait_if_stalled(100_000)
        got.append(time.monotonic() - t0 >= 0.09)
        wc.wait_if_stalled(10 ** 9, timeout=0.0)   # the delay caps at 1 s
        wbm = mod.WriteBufferManager(1000)
        wbm.reserve(600)
        got.append(wbm.should_flush())
        wbm.reserve(600)
        got.append(wbm.should_flush())
        wbm.free(900)
        got.append(wbm.should_flush())
        states[pkg] = got
    assert states["port"] == states["ref"]
    assert states["port"][3:] == [[], ["resumed"], True, True, False, True,
                                  False]
