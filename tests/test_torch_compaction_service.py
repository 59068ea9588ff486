"""The CompactionService of toplingdb_tpu_torch against toplingdb_tpu's,
on the CPU.

- the 4 cases of tests/test_compaction_service.py on the port (the worker
  side with its in-band errors, the executor end to end, the subprocess
  transport, a non-default column family), the jobs on the port's
  "cpu-jax" device (the data plane on the kernels' plain versions) where
  the reference runs its host path;
- open_and_compact on one DB written by the reference: the port's "cpu"
  worker (the host path) writes the reference's bytes, and "cpu-jax" the
  reference's entries; an unknown device fails the job in band;
- no fallback: a failed service job raises, becomes the scheduler's
  last_error and the DB's background error, and leaves no output under
  the job root; the factory refuses an unknown device and has no
  allow_fallback.

Tolerance: none.
"""

import os

import pytest

import toplingdb_tpu.compaction.compaction_service as ref_cs
import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.options import Options as RefOptions

import toplingdb_tpu_torch.compaction.compaction_service as cs
import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.table.factory import open_table


def _opts(**kw):
    return Options(compaction_executor_factory=(
        DeviceCompactionExecutorFactory(device="cpu")), **kw)


def _fill(DB, opts, path, n=3000, overwrite=2000):
    db = DB.open(path, opts(write_buffer_size=1 << 14,
                            disable_auto_compactions=True))
    for i in range(n):
        db.put(b"key%05d" % (i % overwrite), b"val%06d" % i)
    db.delete(b"key00007")
    db.flush()
    return db


def _entries(out_dir, files):
    icmp = InternalKeyComparator()
    rows = []
    for d in files:
        r = open_table(PosixEnv().new_random_access_file(
            os.path.join(out_dir, d["path"])), icmp)
        it = r.new_iterator()
        it.seek_to_first()
        rows.extend(it.entries())
    return rows


def _input(nums, device, **kw):
    return cs.CompactionServiceInput(
        cf_name="default", input_files=nums, output_level=2,
        bottommost=True, snapshots=[], max_output_file_size=1 << 62,
        creation_time=1_700_000_000, device=device, **kw)


def test_open_and_compact_worker_side(tmp_path):
    """tests/test_compaction_service.py:25 on the port's "cpu-jax" worker,
    and the in-band errors: an unknown file, an unknown CF, an unknown
    device."""
    dbp, outp = str(tmp_path / "db"), str(tmp_path / "out")
    db = _fill(dbm.DB, _opts, dbp)
    nums = [f.number for f in db.versions.cf_current(0).files[0]]
    assert len(nums) >= 2
    db.close()
    res = cs.CompactionServiceResult.from_json(
        cs.open_and_compact(dbp, outp, _input(nums, "cpu-jax").to_json()))
    assert res.status == "ok", res.status
    assert res.output_files and res.bytes_written > 0
    for d in res.output_files:
        assert os.path.exists(os.path.join(outp, d["path"]))
    assert not any(f.startswith("service") for f in os.listdir(dbp))
    rows = _entries(outp, res.output_files)
    assert len(rows) == 1999 and rows[0][0][:8] == b"key00000"
    for inp, needle in ((_input([999999], "cpu-jax"), "999999"),
                        (_input(nums, "cpu-jax", ), None),
                        (_input(nums, "gpu7"), "unknown device")):
        if needle is None:
            inp.cf_name = "nope"
        r = cs.CompactionServiceResult.from_json(
            cs.open_and_compact(dbp, str(tmp_path / "out2"), inp.to_json()))
        assert r.status != "ok" and r.output_files == []
        if needle:
            assert needle in r.status, r.status
    assert cs.CompactionServiceInput(
        cf_name="x", input_files=[], output_level=1, bottommost=False,
        snapshots=[], max_output_file_size=1).device == "cuda"


def test_worker_entries_equal_reference(tmp_path):
    """One DB written by the reference: its open_and_compact and the port's
    on "cpu" write the same bytes; the port's "cpu-jax" job writes the
    same entries."""
    dbp = str(tmp_path / "db")
    db = _fill(ref_dbm.DB, RefOptions, dbp, n=4000, overwrite=1500)
    snap = db.get_snapshot()
    for i in range(0, 1500, 3):
        db.put(b"key%05d" % i, b"late%05d" % i)
    db.delete(b"key00010")
    db.flush()
    nums = [f.number for f in db.versions.cf_current(0).files[0]]
    seq = snap.sequence
    db.close()
    out = {}
    for tag, mod, device in (("ref", ref_cs, "cpu"), ("cpu", cs, "cpu"),
                             ("cpu-jax", cs, "cpu-jax")):
        inp = mod.CompactionServiceInput(
            cf_name="default", input_files=nums, output_level=3,
            bottommost=False, snapshots=[seq], max_output_file_size=1 << 62,
            creation_time=1_700_000_000, device=device)
        o = str(tmp_path / f"out-{tag}")
        res = mod.CompactionServiceResult.from_json(
            mod.open_and_compact(dbp, o, inp.to_json()))
        assert res.status == "ok", (tag, res.status)
        out[tag] = (res, o)
    rows = {t: _entries(o, r.output_files) for t, (r, o) in out.items()}
    assert rows["cpu"] == rows["ref"] and rows["cpu-jax"] == rows["ref"]
    assert any(k[-8:] != b"\x00" * 8 for k, _ in rows["ref"])  # snapshot kept

    def file_bytes(tag):
        r, o = out[tag]
        return [open(os.path.join(o, d["path"]), "rb").read()
                for d in r.output_files]

    assert file_bytes("cpu") == file_bytes("ref")


def test_service_executor_end_to_end(tmp_path):
    """tests/test_compaction_service.py:74: the DB routes its compaction
    through the service (device "cpu-jax"); outputs install under
    DB-allocated numbers; reads equal the reference's same run."""
    seen = {}
    for tag in ("ref", "port"):
        dbp = str(tmp_path / tag)
        if tag == "ref":
            svc = ref_cs.InProcessCompactionService()
            db = _fill(ref_dbm.DB, RefOptions, dbp)
            db.close()
            o = RefOptions(disable_auto_compactions=True,
                           compaction_executor_factory=(
                               ref_cs.CompactionServiceExecutorFactory(svc)))
            DB = ref_dbm.DB
        else:
            svc = cs.InProcessCompactionService()
            db = _fill(dbm.DB, _opts, dbp)
            db.close()
            o = Options(disable_auto_compactions=True,
                        compaction_executor_factory=(
                            cs.CompactionServiceExecutorFactory(
                                svc, device="cpu-jax")))
            DB = dbm.DB
        db = DB.open(dbp, o)
        db.compact_range()
        assert svc.jobs >= 1
        got = [db.get(b"key00007"), db.get(b"key00008"), db.get(b"key01999")]
        assert got[0] is None and got[2] == b"val%06d" % 1999
        assert not db.versions.cf_current(0).files[0]
        it = db.new_iterator()
        it.seek_to_first()
        seen[tag] = (got, list(it.entries()), svc.jobs)
        db.close()
        db = DB.open(dbp, o if tag == "ref" else _opts())
        assert db.get(b"key00008") is not None
        db.close()
        assert os.listdir(os.path.join(dbp, "service_jobs")) == []
    assert seen["port"] == seen["ref"]


def test_service_subprocess_transport(tmp_path):
    """tests/test_compaction_service.py:101: one job through the CLI
    (python -m toplingdb_tpu_torch.compaction.compaction_service) on
    "cpu", exit code 0, the in-process job's entries."""
    dbp = str(tmp_path / "db")
    db = _fill(dbm.DB, _opts, dbp, n=800, overwrite=500)
    nums = [f.number for f in db.versions.cf_current(0).files[0]]
    db.close()
    svc = cs.SubprocessCompactionService()
    res = cs.CompactionServiceResult.from_json(svc(
        dbp, str(tmp_path / "out"), _input(nums, "cpu").to_json()))
    assert res.status == "ok", res.status
    assert res.output_files and svc.returncodes == [0]
    res2 = cs.CompactionServiceResult.from_json(cs.open_and_compact(
        dbp, str(tmp_path / "out2"), _input(nums, "cpu").to_json()))
    assert _entries(str(tmp_path / "out"), res.output_files) == \
        _entries(str(tmp_path / "out2"), res2.output_files)
    assert cs.main(["only-one-arg"]) == 2


def test_service_executor_non_default_cf(tmp_path):
    """tests/test_compaction_service.py:119: jobs carry their column
    family; a mix-up fails (there is no fallback to mask it)."""
    dbp = str(tmp_path / "db")
    svc = cs.InProcessCompactionService()
    db = dbm.DB.open(dbp, _opts(write_buffer_size=1 << 14,
                                disable_auto_compactions=True))
    cf = db.create_column_family("meta")
    for i in range(2000):
        db.put(b"m%05d" % (i % 900), b"val%06d" % i, cf=cf)
    db.flush()
    db.close()
    db = dbm.DB.open(dbp, Options(
        disable_auto_compactions=True,
        compaction_executor_factory=cs.CompactionServiceExecutorFactory(
            svc, device="cpu-jax")))
    cf = db.get_column_family("meta")
    db.compact_range()
    assert svc.jobs >= 1
    assert db.get(b"m00899", cf=cf) == b"val%06d" % 1799
    assert not db.versions.cf_current(cf.id).files[0]
    assert db._compaction_scheduler.last_error is None
    db.close()


class _FailingService:
    """Writes a partial output into the job's dir, then reports a failure
    (or raises)."""

    def __init__(self, mode):
        self.mode = mode
        self.jobs = 0

    def __call__(self, dbname, output_dir, input_json):
        self.jobs += 1
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "000001.sst"), "wb") as f:
            f.write(b"\x00" * 4096)
        if self.mode == "raise":
            raise OSError("transport lost")
        return cs.CompactionServiceResult(
            status="IOError: worker died", output_files=[]).to_json()


@pytest.mark.parametrize("mode", ["status", "raise"])
def test_failed_service_job_raises_and_latches(tmp_path, mode):
    """A background job that fails becomes the scheduler's last_error and
    the DB's background error; a manual one raises to the caller. Neither
    leaves an output under the job root or installs a file, and no job
    runs on the host."""
    dbp = str(tmp_path / "db")
    db = _fill(dbm.DB, _opts, dbp)
    db.close()
    svc = _FailingService(mode)
    root = str(tmp_path / "jobs")
    factory = cs.CompactionServiceExecutorFactory(svc, job_root=root,
                                                  device="cpu-jax")
    db = dbm.DB.open(dbp, Options(level0_file_num_compaction_trigger=2,
                                  compaction_executor_factory=factory))
    with pytest.raises(Exception, match="background error"):
        db.wait_for_compactions()
    err = db._compaction_scheduler.last_error
    assert svc.jobs >= 1 and err is not None
    assert db._bg_error is not None
    assert ("worker died" in str(err)) if mode == "status" else \
        ("transport lost" in str(err))
    assert os.listdir(root) == [], os.listdir(root)
    assert db._compaction_scheduler.num_local_jobs == 0
    db.close()
    db = dbm.DB.open(dbp, Options(disable_auto_compactions=True,
                                  compaction_executor_factory=factory))
    before = sorted(f for f in os.listdir(dbp) if f.endswith(".sst"))
    jobs = svc.jobs
    with pytest.raises(Exception, match="worker died" if mode == "status"
                       else "transport lost"):
        db.compact_range()
    assert svc.jobs > jobs   # every attempt of the retry policy failed
    assert os.listdir(root) == []
    assert sorted(f for f in os.listdir(dbp) if f.endswith(".sst")) == before
    assert db._compaction_scheduler.num_local_jobs == 0
    db.close()


def test_factory_refuses_unknown_device_and_fallback():
    with pytest.raises(ValueError):
        cs.CompactionServiceExecutorFactory(device="tpu-v9")
    with pytest.raises(TypeError):
        cs.CompactionServiceExecutorFactory(allow_fallback=True)
    f = cs.CompactionServiceExecutorFactory()
    assert f.device == "cuda" and not hasattr(f, "allow_fallback_to_local")
    assert f.job_url(3, 1) == "service://job-00003/att-01"
