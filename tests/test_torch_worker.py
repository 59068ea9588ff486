"""The dcompact worker of toplingdb_tpu_torch (compaction/worker.py)
against toplingdb_tpu's: one job dir written with the reference's
CompactionParams.to_json() over reference-written snappy inputs, run by
both packages' run_job on two copies of it (the reference on JAX's CPU
backend). The output SST bytes, results.json's status and output_files
(every field) and the key set of its stats must be equal. Tolerance:
bitwise. Also: jobs with a prefix extractor, collectors or zip outputs
through both workers, the job the port refuses (a store_spec that names
no store backend) failing with rc 1, an error status and no output, the
heartbeat of a
leased job, and the CLI in a subprocess."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from toplingdb_tpu.compaction import worker as ref_worker
from toplingdb_tpu.compaction.executor import (
    CompactionParams as RefParams,
)
from toplingdb_tpu.db import dbformat as ref_dbformat
from toplingdb_tpu.db.dbformat import ValueType, make_internal_key
from toplingdb_tpu.env import default_env
from toplingdb_tpu.table import format as ref_fmt
from toplingdb_tpu.table.builder import TableBuilder, TableOptions as RefTO

from toplingdb_tpu_torch.compaction import worker
from toplingdb_tpu_torch.compaction.executor import (
    CompactionParams,
    CompactionResults,
    decode_file_meta,
    encode_file_meta,
)
from toplingdb_tpu_torch.compaction.resilience import (
    HEARTBEAT_FILE,
    LEASE_FILE,
    write_lease,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPARATORS = {
    "bytewise": ref_dbformat.BYTEWISE,
    "reverse": ref_dbformat.REVERSE_BYTEWISE,
    "u64ts": ref_dbformat.U64_TS_BYTEWISE,
}


def write_inputs(dbdir, seed, comparator="bytewise", n_files=3,
                 per_file=400, merge_rows=0, p_empty=0.0,
                 codec=ref_fmt.SNAPPY_COMPRESSION, tombstone=True):
    """Input SSTs written with the JAX package's TableBuilder under the
    named comparator: overwrites, 10% deletions, `merge_rows` MERGE rows
    per file, a share `p_empty` of empty values, and (bytewise,
    `tombstone`) a range tombstone in the last file. Returns the input
    paths."""
    ucmp = COMPARATORS[comparator]
    icmp = ref_dbformat.InternalKeyComparator(ucmp)
    env = default_env()
    topts = RefTO(block_size=512, compression=codec)
    rng = np.random.default_rng(seed)
    paths, seq = [], 1
    for fnum in range(11, 11 + n_files):
        entries = []
        for i in range(per_file):
            k = int(rng.integers(0, per_file))
            uk = (ref_dbformat.encode_ts_key(b"key%05d" % k, 100 + i % 3)
                  if comparator == "u64ts" else b"key%05d" % k)
            t = (ValueType.DELETION if rng.random() < 0.1
                 else ValueType.VALUE)
            v = b"" if rng.random() < p_empty else b"val%06d" % seq
            if i < merge_rows:
                t, v = ValueType.MERGE, b"op%06d" % seq
            entries.append((make_internal_key(uk, seq, t), v))
            seq += 1
        entries.sort(key=lambda kv: icmp.sort_key(kv[0]))
        path = os.path.join(dbdir, "%06d.sst" % fnum)
        w = env.new_writable_file(path)
        b = TableBuilder(w, icmp, topts)
        for k, v in entries:
            b.add(k, v)
        if (tombstone and fnum == 10 + n_files
                and comparator == "bytewise"):
            b.add_tombstone(make_internal_key(b"key00050", seq,
                                              ValueType.RANGE_DELETION),
                            b"key00080")
            seq += 1
        b.finish()
        w.close()
        paths.append(path)
    return paths


def write_job(root, inputs, comparator="bytewise", **kw):
    """One job dir, written by the reference's CompactionParams."""
    job = os.path.join(root, "job")
    os.makedirs(os.path.join(job, "out"))
    fields = dict(
        job_id=7, attempt=1, dbname=os.path.dirname(inputs[0]),
        output_dir=os.path.join(job, "out"), input_files=inputs,
        output_level=2, bottommost=True, max_output_file_size=6 * 1024,
        snapshots=[300], comparator=COMPARATORS[comparator].name(),
        merge_operator=None, compaction_filter=None,
        compression=ref_fmt.SNAPPY_COMPRESSION, block_size=512,
        creation_time=1234, device="cpu", lease_sec=0.0)
    fields.update(kw)
    with open(os.path.join(job, "params.json"), "w") as f:
        f.write(RefParams(**fields).to_json())
    return job


def copy_job(job, name):
    """A copy of the job dir whose params point at its own output dir.
    Its params.json is dated 5 s back, so every worker sees a queue wait
    (the compaction.queue_wait span)."""
    import time

    dst = os.path.join(os.path.dirname(job), name)
    shutil.copytree(job, dst)
    p = os.path.join(dst, "params.json")
    d = json.load(open(p))
    d["output_dir"] = os.path.join(dst, "out")
    json.dump(d, open(p, "w"), indent=1)
    os.utime(p, (time.time() - 5, time.time() - 5))
    return dst


def run_both(job):
    """The reference's run_job and the port's on two copies of `job`;
    returns ((rc, results, output bytes) for the reference, the same for
    the port)."""
    out = []
    for name, fn in (("ref", ref_worker.main), ("port", worker.main)):
        d = copy_job(job, name)
        rc = fn(["--job-dir", d])
        res = json.load(open(os.path.join(d, "results.json")))
        files = {f["path"]: open(os.path.join(d, "out", f["path"]),
                                 "rb").read()
                 for f in res["output_files"]}
        out.append((rc, res, files))
    return out


def assert_same_job(ref, port):
    (rrc, rres, rfiles), (prc, pres, pfiles) = ref, port
    assert prc == rrc
    assert pres["status"] == rres["status"]
    assert pres["output_files"] == rres["output_files"]
    assert pfiles == rfiles
    assert set(pres["stats"]) == set(rres["stats"])


@pytest.mark.parametrize("tombstone", [False, True])
@pytest.mark.parametrize("device", ["cpu-jax", "cpu"])
def test_worker_matches_reference(tmp_path, device, tombstone):
    """Without a range tombstone the outputs are cut at 6 KiB; with one
    that survives there is one output holding it."""
    inputs = write_inputs(str(tmp_path), seed=1, tombstone=tombstone)
    job = write_job(str(tmp_path), inputs, device=device)
    ref, port = run_both(job)
    assert ref[0] == 0 and ref[1]["status"] == "ok"
    outs = port[1]["output_files"]
    if tombstone:
        assert len(outs) == 1 and outs[0]["num_range_deletions"]
    else:
        assert len(outs) > 1  # output cutting exercised
    assert_same_job(ref, port)


@pytest.mark.parametrize("device", ["cpu-jax", "cpu"])
def test_worker_merge_operator_and_filter_by_name(tmp_path, device):
    """A merge operator and a compaction filter travel by registry name."""
    inputs = write_inputs(str(tmp_path), seed=2, merge_rows=40,
                          p_empty=0.2)
    job = write_job(str(tmp_path), inputs, device=device,
                    merge_operator="StringAppendOperator",
                    compaction_filter="RemoveEmptyValueCompactionFilter")
    ref, port = run_both(job)
    assert ref[0] == 0
    assert_same_job(ref, port)


@pytest.mark.parametrize("comparator", ["bytewise", "reverse", "u64ts"])
@pytest.mark.parametrize("device", ["cpu-jax", "cpu"])
def test_worker_comparators(tmp_path, comparator, device):
    """Each comparator by name. The non-bytewise ones take the per-entry
    branch: the CompactionIterator for "cpu", the device stream for
    "cpu-jax". The device stream refuses the reverse comparator on both
    sides (rc 1, the same status). The port's admits the u64-timestamp
    one, whose stored-byte order is bytewise, where the reference's
    refuses it and its executor runs such a job on the host path: the
    port's outputs equal the reference's "cpu" run of the same job."""
    inputs = write_inputs(str(tmp_path), seed=3, comparator=comparator)
    job = write_job(str(tmp_path), inputs, comparator=comparator,
                    device=device)
    ref, port = run_both(job)
    if comparator == "u64ts" and device == "cpu-jax":
        assert ref[0] == 1 and "bytewise comparator" in ref[1]["status"]
        host = write_job(str(tmp_path / "host"), inputs,
                         comparator=comparator, device="cpu")
        ref, _ = run_both(host)
        assert ref[0] == 0
    assert_same_job(ref, port)
    if comparator != "reverse" or device == "cpu":
        assert port[0] == 0 and port[1]["output_files"]
    else:
        assert port[0] == 1
        assert "bytewise comparator" in port[1]["status"]


@pytest.mark.parametrize("device", ["cpu-jax", "cpu"])
def test_worker_trace_spans(tmp_path, device):
    """A sampled trace context: the worker adopts it and returns its
    spans, the same names as the reference's worker, under the caller's
    trace and span ids."""
    inputs = write_inputs(str(tmp_path), seed=4, per_file=3000)
    ctx = {"trace_id": "feedbeef01", "span_id": 42, "sampled": 1}
    job = write_job(str(tmp_path), inputs, device=device, trace=ctx,
                    max_output_file_size=1 << 30)
    ref, port = run_both(job)
    assert_same_job(ref, port)
    rspans, pspans = ref[1]["spans"], port[1]["spans"]
    assert sorted(s["name"] for s in pspans) == \
        sorted(s["name"] for s in rspans)
    root = [s for s in pspans if s["name"] == "dcompact.worker"]
    assert len(root) == 1 and root[0]["parent_id"] == 42
    assert {s["trace_id"] for s in pspans} == {"feedbeef01"}
    assert root[0]["proc"] == "dcompact-worker"


def test_worker_heartbeat(tmp_path):
    """lease_sec > 0: the heartbeat file is written while the job runs;
    the submitting side's lease file sits beside it."""
    inputs = write_inputs(str(tmp_path), seed=5)
    job = write_job(str(tmp_path), inputs, lease_sec=0.6)
    write_lease(job, 7, 1, 0.6)
    assert worker.run_job(job) == 0
    beat = open(os.path.join(job, HEARTBEAT_FILE)).read().split()
    assert int(beat[0]) == os.getpid() and float(beat[1]) > 0
    lease = json.load(open(os.path.join(job, LEASE_FILE)))
    assert (lease["job_id"], lease["attempt"], lease["lease_sec"]) == \
        (7, 1, 0.6)


@pytest.mark.parametrize("field,value,needle", [
    ("store_spec", "mem://store", "store_spec"),
    ("prefix_extractor", "tpulsm.FixedPrefix.4", None),
    ("collectors", [{"name": "CompactOnDeletionCollectorFactory",
                     "window_size": 16, "deletion_trigger": 3,
                     "deletion_ratio": 0.0}], None),
    ("table_format", "zip", None),
])
def test_worker_refuses_without_output(tmp_path, field, value, needle):
    """A store_spec that names no store backend (a URL scheme other than
    http(s)) is refused with rc 1 and no output. A prefix
    extractor, property collectors and the zip format, once refused the
    same way, now run: the same job dir through both workers' device data
    plane gives the same bytes."""
    inputs = write_inputs(str(tmp_path), seed=6, n_files=1 if needle else 3,
                          per_file=50 if needle else 400)
    if needle is None:
        job = write_job(str(tmp_path), inputs, device="cpu-jax",
                        **{field: value})
        ref, port = run_both(job)
        assert ref[0] == 0 and ref[1]["status"] == "ok"
        assert_same_job(ref, port)
        if field == "collectors":
            assert any(f["marked_for_compaction"]
                       for f in port[1]["output_files"])
        return
    job = write_job(str(tmp_path), inputs, **{field: value})
    assert worker.main(["--job-dir", job]) == 1
    res = json.load(open(os.path.join(job, "results.json")))
    assert res["status"].startswith("NotSupported: ")
    assert needle in res["status"]
    assert res["output_files"] == []
    assert os.listdir(os.path.join(job, "out")) == []


@pytest.mark.parametrize("device", ["gpu", "cuda:0", "CPU", ""])
def test_worker_refuses_unknown_device(tmp_path, device):
    """A device name outside the contract fails before any file is
    written; it never picks a route by itself."""
    inputs = write_inputs(str(tmp_path), seed=6, n_files=1, per_file=50)
    job = write_job(str(tmp_path), inputs, device=device)
    assert worker.main(["--job-dir", job]) == 1
    res = json.load(open(os.path.join(job, "results.json")))
    assert res["status"].startswith("ValueError: ")
    assert f"unknown device {device!r}" in res["status"]
    assert res["output_files"] == []
    assert os.listdir(os.path.join(job, "out")) == []


def test_params_default_to_the_card():
    """A job built in Python without a device runs on the card."""
    p = CompactionParams(
        job_id=1, attempt=1, dbname="/d", output_dir="/o", input_files=[],
        output_level=1, bottommost=True, max_output_file_size=1,
        snapshots=[], comparator="c", merge_operator=None,
        compaction_filter=None, compression=0, block_size=4096,
        creation_time=0)
    assert p.device == "cuda"
    assert worker._DEVICE_NAMES[p.device] == "cuda"


def test_cuda_device_needs_a_card(tmp_path):
    """"cuda", "tpu" and "device" run on the card; without one the job
    fails and writes nothing (no fallback to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs it")
    inputs = write_inputs(str(tmp_path), seed=7, n_files=1, per_file=50)
    for i, device in enumerate(("cuda", "tpu", "device")):
        job = write_job(os.path.join(str(tmp_path), str(i)), inputs,
                        device=device)
        assert worker.main(["--job-dir", job]) == 1
        res = json.load(open(os.path.join(job, "results.json")))
        assert "no CUDA device" in res["status"]
        assert os.listdir(os.path.join(job, "out")) == []


def test_job_boundary_round_trips():
    """Params and results cross between the packages as JSON, and file
    metadata through encode/decode_file_meta."""
    from toplingdb_tpu.compaction.executor import (
        CompactionResults as RefResults,
    )
    from toplingdb_tpu.db.version_edit import FileMetaData as RefMeta

    p = RefParams(job_id=1, attempt=2, dbname="/d", output_dir="/o",
                  input_files=["/d/000001.sst"], output_level=3,
                  bottommost=False, max_output_file_size=99,
                  snapshots=[5, 9], comparator="c", merge_operator="m",
                  compaction_filter=None, compression=7, block_size=4096,
                  creation_time=11, device="cuda", lease_sec=2.5,
                  trace={"trace_id": "t", "span_id": 1, "sampled": 1})
    mine = CompactionParams.from_json(p.to_json())
    assert mine.to_json() == p.to_json()
    assert RefParams.from_json(mine.to_json()) == p
    r = CompactionResults(status="ok", output_files=[{"path": "x"}],
                          stats={"a": 1}, work_time_usec=5)
    assert RefResults.from_json(r.to_json()).to_json() == r.to_json()
    meta = RefMeta(number=4, file_size=100, smallest=b"a" * 9,
                   largest=b"b" * 9, smallest_seqno=1, largest_seqno=8,
                   num_entries=3, num_deletions=1, num_range_deletions=1,
                   blob_refs=[12], marked_for_compaction=True)
    from toplingdb_tpu.compaction.executor import (
        decode_file_meta as ref_decode,
        encode_file_meta as ref_encode,
    )

    d = ref_encode(meta, "000004.sst")
    assert encode_file_meta(decode_file_meta(d, 4), "000004.sst") == d
    assert ref_decode(encode_file_meta(decode_file_meta(d, 4),
                                       "000004.sst"), 4) == meta


def test_cli_subprocess(tmp_path):
    """python -m toplingdb_tpu_torch.compaction.worker --job-dir DIR in a
    subprocess writes the bytes an in-process run_job writes."""
    inputs = write_inputs(str(tmp_path), seed=8)
    job = write_job(str(tmp_path), inputs, device="cpu-jax")
    twin = copy_job(job, "twin")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "toplingdb_tpu_torch.compaction.worker",
         "--job-dir", job], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert worker.run_job(twin) == 0
    a = json.load(open(os.path.join(job, "results.json")))
    b = json.load(open(os.path.join(twin, "results.json")))
    assert a["status"] == b["status"] == "ok"
    assert a["output_files"] == b["output_files"]
    for f in a["output_files"]:
        assert open(os.path.join(job, "out", f["path"]), "rb").read() == \
            open(os.path.join(twin, "out", f["path"]), "rb").read()
