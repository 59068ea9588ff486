"""The mesh route of toplingdb_tpu_torch (ops/mesh_compaction.py,
parallel/mesh_plan.py, compaction/dcompact_service.ChipPool,
parallel/scaling_probe.py) against toplingdb_tpu's, on the CPU, with fake
device lists ([cpu, cpu]; the reference runs on two of the 8 virtual JAX
CPU devices tests/conftest.py gives, its knobs set with monkeypatch).

Mirrors tests/test_mesh_compaction.py: byte parity (:43; block and zip,
none and zstd, a surviving range tombstone and snapshots), one wedged
entry and every entry wedged (:87; and the job's own device failing
too, which raises), the pipelined plane (:129), the eligibility matrix
(:156), the gating (:190), the tickers (:213), ChipPool (:237, :270), the
service's card metrics (:285) and the probe's exit codes (:312); and a
job through a `--chips 2` service running over its grant. Tolerance:
none (byte-identical files, equal reasons and grants).
"""

import json
import os
import urllib.request

import pytest

from toplingdb_tpu.compaction.dcompact_service import ChipPool as RefPool
from toplingdb_tpu.ops import device_compaction as ref_dc
from toplingdb_tpu.parallel import mesh_plan as ref_mp
from toplingdb_tpu.table import format as ref_fmt
from toplingdb_tpu.utils import codecs as ref_codecs

from toplingdb_tpu_torch.compaction import dcompact_service as svc_mod
from toplingdb_tpu_torch.compaction.compaction_job import CompactionStats
from toplingdb_tpu_torch.compaction.scheduler import CompactionScheduler
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.ops import mesh_compaction as mc
from toplingdb_tpu_torch.parallel import mesh_plan, scaling_probe
from toplingdb_tpu_torch.utils import statistics as st

import test_torch_pipeline as tp

N = 9000
CPU2 = ["cpu", "cpu"]


@pytest.fixture
def small_mesh(monkeypatch):
    """Both packages' serial routes in 4 shards at test size, the mesh
    row floor at 1; the reference's mesh knob stays off until a test
    turns it on."""
    monkeypatch.setattr(ref_dc, "_SHARD_MIN_ROWS", 1)
    monkeypatch.setattr(dc, "_SHARD_MIN_ROWS", 1)
    monkeypatch.setattr(mesh_plan, "DEFAULT_MESH_MIN_ROWS", 1)
    monkeypatch.setenv("TPULSM_DEVICE_SHARDS", "4")
    monkeypatch.setenv("TPULSM_MESH_MIN_ROWS", "1")
    monkeypatch.setenv("TPULSM_MESH_DEVICES", "2")
    monkeypatch.setenv("TPULSM_PIPELINE", "0")
    monkeypatch.delenv("TPULSM_MESH_COMPACT", raising=False)
    monkeypatch.delenv("TPULSM_HOST_SORT", raising=False)
    return monkeypatch


def _topts(fmt_name, codec):
    comp = {"none": ref_fmt.NO_COMPRESSION,
            "zstd": ref_fmt.ZSTD_COMPRESSION}[codec]
    ref = (tp.RefTO(block_size=tp.BLOCK, compression=comp)
           if fmt_name == "block" else
           tp.RefTO(format="zip", compression=comp))
    return ref, tp.table_options_from_plain(tp.plain_options(ref))


def _run_ref(dbdir, metas, snaps, ref_topts, base):
    c = tp.RefCompaction(level=0, output_level=2, inputs=list(metas),
                         bottommost=True, max_output_file_size=1 << 30)
    tc = tp.RefTableCache(tp.default_env(), dbdir, tp.REF_ICMP,
                          tp.RefTO(block_size=tp.BLOCK))
    return tp.ref_dc.run_device_compaction(
        tp.default_env(), dbdir, tp.REF_ICMP, c, tc, ref_topts, snaps,
        new_file_number=tp.allocator(base), creation_time=7,
        device_name="cpu")


def _run_port(dbdir, metas, snaps, topts, base, **kw):
    import dataclasses

    inputs = [tp.FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = tp.Compaction(level=0, output_level=2, inputs=inputs,
                      bottommost=True, max_output_file_size=1 << 30)
    tc = tp.TableCache(tp.PosixEnv(), dbdir, tp.ICMP, _topts("block",
                                                             "none")[1])
    kw.setdefault("pipeline", False)
    kw.setdefault("num_shards", 4)
    return dc.run_device_compaction(
        tp.PosixEnv(), dbdir, tp.ICMP, c, tc, topts, snaps,
        new_file_number=tp.allocator(base), creation_time=7,
        device_name="cpu", **kw)


@pytest.mark.parametrize("fmt_name,codec", [
    ("block", "none"), ("block", "zstd"), ("zip", "none"), ("zip", "zstd")])
def test_mesh_byte_parity(tmp_path, small_mesh, fmt_name, codec):
    """:43: the mesh route's bytes equal the single-device route's and
    the reference's mesh bytes, with a surviving range tombstone and
    live snapshots."""
    if codec != "none" and not ref_codecs.available(codec):
        pytest.skip(f"{codec} unavailable")
    ref_topts, topts = _topts(fmt_name, codec)
    dbdir = str(tmp_path)
    metas = tp.build_runs(dbdir, N, seed=3, tombstone_file=True)
    snaps = [N // 3, 2 * N // 3]
    single, sstats = _run_port(dbdir, metas, snaps, topts, 1000)
    assert sstats.mesh_chips == 0 and sstats.mesh_fallbacks == 0
    mesh, stats = _run_port(dbdir, metas, snaps, topts, 2000,
                            mesh_devices=CPU2)
    small_mesh.setenv("TPULSM_MESH_COMPACT", "1")
    ref_outs, ref_stats = _run_ref(dbdir, metas, snaps, ref_topts, 3000)
    assert (stats.mesh_chips, stats.mesh_shards) == \
        (ref_stats.mesh_chips, ref_stats.mesh_shards) == (2, 4)
    assert CompactionScheduler._compaction_mode(stats) == "mesh"
    assert len(single) == len(mesh) >= 1
    assert tp.read_bytes(dbdir, mesh) == tp.read_bytes(dbdir, single)
    assert tp.read_bytes(dbdir, mesh) == tp.read_bytes(dbdir, ref_outs)


@pytest.mark.parametrize("kill", [1, 2, 3])
def test_mesh_chip_failure_demotion(tmp_path, small_mesh, monkeypatch,
                                    kill):
    """:87: one wedged entry (kill=1) moves its shards to the other; both
    wedged (kill=2) move them to the job's own device; the same bytes,
    demotions counted. kill=3: the job's device fails too and the job
    raises."""
    _ref, topts = _topts("block", "none")
    dbdir = str(tmp_path)
    metas = tp.build_runs(dbdir, N, seed=4, tombstone_file=True)
    snaps = [N // 2]
    single, _ = _run_port(dbdir, metas, snaps, topts, 1000)
    calls = []

    def hook(s, device):
        calls.append((s, str(device)))
        if len(calls) <= kill:
            raise RuntimeError("chip down")

    monkeypatch.setattr(mc, "_FAULT_HOOK", hook)
    if kill == 3:
        before = set(os.listdir(dbdir))
        with pytest.raises(RuntimeError, match="chip down"):
            _run_port(dbdir, metas, snaps, topts, 2000, mesh_devices=CPU2)
        assert set(os.listdir(dbdir)) == before
        return
    mesh, stats = _run_port(dbdir, metas, snaps, topts, 2000,
                            mesh_devices=CPU2)
    assert stats.mesh_fallbacks == kill
    assert stats.mesh_chips == 1
    assert tp.read_bytes(dbdir, mesh) == tp.read_bytes(dbdir, single)


@pytest.mark.parametrize("wedge", [False, True])
def test_mesh_pipeline_parity(tmp_path, small_mesh, monkeypatch, wedge):
    """:129: the pipelined compute stage places shards over the entries
    (UPLOAD_DEPTH each) with the bytes of the mesh-off pipeline and of
    the reference's pipelined mesh; a wedge at shard 1 demotes the rest
    of the job to its device with the same bytes."""
    monkeypatch.setattr(tp.ref_pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.setattr(tp.pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.setenv("TPULSM_PIPELINE", "1")
    monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "4")
    ref_topts, topts = _topts("block", "none")
    dbdir = str(tmp_path)
    metas = tp.build_runs(dbdir, N, seed=5, tombstone_file=True)
    snaps = [N // 3]
    single, sstats = _run_port(dbdir, metas, snaps, topts, 1000,
                               pipeline=True, pipeline_shards=4)
    if wedge:
        monkeypatch.setattr(mc, "_FAULT_HOOK", lambda s, d: (
            s == 1 and _raise()))
    mesh, stats = _run_port(dbdir, metas, snaps, topts, 2000,
                            pipeline=True, pipeline_shards=4,
                            mesh_devices=CPU2)
    monkeypatch.setenv("TPULSM_MESH_COMPACT", "1")
    monkeypatch.setattr(mc, "_FAULT_HOOK", None)
    ref_outs, ref_stats = _run_ref(dbdir, metas, snaps, ref_topts, 3000)
    assert sstats.pipelined and stats.pipelined and ref_stats.pipelined
    assert stats.mesh_chips == (1 if wedge else 2)
    assert stats.mesh_fallbacks == (1 if wedge else 0)
    assert ref_stats.mesh_chips == 2
    assert tp.read_bytes(dbdir, mesh) == tp.read_bytes(dbdir, single)
    assert tp.read_bytes(dbdir, mesh) == tp.read_bytes(dbdir, ref_outs)


def _raise():
    raise RuntimeError("chip down")


def test_eligibility_matrix():
    """:156: every reason of the one fallback matrix, equal to the
    reference's on the same shards, and the plan's shape."""
    devs = ["d0", "d1", "d2"]
    shards = mesh_plan._make_uniform_shards(4, 64, key_len=20)
    ref_shards = ref_mp._make_uniform_shards(4, 64, key_len=20)
    for args, kw in (((None, False, devs), {}),
                     (([], False, devs), {}),
                     (("1", False, devs), dict(min_rows=1)),
                     (("all", True, devs), dict(min_rows=1)),
                     (("all", False, devs), dict(min_rows=10**9)),
                     (("all", False, devs[:1]), dict(min_rows=1)),
                     (("all", False, devs), dict(min_rows=1))):
        def pick(sh):
            if isinstance(args[0], str):
                return sh[:1] if args[0] == "1" else sh
            return args[0]

        got = mesh_plan.check_eligibility(pick(shards), *args[1:], **kw)
        want = ref_mp.check_eligibility(pick(ref_shards), *args[1:], **kw)
        assert got == want
    assert mesh_plan.check_eligibility(shards, False, devs,
                                       min_rows=1) == (None, 4 * 64)
    plan, reason = mesh_plan.plan_shards(shards, devices=devs, min_rows=1)
    assert reason is None and plan.assignments == [0, 1, 2, 0]
    assert plan.n_devices == 3
    assert plan.window == mesh_plan.UPLOAD_DEPTH * 3
    plan, reason = mesh_plan.plan_shards(shards, any_complex=True,
                                         devices=devs, min_rows=1)
    assert plan is None and reason == "complex-groups"


def test_maybe_plan_gating(small_mesh):
    """:190: no device list → None and no fallback tick; an ineligible job
    → None with a tick; an eligible one → a plan and its stats."""
    shards = mesh_plan._make_uniform_shards(4, 64, key_len=20)
    stats = CompactionStats()
    assert mc.maybe_plan(shards, stats=stats) is None
    assert stats.mesh_fallbacks == 0
    assert mc.maybe_plan(shards, any_complex=True, stats=stats,
                         mesh_devices=CPU2) is None
    assert stats.mesh_fallbacks == 1
    plan = mc.maybe_plan(shards, stats=stats, mesh_devices=CPU2)
    assert plan is not None and plan.n_devices == 2
    assert stats.mesh_chips == 2 and stats.mesh_shards == 4
    assert mc.pipeline_devices(4, mesh_devices=["cpu"]) is None
    assert mc.pipeline_devices(1, mesh_devices=CPU2) is None
    assert mc.pipeline_devices(4, mesh_devices=CPU2) == CPU2


def test_mesh_statistics_tickers():
    """:213: the mesh fields of CompactionStats land on the
    DCOMPACTION_MESH_* tickers."""
    stats = st.Statistics()
    cs = CompactionStats(device="cpu")
    cs.mesh_chips, cs.mesh_shards, cs.mesh_fallbacks = 4, 16, 2
    stats.record_compaction(cs)
    t = stats.tickers()
    assert t[st.DCOMPACTION_MESH_JOBS] == 1
    assert t[st.DCOMPACTION_MESH_SHARDS] == 16
    assert t[st.DCOMPACTION_MESH_FALLBACKS] == 2
    stats2 = st.Statistics()
    stats2.record_compaction(CompactionStats(device="cpu"))
    assert st.DCOMPACTION_MESH_JOBS not in stats2.tickers()


def _pool_script(pool):
    """:237's sequence; returns every observation."""
    obs = []
    g1 = pool.admit(want=2)
    g2 = pool.admit(want=2)
    obs += [g1, g2, pool.queue_depths()]
    pool.release(g1, ok=True)
    pool.release(g2, ok=True)
    obs.append(pool.queue_depths())
    for _ in range(3):
        pool.health.record_failure("chip:0")
    g3 = pool.admit()
    obs.append(g3)
    pool.release(g3, ok=True)
    return obs


def test_chip_pool_admission_and_demotion():
    """:237: least-loaded targeting, wedge-aware demotion, failure
    feedback through the breakers, queue depths: the reference's grants."""
    got = _pool_script(svc_mod.ChipPool(4))
    assert got == _pool_script(RefPool(4))
    g1, g2 = got[0], got[1]
    assert len(g1) == len(g2) == 2 and not set(g1) & set(g2)
    assert "chip:0" not in got[4] and len(got[4]) == 3
    pool2 = svc_mod.ChipPool(2)
    for _ in range(3):
        g = pool2.admit()
        pool2.release(g, ok=False, failed_chips=set(g))
    assert pool2.admit(timeout=0.1) == []


def test_chip_pool_timeout_partial_grant():
    """:270: a gang-wait that times out takes the free subset."""
    pool = svc_mod.ChipPool(2)
    hold = pool.admit(want=1)
    assert len(hold) == 1
    g = pool.admit(want=2, timeout=0.15)
    assert len(g) == 1 and g[0] not in hold
    pool.release(g)
    pool.release(hold)
    assert all(v == 0 for v in pool.queue_depths().values())


def test_service_chip_metrics():
    """:285: --chips exposes per-card gauges on /metrics and the pool on
    /stats."""
    svc = svc_mod.DcompactWorkerService(device="cpu-jax", chips=2)
    port = svc.start()
    try:
        for _ in range(3):
            svc.pool.health.record_failure("chip:1")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics") as r:
            body = r.read().decode()
        assert 'tpulsm_dcompact_chip_queue_depth{chip="chip:0"} 0' in body
        assert 'tpulsm_dcompact_chip_wedged{chip="chip:1"} 1' in body
        assert 'tpulsm_dcompact_chip_busy{chip="chip:0"} 0' in body
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats") as r:
            stats = json.loads(r.read())
        assert stats["chips"]["chip:1"]["state"] == "open"
        assert stats["chips"]["chip:0"]["queue_depth"] == 0
    finally:
        svc.stop()


def test_chips_service_runs_jobs_over_its_grant(tmp_path, monkeypatch):
    """`--chips 2`: a DB's jobs through the HTTP service run with the
    grant as their mesh ("cpu" entries on a "cpu-jax" service), and the
    DB's tables (names, sizes) and rows equal those of the same DB through
    a service without cards (the tables' creation_time differs)."""
    from toplingdb_tpu_torch.compaction import worker
    from toplingdb_tpu_torch.db import db as dbm
    from toplingdb_tpu_torch.options import Options

    seen = []
    orig = worker.run_job

    def spy(job_dir, mesh_devices=None):
        seen.append(mesh_devices)
        return orig(job_dir, mesh_devices=mesh_devices)

    monkeypatch.setattr(worker, "run_job", spy)
    # Jobs this small in several shards, and over the mesh.
    monkeypatch.setattr(dc, "_SHARD_MIN_ROWS", 1)
    monkeypatch.setattr(dc, "_SHARD_ROWS", 1024)
    monkeypatch.setattr(mesh_plan, "DEFAULT_MESH_MIN_ROWS", 1)
    files = {}
    mesh_jobs = {}
    for chips in (0, 2):
        svc = svc_mod.DcompactWorkerService(device="cpu-jax", chips=chips)
        port = svc.start()
        path = str(tmp_path / f"db{chips}")
        try:
            fac = svc_mod.HttpCompactionExecutorFactory(
                [f"http://127.0.0.1:{port}"], device="cpu-jax")
            stats = st.Statistics()
            with dbm.DB.open(path, Options(
                    write_buffer_size=64 * 1024, memtable_rep="vector",
                    disable_auto_compactions=True, statistics=stats,
                    compaction_executor_factory=fac)) as db:
                for i in range(6000):
                    db.put(b"key%06d" % (i * 7919 % 3000), b"v%08d" % i)
                    if i % 1500 == 1499:
                        db.flush()
                db.compact_range()
                it = db.new_iterator()
                it.seek_to_first()
                rows = list(it.entries())
            assert svc.jobs_done >= 1 and svc.jobs_failed == 0
        finally:
            svc.stop()
        mesh_jobs[chips] = stats.tickers().get(st.DCOMPACTION_MESH_JOBS, 0)
        files[chips] = (rows, {
            f: os.path.getsize(os.path.join(path, f))
            for f in os.listdir(path) if f.endswith(".sst")})
    assert None in seen and ["cpu", "cpu"] in seen
    assert mesh_jobs[0] == 0 and mesh_jobs[2] >= 1
    assert len(files[0][0]) == 3000
    assert files[0] == files[2]


def test_probe_cli_exit_codes(monkeypatch, capsys):
    """:312: more devices than the host has is a SKIP; a broken
    measurement is a FAILURE; a small mesh measurement runs."""
    rc = scaling_probe.main(["--device", "cpu", "--devices", "4096"])
    out = capsys.readouterr().out
    assert rc == mesh_plan.EXIT_SKIP
    assert "skip" in json.loads(out.strip().splitlines()[-1])
    rc = scaling_probe.main(["--device", "cpu", "--mode", "mesh",
                             "--devices", "2",
                             "--rows-per-device", "256", "--repeats", "1"])
    out = capsys.readouterr().out
    assert rc == mesh_plan.EXIT_OK
    rows = json.loads(out.strip().splitlines()[-1])["mesh_compact"]
    assert [r["devices"] for r in rows] == [1, 2]

    def boom(*a, **k):
        raise RuntimeError("measurement broke")

    monkeypatch.setattr(mesh_plan, "weak_scaling_rows", boom)
    rc = scaling_probe.main(["--device", "cpu", "--devices", "1",
                             "--rows-per-device", "64"])
    out = capsys.readouterr().out
    assert rc == mesh_plan.EXIT_FAILURE
    assert "error" in json.loads(out.strip().splitlines()[-1])
