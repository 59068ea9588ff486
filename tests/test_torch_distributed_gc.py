"""The distributed GC step of toplingdb_tpu_torch
(parallel/distributed_gc.py, torch.distributed over gloo ranks) against
toplingdb_tpu's (a shard_map program on a JAX CPU mesh of the same shape;
tests/conftest.py gives 8 virtual devices), on the same seeded jobs.

One module-scoped run spawns four gloo ranks (a file store under the
test's tmp dir, no TCP port, a join timeout) and runs every case; the
reference runs each case in this process. Cases: (jobs, range) meshes
(1, 2) on two of the four ranks, (2, 2) and (1, 4), with plain,
merge-bearing and tombstone-bearing jobs, snapshots, bottommost and not,
1000-row jobs, and a skewed job whose buckets overflow: TryAgain on both
sides. Then the port's dryrun_multichip(4) (tests/test_distributed_mesh.py)
and the step's helpers. Tolerance: none (bitwise arrays).
"""

import pickle

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from toplingdb_tpu.db.dbformat import ValueType as RefVT
from toplingdb_tpu.db.dbformat import make_internal_key as ref_mik
from toplingdb_tpu.ops import compaction_kernels as ref_ck
from toplingdb_tpu.ops.columnar import ColumnarEntries as RefCE
from toplingdb_tpu.parallel.distributed_gc import (
    run_distributed_gc as ref_run,
)
from toplingdb_tpu.utils.status import TryAgain as RefTryAgain

from toplingdb_tpu_torch.parallel import distributed_gc as dg
from toplingdb_tpu_torch.parallel import entry
from toplingdb_tpu_torch.parallel import mesh_plan, scaling_probe

WORLD = 4


def _ref_padded(entries, cover, max_key_bytes=8):
    d = ref_ck.pad_columns(RefCE.from_entries(entries,
                                              max_key_bytes=max_key_bytes))
    d = {k: np.asarray(v) if hasattr(v, "shape") else v
         for k, v in d.items()}
    if cover is not None:
        d["tomb_cover"] = cover
    return d


def _tiny(specs):
    return [_ref_padded(*entry.tiny_job(i + 1, m, t))
            for i, (m, t) in enumerate(specs)]


def _skewed_job():
    """64 rows: the first 16 (range rank 0's block on a 4-wide axis) hold
    the smallest keys, so all of them land in one bucket of capacity 8."""
    entries = []
    for i in range(64):
        k = b"a%03d" % i if i < 16 else b"z%03d" % ((i * 37) % 48)
        entries.append((ref_mik(k, i + 1, RefVT.VALUE), b"v"))
    return _ref_padded(entries, None)


def _big_job(seed, n=1000):
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, n // 3, n)
    vts = rng.choice([RefVT.VALUE, RefVT.VALUE, RefVT.DELETION,
                      RefVT.MERGE], n)
    entries = [(ref_mik(b"%012d" % draws[i], i + 1, vts[i]), b"v")
               for i in range(n)]
    cover = np.where(rng.random(n) < 0.1,
                     rng.integers(1, n + 1, n), 0).astype(np.uint64)
    return _ref_padded(entries, cover, max_key_bytes=12)


def _cases():
    mixed = [(False, False), (True, False), (False, True)]
    return {
        "1x2-mixed": dict(jobs=1, range=2, ranks=[0, 1],
                          gc_jobs=_tiny(mixed), snapshots=[10, 40],
                          bottommost=True),
        "2x2-mixed": dict(jobs=2, range=2, gc_jobs=_tiny(mixed),
                          snapshots=[10, 40], bottommost=True),
        "1x4-mixed": dict(jobs=1, range=4, gc_jobs=_tiny(mixed + mixed),
                          snapshots=[10, 40], bottommost=False),
        "2x2-big": dict(jobs=2, range=2,
                        gc_jobs=[_big_job(1), _big_job(2), _big_job(3)],
                        snapshots=[100, 350, 700], bottommost=True),
        "1x4-big": dict(jobs=1, range=4, gc_jobs=[_big_job(4)],
                        snapshots=[], bottommost=True),
        "1x4-skewed": dict(jobs=1, range=4, gc_jobs=[_skewed_job()],
                           snapshots=[], bottommost=True),
    }


CASES = _cases()


def _ref_result(case):
    j, r = case["jobs"], case["range"]
    devs = np.array(jax.devices()[:j * r]).reshape(j, r)
    try:
        return tuple(np.asarray(a) for a in ref_run(
            Mesh(devs, ("jobs", "range")), case["gc_jobs"],
            case["snapshots"], case["bottommost"]))
    except RefTryAgain as e:
        return ("TryAgain", str(e))


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dgc")
    out = str(d / "results.pkl")
    dg.spawn_ranks(dg.run_cases, WORLD, str(d),
                   args=(list(CASES.values()), out), timeout=120)
    with open(out, "rb") as f:
        return dict(zip(CASES, pickle.load(f)))


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_gc_matches_the_reference(name, port_results):
    got = port_results[name]
    want = _ref_result(CASES[name])
    if name.endswith("skewed"):
        assert want[0] == "TryAgain" and got[0] == "TryAgain"
        return
    assert not isinstance(want[0], str) and not isinstance(got[0], str)
    for g, w, what in zip(got, want, ("keep", "zero_seq", "idx", "cx")):
        assert g.shape == w.shape, what
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=what)
    # The mesh keeps every real row exactly once.
    for job, idx in zip(CASES[name]["gc_jobs"], got[2]):
        real = idx[idx >= 0]
        assert sorted(real.tolist()) == list(range(job["n"]))


def test_dryrun_multichip_4(tmp_path, capfd):
    """tests/test_distributed_mesh.py:10 on four gloo ranks."""
    entry.dryrun_multichip(4, store_dir=str(tmp_path), device="cpu")
    out = capfd.readouterr().out
    assert "mesh jobs=2 x range=2, 3 jobs validated" in out
    assert "mesh jobs=4 x range=1, 5 jobs validated" in out


def test_entry_forward_step():
    """The forward step on "cpu" equals __graft_entry__.entry()'s
    (keep, zero_seq, perm) bitwise."""
    import __graft_entry__ as ref_entry

    fn, args = entry.entry("cpu")
    keep, zero_seq, perm = fn(*args)
    assert keep.shape == zero_seq.shape == perm.shape == (1024,)
    assert sorted(perm.tolist()) == list(range(1024))
    rfn, rargs = ref_entry.entry()
    for got, want in zip((keep, zero_seq, perm), rfn(*rargs)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_entry_points_default_to_the_card(monkeypatch):
    """entry, dryrun_multichip and the probe run on "cuda" unless the
    caller asks for "cpu": without a card, the first two raise and the
    probe answers SKIP."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(1)
    assert scaling_probe.main(["--devices", "1"]) == mesh_plan.EXIT_SKIP


def test_local_sort_and_lex_less():
    import torch

    rng = np.random.default_rng(5)
    cols = rng.integers(-3, 3, size=(200, 5)).astype(np.int32)
    pay = np.arange(200, dtype=np.int32)[:, None]
    cs, ps = dg._local_sort(torch.from_numpy(cols), torch.from_numpy(pay))
    want = np.lexsort(tuple(cols[:, i] for i in range(4, -1, -1)))
    np.testing.assert_array_equal(ps[:, 0].numpy(), want)
    a = torch.from_numpy(cols[:50])
    b = torch.from_numpy(cols[50:100])
    lt = dg._lex_less(a, b).numpy()
    exp = [tuple(x) < tuple(y) for x, y in zip(cols[:50], cols[50:100])]
    assert lt.tolist() == exp


def test_weak_scaling_job_matches_the_reference():
    from toplingdb_tpu.parallel import mesh_plan as ref_mp

    got = mesh_plan.make_weak_scaling_job(300)
    want = ref_mp.make_weak_scaling_job(300)
    for k in ("key_words", "key_len", "inv_hi", "inv_lo", "vtype"):
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["w"], got["n"]) == (want["w"], want["n"])
