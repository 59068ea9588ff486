"""The host twins of toplingdb_tpu_torch (ops/compaction_kernels.host_*,
the native tpulsm_merge_gc_runs, ops/pipeline._host_compute and the
serial route's host branch) against toplingdb_tpu's, on the CPU.

- every host-twin function on the same seeded numpy runs (snapshots,
  covers, run starts, MERGE / SINGLE_DELETION groups, user keys over 8
  bytes, the merge forced to 1 and 4 threads, host_merge=False) equals the
  reference's arrays bitwise; the reference reads TPULSM_MERGE_THREADS and
  TPULSM_HOST_MERGE through monkeypatch, the port takes arguments;
- the fused native pass equals the two-pass twin
  (tests/test_host_merge_gc.py:83, :109, :124);
- the pipelined and serial host routes (`host_sort=True`) write the SST
  bytes of the reference's TPULSM_HOST_SORT=1 jobs and of the port's own
  "cpu" device route, uncompressed, snappy and zstd
  (tests/test_compaction_pipeline.py:165), also with host_merge=False;
- a cancellation in the host compute stage leaves no output behind (:377);
- host_sort=True without the native library raises.

Tolerance: none (bitwise arrays, byte-identical files).
"""

import os

import numpy as np
import pytest

from toplingdb_tpu.db.dbformat import ValueType
from toplingdb_tpu.ops import compaction_kernels as ref_ck
from toplingdb_tpu.ops import pipeline as ref_pl
from toplingdb_tpu.table import format as ref_fmt
from toplingdb_tpu.utils import codecs as ref_codecs

from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.ops import compaction_kernels as ck
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.ops import pipeline as pl
from toplingdb_tpu_torch.utils.status import NotSupported

import test_torch_pipeline as tp

N = 6000


def make_runs(rng, n_runs, per_run, key_space, p_merge=0.0, p_sd=0.0,
              p_del=0.15, key_fmt=b"%08d"):
    """Columnar (key_buf, key_offs, key_lens, run_starts) of presorted runs
    of decimal user keys (tests/test_host_merge_gc.py's generator)."""
    bufs = []
    seq_counter = 1
    run_starts = [0]
    total = 0
    for _ in range(n_runs):
        draws = rng.integers(0, key_space, per_run)
        seqs = np.arange(seq_counter, seq_counter + per_run, dtype=np.uint64)
        seq_counter += per_run
        vts = np.full(per_run, int(ValueType.VALUE), dtype=np.uint64)
        r = rng.random(per_run)
        vts[r < p_del] = int(ValueType.DELETION)
        vts[r > 1 - p_merge] = int(ValueType.MERGE)
        vts[(r > p_del) & (r < p_del + p_sd)] = int(
            ValueType.SINGLE_DELETION)
        order = np.lexsort(
            (np.iinfo(np.int64).max - seqs.view(np.int64), draws))
        for i in order:
            packed = (int(seqs[i]) << 8) | int(vts[i])
            bufs.append(key_fmt % draws[i] + packed.to_bytes(8, "little"))
        total += per_run
        run_starts.append(total)
    lens = np.array([len(b) for b in bufs], dtype=np.int64)
    key_buf = np.frombuffer(b"".join(bufs), dtype=np.uint8)
    key_offs = (np.cumsum(lens) - lens).astype(np.int64)
    return key_buf, key_offs, lens, np.array(run_starts, dtype=np.int64)


def assert_tuples_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, i
            np.testing.assert_array_equal(g, w, err_msg=str(i))
        else:
            assert g == w, i


CASES = [
    dict(n_runs=4, per_run=3000, key_space=1500, snaps=[], bottom=True),
    dict(n_runs=4, per_run=3000, key_space=1500, snaps=[2000, 7000],
         bottom=True),
    dict(n_runs=3, per_run=2000, key_space=400, snaps=[500, 1500, 3000],
         bottom=False),
    dict(n_runs=2, per_run=2500, key_space=800, snaps=[], bottom=True,
         p_merge=0.05, p_sd=0.03),
    dict(n_runs=5, per_run=1000, key_space=50, snaps=[1200], bottom=True,
         p_merge=0.02, cover=True),
    dict(n_runs=4, per_run=1500, key_space=99999999, snaps=[], bottom=True),
    # User keys over 8 bytes: the native merge refuses them.
    dict(n_runs=3, per_run=800, key_space=300, snaps=[900], bottom=True,
         key_fmt=b"longkey-%010d", cover=True),
]


@pytest.mark.parametrize("host_merge", [True, False])
@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in
                                             range(len(CASES))])
def test_host_twins_match_the_reference(case, threads, host_merge,
                                        monkeypatch):
    monkeypatch.setenv("TPULSM_MERGE_THREADS", str(threads))
    monkeypatch.setenv("TPULSM_HOST_MERGE", "1" if host_merge else "0")
    rng = np.random.default_rng(42 + threads)
    kb, ko, kl, rs = make_runs(
        rng, case["n_runs"], case["per_run"], case["key_space"],
        p_merge=case.get("p_merge", 0.0), p_sd=case.get("p_sd", 0.0),
        key_fmt=case.get("key_fmt", b"%08d"))
    cover = None
    if case.get("cover"):
        cover = rng.integers(0, 5000, len(ko)).astype(np.uint64)
        cover[rng.random(len(ko)) < 0.5] = 0
    snaps, bottom = case["snaps"], case["bottom"]
    mkb = int(kl.max()) - 8

    assert_tuples_equal(
        ck._trailer_seq_vtype(kb, ko, kl),
        ref_ck._trailer_seq_vtype(kb, ko, kl))
    assert_tuples_equal(
        ck.host_encode_sort(kb, ko, kl, mkb),
        ref_ck.host_encode_sort(kb, ko, kl, mkb))
    got = ck.host_sort_order(kb, ko, kl, run_starts=rs,
                             host_merge=host_merge)
    assert_tuples_equal(got, ref_ck.host_sort_order(kb, ko, kl,
                                                    run_starts=rs))
    assert_tuples_equal(
        ck.host_sort_with_boundaries(kb, ko, kl, mkb, run_starts=rs,
                                     host_merge=host_merge),
        ref_ck.host_sort_with_boundaries(kb, ko, kl, mkb, run_starts=rs))
    s, new_key, seq, vt = ref_ck.host_sort_with_boundaries(
        kb, ko, kl, mkb, run_starts=rs)
    sc = None if cover is None else cover[s]
    assert_tuples_equal(
        ck.host_gc_mask(new_key, seq[s], vt[s], snaps, sc, bottom),
        ref_ck.host_gc_mask(new_key, seq[s], vt[s], snaps, sc, bottom))
    fused = ck.host_merge_gc(kb, ko, kl, snaps, bottom, cover, rs,
                             host_merge=host_merge, threads=threads)
    assert_tuples_equal(fused, ref_ck.host_merge_gc(kb, ko, kl, snaps,
                                                    bottom, cover, rs))
    if host_merge and "key_fmt" not in case:
        assert fused is not None
    else:
        assert fused is None  # the two-pass twin runs
    assert_tuples_equal(
        ck.host_fused_full(kb, ko, kl, mkb, snaps, bottom, cover,
                           run_starts=rs, host_merge=host_merge,
                           threads=threads),
        ref_ck.host_fused_full(kb, ko, kl, mkb, snaps, bottom, cover,
                               run_starts=rs))


def _two_pass(key_buf, key_offs, key_lens, snapshots, bottommost, cover,
              run_starts):
    s, new_key, seq, vtype = ck.host_sort_with_boundaries(
        key_buf, key_offs, key_lens, 8, run_starts=run_starts)
    keep, zero_seq, host_resolve, _ = ck.host_gc_mask(
        new_key, seq[s], vtype[s], snapshots,
        None if cover is None else cover[s], bottommost)
    out = keep | host_resolve
    return (s[out].astype(np.int32), zero_seq[out], host_resolve[out],
            bool(host_resolve.any()), seq, vtype)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("with_cover", [False, True])
def test_fused_matches_two_pass(threads, with_cover):
    """tests/test_host_merge_gc.py:83 and :109 on the port alone: the
    fused pass's flags equal the two-pass twin's after its ~cx mask."""
    rng = np.random.default_rng(7 + threads)
    kb, ko, kl, rs = make_runs(rng, 4, 2000, 600, p_merge=0.02, p_sd=0.01)
    cover = None
    if with_cover:
        cover = rng.integers(0, 9000, len(ko)).astype(np.uint64)
        cover[rng.random(len(ko)) < 0.5] = 0
    for snaps in ([], [3000], [1000, 5000]):
        got = ck.host_merge_gc(kb, ko, kl, snaps, True, cover, rs,
                               threads=threads)
        want = _two_pass(kb, ko, kl, snaps, True, cover, rs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1] & ~want[2])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3]


def test_fused_ineligible_long_keys():
    """tests/test_host_merge_gc.py:124: user keys over 8 bytes → None."""
    keys = [b"averylongkey1" + (1 << 8 | 1).to_bytes(8, "little"),
            b"averylongkey2" + (2 << 8 | 1).to_bytes(8, "little")]
    kb = np.frombuffer(b"".join(keys), dtype=np.uint8)
    kl = np.full(2, 21, dtype=np.int64)
    ko = np.arange(2, dtype=np.int64) * 21
    rs = np.array([0, 1, 2], dtype=np.int64)
    assert ck.host_merge_gc(kb, ko, kl, [], True, None, rs) is None
    assert ref_ck.host_merge_gc(kb, ko, kl, [], True, None, rs) is None


CODECS = {"none": ref_fmt.NO_COMPRESSION, "snappy": ref_fmt.SNAPPY_COMPRESSION,
          "zstd": ref_fmt.ZSTD_COMPRESSION}


def _topts(codec):
    ref = tp.RefTO(block_size=tp.BLOCK, compression=CODECS[codec])
    return ref, tp.table_options_from_plain(tp.plain_options(ref))


def _run_ref(dbdir, metas, snaps, ref_topts, base):
    c = tp.RefCompaction(level=0, output_level=2, inputs=list(metas),
                         bottommost=True, max_output_file_size=1 << 30)
    tc = tp.RefTableCache(tp.default_env(), dbdir, tp.REF_ICMP, ref_topts)
    return tp.ref_dc.run_device_compaction(
        tp.default_env(), dbdir, tp.REF_ICMP, c, tc, ref_topts, snaps,
        new_file_number=tp.allocator(base), creation_time=7,
        device_name="cpu")


def _run_port(dbdir, metas, snaps, topts, base, **kw):
    import dataclasses

    inputs = [tp.FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = tp.Compaction(level=0, output_level=2, inputs=inputs,
                      bottommost=True, max_output_file_size=1 << 30)
    tc = tp.TableCache(tp.PosixEnv(), dbdir, tp.ICMP, topts)
    return dc.run_device_compaction(
        tp.PosixEnv(), dbdir, tp.ICMP, c, tc, topts, snaps,
        new_file_number=tp.allocator(base), creation_time=7,
        device_name="cpu", **kw)


@pytest.mark.parametrize("codec", ["none", "snappy", "zstd"])
@pytest.mark.parametrize("route", ["pipelined", "serial"])
def test_host_routes_write_the_reference_bytes(tmp_path, monkeypatch,
                                               small_pipeline, route, codec):
    """tests/test_compaction_pipeline.py:165 (mode=host): the port's host
    routes write the reference's TPULSM_HOST_SORT=1 bytes, and the bytes
    of the port's own device route on "cpu"."""
    if codec != "none" and not ref_codecs.available(codec):
        pytest.skip(f"{codec} unavailable")
    piped = route == "pipelined"
    monkeypatch.setenv("TPULSM_HOST_SORT", "1")
    monkeypatch.setenv("TPULSM_PIPELINE", "1" if piped else "0")
    monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "4")
    ref_topts, topts = _topts(codec)
    dbdir = str(tmp_path)
    metas = tp.build_runs(dbdir, N, seed=3, tombstone_file=True)
    snaps = [N // 3, 2 * N // 3]
    ref_outs, _ = _run_ref(dbdir, metas, snaps, ref_topts, 1000)
    host_outs, hstats = _run_port(dbdir, metas, snaps, topts, 2000,
                                  host_sort=True, pipeline=piped,
                                  pipeline_shards=4)
    dev_outs, dstats = _run_port(dbdir, metas, snaps, topts, 3000,
                                 pipeline=piped, pipeline_shards=4)
    want = 1 if piped else 0
    assert small_pipeline == {"ref": want, "port": 2 * want}
    assert hstats.pipelined == dstats.pipelined == piped
    assert hstats.host_compute_usec > 0
    assert tp.read_bytes(dbdir, host_outs) == tp.read_bytes(dbdir, ref_outs)
    assert tp.read_bytes(dbdir, host_outs) == tp.read_bytes(dbdir, dev_outs)
    assert [m.num_entries for m in host_outs] == \
        [m.num_entries for m in ref_outs]


@pytest.mark.parametrize("route", ["pipelined", "serial"])
def test_host_merge_off_writes_the_same_bytes(tmp_path, monkeypatch,
                                              small_pipeline, route):
    """host_merge=False (the reference's TPULSM_HOST_MERGE=0) takes the
    two-pass twin: the same bytes as the reference's, with a complex job
    on the serial route."""
    piped = route == "pipelined"
    monkeypatch.setenv("TPULSM_HOST_SORT", "1")
    monkeypatch.setenv("TPULSM_HOST_MERGE", "0")
    monkeypatch.setenv("TPULSM_PIPELINE", "1" if piped else "0")
    monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "3")
    ref_topts, topts = _topts("none")
    dbdir = str(tmp_path)
    metas = tp.build_runs(dbdir, N, seed=12)
    ref_outs, _ = _run_ref(dbdir, metas, [N // 2], ref_topts, 1000)
    calls = []
    orig = ck.host_merge_gc
    monkeypatch.setattr(ck, "host_merge_gc", lambda *a, **k: (
        calls.append(k.get("host_merge")) or orig(*a, **k)))
    outs, _ = _run_port(dbdir, metas, [N // 2], topts, 2000,
                        host_sort=True, host_merge=False, pipeline=piped,
                        pipeline_shards=3)
    assert calls and not any(calls)
    assert tp.read_bytes(dbdir, outs) == tp.read_bytes(dbdir, ref_outs)


class _Cancel(BaseException):
    """Out-of-band cancellation (a BaseException, so nothing retries)."""


def test_cancel_mid_pipeline_leaves_no_orphans(tmp_path, monkeypatch,
                                               small_pipeline):
    """tests/test_compaction_pipeline.py:377: a cancellation in the host
    compute stage stops every stage and deletes every partial output; the
    job runs through once it is gone."""
    dbdir = str(tmp_path)
    metas = tp.build_runs(dbdir, 20_000, seed=9)
    before = set(os.listdir(dbdir))
    _ref, topts = _topts("none")
    orig = ck.host_fused_full
    hits = []

    def cancel_on_second(*a, **k):
        hits.append(1)
        if len(hits) >= 2:
            raise _Cancel("injected cancel")
        return orig(*a, **k)

    monkeypatch.setattr(ck, "host_fused_full", cancel_on_second)
    with pytest.raises(_Cancel):
        _run_port(dbdir, metas, [], topts, 7000, host_sort=True,
                  pipeline_shards=4)
    monkeypatch.setattr(ck, "host_fused_full", orig)
    assert set(os.listdir(dbdir)) == before, "orphan outputs left behind"
    assert not [t for t in __import__("threading").enumerate()
                if t.name.startswith("pipeline-")]
    outs, stats = _run_port(dbdir, metas, [], topts, 7100, host_sort=True,
                            pipeline_shards=4)
    assert outs and stats.pipelined


def test_host_sort_without_the_native_library_raises(tmp_path, monkeypatch):
    """Ground rule 8: no quiet numpy route when the library is missing."""
    dbdir = str(tmp_path)
    metas = tp.build_runs(dbdir, 2000, seed=5)
    _ref, topts = _topts("none")
    monkeypatch.setattr(native, "lib", lambda: None)
    with pytest.raises(NotSupported, match="native library"):
        _run_port(dbdir, metas, [], topts, 2000, host_sort=True)
    kb, ko, kl, rs = make_runs(np.random.default_rng(1), 2, 10, 5)
    with pytest.raises(NotSupported):
        ck.host_fused_full(kb, ko, kl, 8, [], True, run_starts=rs)


@pytest.fixture
def small_pipeline(monkeypatch):
    monkeypatch.setattr(ref_pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    calls = {"ref": 0, "port": 0}

    def spy(mod, name):
        orig = mod.run_pipelined

        def wrapped(*a, **k):
            r = orig(*a, **k)
            calls[name] += 1
            return r

        monkeypatch.setattr(mod, "run_pipelined", wrapped)

    spy(ref_pl, "ref")
    spy(pl, "port")
    return calls
