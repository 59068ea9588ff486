"""The pipelined data plane of toplingdb_tpu_torch (ops/pipeline.py) against
toplingdb_tpu's: input SSTs written by the JAX package (its columnar writer
for the runs, its TableBuilder for a file holding a range tombstone), the
same job compacted by both packages' run_device_compaction with the
pipeline on (the reference's default, TPULSM_PIPELINE=1, on JAX's CPU
backend; the port on device_name="cpu"), MIN_PIPELINE_ROWS lowered on both
sides and a spy confirming that both pipelines engaged. The output SST
files must be byte-identical and the FileMetaData equal. Tolerance:
bitwise. Also: jobs the pipeline does not cover fall back on both sides to
the same bytes and file numbers, a failure in the compute stage reaches the
caller with no thread or partial SST left behind, and the prefetch
buffer's pre-armed window."""

import dataclasses
import os
import threading

import numpy as np
import pytest

from toplingdb_tpu.compaction.picker import Compaction as RefCompaction
from toplingdb_tpu.db import filename as ref_fn
from toplingdb_tpu.db.dbformat import (
    InternalKeyComparator as RefICMP,
    ValueType,
    make_internal_key,
)
from toplingdb_tpu.db.table_cache import TableCache as RefTableCache
from toplingdb_tpu.db.version_edit import FileMetaData as RefMeta
from toplingdb_tpu.env import default_env
from toplingdb_tpu.ops import device_compaction as ref_dc
from toplingdb_tpu.ops import pipeline as ref_pl
from toplingdb_tpu.ops.columnar_io import (
    ColumnarKV as RefKV,
    write_tables_columnar as ref_write,
)
from toplingdb_tpu.table.builder import TableBuilder, TableOptions as RefTO

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.ops import compaction_kernels as ck
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.ops import pipeline as pl
from toplingdb_tpu_torch.table.prefetch import FilePrefetchBuffer

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()
BLOCK = 512
N = 6000


def plain_options(o) -> dict:
    d = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)
         if isinstance(getattr(o, f.name), (bool, int, float, str))}
    d["filter_policy_name"] = o.filter_policy.name() if o.filter_policy \
        else ""
    d["compression_opts"] = dataclasses.asdict(o.compression_opts)
    return d


def _meta(env, dbdir, fnum, smallest, largest, props):
    return RefMeta(
        number=fnum,
        file_size=env.get_file_size(ref_fn.table_file_name(dbdir, fnum)),
        smallest=smallest, largest=largest,
        smallest_seqno=props.smallest_seqno,
        largest_seqno=props.largest_seqno)


def build_runs(dbdir, n_total, seed, runs=4, tombstone_file=False,
               varlen=False):
    """4 presorted runs (~2x overwrites, 15% deletions, 8-digit keys;
    `varlen`: the digits without leading zeros, so 1-8 byte user keys),
    written with the JAX package's columnar writer; optionally one more
    file, written with its TableBuilder, with 50 points and a range
    tombstone newer than every point. Returns the reference metas."""
    env = default_env()
    topts = RefTO(block_size=BLOCK)
    rng = np.random.default_rng(seed)
    per_run = n_total // runs
    metas = []
    fnum = [20]

    def alloc():
        fnum[0] += 1
        return fnum[0]

    for run in range(runs):
        n = per_run
        draws = rng.integers(0, max(1, n_total // 2), n)
        seqs = np.arange(run * per_run + 1, run * per_run + n + 1,
                         dtype=np.uint64)
        vts = np.where(rng.random(n) < 0.15, int(ValueType.DELETION),
                       int(ValueType.VALUE)).astype(np.int32)
        uks = [(b"%d" if varlen else b"%08d") % d for d in draws]
        s = sorted(range(n), key=lambda i: (uks[i], -int(seqs[i])))
        keys = [make_internal_key(uks[i], int(seqs[i]), int(vts[i]))
                for i in s]
        vals = [b"v%019d" % seqs[i] if vts[i] else b"" for i in s]
        klens = np.array([len(k) for k in keys], dtype=np.int32)
        vlens = np.array([len(v) for v in vals], dtype=np.int32)
        kv = RefKV(np.frombuffer(b"".join(keys), np.uint8).copy(),
                   (np.cumsum(klens) - klens).astype(np.int32), klens,
                   np.frombuffer(b"".join(vals) or b"\0", np.uint8).copy(),
                   (np.cumsum(vlens) - vlens).astype(np.int32), vlens)
        for fn_, path, props, smallest, largest, _sel in ref_write(
                env, dbdir, alloc, REF_ICMP, topts, kv,
                np.arange(n, dtype=np.int32), np.full(n, -1, np.int64),
                vts[s], seqs[s], [], creation_time=1):
            metas.append(_meta(env, dbdir, fn_, smallest, largest, props))
    if tombstone_file:
        f = alloc()
        w = env.new_writable_file(ref_fn.table_file_name(dbdir, f))
        b = TableBuilder(w, REF_ICMP, topts)
        base = n_total * 2
        for i in range(50):
            b.add(make_internal_key(b"%08d" % (i * 37), base + i,
                                    ValueType.VALUE), b"t%05d" % i)
        b.add_tombstone(make_internal_key(
            b"%08d" % (n_total // 8), base + 99, ValueType.RANGE_DELETION),
            b"%08d" % (n_total // 4))
        props = b.finish()
        w.close()
        metas.append(_meta(env, dbdir, f, b.smallest_key, b.largest_key,
                           props))
    return metas


def allocator(base):
    s = [base]

    def alloc():
        s[0] += 1
        return s[0]

    return alloc


def run_ref(dbdir, metas, snaps, bottommost, max_out, base=1000):
    c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=bottommost, max_output_file_size=max_out)
    topts = RefTO(block_size=BLOCK)
    tc = RefTableCache(default_env(), dbdir, REF_ICMP, topts)
    outs, stats = ref_dc.run_device_compaction(
        default_env(), dbdir, REF_ICMP, c, tc, topts, snaps,
        new_file_number=allocator(base), creation_time=7, device_name="cpu")
    return outs, stats


def run_port(dbdir, metas, snaps, bottommost, max_out, base=2000, **kw):
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = Compaction(level=0, output_level=2, inputs=inputs,
                   bottommost=bottommost, max_output_file_size=max_out)
    topts = table_options_from_plain(plain_options(RefTO(block_size=BLOCK)))
    tc = TableCache(PosixEnv(), dbdir, ICMP, topts)
    return dc.run_device_compaction(
        PosixEnv(), dbdir, ICMP, c, tc, topts, snaps,
        new_file_number=allocator(base), creation_time=7, device_name="cpu",
        **kw)


def read_bytes(dbdir, outs):
    return [open(ref_fn.table_file_name(dbdir, m.number), "rb").read()
            for m in outs]


def assert_same_outputs(dbdir, ref_outs, port_outs):
    assert ref_outs and len(ref_outs) == len(port_outs)
    assert read_bytes(dbdir, port_outs) == read_bytes(dbdir, ref_outs)
    for r, p in zip(ref_outs, port_outs):
        a, b = dataclasses.asdict(r), dataclasses.asdict(p)
        # Same number of file numbers drawn before each output.
        assert a.pop("number") - 1000 == b.pop("number") - 2000
        assert a == b


@pytest.fixture
def small_pipeline(monkeypatch):
    """Both pipelines at test size; returns the engaged-call counters."""
    monkeypatch.setattr(ref_pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.delenv("TPULSM_PIPELINE", raising=False)
    monkeypatch.delenv("TPULSM_HOST_SORT", raising=False)
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


@pytest.mark.parametrize("shards,snaps,bottommost,max_out,tombs", [
    (4, [N // 3, 2 * N // 3], True, 1 << 30, True),
    (2, [N // 3, 2 * N // 3], False, 1 << 30, True),
    (5, [], True, 16 * 1024, False),
    (4, [N // 2], False, 24 * 1024, False),
])
def test_pipeline_writes_reference_bytes(tmp_path, monkeypatch,
                                         small_pipeline, shards, snaps,
                                         bottommost, max_out, tombs):
    monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", str(shards))
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, N, seed=3 + shards, tombstone_file=tombs)
    ref_outs, _ = run_ref(dbdir, metas, snaps, bottommost, max_out)
    port_outs, stats = run_port(dbdir, metas, snaps, bottommost, max_out,
                                pipeline_shards=shards)
    assert small_pipeline == {"ref": 1, "port": 1}, "a pipeline gave up"
    assert stats.pipelined and stats.prefetch_misses > 0
    assert stats.input_records == N + (50 if tombs else 0)
    assert_same_outputs(dbdir, ref_outs, port_outs)
    if tombs:
        # A tombstone newer than every snapshot survives: one output.
        assert len(port_outs) == 1 and port_outs[0].num_range_deletions
    if max_out < (1 << 20):
        assert len(port_outs) > 1  # output cutting exercised


def test_pipeline_matches_the_serial_route(tmp_path, small_pipeline):
    """The port's two routes agree with each other on the same job (the
    pipelined outputs equal the serial route's byte for byte)."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, N, seed=21, tombstone_file=True)
    snaps = [N // 4]
    piped, pstats = run_port(dbdir, metas, snaps, True, 1 << 30,
                             pipeline_shards=3)
    serial, sstats = run_port(dbdir, metas, snaps, True, 1 << 30,
                              base=3000, pipeline=False)
    assert small_pipeline["port"] == 1
    assert pstats.pipelined and not sstats.pipelined
    assert read_bytes(dbdir, piped) == read_bytes(dbdir, serial)
    assert (pstats.input_records, pstats.output_records) == \
        (sstats.input_records, sstats.output_records)
    assert pstats.prefetch_misses > 0 and not sstats.prefetch_misses


def test_non_uniform_keys_fall_back_on_both_sides(tmp_path, monkeypatch,
                                                  small_pipeline):
    """Variable-length keys: both pipelines give up after their writers drew
    a file number, both serial routes write the same bytes under the same
    numbers, and the aborted attempts leave no file behind."""
    monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "4")
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, N, seed=8, varlen=True)
    before = set(os.listdir(dbdir))
    ref_outs, _ = run_ref(dbdir, metas, [N // 2], True, 1 << 30)
    port_outs, stats = run_port(dbdir, metas, [N // 2], True, 1 << 30,
                                pipeline_shards=4)
    assert small_pipeline == {"ref": 0, "port": 0}
    assert not stats.pipelined
    assert_same_outputs(dbdir, ref_outs, port_outs)
    assert ref_outs[0].number == 1002  # 1001 went to the aborted attempt
    after = set(os.listdir(dbdir))
    want = before | {f"{m.number:06d}.sst" for m in ref_outs + port_outs}
    assert after == want, f"stray files: {sorted(after - want)}"


def test_compute_failure_reaches_the_caller(tmp_path, monkeypatch,
                                            small_pipeline):
    """A failure in the compute stage (as a kernel or CUDA error would
    raise it) propagates as it is: no serial retry, no thread and no
    partial SST left behind. The same job then runs through."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, N, seed=9)
    before = set(os.listdir(dbdir))
    orig = ck.fused_uniform_shard_start
    calls = []

    def fail_second(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected kernel failure")
        return orig(*a, **k)

    serial = []
    orig_collect = dc._collect_raw_columnar
    monkeypatch.setattr(ck, "fused_uniform_shard_start", fail_second)
    monkeypatch.setattr(dc, "_collect_raw_columnar",
                        lambda *a, **k: serial.append(1) or orig_collect(
                            *a, **k))
    with pytest.raises(RuntimeError, match="injected kernel failure"):
        run_port(dbdir, metas, [], True, 2048, pipeline_shards=4)
    assert not serial, "the failure was routed to the serial path"
    assert not [t for t in threading.enumerate()
                if t.name.startswith("pipeline-")]
    assert set(os.listdir(dbdir)) == before, "partial outputs left behind"
    monkeypatch.setattr(ck, "fused_uniform_shard_start", orig)
    outs, stats = run_port(dbdir, metas, [], True, 2048, pipeline_shards=4)
    assert outs and stats.pipelined


def test_scan_failure_reaches_the_caller(tmp_path, small_pipeline):
    """A corrupt input block fails the scan stage: the Corruption reaches
    the caller, every stage stops and no output is left behind."""
    from toplingdb_tpu_torch.utils.status import Corruption

    dbdir = str(tmp_path)
    metas = build_runs(dbdir, N, seed=10)
    path = ref_fn.table_file_name(dbdir, metas[2].number)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    before = set(os.listdir(dbdir))
    with pytest.raises(Corruption):
        run_port(dbdir, metas, [], True, 1 << 30, pipeline_shards=4)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("pipeline-")]
    assert set(os.listdir(dbdir)) == before


def test_pipeline_shard_count():
    assert pl._pipeline_shards(10_000_000) == 32
    assert pl._pipeline_shards(1 << 20) == 2
    assert pl._pipeline_shards(1 << 18) == 1
    assert pl._pipeline_shards(1 << 18, requested=5) == 5
    for n in (1 << 18, 3_000_000, 10_000_000, 1 << 26):
        assert pl._pipeline_shards(n) == ref_pl._pipeline_shards(n)


class _MemFile:
    def __init__(self, data: bytes):
        self._data = data
        self.reads = 0

    def read(self, offset: int, n: int) -> bytes:
        self.reads += 1
        return self._data[offset: offset + n]

    def size(self) -> int:
        return len(self._data)


def test_prefetch_buffer_pre_armed_window():
    """arm_immediately + initial_readahead fetch a full window on the very
    first read; sequential successors hit, a random read resets cleanly."""
    f = _MemFile(bytes(range(256)) * 1024)  # 256 KiB
    pf = FilePrefetchBuffer(f, max_readahead=64 * 1024,
                            initial_readahead=64 * 1024,
                            arm_immediately=True)
    assert pf.read(0, 4096) == bytes(range(256)) * 16
    assert (pf.hits, pf.misses) == (0, 1)
    for i in range(1, 16):
        assert pf.read(i * 4096, 4096) == bytes(range(256)) * 16
    assert pf.hits == 15 and f.reads == 1  # the rest of the 64 KiB window
    h, m = pf.hits, pf.misses
    assert pf.read(200 * 1024, 4096) == bytes(range(256)) * 16
    assert (pf.hits, pf.misses) == (h, m + 1)  # random access: miss, reset


def test_prefetch_buffer_ramps_on_sequential_reads():
    """Without arming, readahead starts after ARM_AFTER sequential reads and
    the window doubles up to its ceiling."""
    data = os.urandom(1 << 20)
    f = _MemFile(data)
    pf = FilePrefetchBuffer(f, max_readahead=64 * 1024)
    off = 0
    for _ in range(64):
        assert pf.read(off, 1024) == data[off:off + 1024]
        off += 1024
    assert pf.misses < 10 and pf.hits > 50
    assert pf._readahead == 64 * 1024
    pf.reset()
    assert pf.read(0, 10) == data[:10] and pf._readahead == 8 * 1024
