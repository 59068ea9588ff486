"""Compressed SSTs on every device route of toplingdb_tpu_torch against
toplingdb_tpu's: compressed input SSTs written by the JAX package (its
columnar writer for the runs, its TableBuilder for a file holding a range
tombstone), the same job compacted by both packages' run_device_compaction
(the reference on JAX's CPU backend, the port on device_name="cpu") with
compressed output, on the pipelined plane (MIN_PIPELINE_ROWS lowered on
both sides, spies confirming which pipelines engaged), the serial shard
route, the per-entry route and the block-assembly request. The output SST
files must be byte-identical and the FileMetaData equal. Tolerance:
bitwise."""

import dataclasses

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
from toplingdb_tpu.ops import block_assembly as ref_ba
from toplingdb_tpu.ops import device_compaction as ref_dc
from toplingdb_tpu.ops import pipeline as ref_pl
from toplingdb_tpu.ops.columnar_io import (
    ColumnarKV as RefKV,
    write_tables_columnar as ref_write,
)
from toplingdb_tpu.table import format as ref_fmt
from toplingdb_tpu.table.builder import (
    CompressionOptions as RefCO,
    TableBuilder,
    TableOptions as RefTO,
)
from toplingdb_tpu.utils.compaction_filter import (
    RemoveEmptyValueCompactionFilter as RefRemoveEmpty,
)

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.ops import block_assembly as ba
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.ops import pipeline as pl
from toplingdb_tpu_torch.utils.compaction_filter import (
    create_compaction_filter,
)

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()
BLOCK = 512
N = 6000

# Codec name → reference table options for inputs and outputs.
CODECS = {
    "none": dict(compression=ref_fmt.NO_COMPRESSION),
    "snappy": dict(compression=ref_fmt.SNAPPY_COMPRESSION),
    "zstd": dict(compression=ref_fmt.ZSTD_COMPRESSION),
    "zstd-level": dict(compression=ref_fmt.ZSTD_COMPRESSION,
                       compression_opts=RefCO(level=7)),
    "zstd-dict": dict(compression=ref_fmt.ZSTD_COMPRESSION,
                      compression_opts=RefCO(max_dict_bytes=4096,
                                             zstd_max_train_bytes=1 << 15)),
    "lz4": dict(compression=ref_fmt.LZ4_COMPRESSION),
    "lz4hc": dict(compression=ref_fmt.LZ4HC_COMPRESSION),
    "zlib": dict(compression=ref_fmt.ZLIB_COMPRESSION),
    "bz2": dict(compression=ref_fmt.BZIP2_COMPRESSION),
    "lzma": dict(compression=ref_fmt.LZMA_COMPRESSION),
}


def ref_options(codec, **kw) -> RefTO:
    return RefTO(block_size=BLOCK, **CODECS[codec], **kw)


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


def build_runs(dbdir, n_total, seed, codec, runs=4, tombstone_file=False,
               p_empty=0.0):
    """4 presorted runs (~2x overwrites, 15% deletions, 8-digit keys,
    20-byte values, a share `p_empty` of them empty) written compressed
    with the JAX package's columnar writer; optionally one more file,
    written with its TableBuilder, with 50 points and a range tombstone
    newer than every point. Returns the reference metas."""
    env = default_env()
    topts = ref_options(codec)
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
        empty = rng.random(n) < p_empty
        uks = [b"%08d" % d for d in draws]
        s = sorted(range(n), key=lambda i: (uks[i], -int(seqs[i])))
        keys = [make_internal_key(uks[i], int(seqs[i]), int(vts[i]))
                for i in s]
        vals = [b"v%019d" % seqs[i] if vts[i] and not empty[i] else b""
                for i in s]
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


def run_ref(dbdir, metas, snaps, topts, max_out=1 << 30, **kw):
    c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=True, max_output_file_size=max_out)
    tc = RefTableCache(default_env(), dbdir, REF_ICMP, topts)
    outs, _ = ref_dc.run_device_compaction(
        default_env(), dbdir, REF_ICMP, c, tc, topts, snaps,
        new_file_number=allocator(1000), creation_time=7, device_name="cpu",
        **kw)
    return outs


def run_port(dbdir, metas, snaps, ref_topts, max_out=1 << 30, base=2000,
             **kw):
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = Compaction(level=0, output_level=2, inputs=inputs, bottommost=True,
                   max_output_file_size=max_out)
    topts = table_options_from_plain(plain_options(ref_topts))
    tc = TableCache(PosixEnv(), dbdir, ICMP, topts)
    return dc.run_device_compaction(
        PosixEnv(), dbdir, ICMP, c, tc, topts, snaps,
        new_file_number=allocator(base), creation_time=7, device_name="cpu",
        **kw)


def read_bytes(dbdir, outs):
    return [open(ref_fn.table_file_name(dbdir, m.number), "rb").read()
            for m in outs]


def assert_same_outputs(dbdir, ref_outs, port_outs, base=2000):
    assert ref_outs and len(ref_outs) == len(port_outs)
    assert read_bytes(dbdir, port_outs) == read_bytes(dbdir, ref_outs)
    for r, p in zip(ref_outs, port_outs):
        a, b = dataclasses.asdict(r), dataclasses.asdict(p)
        # Same number of file numbers drawn before each output.
        assert a.pop("number") - 1000 == b.pop("number") - base
        assert a == b


def first_block_type(dbdir, outs) -> int:
    """The type byte of the first output's first data block."""
    raw = read_bytes(dbdir, outs[0:1])[0]
    from toplingdb_tpu_torch.table.reader import TableReader

    r = TableReader(PosixEnv().new_random_access_file(
        ref_fn.table_file_name(dbdir, outs[0].number)), ICMP)
    idx = r.new_index_iterator()
    idx.seek_to_first()
    from toplingdb_tpu_torch.table import format as fmt

    h = fmt.BlockHandle.decode_exact(idx.value())
    return raw[h.offset + h.size]


@pytest.fixture
def small_pipeline(monkeypatch):
    """Both pipelines at test size; returns the engaged-call counters."""
    monkeypatch.setattr(ref_pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.delenv("TPULSM_PIPELINE", raising=False)
    monkeypatch.delenv("TPULSM_HOST_SORT", raising=False)
    monkeypatch.delenv("TPULSM_DEVICE_BLOCKS", raising=False)
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


@pytest.mark.parametrize("codec", ["snappy", "zstd"])
def test_pipeline_byte_parity(tmp_path, monkeypatch, small_pipeline, codec):
    """The mirror of the reference's test_pipeline_byte_parity[codec]
    (tests/test_compaction_pipeline.py:163): compressed inputs, snapshots
    and a surviving range tombstone through both pipelines (the native
    scan inflates the blocks inline), compressed outputs byte-identical,
    and the port's serial route writes the same bytes."""
    monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "3")
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, N, seed=31, codec=codec, tombstone_file=True)
    topts = ref_options(codec)
    snaps = [N // 3, 2 * N // 3]
    ref_outs = run_ref(dbdir, metas, snaps, topts)
    port_outs, stats = run_port(dbdir, metas, snaps, topts,
                                pipeline_shards=3)
    assert small_pipeline == {"ref": 1, "port": 1}, "a pipeline gave up"
    assert stats.pipelined
    assert_same_outputs(dbdir, ref_outs, port_outs)
    assert first_block_type(dbdir, port_outs) == topts.compression
    serial, sstats = run_port(dbdir, metas, snaps, topts, base=3000,
                              pipeline=False)
    assert not sstats.pipelined
    assert read_bytes(dbdir, serial) == read_bytes(dbdir, port_outs)


@pytest.mark.parametrize("codec,max_out", [
    ("lz4", 1 << 30), ("lz4hc", 8 * 1024), ("zlib", 1 << 30),
    ("bz2", 1 << 30), ("lzma", 1 << 30), ("zstd-level", 6 * 1024),
    ("zstd-dict", 1 << 30), ("zstd-dict", 6 * 1024), ("snappy", 8 * 1024),
])
def test_serial_route_parity(tmp_path, monkeypatch, codec, max_out):
    """The serial shard route (3 key-range shards streaming into the
    writer) over compressed inputs: the Python inflate for the codecs the
    native scan lacks and for dictionary frames, the per-block writer for
    them, the native sections for snappy / zstd; with output cutting
    where max_out is small."""
    monkeypatch.setenv("TPULSM_PIPELINE", "0")
    monkeypatch.setenv("TPULSM_DEVICE_SHARDS", "3")
    monkeypatch.setattr(ref_dc, "_SHARD_MIN_ROWS", 1)
    monkeypatch.setattr(dc, "_SHARD_MIN_ROWS", 1)
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 2400, seed=len(codec) + max_out % 7,
                       codec=codec, tombstone_file=max_out > (1 << 20))
    topts = ref_options(codec)
    ref_outs = run_ref(dbdir, metas, [800], topts, max_out)
    port_outs, stats = run_port(dbdir, metas, [800], topts, max_out,
                                pipeline=False, num_shards=3)
    assert not stats.pipelined
    assert_same_outputs(dbdir, ref_outs, port_outs)
    if max_out < (1 << 20):
        assert len(port_outs) > 1  # output cutting exercised


def test_dict_inputs_leave_the_pipeline(tmp_path, small_pipeline):
    """Dictionary-compressed inputs make both pipelines give up before
    they start (neither writes a file); both serial routes write the same
    bytes under the same file numbers."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, N, seed=5, codec="zstd-dict")
    topts = ref_options("zstd-dict")
    ref_outs = run_ref(dbdir, metas, [N // 2], topts)
    port_outs, stats = run_port(dbdir, metas, [N // 2], topts,
                                pipeline_shards=3)
    assert small_pipeline == {"ref": 0, "port": 0}
    assert not stats.pipelined
    assert_same_outputs(dbdir, ref_outs, port_outs)


@pytest.mark.parametrize("in_codec,out_codec", [
    ("none", "zstd"), ("snappy", "zstd-dict"), ("zstd", "lz4")])
def test_codec_change_across_the_job(tmp_path, monkeypatch, small_pipeline,
                                     in_codec, out_codec):
    """Inputs in one codec, outputs in another (bench.py's zstd-output
    row has uncompressed inputs): the reader takes each file's own type
    bytes and the writer the job's options."""
    monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "2")
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, N, seed=13, codec=in_codec)
    topts = ref_options(out_codec)
    ref_outs = run_ref(dbdir, metas, [], topts)
    port_outs, _ = run_port(dbdir, metas, [], topts, pipeline_shards=2)
    assert small_pipeline["ref"] == small_pipeline["port"]
    assert_same_outputs(dbdir, ref_outs, port_outs)


@pytest.mark.parametrize("codec", ["lz4", "zstd-dict", "zlib"])
def test_parallel_columnar_writer(tmp_path, monkeypatch, codec):
    """compression_parallel_threads > 1: the columnar writer compresses
    its per-block path on a pool and writes in order, the same bytes as
    the reference's and as one thread. One output file: with a pool, the
    cut point depends on which queued blocks have finished compressing
    (their raw size counts until then), on both sides."""
    monkeypatch.setenv("TPULSM_PIPELINE", "0")
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 2400, seed=17, codec="snappy",
                       tombstone_file=True)
    topts = ref_options(codec, compression_parallel_threads=4)
    ref_outs = run_ref(dbdir, metas, [300], topts)
    port_outs, _ = run_port(dbdir, metas, [300], topts, pipeline=False)
    assert_same_outputs(dbdir, ref_outs, port_outs)
    one, _ = run_port(dbdir, metas, [300], ref_options(codec), base=3000,
                      pipeline=False)
    assert read_bytes(dbdir, one) == read_bytes(dbdir, port_outs)


@pytest.mark.parametrize("codec", ["snappy", "zstd-dict", "bz2"])
def test_per_entry_route_with_filter(tmp_path, codec):
    """RemoveEmptyValueCompactionFilter sends the job to the per-entry
    route on both sides: the Python reader inflates (with the dictionary),
    the per-entry TableBuilder compresses."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 1600, seed=23, codec=codec, p_empty=0.2,
                       tombstone_file=True)
    topts = ref_options(codec)
    ref_outs = run_ref(dbdir, metas, [500], topts,
                       compaction_filter=RefRemoveEmpty())
    port_outs, stats = run_port(
        dbdir, metas, [500], topts, compaction_filter=create_compaction_filter(
            RefRemoveEmpty().name()))
    assert not stats.pipelined
    assert_same_outputs(dbdir, ref_outs, port_outs)


def test_device_blocks_with_compression_takes_the_packed_route(
        tmp_path, monkeypatch):
    """Block assembly refuses compressed output on both sides, so a
    device_blocks=True job (TPULSM_DEVICE_BLOCKS=1) takes the serial
    packed route and writes the same bytes."""
    monkeypatch.setenv("TPULSM_DEVICE_BLOCKS", "1")
    calls = {"ref": 0, "port": 0}
    for mod, name in ((ref_ba, "ref"), (ba, "port")):
        orig = mod.run_block_assembly

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "run_block_assembly", wrapped)
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 2400, seed=29, codec="snappy")
    topts = ref_options("snappy")
    ref_outs = run_ref(dbdir, metas, [1000], topts)
    port_outs, _ = run_port(dbdir, metas, [1000], topts, device_blocks=True)
    assert calls == {"ref": 0, "port": 0}
    assert_same_outputs(dbdir, ref_outs, port_outs)
    # The same job uncompressed does take block assembly on both sides.
    plain_dir = tmp_path / "plain"
    plain_dir.mkdir()
    metas = build_runs(str(plain_dir), 2400, seed=29, codec="none")
    ref_outs = run_ref(str(plain_dir), metas, [1000], ref_options("none"))
    port_outs, _ = run_port(str(plain_dir), metas, [1000],
                            ref_options("none"), device_blocks=True)
    assert calls == {"ref": 1, "port": 1}
    assert_same_outputs(str(plain_dir), ref_outs, port_outs)
