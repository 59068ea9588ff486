"""ZipTable in toplingdb_tpu_torch (table/zip_table.py and the zip plane of
its native library) against toplingdb_tpu's: the same entries built by
both packages' ZipTableBuilder, the same compaction job written by both
packages' zip columnar writer (serial and pipelined, the reference on
JAX's CPU backend, the port on device_name="cpu"), and the port's reader
against the reference's reader on the same files. SST bytes and
FileMetaData must be equal; `zip_plane=False` (the numpy encoders) must
write the native plane's bytes, and a failing native call must raise.
Tolerance: bitwise."""

import dataclasses
import os
import random

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
from toplingdb_tpu.table import factory as ref_factory
from toplingdb_tpu.table import format as ref_fmt
from toplingdb_tpu.table.builder import (
    CompressionOptions as RefCO,
    TableBuilder,
    TableOptions as RefTO,
)
from toplingdb_tpu.utils import codecs as ref_codecs

from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.range_del import (
    RangeTombstone,
    fragment_tombstones,
)
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.ops import pipeline as pl
from toplingdb_tpu_torch.ops.columnar_io import ColumnarKV
from toplingdb_tpu_torch.table import factory
from toplingdb_tpu_torch.table.zip_table import (
    ZipTableReader,
    write_tables_zip_columnar,
)
from toplingdb_tpu_torch.utils.status import Corruption

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()
ZSTD = (ref_fmt.ZSTD_COMPRESSION if ref_codecs.available("zstd")
        else ref_fmt.NO_COMPRESSION)


def plain_options(o) -> dict:
    """The reference options as plain values."""
    d = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)
         if isinstance(getattr(o, f.name), (bool, int, float, str))}
    d["filter_policy_name"] = o.filter_policy.name() if o.filter_policy \
        else ""
    d["compression_opts"] = dataclasses.asdict(o.compression_opts)
    return d


def port_options(o):
    return table_options_from_plain(plain_options(o))


def build_both(tmp_path, entries, ref_topts, tombstones=()):
    """The same entries through both packages' new_table_builder; returns
    the two files' bytes and the port file's path."""
    out = []
    for name, fac, icmp, env, topts in (
            ("ref", ref_factory, REF_ICMP, default_env(), ref_topts),
            ("port", factory, ICMP, PosixEnv(), port_options(ref_topts))):
        path = str(tmp_path / f"{name}.sst")
        w = env.new_writable_file(path)
        b = fac.new_table_builder(w, icmp, topts)
        for k, v in entries:
            b.add(k, v)
        for begin, end in tombstones:
            b.add_tombstone(begin, end)
        b.finish()
        w.close()
        out.append(open(path, "rb").read())
    return out[0], out[1], str(tmp_path / "port.sst")


def open_port(path, topts=None):
    r = factory.open_table(PosixEnv().new_random_access_file(path), ICMP,
                           topts)
    assert isinstance(r, ZipTableReader)
    return r


def _entries(rng, n, vlen_lo=4, vlen_hi=60):
    out = {}
    seq = 1
    for _ in range(n):
        k = b"user%07d" % rng.randrange(n * 3)
        out[k] = (make_internal_key(k, seq, ValueType.VALUE),
                  bytes(rng.randrange(97, 123)
                        for _ in range(rng.randrange(vlen_lo, vlen_hi))))
        seq += 1
    return [out[k] for k in sorted(out)]


@pytest.mark.parametrize("compression", [ref_fmt.NO_COMPRESSION, ZSTD])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 400])
def test_zip_round_trip(tmp_path, n, compression):
    """Mirrors tests/test_zip_table.py::test_zip_round_trip: equal bytes,
    and the port's reader iterates, seeks and walks back over them."""
    rng = random.Random(n + compression)
    entries = _entries(rng, n)
    topts = RefTO(format="zip", compression=compression, filter_policy=None)
    ref_b, port_b, path = build_both(tmp_path, entries, topts)
    assert port_b == ref_b
    it = open_port(path).new_iterator()
    it.seek_to_first()
    assert list(it.entries()) == entries
    for k, v in entries[:: max(1, len(entries) // 37)]:
        it.seek(k)
        assert it.valid() and it.key() == k and it.value() == v
    for i in range(0, len(entries) - 1, max(1, len(entries) // 11)):
        probe = entries[i][0][:-8] + b"\x00\xff"
        it.seek(make_internal_key(probe, 1 << 40, ValueType.MAX))
        assert it.valid() and it.key() == entries[i + 1][0]
    it.seek_to_last()
    rev = []
    while it.valid():
        rev.append((it.key(), it.value()))
        it.prev()
    assert rev == entries[::-1]


def test_zip_dict_compression_and_big_values(tmp_path):
    """Mirrors test_zip_dict_compression_and_big_values: a ZSTD dictionary
    over the value groups and one 70000-byte value (u32 length
    directory)."""
    if ZSTD == ref_fmt.NO_COMPRESSION:
        pytest.skip("libzstd unavailable")
    rng = random.Random(7)
    entries = []
    for i in range(3000):
        k = make_internal_key(b"k%07d" % i, i + 1, ValueType.VALUE)
        v = (b"prefix-common-" * 3) + (b"%d" % (i % 50)) * rng.randrange(1, 9)
        entries.append((k, v))
    entries[1234] = (entries[1234][0], b"Z" * 70000)
    topts = RefTO(format="zip", compression=ZSTD, filter_policy=None,
                  compression_opts=RefCO(max_dict_bytes=4096))
    ref_b, port_b, path = build_both(tmp_path, entries, topts)
    assert port_b == ref_b
    r = open_port(path)
    assert r.properties.compression_name == "zip+zstd"
    assert r.value_at(1234) == b"Z" * 70000
    it = r.new_iterator()
    it.seek_to_first()
    assert list(it.entries()) == entries
    assert len(port_b) < sum(len(k) + len(v) for k, v in entries)


def test_zip_tombstone_only_file(tmp_path):
    ref_b, port_b, path = build_both(
        tmp_path, [], RefTO(format="zip", filter_policy=None),
        tombstones=[(make_internal_key(b"a", 9, ValueType.RANGE_DELETION),
                     b"m")])
    assert port_b == ref_b
    r = open_port(path)
    assert len(r.range_del_entries()) == 1
    it = r.new_iterator()
    it.seek_to_first()
    assert not it.valid()


def test_zip_long_keys_meta16(tmp_path):
    """Keys past 255 bytes: u16 front-coding meta pairs."""
    entries = [(make_internal_key((b"longprefix-" * 30) + b"%06d" % i, i + 1,
                                  ValueType.VALUE), b"v%04d" % i)
               for i in range(120)]
    ref_b, port_b, path = build_both(
        tmp_path, entries, RefTO(format="zip", filter_policy=None))
    assert port_b == ref_b
    it = open_port(path).new_iterator()
    it.seek_to_first()
    assert list(it.entries()) == entries
    it.seek(entries[77][0])
    assert it.valid() and it.key() == entries[77][0]


def test_zip_reader_matches_reference_reader(tmp_path):
    """On port-written files the port's reader answers as the reference's
    reader does: scan_columnar (the native key and value-group decoders)
    over whole and partial ranges, seek, seek_for_prev, entry_lower_bound
    and the filter probe."""
    from toplingdb_tpu.table.zip_table import ZipTableReader as RefReader

    rng = random.Random(11)
    entries = _entries(rng, 900, 0, 300)
    topts = RefTO(format="zip", compression=ZSTD,
                  compression_opts=RefCO(max_dict_bytes=2048))
    ref_b, port_b, path = build_both(tmp_path, entries, topts)
    assert port_b == ref_b
    mine = open_port(path)
    ref = RefReader(default_env().new_random_access_file(path), REF_ICMP,
                    topts)
    assert mine.scan_native_ready()
    for e0, e1 in ((0, mine.n), (5, 17), (100, 613), (mine.n - 3, mine.n)):
        for a, b in zip(mine.scan_columnar(e0, e1),
                        ref.scan_columnar(e0, e1)):
            assert np.array_equal(a, b)
    mit, rit = mine.new_iterator(), ref.new_iterator()
    for i in range(0, len(entries), 7):
        k = entries[i][0]
        for probe in (k, k[:-8] + b"\x00",
                      make_internal_key(k[:-8], 0, ValueType.DELETION)):
            mit.seek(probe)
            rit.seek(probe)
            assert mit.valid() == rit.valid()
            if rit.valid():
                assert (mit.key(), mit.value()) == (rit.key(), rit.value())
            mit.seek_for_prev(probe)
            rit.seek_for_prev(probe)
            assert mit.valid() == rit.valid()
            if rit.valid():
                assert (mit.key(), mit.value()) == (rit.key(), rit.value())
            assert mine.entry_lower_bound(probe) == \
                ref.entry_lower_bound(probe)
        uk = k[:-8]
        assert mine.key_may_match(uk) == ref.key_may_match(uk) is True
        miss = b"absent%07d" % i
        assert mine.key_may_match(miss) == ref.key_may_match(miss)


# --- the zip writer on the compaction routes ------------------------------


def write_inputs(dbdir, rng, cut):
    """Three input SSTs written with the JAX package's TableBuilder (15%
    deletions, overwrites); returns the reference metas."""
    env = default_env()
    metas = []
    seq = 1
    for fnum in (81, 82, 83):
        entries = {}
        for _ in range(400):
            k = b"key%06d" % rng.randrange(600)
            t = (ValueType.VALUE if rng.random() < 0.85
                 else ValueType.DELETION)
            entries[k] = (make_internal_key(k, seq, t),
                          b"" if t != ValueType.VALUE
                          else b"val%06d" % seq * rng.randrange(1, 3))
            seq += 1
        path = ref_fn.table_file_name(dbdir, fnum)
        w = env.new_writable_file(path)
        b = TableBuilder(w, REF_ICMP, RefTO(block_size=512))
        for k, v in sorted(entries.values(),
                           key=lambda kv: REF_ICMP.sort_key(kv[0])):
            b.add(k, v)
        props = b.finish()
        w.close()
        metas.append(RefMeta(
            number=fnum, file_size=env.get_file_size(path),
            smallest=b.smallest_key, largest=b.largest_key,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno))
    return metas


def allocator(base):
    s = [base]

    def alloc():
        s[0] += 1
        return s[0]

    return alloc


def run_ref(dbdir, metas, out_topts, snaps, max_out, base=1000):
    c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=True, max_output_file_size=max_out)
    tc = RefTableCache(default_env(), dbdir, REF_ICMP, RefTO(block_size=512))
    outs, _ = ref_dc.run_device_compaction(
        default_env(), dbdir, REF_ICMP, c, tc, out_topts, snaps,
        new_file_number=allocator(base), creation_time=4,
        device_name="cpu")
    return outs


def run_port(dbdir, metas, out_topts, snaps, max_out, base=2000, **kw):
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = Compaction(level=0, output_level=2, inputs=inputs, bottommost=True,
                   max_output_file_size=max_out)
    tc = TableCache(PosixEnv(), dbdir, ICMP)
    return dc.run_device_compaction(
        PosixEnv(), dbdir, ICMP, c, tc, port_options(out_topts), snaps,
        new_file_number=allocator(base), creation_time=4,
        device_name="cpu", **kw)


def read_bytes(dbdir, outs):
    return [open(ref_fn.table_file_name(dbdir, m.number), "rb").read()
            for m in outs]


def assert_same_outputs(dbdir, ref_outs, port_outs, ref_base=1000,
                        port_base=2000):
    assert ref_outs and len(ref_outs) == len(port_outs)
    assert read_bytes(dbdir, port_outs) == read_bytes(dbdir, ref_outs)
    for r, p in zip(ref_outs, port_outs):
        a, b = dataclasses.asdict(r), dataclasses.asdict(p)
        assert a.pop("number") - ref_base == b.pop("number") - port_base
        assert a == b


@pytest.fixture
def no_per_entry(monkeypatch):
    """The port's job must stay on the columnar route."""
    def fail(*a, **k):
        raise AssertionError("the zip job fell back to the per-entry route")

    monkeypatch.setattr(dc, "collect_raw_entries", fail)


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("zip_plane", [True, False])
def test_zip_columnar_writer_byte_parity(tmp_path, no_per_entry, cut,
                                         zip_plane):
    """Mirrors test_zip_columnar_writer_byte_parity: a zstd zip job through
    the serial columnar route writes the reference's bytes, output cuts
    included, on the native plane and on the numpy encoders."""
    dbdir = str(tmp_path)
    metas = write_inputs(dbdir, random.Random(31 + cut), cut)
    topts = RefTO(format="zip", compression=ZSTD)
    max_out = 6000 if cut else 1 << 62
    ref_outs = run_ref(dbdir, metas, topts, [300], max_out)
    port_outs, stats = run_port(dbdir, metas, topts, [300], max_out,
                                pipeline=False, zip_plane=zip_plane)
    assert len(port_outs) >= (2 if cut else 1)
    assert_same_outputs(dbdir, ref_outs, port_outs)


def test_zip_columnar_tombstone_only_parity(tmp_path):
    """An entry-less zip output holding only a range tombstone: the port's
    columnar writer writes the reference's per-entry builder's bytes."""
    from toplingdb_tpu.db.range_del import (
        RangeTombstone as RefTomb,
        fragment_tombstones as ref_frag,
    )

    env = default_env()
    p1 = str(tmp_path / "ref.sst")
    w = env.new_writable_file(p1)
    b = ref_factory.new_table_builder(w, REF_ICMP,
                                      RefTO(format="zip", filter_policy=None),
                                      column_family_name="default")
    for f in ref_frag([RefTomb(42, b"aaa", b"mmm")],
                      REF_ICMP.user_comparator):
        b.add_tombstone(*f.to_table_entry())
    b.finish()
    w.close()
    frags = fragment_tombstones([RangeTombstone(42, b"aaa", b"mmm")],
                                ICMP.user_comparator)
    kv = ColumnarKV(np.zeros(0, np.uint8), np.zeros(0, np.int32),
                    np.zeros(0, np.int32), np.zeros(0, np.uint8),
                    np.zeros(0, np.int32), np.zeros(0, np.int32))
    res = write_tables_zip_columnar(
        PosixEnv(), str(tmp_path), lambda: 7, ICMP,
        port_options(RefTO(format="zip", filter_policy=None)), kv,
        np.empty(0, np.int64), np.empty(0, np.int64),
        np.empty(0, np.int32), np.empty(0, np.uint64), 0,
        tombstones=frags)
    assert len(res) == 1
    assert open(res[0][1], "rb").read() == open(p1, "rb").read()
    assert res[0][2].smallest_seqno == 42


def build_runs(dbdir, n_total, seed, runs=4):
    """4 presorted runs written with the JAX package's columnar writer (2x
    overwrites, 15% deletions, 8-digit keys) and one TableBuilder file
    holding 50 points and a range tombstone newer than every point."""
    env = default_env()
    topts = RefTO(block_size=512)
    rng = np.random.default_rng(seed)
    per_run = n_total // runs
    metas = []
    fnum = [20]

    def alloc():
        fnum[0] += 1
        return fnum[0]

    def meta(f, smallest, largest, props):
        return RefMeta(number=f, file_size=env.get_file_size(
            ref_fn.table_file_name(dbdir, f)), smallest=smallest,
            largest=largest, smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno)

    for run in range(runs):
        n = per_run
        draws = rng.integers(0, n_total // 2, n)
        seqs = np.arange(run * per_run + 1, run * per_run + n + 1,
                         dtype=np.uint64)
        vts = np.where(rng.random(n) < 0.15, int(ValueType.DELETION),
                       int(ValueType.VALUE)).astype(np.int32)
        uks = [b"%08d" % d for d in draws]
        s = sorted(range(n), key=lambda i: (uks[i], -int(seqs[i])))
        keys = [make_internal_key(uks[i], int(seqs[i]), int(vts[i]))
                for i in s]
        vals = [b"v%019d" % seqs[i] if vts[i] else b"" for i in s]
        klens = np.array([len(k) for k in keys], dtype=np.int32)
        vlens = np.array([len(v) for v in vals], dtype=np.int32)
        kv = RefKV(np.frombuffer(b"".join(keys), np.uint8).copy(),
                   (np.cumsum(klens) - klens).astype(np.int32), klens,
                   np.frombuffer(b"".join(vals), np.uint8).copy(),
                   (np.cumsum(vlens) - vlens).astype(np.int32), vlens)
        for f, _p, props, smallest, largest, _sel in ref_write(
                env, dbdir, alloc, REF_ICMP, topts, kv,
                np.arange(n, dtype=np.int32), np.full(n, -1, np.int64),
                vts[s], seqs[s], [], creation_time=1):
            metas.append(meta(f, smallest, largest, props))
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
    metas.append(meta(f, b.smallest_key, b.largest_key, props))
    return metas


@pytest.fixture
def small_pipeline(monkeypatch):
    """Both pipelines at test size; returns the engaged-call counters."""
    monkeypatch.setattr(ref_pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    for var in ("TPULSM_PIPELINE", "TPULSM_HOST_SORT", "TPULSM_ZIP_PLANE",
                "TPULSM_DEVICE_BLOCKS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "4")
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


def test_pipeline_zip_byte_parity(tmp_path, monkeypatch, small_pipeline):
    """Mirrors tests/test_compaction_pipeline.py::
    test_pipeline_zip_byte_parity: zip outputs ride both pipelines with
    snapshots and a surviving range tombstone; the port's pipelined bytes
    equal the reference's pipelined bytes and the port's serial route's;
    zip_plane=False keeps the job off the pipeline and the numpy encoders
    write the same bytes again."""
    dbdir = str(tmp_path)
    n = 6000
    metas = build_runs(dbdir, n, seed=3)
    snaps = [n // 3, 2 * n // 3]
    topts = RefTO(format="zip", compression=ZSTD)
    ref_outs = run_ref(dbdir, metas, topts, snaps, 1 << 62)
    piped, pstats = run_port(dbdir, metas, topts, snaps, 1 << 62,
                             pipeline_shards=4)
    assert small_pipeline == {"ref": 1, "port": 1}, "a pipeline gave up"
    assert pstats.pipelined
    assert_same_outputs(dbdir, ref_outs, piped)
    assert len(piped) == 1 and piped[0].num_range_deletions
    serial, sstats = run_port(dbdir, metas, topts, snaps, 1 << 62,
                              base=3000, pipeline=False)
    assert not sstats.pipelined
    assert_same_outputs(dbdir, ref_outs, serial, port_base=3000)
    off, ostats = run_port(dbdir, metas, topts, snaps, 1 << 62, base=4000,
                           zip_plane=False)
    assert small_pipeline["port"] == 1 and not ostats.pipelined
    assert_same_outputs(dbdir, ref_outs, off, port_base=4000)


@pytest.mark.parametrize("kernel", ["tpulsm_zip_newkey",
                                    "tpulsm_zip_encode_keys",
                                    "tpulsm_zip_encode_values"])
def test_failed_native_zip_call_raises(tmp_path, monkeypatch, kernel):
    """A native zip call that fails raises Corruption out of
    run_device_compaction: no switch to the numpy encoders, no per-entry
    route, and no output left behind."""
    dbdir = str(tmp_path)
    metas = write_inputs(dbdir, random.Random(5), False)
    before = sorted(os.listdir(dbdir))

    def failing(*a):
        return -3

    monkeypatch.setattr(native.lib(), kernel, failing)
    monkeypatch.setattr(dc, "collect_raw_entries", None)
    with pytest.raises(Corruption, match="native zip"):
        run_port(dbdir, metas, RefTO(format="zip", compression=ZSTD), [],
                 1 << 62, pipeline=False)
    assert sorted(os.listdir(dbdir)) == before


def test_zip_inputs_take_the_per_entry_route(tmp_path, monkeypatch):
    """Zip inputs cannot be scanned columnar: the job takes the per-entry
    route (the columnar scan refuses them) and writes the bytes that the
    same entries in block-based inputs give on the reference's device
    route."""
    dbdir = str(tmp_path)
    metas = write_inputs(dbdir, random.Random(8), False)
    ref_outs = run_ref(dbdir, metas, RefTO(block_size=512), [], 1 << 62)
    # The same entries again as zip inputs, written by the port.
    env = PosixEnv()
    zip_metas = []
    for m in metas:
        r = factory.open_table(env.new_random_access_file(
            ref_fn.table_file_name(dbdir, m.number)), ICMP)
        it = r.new_iterator()
        it.seek_to_first()
        path = ref_fn.table_file_name(dbdir, m.number + 100)
        w = env.new_writable_file(path)
        b = factory.new_table_builder(
            w, ICMP, port_options(RefTO(format="zip")))
        for k, v in it.entries():
            b.add(k, v)
        props = b.finish()
        w.close()
        zip_metas.append(RefMeta(
            number=m.number + 100, file_size=env.get_file_size(path),
            smallest=b.smallest_key, largest=b.largest_key,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno))
    calls = []
    orig = dc.collect_raw_entries

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(dc, "collect_raw_entries", spy)
    port_outs, stats = run_port(dbdir, zip_metas, RefTO(block_size=512), [],
                                1 << 62)
    assert calls == [1] and not stats.pipelined
    assert_same_outputs(dbdir, ref_outs, port_outs)
