"""Every table format and table option of toplingdb_tpu_torch against
toplingdb_tpu's: per-entry protection on the serial, pipelined and
block-assembly routes (and a tampered output raising Corruption), a
two-level index and partitioned filters as outputs and as inputs, prefix
extractors on the per-entry and the columnar route, property collectors,
the single_fast, plain and cuckoo formats (round trips and compactions),
`open_table` on all five footer magics, and `interop.table_options_from_
plain` on every field these add. The reference runs on JAX's CPU backend,
the port on device_name="cpu"; SST bytes and FileMetaData must be equal.
Tolerance: bitwise."""

import dataclasses
import os
import random

import numpy as np
import pytest

from toplingdb_tpu.compaction.compaction_job import (
    run_compaction_to_tables as ref_run_to_tables,
)
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
from toplingdb_tpu.ops import columnar_io as ref_cio
from toplingdb_tpu.ops import device_compaction as ref_dc
from toplingdb_tpu.ops import pipeline as ref_pl
from toplingdb_tpu.table import block as ref_block
from toplingdb_tpu.table import factory as ref_factory
from toplingdb_tpu.table.builder import TableBuilder, TableOptions as RefTO
from toplingdb_tpu.utils.slice_transform import (
    CappedPrefixTransform as RefCapped,
    FixedPrefixTransform as RefFixed,
)
from toplingdb_tpu.utils.status import (
    Corruption as RefCorruption,
    NotSupported as RefNotSupported,
)
from toplingdb_tpu.utils.table_properties_collector import (
    CompactOnDeletionCollectorFactory as RefCollector,
)

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.ops import block_assembly as ba
from toplingdb_tpu_torch.ops import columnar_io as cio
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.ops import pipeline as pl
from toplingdb_tpu_torch.table import block as port_block
from toplingdb_tpu_torch.table import factory
from toplingdb_tpu_torch.table.cuckoo import CuckooTableReader
from toplingdb_tpu_torch.table.plain import PlainTableReader
from toplingdb_tpu_torch.table.reader import TableReader
from toplingdb_tpu_torch.table.single_fast import SingleFastTableReader
from toplingdb_tpu_torch.table.zip_table import ZipTableReader
from toplingdb_tpu_torch.utils.status import (
    Corruption,
    InvalidArgument,
    NotSupported,
)

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()
BLOCK = 512
N = 6000


def plain_options(o) -> dict:
    """The reference options as plain values, the prefix extractor by name
    and the collectors serialized."""
    d = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)
         if isinstance(getattr(o, f.name), (bool, int, float, str))}
    d["filter_policy_name"] = o.filter_policy.name() if o.filter_policy \
        else ""
    d["compression_opts"] = dataclasses.asdict(o.compression_opts)
    d["prefix_extractor"] = (o.prefix_extractor.name()
                             if o.prefix_extractor else None)
    d["properties_collector_factories"] = [
        f.serialize() for f in o.properties_collector_factories]
    return d


def port_options(o):
    return table_options_from_plain(plain_options(o))


def allocator(base):
    s = [base]

    def alloc():
        s[0] += 1
        return s[0]

    return alloc


def _meta(env, dbdir, fnum, smallest, largest, props):
    return RefMeta(number=fnum, file_size=env.get_file_size(
        ref_fn.table_file_name(dbdir, fnum)), smallest=smallest,
        largest=largest, smallest_seqno=props.smallest_seqno,
        largest_seqno=props.largest_seqno)


def build_runs(dbdir, n_total, seed, runs=4, in_topts=None):
    """`runs` presorted input files written with the JAX package's
    TableBuilder under `in_topts` (2x overwrites, 15% deletions, 8-digit
    keys, 20-byte values)."""
    env = default_env()
    in_topts = in_topts or RefTO(block_size=BLOCK)
    rng = np.random.default_rng(seed)
    per_run = n_total // runs
    metas = []
    for run in range(runs):
        draws = rng.integers(0, n_total // 2, per_run)
        dels = rng.random(per_run) < 0.15
        ents = {}
        for i in range(per_run):
            seq = run * per_run + i + 1
            t = ValueType.DELETION if dels[i] else ValueType.VALUE
            uk = b"%08d" % draws[i]
            ents[(uk, seq)] = (make_internal_key(uk, seq, t),
                               b"" if dels[i] else b"v%019d" % seq)
        fnum = 21 + run
        path = ref_fn.table_file_name(dbdir, fnum)
        w = env.new_writable_file(path)
        b = ref_factory.new_table_builder(w, REF_ICMP, in_topts)
        for k, v in sorted(ents.values(),
                           key=lambda kv: REF_ICMP.sort_key(kv[0])):
            b.add(k, v)
        props = b.finish()
        w.close()
        metas.append(_meta(env, dbdir, fnum, b.smallest_key, b.largest_key,
                           props))
    return metas


def run_ref(dbdir, metas, topts, snaps=(), bottommost=True,
            max_out=1 << 30, base=1000, in_topts=None):
    c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=bottommost, max_output_file_size=max_out)
    tc = RefTableCache(default_env(), dbdir, REF_ICMP,
                       in_topts or RefTO(block_size=BLOCK))
    outs, _ = ref_dc.run_device_compaction(
        default_env(), dbdir, REF_ICMP, c, tc, topts, list(snaps),
        new_file_number=allocator(base), creation_time=7, device_name="cpu")
    return outs


def run_port(dbdir, metas, topts, snaps=(), bottommost=True,
             max_out=1 << 30, base=2000, **kw):
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = Compaction(level=0, output_level=2, inputs=inputs,
                   bottommost=bottommost, max_output_file_size=max_out)
    tc = TableCache(PosixEnv(), dbdir, ICMP)
    return dc.run_device_compaction(
        PosixEnv(), dbdir, ICMP, c, tc, port_options(topts), list(snaps),
        new_file_number=allocator(base), creation_time=7, device_name="cpu",
        **kw)


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


def spy(monkeypatch, mod, name):
    calls = []
    orig = getattr(mod, name)

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.fixture
def routes(monkeypatch):
    """Both packages' route switches at test size (pipeline row floor
    lowered, environment knobs cleared)."""
    monkeypatch.setattr(ref_pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    for var in ("TPULSM_PIPELINE", "TPULSM_HOST_SORT", "TPULSM_ZIP_PLANE",
                "TPULSM_DEVICE_BLOCKS", "TPULSM_PIPELINE_SHARDS"):
        monkeypatch.delenv(var, raising=False)

    def select(route):
        """The reference's knobs for `route`; returns the port's
        run_device_compaction arguments."""
        if route == "serial":
            monkeypatch.setenv("TPULSM_PIPELINE", "0")
            return dict(pipeline=False)
        if route == "pipelined":
            monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "3")
            return dict(pipeline=True, pipeline_shards=3)
        monkeypatch.setenv("TPULSM_DEVICE_BLOCKS", "1")
        return dict(device_blocks=True)

    return select


# --- per-entry protection --------------------------------------------------


@pytest.mark.parametrize("route", ["serial", "pipelined", "blocks"])
@pytest.mark.parametrize("pb", [1, 8])
def test_protection_on_every_columnar_route(tmp_path, monkeypatch, routes,
                                            route, pb):
    """protection_bytes_per_key on: each output is verified, and the bytes
    equal the unprotected run's and the reference's on the same route."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, N, seed=5)
    kw = routes(route)
    engaged = {"pipelined": (spy(monkeypatch, ref_pl, "run_pipelined"),
                             spy(monkeypatch, pl, "run_pipelined")),
               "blocks": (spy(monkeypatch, ref_ba, "run_block_assembly"),
                          spy(monkeypatch, ba, "run_block_assembly"))}
    verified = spy(monkeypatch, dc, "verify_output_table")
    topts = RefTO(block_size=BLOCK, protection_bytes_per_key=pb)
    ref_outs = run_ref(dbdir, metas, topts)
    port_outs, stats = run_port(dbdir, metas, topts, **kw)
    assert_same_outputs(dbdir, ref_outs, port_outs)
    assert len(verified) == len(port_outs)
    plain_outs, _ = run_port(dbdir, metas, RefTO(block_size=BLOCK),
                             base=3000, **kw)
    assert read_bytes(dbdir, plain_outs) == read_bytes(dbdir, port_outs)
    if route in engaged:
        assert [len(c) for c in engaged[route]] == [1, 2]
    assert stats.pipelined == (route == "pipelined")


def _flip_value_byte(kv):
    """Flip the first value byte of every row (restored by a second call)."""
    buf = kv.val_buf
    if not buf.flags.writeable:
        kv.val_buf = buf = buf.copy()
    first = kv.val_offs[kv.val_lens > 0]
    buf[first] ^= 0x20


@pytest.mark.parametrize("route", ["columnar", "per_entry"])
def test_tampered_output_raises_corruption(tmp_path, monkeypatch, routes,
                                           route):
    """A writer that alters one value byte per entry before the block is
    framed (checksums still good): both packages raise Corruption; the
    port leaves no file on either route. On the per-entry route the flip
    sits in the block builder, on the columnar route in the native
    writer's input rows."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 2000, seed=6)
    topts = RefTO(block_size=BLOCK, protection_bytes_per_key=8)
    before = set(os.listdir(dbdir))
    if route == "columnar":
        routes("serial")
        # A retry with conservative kernels would follow a failure of the
        # reference's columnar route; with both knobs at 0 it raises.
        monkeypatch.setenv("TPULSM_PALLAS_GC", "0")
        monkeypatch.setenv("TPULSM_DEVICE_MERGE", "0")
        for mod in (ref_cio, cio):
            orig = mod.write_tables_columnar

            def tampered(env, dbname, nfn, icmp, options, kv, *a,
                         _orig=orig, **k):
                _flip_value_byte(kv)
                try:
                    return _orig(env, dbname, nfn, icmp, options, kv, *a,
                                 **k)
                finally:
                    _flip_value_byte(kv)

            monkeypatch.setattr(mod, "write_tables_columnar", tampered)
        kw = dict(pipeline=False)
    else:
        # Collectors send the job to the per-entry route on both sides.
        topts.properties_collector_factories = [RefCollector(64, 32)]
        for mod in (ref_block, port_block):
            orig = mod.BlockBuilder.add

            def add(self, key, value, _orig=orig):
                if value[:2] == b"v0":  # the entries' values only
                    value = b"V" + value[1:]
                return _orig(self, key, value)

            monkeypatch.setattr(mod.BlockBuilder, "add", add)
        kw = {}
    with pytest.raises(RefCorruption, match="does not match"):
        run_ref(dbdir, metas, topts)
    if route == "per_entry":
        assert set(os.listdir(dbdir)) == before
    for f in set(os.listdir(dbdir)) - before:
        os.remove(os.path.join(dbdir, f))
    with pytest.raises(Corruption, match="does not match"):
        run_port(dbdir, metas, topts, **kw)
    assert set(os.listdir(dbdir)) == before


# --- two-level index, partitioned filters, prefix extractors --------------


@pytest.mark.parametrize("opts", [
    dict(index_type="two_level", metadata_block_size=256),
    dict(index_type="two_level", metadata_block_size=256,
         partition_filters=True),
    dict(partition_filters=True, metadata_block_size=256),
])
def test_partitioned_outputs(tmp_path, monkeypatch, routes, opts):
    """A two-level index sends the job to the per-entry route on both
    sides; partitioned filters alone stay on the columnar route, whose
    writer (the reference's as the port's) writes one whole-key filter."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 2000, seed=7)
    routes("serial")
    per_entry = spy(monkeypatch, dc, "collect_raw_entries")
    topts = RefTO(block_size=BLOCK, **opts)
    ref_outs = run_ref(dbdir, metas, topts)
    port_outs, _ = run_port(dbdir, metas, topts, pipeline=False)
    assert_same_outputs(dbdir, ref_outs, port_outs)
    assert len(per_entry) == (opts.get("index_type") == "two_level")
    r = factory.open_table(PosixEnv().new_random_access_file(
        ref_fn.table_file_name(dbdir, port_outs[0].number)), ICMP)
    assert r.properties.index_type == opts.get("index_type", "binary")
    assert (r._filter_top is not None) == bool(
        per_entry and opts.get("partition_filters"))


@pytest.mark.parametrize("route", ["serial", "pipelined"])
def test_two_level_inputs(tmp_path, monkeypatch, routes, route):
    """Inputs with a two-level index and partitioned filters: the columnar
    scans walk the index partitions; serial and pipelined jobs write the
    reference's bytes. The port's reader seeks and probes them."""
    dbdir = str(tmp_path)
    in_topts = RefTO(block_size=BLOCK, index_type="two_level",
                     metadata_block_size=128, partition_filters=True)
    metas = build_runs(dbdir, N, seed=8, in_topts=in_topts)
    kw = routes(route)
    piped = spy(monkeypatch, pl, "run_pipelined")
    per_entry = spy(monkeypatch, dc, "collect_raw_entries")
    topts = RefTO(block_size=BLOCK)
    ref_outs = run_ref(dbdir, metas, topts, in_topts=in_topts)
    port_outs, stats = run_port(dbdir, metas, topts, **kw)
    assert_same_outputs(dbdir, ref_outs, port_outs)
    assert not per_entry and stats.pipelined == (route == "pipelined")
    assert len(piped) == (route == "pipelined")
    ref_r = ref_factory.open_table(default_env().new_random_access_file(
        ref_fn.table_file_name(dbdir, metas[0].number)), REF_ICMP,
        in_topts)
    r = factory.open_table(PosixEnv().new_random_access_file(
        ref_fn.table_file_name(dbdir, metas[0].number)), ICMP)
    assert isinstance(r, TableReader) and r._partitioned_index
    it, rit = r.new_iterator(), ref_r.new_iterator()
    for i in range(0, N, 97):
        probe = make_internal_key(b"%08d" % i, 1 << 50, ValueType.VALUE)
        for a, b in ((it, rit),):
            a.seek(probe)
            b.seek(probe)
            assert a.valid() == b.valid()
            if b.valid():
                assert (a.key(), a.value()) == (b.key(), b.value())
            a.seek_for_prev(probe)
            b.seek_for_prev(probe)
            assert a.valid() == b.valid()
            if b.valid():
                assert a.key() == b.key()
        uk = b"%08d" % i
        assert r.key_may_match(uk) == ref_r.key_may_match(uk)


def _first_difference(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    diff = np.flatnonzero(np.frombuffer(a[:n], np.uint8)
                          != np.frombuffer(b[:n], np.uint8))
    return int(diff[0]) if len(diff) else n


@pytest.mark.parametrize("pe", ["fixed", "capped"])
def test_prefix_extractor_on_both_routes(tmp_path, monkeypatch, routes, pe):
    """A prefix extractor: the device route's columnar writer (the
    reference's as the port's) writes a whole-key filter and records no
    extractor, the per-entry TableBuilder adds prefix filter keys and the
    extractor's name. The port matches the reference on each route; the
    two routes of the reference differ from the filter block on (see
    ROADMAP §C). Block assembly refuses such jobs on both sides."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 2000, seed=9)
    routes("blocks")
    blocks = (spy(monkeypatch, ref_ba, "run_block_assembly"),
              spy(monkeypatch, ba, "run_block_assembly"))
    topts = RefTO(block_size=BLOCK, prefix_extractor=(
        RefFixed(5) if pe == "fixed" else RefCapped(6)))
    col_ref = run_ref(dbdir, metas, topts)
    col_port, _ = run_port(dbdir, metas, topts, device_blocks=True)
    assert_same_outputs(dbdir, col_ref, col_port)
    assert blocks == ([], [])
    # The per-entry route: the reference's host CompactionIterator job
    # against the port's per-entry device route.
    rc = RefCompaction(level=0, output_level=2, inputs=list(metas),
                       bottommost=True, max_output_file_size=1 << 30)
    pe_ref, _ = ref_run_to_tables(
        default_env(), dbdir, REF_ICMP, rc, RefTableCache(
            default_env(), dbdir, REF_ICMP, RefTO(block_size=BLOCK)),
        topts, [], new_file_number=allocator(3000), creation_time=7)
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    pe_port, _ = dc._run_per_entry(
        PosixEnv(), dbdir, ICMP, Compaction(
            level=0, output_level=2, inputs=inputs, bottommost=True,
            max_output_file_size=1 << 30),
        TableCache(PosixEnv(), dbdir, ICMP), port_options(topts), [], None,
        None, allocator(4000), 7, "cpu", None, None, (0, "default"))
    assert_same_outputs(dbdir, pe_ref, pe_port, 3000, 4000)
    col, per = read_bytes(dbdir, col_ref)[0], read_bytes(dbdir, pe_ref)[0]
    assert col != per
    # The data blocks agree; the filter block is the first difference.
    r = factory.open_table(PosixEnv().new_random_access_file(
        ref_fn.table_file_name(dbdir, pe_port[0].number)), ICMP)
    fh = r._meta_handles[b"filter.fullfilter"]
    assert _first_difference(col, per) >= fh.offset
    assert r.properties.prefix_extractor_name == topts.prefix_extractor.name()
    assert r.prefix_may_match(b"%08d" % 123)


# --- property collectors ---------------------------------------------------


def test_collectors_take_the_per_entry_route(tmp_path, monkeypatch,
                                             routes):
    """A CompactOnDeletionCollector: the job takes the per-entry route on
    both sides; the outputs carry its properties and both packages mark
    the same files for compaction."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 2000, seed=10)
    routes("serial")
    per_entry = spy(monkeypatch, dc, "collect_raw_entries")
    topts = RefTO(block_size=BLOCK, properties_collector_factories=[
        RefCollector(window_size=32, deletion_trigger=6)])
    ref_outs = run_ref(dbdir, metas, topts, snaps=[900], bottommost=False,
                       max_out=8 * 1024)
    port_outs, _ = run_port(dbdir, metas, topts, snaps=[900],
                            bottommost=False, max_out=8 * 1024)
    assert_same_outputs(dbdir, ref_outs, port_outs)
    assert per_entry == [1] and len(port_outs) > 1
    assert any(m.marked_for_compaction for m in port_outs)


# --- single_fast, plain, cuckoo -------------------------------------------


def _build_both(tmp_path, entries, ref_topts, tombstones=()):
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
    assert out[0] == out[1]
    return factory.open_table(PosixEnv().new_random_access_file(
        str(tmp_path / "port.sst")), ICMP, port_options(ref_topts))


def _sorted_entries(n, key_space, seed, unique=False):
    rng = random.Random(seed)
    ents = {}
    for seq in range(1, n + 1):
        uk = b"key%05d" % rng.randrange(key_space)
        ents[uk if unique else (uk, seq)] = (
            make_internal_key(uk, seq, ValueType.VALUE), b"v%d" % seq)
    return sorted(ents.values(), key=lambda kv: REF_ICMP.sort_key(kv[0]))


def test_single_fast_round_trip(tmp_path):
    """Mirrors tests/test_single_fast.py:37-74: magic dispatch, iteration,
    seek / prev, the bloom, the hash index, range tombstones, anchors and
    the data-region checksum."""
    entries = [(make_internal_key(b"key%05d" % i, i + 1, ValueType.VALUE),
                b"val%05d" % i) for i in range(300)]
    begin = make_internal_key(b"key00010", 999, ValueType.RANGE_DELETION)
    r = _build_both(tmp_path, entries, RefTO(format="single_fast",
                                             hash_index=True),
                    tombstones=[(begin, b"key00020")])
    assert isinstance(r, SingleFastTableReader) and r.has_hash_index
    it = r.new_iterator()
    it.seek_to_first()
    assert list(it.entries()) == entries
    it.seek(make_internal_key(b"key00150", 2**56 - 1, 0x7F))
    assert it.key() == entries[150][0]
    it.prev()
    assert it.key() == entries[149][0]
    assert r.key_may_match(b"key00001")
    assert sum(r.key_may_match(b"no%05d" % i) for i in range(1000)) < 60
    assert r._entry(r.hash_probe(b"key00077")) == entries[77]
    assert r.hash_probe(b"nope") is None
    assert r.range_del_entries() == [(begin, b"key00020")]
    assert len(r.anchors(8)) == 8
    data = bytearray(open(tmp_path / "port.sst", "rb").read())
    data[40] ^= 0xFF
    open(tmp_path / "bad.sst", "wb").write(bytes(data))
    with pytest.raises(Corruption):
        factory.open_table(PosixEnv().new_random_access_file(
            str(tmp_path / "bad.sst")), ICMP)


def test_plain_round_trip(tmp_path):
    """Mirrors tests/test_plain_table.py:72-123: the prefix hash index,
    out-of-domain keys, the newest version winning, prefix groups; and
    the extractor being required."""
    entries = []
    for grp in (b"aaaa", b"bbbb", b"cccc"):
        for i in range(5):
            entries.append((make_internal_key(grp + b"%02d" % i, 10 + i,
                                              ValueType.VALUE), b"v" + grp))
    entries.append((make_internal_key(b"aaaa01", 3, ValueType.VALUE),
                    b"old"))
    entries.append((make_internal_key(b"zz", 3, ValueType.VALUE), b"short"))
    entries.sort(key=lambda kv: REF_ICMP.sort_key(kv[0]))
    r = _build_both(tmp_path, entries, RefTO(
        format="plain", prefix_extractor=RefFixed(4)))
    assert isinstance(r, PlainTableReader) and r.has_hash_index
    assert r.properties.prefix_extractor_name == "tpulsm.FixedPrefix.4"
    assert r._entry(r.hash_probe(b"bbbb03"))[0][:-8] == b"bbbb03"
    assert r._entry(r.hash_probe(b"aaaa01"))[1] == b"vaaaa"
    assert r.hash_probe(b"bbbb99") is None and r.hash_probe(b"qqqq00") is None
    assert r._entry(r.hash_probe(b"zz"))[1] == b"short"
    assert r._entry(r.prefix_seek_start(b"cccc"))[0][:-8] == b"cccc00"
    assert r.prefix_seek_start(b"dddd") is None
    it = r.new_iterator()
    it.seek_to_first()
    assert [k for k, _ in it.entries()] == [k for k, _ in entries]
    with pytest.raises(InvalidArgument):
        factory.new_table_builder(
            PosixEnv().new_writable_file(str(tmp_path / "x.sst")), ICMP,
            port_options(RefTO(format="plain")))


def test_cuckoo_round_trip(tmp_path):
    """Mirrors tests/test_cuckoo.py:40-93 and 165-194: every key resolves
    in two buckets, absent keys are rejected, duplicate user keys and
    range deletions are refused, the empty table reads."""
    entries = _sorted_entries(2000, 10 ** 5, 11, unique=True)
    r = _build_both(tmp_path, entries, RefTO(format="cuckoo"))
    assert isinstance(r, CuckooTableReader) and r.has_hash_index
    for ik, v in entries:
        assert r._entry(r.hash_probe(ik[:-8])) == (ik, v)
    for uk in (b"nope", b"key99999x", b""):
        assert r.hash_probe(uk) is None
    it = r.new_iterator()
    it.seek_to_first()
    assert list(it.entries()) == entries
    w = PosixEnv().new_writable_file(str(tmp_path / "dup.sst"))
    b = factory.new_table_builder(w, ICMP,
                                  port_options(RefTO(format="cuckoo")))
    b.add(make_internal_key(b"aaa", 5, ValueType.VALUE), b"v1")
    with pytest.raises(NotSupported):
        b.add(make_internal_key(b"aaa", 3, ValueType.VALUE), b"v0")
    with pytest.raises(NotSupported):
        b.add_tombstone(make_internal_key(b"b", 9, ValueType.RANGE_DELETION),
                        b"c")
    w.close()
    empty = _build_both(tmp_path, [], RefTO(format="cuckoo"))
    assert empty.hash_probe(b"anything") is None


@pytest.mark.parametrize("fmt_,opts", [
    ("single_fast", {}),
    ("single_fast", dict(hash_index=True)),
    ("plain", dict(prefix_extractor=RefFixed(6))),
    ("cuckoo", {}),
])
def test_per_entry_format_compactions(tmp_path, monkeypatch, routes, fmt_,
                                      opts):
    """Each format as the output of a bottommost job with no snapshots
    (one version per key: what cuckoo requires): the per-entry route on
    both sides, the same bytes, cuts and FileMetaData."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 2000, seed=12)
    routes("serial")
    per_entry = spy(monkeypatch, dc, "collect_raw_entries")
    topts = RefTO(format=fmt_, **opts)
    ref_outs = run_ref(dbdir, metas, topts, max_out=12 * 1024)
    port_outs, _ = run_port(dbdir, metas, topts, max_out=12 * 1024)
    assert_same_outputs(dbdir, ref_outs, port_outs)
    assert per_entry == [1] and len(port_outs) > 1
    reader_cls = {"single_fast": SingleFastTableReader,
                  "plain": PlainTableReader,
                  "cuckoo": CuckooTableReader}[fmt_]
    r = factory.open_table(PosixEnv().new_random_access_file(
        ref_fn.table_file_name(dbdir, port_outs[0].number)), ICMP,
        port_options(topts))
    assert isinstance(r, reader_cls)


def test_cuckoo_refusal_leaves_no_output(tmp_path, routes):
    """Several versions of a key survive under a snapshot: both packages
    refuse the cuckoo job mid-stream and leave no file."""
    dbdir = str(tmp_path)
    metas = build_runs(dbdir, 2000, seed=13)
    routes("serial")
    before = set(os.listdir(dbdir))
    topts = RefTO(format="cuckoo")
    with pytest.raises(RefNotSupported):
        run_ref(dbdir, metas, topts, snaps=[1200])
    assert set(os.listdir(dbdir)) == before
    with pytest.raises(NotSupported, match="unique user keys"):
        run_port(dbdir, metas, topts, snaps=[1200])
    assert set(os.listdir(dbdir)) == before


# --- open_table, interop ---------------------------------------------------


@pytest.mark.parametrize("fmt_,cls", [
    ("block", TableReader), ("single_fast", SingleFastTableReader),
    ("cuckoo", CuckooTableReader), ("plain", PlainTableReader),
    ("zip", ZipTableReader)])
def test_open_table_dispatches_on_every_magic(tmp_path, fmt_, cls):
    """A reference-written file of each format opens in the port as its
    reader class, whatever format the options name; its entries read."""
    entries = _sorted_entries(200, 1000, 14, unique=True)
    topts = RefTO(format=fmt_, prefix_extractor=RefFixed(4))
    path = str(tmp_path / "t.sst")
    w = default_env().new_writable_file(path)
    b = ref_factory.new_table_builder(w, REF_ICMP, topts)
    for k, v in entries:
        b.add(k, v)
    b.finish()
    w.close()
    r = factory.open_table(PosixEnv().new_random_access_file(path), ICMP)
    assert type(r) is cls
    it = r.new_iterator()
    it.seek_to_first()
    assert list(it.entries()) == entries
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0x01
    open(path, "wb").write(bytes(data))
    with pytest.raises(Corruption, match="unknown SST magic"):
        factory.open_table(PosixEnv().new_random_access_file(path), ICMP)


def test_table_options_from_plain_carries_every_new_field():
    ref = RefTO(format="zip", index_type="two_level",
                metadata_block_size=1024, partition_filters=True,
                prefix_extractor=RefCapped(7), protection_bytes_per_key=4,
                properties_collector_factories=[RefCollector(10, 3, 0.5)])
    mine = port_options(ref)
    assert (mine.format, mine.index_type, mine.metadata_block_size,
            mine.partition_filters, mine.protection_bytes_per_key) == \
        ("zip", "two_level", 1024, True, 4)
    assert mine.prefix_extractor.name() == "tpulsm.CappedPrefix.7"
    [f] = mine.properties_collector_factories
    assert f.serialize() == ref.properties_collector_factories[0].serialize()
    for bad in ({"prefix_extractor": "custom.Extractor"},
                {"properties_collector_factories": [{"name": "x"}]},
                {"no_such_option": 1}):
        with pytest.raises(InvalidArgument):
            table_options_from_plain(bad)
    assert table_options_from_plain({"prefix_extractor": None}) \
        .prefix_extractor is None
