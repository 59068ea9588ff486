"""The per-entry route and blob values through toplingdb_tpu_torch against
toplingdb_tpu, on the CPU (the port's device_name="cpu", the reference on
JAX's CPU backend):

- compaction-filter jobs (REMOVE through RemoveEmptyValueCompactionFilter,
  CHANGE_VALUE through a test filter registered on both sides): SST bytes;
- blob jobs: BLOB_INDEX rows on the columnar route (serial and pipelined)
  with their blob refs; blob GC on the per-entry route, the rewritten blob
  file's bytes included, values below min_blob_size inlined; a job that
  fails mid-way leaves neither SSTs nor the half-written blob file;
- the per-entry TableBuilder's bytes against the reference's;
- each merge operator against the reference's.

Tolerance: none; SST and blob file bytes, FileMetaData and merge results
must be equal.
"""

import dataclasses
import os
import random
import struct

import pytest

from toplingdb_tpu.compaction.picker import Compaction as RefCompaction
from toplingdb_tpu.db import blob as ref_blob
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
from toplingdb_tpu.table.builder import TableBuilder as RefTableBuilder
from toplingdb_tpu.table.builder import TableOptions as RefTO
from toplingdb_tpu.utils import compaction_filter as ref_cf
from toplingdb_tpu.utils import merge_operator as ref_mo

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db import blob
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.ops import pipeline as pl
from toplingdb_tpu_torch.table.builder import TableBuilder
from toplingdb_tpu_torch.utils import compaction_filter as cf
from toplingdb_tpu_torch.utils import merge_operator as mo

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()
BLOCK = 512
BLOB_FILES = (11, 12)


def _plain_options(o) -> dict:
    d = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)
         if isinstance(getattr(o, f.name), (bool, int, float, str))}
    d["filter_policy_name"] = o.filter_policy.name() if o.filter_policy \
        else ""
    return d


def allocator(base, fail_at=None):
    s = [base]

    def alloc():
        s[0] += 1
        if fail_at is not None and s[0] - base == fail_at:
            raise RuntimeError("no file number left")
        return s[0]

    return alloc


def write_inputs(dbdir, rng, n_files=3, per_file=300, key_space=400,
                 p_empty=0.05, p_blob=0.1, blob_sizes=(1024,)):
    """Input SSTs (and, with p_blob > 0, two blob files holding that share
    of the values as BLOB_INDEX rows), written with the JAX package. Values:
    a p_empty share empty, the rest 20 bytes; blob values are `blob_sizes`
    bytes long. Returns (reference FileMetaData list, {blob index: value})."""
    env = default_env()
    builders = {}
    if p_blob:
        builders = {fn: ref_blob.BlobFileBuilder(env, dbdir, fn)
                    for fn in BLOB_FILES}
    blob_values = {}
    metas, seq = [], 1
    for fnum in range(41, 41 + n_files):
        entries = []
        for _ in range(per_file):
            k = b"key%05d" % rng.randrange(key_space)
            r = rng.random()
            if r < p_empty:
                entries.append((make_internal_key(k, seq, ValueType.VALUE),
                                b""))
            elif r < p_empty + p_blob:
                raw = bytes([65 + seq % 26]) * rng.choice(blob_sizes)
                bi = builders[rng.choice(BLOB_FILES)].add(k, raw)
                blob_values[bi] = raw
                entries.append((make_internal_key(
                    k, seq, ValueType.BLOB_INDEX), bi))
            elif r < 0.95:
                entries.append((make_internal_key(k, seq, ValueType.VALUE),
                                b"val%017d" % seq))
            else:
                entries.append((make_internal_key(
                    k, seq, ValueType.DELETION), b""))
            seq += 1
        entries.sort(key=lambda kv: REF_ICMP.sort_key(kv[0]))
        path = ref_fn.table_file_name(dbdir, fnum)
        w = env.new_writable_file(path)
        b = RefTableBuilder(w, REF_ICMP, RefTO(block_size=BLOCK))
        refs = set()
        for k, v in entries:
            b.add(k, v)
            if k[-8] == ValueType.BLOB_INDEX:
                refs.add(ref_blob.decode_blob_index(v)[0])
        props = b.finish()
        w.close()
        metas.append(RefMeta(
            number=fnum, file_size=env.get_file_size(path),
            smallest=b.smallest_key, largest=b.largest_key,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno, blob_refs=sorted(refs)))
    for bb in builders.values():
        bb.finish()
    return metas, blob_values


def twin_dir(tmp_path, dbdir):
    """A second directory holding the same input files (hard links), so
    each package writes its outputs under the same file numbers."""
    other = str(tmp_path / "port")
    os.makedirs(other)
    for name in os.listdir(dbdir):
        if name.endswith((".sst", ".blob")):
            os.link(os.path.join(dbdir, name), os.path.join(other, name))
    return other


def ref_job(dbdir, metas, snaps, alloc, bottommost=True, max_out=1 << 62,
            **kw):
    c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=bottommost, max_output_file_size=max_out)
    topts = RefTO(block_size=BLOCK)
    tc = RefTableCache(default_env(), dbdir, REF_ICMP, topts)
    return ref_dc.run_device_compaction(
        default_env(), dbdir, REF_ICMP, c, tc, topts, snaps,
        new_file_number=alloc, creation_time=7, device_name="cpu", **kw)


def port_job(dbdir, metas, snaps, alloc, bottommost=True, max_out=1 << 62,
             **kw):
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = Compaction(level=0, output_level=2, inputs=inputs,
                   bottommost=bottommost, max_output_file_size=max_out)
    topts = table_options_from_plain(_plain_options(RefTO(block_size=BLOCK)))
    tc = TableCache(PosixEnv(), dbdir, ICMP, topts)
    return dc.run_device_compaction(
        PosixEnv(), dbdir, ICMP, c, tc, topts, snaps,
        new_file_number=alloc, creation_time=7, device_name="cpu", **kw)


def file_bytes(dbdir, names):
    return [open(os.path.join(dbdir, n), "rb").read() for n in names]


def sst_names(outs):
    return [f"{m.number:06d}.sst" for m in outs]


def same_meta(ref, port):
    a = dataclasses.asdict(ref)
    b = dataclasses.asdict(port)
    return ({k: v for k, v in a.items() if k in b}
            == {k: v for k, v in b.items()})


def spy_routes(monkeypatch):
    """Which route each package's jobs took: 'entries' per call of
    collect_raw_entries."""
    seen = []
    for mod, name in ((ref_dc, "ref"), (dc, "port")):
        orig = mod.collect_raw_entries
        monkeypatch.setattr(
            mod, "collect_raw_entries",
            lambda *a, _o=orig, _n=name, **k: seen.append(_n) or _o(*a, **k))
    return seen


# ---------------------------------------------------------------------------
# Compaction filters
# ---------------------------------------------------------------------------


@ref_cf.register_compaction_filter
class RefTagOddFilter(ref_cf.CompactionFilter):
    """Keys ending in an odd digit get their value replaced; keys ending
    in 0 are removed."""

    def name(self):
        return "test.TagOddFilter"

    def filter(self, level, key, value):
        if key.endswith(b"0"):
            return ref_cf.Decision.REMOVE, None
        if key[-1] % 2:
            return ref_cf.Decision.CHANGE_VALUE, b"L%d:" % level + value
        return ref_cf.Decision.KEEP, None


@cf.register_compaction_filter
class TagOddFilter(cf.CompactionFilter):
    def name(self):
        return "test.TagOddFilter"

    def filter(self, level, key, value):
        if key.endswith(b"0"):
            return cf.Decision.REMOVE, None
        if key[-1] % 2:
            return cf.Decision.CHANGE_VALUE, b"L%d:" % level + value
        return cf.Decision.KEEP, None


@pytest.mark.parametrize("name,snaps,bottommost", [
    ("RemoveEmptyValueCompactionFilter", [], True),
    ("RemoveEmptyValueCompactionFilter", [300, 600], False),
    ("test.TagOddFilter", [], True),
    ("test.TagOddFilter", [450], True),
])
def test_compaction_filter_job_writes_reference_bytes(
        tmp_path, monkeypatch, name, snaps, bottommost):
    dbdir = str(tmp_path)
    metas, _ = write_inputs(dbdir, random.Random(len(name) + len(snaps)),
                            p_blob=0)
    other = twin_dir(tmp_path, dbdir)
    seen = spy_routes(monkeypatch)
    ref_outs, _ = ref_job(dbdir, metas, snaps, allocator(100),
                          bottommost=bottommost, max_out=4096,
                          compaction_filter=ref_cf.create_compaction_filter(
                              name))
    port_outs, stats = port_job(other, metas, snaps, allocator(100),
                                bottommost=bottommost, max_out=4096,
                                compaction_filter=cf.create_compaction_filter(
                                    name))
    assert seen == ["ref", "port"]
    assert len(ref_outs) == len(port_outs) > 1
    assert file_bytes(other, sst_names(port_outs)) == file_bytes(
        dbdir, sst_names(ref_outs))
    for r, p in zip(ref_outs, port_outs):
        assert same_meta(r, p)
    assert stats.input_records == 900
    assert stats.output_records == sum(m.num_entries for m in port_outs)


# ---------------------------------------------------------------------------
# Blobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipelined", [False, True])
def test_blob_rows_on_the_columnar_route(tmp_path, monkeypatch, pipelined):
    dbdir = str(tmp_path)
    metas, _ = write_inputs(dbdir, random.Random(4))
    other = twin_dir(tmp_path, dbdir)
    seen = spy_routes(monkeypatch)
    if pipelined:
        monkeypatch.setattr(ref_pl, "MIN_PIPELINE_ROWS", 256)
        monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
        monkeypatch.delenv("TPULSM_PIPELINE", raising=False)
        monkeypatch.setenv("TPULSM_PIPELINE_SHARDS", "2")
    else:
        monkeypatch.setenv("TPULSM_PIPELINE", "0")
    ref_outs, ref_stats = ref_job(dbdir, metas, [400], allocator(100),
                                  max_out=4096)
    port_outs, stats = port_job(other, metas, [400], allocator(100),
                                max_out=4096, pipeline=pipelined,
                                pipeline_shards=2 if pipelined else None)
    assert seen == []
    assert stats.pipelined == ref_stats.pipelined == pipelined
    assert len(ref_outs) == len(port_outs) > 1
    assert file_bytes(other, sst_names(port_outs)) == file_bytes(
        dbdir, sst_names(ref_outs))
    for r, p in zip(ref_outs, port_outs):
        assert same_meta(r, p)
    assert set().union(*(m.blob_refs for m in port_outs)) == set(BLOB_FILES)


def _gc_pair(dbdir, other, metas, alloc_ref, alloc_port, min_blob_size):
    refs = [fn for m in metas for fn in m.blob_refs]
    ref_src = ref_blob.BlobSource(default_env(), dbdir)
    src = blob.BlobSource(PosixEnv(), other)
    ref_gc = ref_blob.BlobGarbageCollector(
        default_env(), dbdir, refs, 0.5, min_blob_size, ref_src.get,
        alloc_ref)
    gc = blob.BlobGarbageCollector(PosixEnv(), other, refs, 0.5,
                                   min_blob_size, src.get, alloc_port)
    assert gc.gc_files == ref_gc.gc_files == {BLOB_FILES[0]}
    return ref_gc, gc, ref_src, src


@pytest.mark.parametrize("blob_sizes,snaps", [
    ((1024,), [500]),          # every rewritten value stays a blob
    ((300, 1024), []),         # those below min_blob_size are inlined
])
def test_blob_gc_job_writes_reference_bytes(tmp_path, monkeypatch,
                                            blob_sizes, snaps):
    dbdir = str(tmp_path)
    metas, values = write_inputs(dbdir, random.Random(6),
                                 blob_sizes=blob_sizes)
    other = twin_dir(tmp_path, dbdir)
    seen = spy_routes(monkeypatch)
    alloc_ref, alloc_port = allocator(100), allocator(100)
    ref_gc, gc, ref_src, src = _gc_pair(dbdir, other, metas, alloc_ref,
                                        alloc_port, 512)
    ref_outs, _ = ref_job(dbdir, metas, snaps, alloc_ref, max_out=4096,
                          blob_gc=ref_gc, blob_resolver=ref_src.get)
    port_outs, _ = port_job(other, metas, snaps, alloc_port, max_out=4096,
                            blob_gc=gc, blob_resolver=src.get)
    assert seen == ["ref", "port"]
    assert gc.new_blob_file == ref_gc.new_blob_file is not None
    assert (gc.rewritten, gc.inlined) == (ref_gc.rewritten, ref_gc.inlined)
    assert gc.rewritten > 0 and (gc.inlined > 0) == (300 in blob_sizes)
    assert len(ref_outs) == len(port_outs) > 1
    names = sst_names(ref_outs) + [f"{gc.new_blob_file:06d}.blob"]
    assert file_bytes(other, names) == file_bytes(dbdir, names)
    for r, p in zip(ref_outs, port_outs):
        assert same_meta(r, p)
    refs = set().union(*(m.blob_refs for m in port_outs))
    assert refs == {BLOB_FILES[1], gc.new_blob_file}
    # Every surviving blob index resolves to the value it was written with.
    from toplingdb_tpu_torch.table.reader import TableReader

    fresh = blob.BlobSource(PosixEnv(), other)
    written = set(values.values())
    n_blobs = 0
    for m in port_outs:
        r = TableReader(PosixEnv().new_random_access_file(
            os.path.join(other, f"{m.number:06d}.sst")), ICMP)
        it = r.new_iterator()
        it.seek_to_first()
        for k, v in it.entries():
            if k[-8] == ValueType.BLOB_INDEX:
                raw = fresh.get(v)
                assert raw in written
                if blob.decode_blob_index(v)[0] == gc.new_blob_file:
                    assert len(raw) >= 512
                n_blobs += 1
            elif k[-8] == ValueType.VALUE and len(v) == 300:
                assert v in written  # inlined below min_blob_size
        r.close()
    assert n_blobs > 0
    fresh.close()
    src.close()


def test_blob_gc_failure_deletes_the_half_written_blob_file(tmp_path):
    dbdir = str(tmp_path)
    metas, _ = write_inputs(dbdir, random.Random(8))
    other = twin_dir(tmp_path, dbdir)
    before = set(os.listdir(other))
    # Call 1 names the first SST, call 2 the new blob file; the second SST
    # finds no number.
    alloc_ref, alloc_port = allocator(100, 3), allocator(100, 3)
    ref_gc, gc, _, _ = _gc_pair(dbdir, other, metas, alloc_ref, alloc_port,
                                512)
    with pytest.raises(RuntimeError, match="no file number"):
        ref_job(dbdir, metas, [], alloc_ref, max_out=4096, blob_gc=ref_gc)
    with pytest.raises(RuntimeError, match="no file number"):
        port_job(other, metas, [], alloc_port, max_out=4096, blob_gc=gc)
    assert gc.new_blob_file is None and ref_gc.new_blob_file is None
    assert set(os.listdir(other)) == before
    assert set(os.listdir(dbdir)) == before | {"port"}


def test_blob_gc_abort_and_finish(tmp_path):
    """finish() keeps the blob file the rewrite wrote; abort() deletes it;
    a stream with nothing to rewrite opens no file."""
    d = str(tmp_path)
    env = PosixEnv()
    src_b = blob.BlobFileBuilder(env, d, 5)
    bi = src_b.add(b"k", b"x" * 600)
    src_b.finish()
    row = (make_internal_key(b"k", 9, ValueType.BLOB_INDEX), bi)
    for base, action, stream, kept in ((20, "finish", [row], True),
                                       (30, "abort", [row], False),
                                       (40, "finish", [], False)):
        gc = blob.BlobGarbageCollector(
            env, d, [5], 1.0, 512, blob.BlobSource(env, d).get,
            allocator(base))
        out = list(gc.rewrite(stream))
        number = gc.new_blob_file
        assert (number is None) == (not stream)
        getattr(gc, action)()
        if number is not None:
            assert os.path.exists(blob.blob_file_name(d, number)) == kept
        if kept:
            (_, v), = out
            assert blob.decode_blob_index(v)[0] == number
            assert blob.BlobSource(env, d).get(v) == b"x" * 600
    assert sorted(os.listdir(d)) == ["000005.blob", "000021.blob"]


def test_blob_files_match_the_reference_bytes(tmp_path):
    dbdir = str(tmp_path)
    rng = random.Random(2)
    vals = [(b"k%d" % i, bytes(rng.randrange(256) for _ in range(
        rng.randrange(0, 700)))) for i in range(50)]
    ref_b = ref_blob.BlobFileBuilder(default_env(), dbdir, 7)
    port_b = blob.BlobFileBuilder(PosixEnv(), dbdir, 8)
    idx = [(ref_b.add(k, v), port_b.add(k, v)) for k, v in vals]
    ref_b.finish()
    port_b.finish()
    a, b = file_bytes(dbdir, ["000007.blob", "000008.blob"])
    assert a == b
    src = blob.BlobSource(PosixEnv(), dbdir)
    for (ri, pi), (_, v) in zip(idx, vals):
        assert ref_blob.decode_blob_index(ri)[1:] == \
            blob.decode_blob_index(pi)[1:]
        assert src.get(pi) == v


# ---------------------------------------------------------------------------
# TableBuilder and merge operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opts", [
    {},
    {"block_size": 256, "restart_interval": 4},
    {"filter_policy_name": ""},
    {"filter_policy_name": "tpulsm.BloomFilter:10.0"},
    {"whole_key_filtering": False, "index_restart_interval": 3},
])
@pytest.mark.parametrize("with_tombstones", [False, True])
def test_table_builder_writes_reference_bytes(tmp_path, opts,
                                              with_tombstones):
    from toplingdb_tpu.table.filter import filter_policy_from_name

    rng = random.Random(len(opts) * 2 + with_tombstones)
    entries = {}
    for seq in range(1, 800):
        k = b"key%04d" % rng.randrange(500)
        t = rng.choice([ValueType.VALUE, ValueType.VALUE, ValueType.MERGE,
                        ValueType.DELETION, ValueType.SINGLE_DELETION])
        entries[make_internal_key(k, seq, t)] = b"v" * rng.randrange(40)
    rows = sorted(entries.items(), key=lambda kv: REF_ICMP.sort_key(kv[0]))
    ref_kw = {k: v for k, v in opts.items() if k != "filter_policy_name"}
    if "filter_policy_name" in opts:
        ref_kw["filter_policy"] = filter_policy_from_name(
            opts["filter_policy_name"]) if opts["filter_policy_name"] \
            else None
    ref_opts = RefTO(**{"block_size": BLOCK, **ref_kw})
    port_opts = table_options_from_plain(_plain_options(ref_opts))
    tombs = [(b"key0100", 900, b"key0150"), (b"key0300", 901, b"key0320")] \
        if with_tombstones else []
    out = []
    for name, builder_cls, topts, icmp, env in (
            ("ref.sst", RefTableBuilder, ref_opts, REF_ICMP, default_env()),
            ("port.sst", TableBuilder, port_opts, ICMP, PosixEnv())):
        w = env.new_writable_file(str(tmp_path / name))
        b = builder_cls(w, icmp, topts, column_family_id=3,
                        column_family_name="cf", creation_time=11)
        for k, v in rows:
            b.add(k, v)
        for begin, seq, end in tombs:
            b.add_tombstone(make_internal_key(begin, seq,
                                              ValueType.RANGE_DELETION), end)
        props = b.finish()
        w.close()
        out.append((open(str(tmp_path / name), "rb").read(),
                    b.smallest_key, b.largest_key, b.num_entries,
                    props.num_deletions, props.num_merge_operands))
    assert out[0] == out[1]


def _operands(name, rng, n):
    """n operands in the format the named operator folds."""
    ops = []
    for _ in range(n):
        if name == "uint64add":
            ops.append(struct.pack("<Q", rng.randrange(1 << 64)))
        elif name == "sortlist":
            ops.append(b",".join(b"%d" % rng.randrange(100)
                                 for _ in range(rng.randrange(4))))
        elif name == "aggmerge":
            agg = rng.choice([b"sum", b"max", b"min", b"first", b"last"])
            ops.append(ref_mo.AggMergeOperator.pack(
                agg, struct.pack("<Q", rng.randrange(1 << 40))))
        elif name == "cassandra":
            cols = {rng.randrange(5): (rng.randrange(100),
                                       b"c" * rng.randrange(4))
                    for _ in range(3)}
            ops.append(ref_mo.CassandraValueMergeOperator._encode(cols))
        else:
            ops.append(bytes(rng.randrange(256)
                             for _ in range(rng.randrange(1, 9))))
    return ops


@pytest.mark.parametrize("name", ["put", "uint64add", "stringappend", "max",
                                  "bytesxor", "sortlist", "aggmerge",
                                  "cassandra"])
def test_merge_operator_matches_the_reference(name):
    ref_op = ref_mo.create_merge_operator(name)
    op = mo.create_merge_operator(ref_op.name())
    assert type(op).__name__ == type(ref_op).__name__
    assert op.name() == ref_op.name()
    rng = random.Random(name)
    for _ in range(40):
        ops = _operands(name, rng, rng.randrange(1, 6))
        base = _operands(name, rng, 1)[0] if rng.random() < 0.5 else None
        assert op.full_merge(b"k", base, ops) == ref_op.full_merge(
            b"k", base, ops)
        if len(ops) > 1:
            assert op.partial_merge(b"k", ops[0], ops[1]) == \
                ref_op.partial_merge(b"k", ops[0], ops[1])
        assert op.allow_single_operand() == ref_op.allow_single_operand()
