"""MERGE / SINGLE_DELETION groups through toplingdb_tpu_torch against
toplingdb_tpu, on the CPU (the port's device_name="cpu", the reference on
JAX's CPU backend):

- the per-entry route's `device_gc_entries` against the reference's and
  against its CompactionIterator over the sorted input, on the reference
  tests' generator (seeds 1-5) and on the empty, single-entry and unsorted
  cases;
- complex columnar jobs with range tombstones and 200 snapshots, as one
  shard and as two: SST bytes against the reference's run_device_compaction
  and run_compaction_to_tables, with collect_raw_entries spied to stay
  uncalled on both sides (the jobs stay on the columnar route);
- variable-length keys with MERGE rows (the whole-job program, then the
  fold);
- a sparse variable-length key buffer, which takes the per-entry route on
  both sides: the same bytes and the same file numbers.

Tolerance: none; entry streams, SST bytes and FileMetaData must be equal.
"""

import dataclasses
import os
import random
import struct

import numpy as np
import pytest

from toplingdb_tpu.compaction.compaction_iterator import (
    CompactionIterator as RefCompactionIterator,
)
from toplingdb_tpu.compaction.compaction_job import run_compaction_to_tables
from toplingdb_tpu.compaction.picker import Compaction as RefCompaction
from toplingdb_tpu.db import filename as ref_fn
from toplingdb_tpu.db.dbformat import (
    InternalKeyComparator as RefICMP,
    ValueType,
    make_internal_key,
)
from toplingdb_tpu.db.range_del import (
    RangeDelAggregator as RefRangeDelAggregator,
    RangeTombstone as RefRangeTombstone,
)
from toplingdb_tpu.db.table_cache import TableCache as RefTableCache
from toplingdb_tpu.db.version_edit import FileMetaData as RefMeta
from toplingdb_tpu.env import default_env
from toplingdb_tpu.ops import device_compaction as ref_dc
from toplingdb_tpu.table.builder import TableBuilder, TableOptions as RefTO
from toplingdb_tpu.utils.merge_operator import UInt64AddOperator

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.range_del import (
    RangeDelAggregator,
    RangeTombstone,
)
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.utils.merge_operator import create_merge_operator

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()
BLOCK = 512


class ListIter:
    def __init__(self, items):
        self._items = items
        self._i = 0

    def valid(self):
        return self._i < len(self._items)

    def key(self):
        return self._items[self._i][0]

    def value(self):
        return self._items[self._i][1]

    def next(self):
        self._i += 1


def gen_workload(rng, n, key_space=200):
    """The reference tests' generator (tests/test_device_compaction.py):
    60% VALUE, 15% DELETION, 10% MERGE (u64 LE operands), 15%
    SINGLE_DELETION."""
    entries = []
    for seq in range(1, n + 1):
        k = b"key%04d" % rng.randrange(key_space)
        r = rng.random()
        if r < 0.6:
            entries.append((make_internal_key(k, seq, ValueType.VALUE),
                            b"v%06d" % seq))
        elif r < 0.75:
            entries.append((make_internal_key(k, seq, ValueType.DELETION),
                            b""))
        elif r < 0.85:
            entries.append((make_internal_key(k, seq, ValueType.MERGE),
                            struct.pack("<Q", seq)))
        else:
            entries.append((make_internal_key(
                k, seq, ValueType.SINGLE_DELETION), b""))
    return entries


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_device_gc_entries_matches_the_reference(seed):
    rng = random.Random(seed)
    entries = gen_workload(rng, rng.randrange(50, 400))
    maxseq = len(entries)
    snaps = sorted(rng.sample(range(1, maxseq + 1), rng.randrange(0, 4)))
    bottom = rng.random() < 0.5
    tombs = []
    if rng.random() < 0.6:
        for _ in range(rng.randrange(1, 4)):
            a = b"key%04d" % rng.randrange(200)
            b = b"key%04d" % rng.randrange(200)
            if a > b:
                a, b = b, a
            if a != b:
                tombs.append((rng.randrange(1, maxseq), a, b))
    ref_rd = rd = None
    if tombs:
        ref_rd = RefRangeDelAggregator(REF_ICMP.user_comparator)
        rd = RangeDelAggregator(ICMP.user_comparator)
        for t in tombs:
            ref_rd.add(RefRangeTombstone(*t))
            rd.add(RangeTombstone(*t))
    ref_op = UInt64AddOperator()
    srt = sorted(entries, key=lambda kv: REF_ICMP.sort_key(kv[0]))
    oracle = list(RefCompactionIterator(
        ListIter(srt), REF_ICMP, snaps, bottommost_level=bottom,
        merge_operator=ref_op, range_del_agg=ref_rd).entries())
    ref = list(ref_dc.device_gc_entries(
        entries, REF_ICMP, snaps, bottom, merge_operator=ref_op, rd=ref_rd))
    got = list(dc.device_gc_entries(
        entries, ICMP, snaps, bottom,
        merge_operator=create_merge_operator(ref_op.name()), rd=rd,
        device_name="cpu"))
    assert got == ref == oracle


def test_device_gc_entries_empty_and_single():
    assert list(dc.device_gc_entries([], ICMP, [], True,
                                     device_name="cpu")) == []
    e = [(make_internal_key(b"k", 1, ValueType.VALUE), b"v")]
    assert list(dc.device_gc_entries(e, ICMP, [], False,
                                     device_name="cpu")) == e
    assert list(dc.device_gc_entries(e, ICMP, [], True, device_name="cpu")
                ) == list(ref_dc.device_gc_entries(e, REF_ICMP, [], True))


def test_device_gc_entries_merges_unsorted_runs():
    run1 = [(make_internal_key(b"b", 2, ValueType.VALUE), b"v2"),
            (make_internal_key(b"d", 4, ValueType.VALUE), b"v4")]
    run2 = [(make_internal_key(b"a", 1, ValueType.VALUE), b"v1"),
            (make_internal_key(b"c", 3, ValueType.VALUE), b"v3")]
    got = list(dc.device_gc_entries(run1 + run2, ICMP, [], False,
                                    device_name="cpu"))
    assert [k[:-8] for k, _ in got] == [b"a", b"b", b"c", b"d"]
    assert got == list(ref_dc.device_gc_entries(run1 + run2, REF_ICMP, [],
                                                False))


def test_device_sort_breaks_ties_by_input_order():
    """Duplicate internal keys (the same user key, seqno and type in two
    inputs) keep their input order, as the reference's stable sort does;
    pad rows sort last."""
    from toplingdb_tpu.ops import compaction_kernels as ref_ck
    from toplingdb_tpu.ops.columnar import ColumnarEntries as RefColumnar

    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops.columnar import ColumnarEntries

    rng = random.Random(3)
    entries = [(make_internal_key(b"k%d" % rng.randrange(6), rng.randrange(4),
                                  ValueType.VALUE), b"%d" % i)
               for i in range(77)]
    entries.append((b"\xff" * 12 + entries[0][0][-8:], b"top"))
    cols, perm = ck.device_sort(
        ck.pad_columns(ColumnarEntries.from_entries(entries)), "cpu")
    _, ref_perm = ref_ck.device_sort(
        ref_ck.pad_columns(RefColumnar.from_entries(entries)))
    assert np.array_equal(perm, ref_perm)
    assert cols["vtype"][len(entries):].tolist() == [-1] * (
        128 - len(entries))


def _plain_options(o) -> dict:
    d = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)
         if isinstance(getattr(o, f.name), (bool, int, float, str))}
    d["filter_policy_name"] = o.filter_policy.name() if o.filter_policy \
        else ""
    return d


def write_complex_inputs(dbdir, rng, fnums, per_file=400, key_space=500,
                         key_fn=None, n_tombs=2):
    """The inputs of the reference's columnar complex test: per file
    `per_file` rows of 60% VALUE, 20% MERGE (u64 LE operands), 10% DELETION
    and 10% SINGLE_DELETION over `key_space` keys, and `n_tombs` range
    tombstones, written with the JAX package's TableBuilder. Returns
    (reference FileMetaData list, next seqno)."""
    env = default_env()
    topts = RefTO(block_size=BLOCK)
    key_fn = key_fn or (lambda i: b"key%05d" % i)
    metas = []
    seq = 1
    for fnum in fnums:
        entries = []
        for _ in range(per_file):
            k = key_fn(rng.randrange(key_space))
            r = rng.random()
            if r < 0.6:
                entries.append((make_internal_key(k, seq, ValueType.VALUE),
                                b"val%06d" % seq))
            elif r < 0.8:
                entries.append((make_internal_key(k, seq, ValueType.MERGE),
                                struct.pack("<Q", seq % 97)))
            elif r < 0.9:
                entries.append((make_internal_key(
                    k, seq, ValueType.DELETION), b""))
            else:
                entries.append((make_internal_key(
                    k, seq, ValueType.SINGLE_DELETION), b""))
            seq += 1
        entries.sort(key=lambda kv: REF_ICMP.sort_key(kv[0]))
        w = env.new_writable_file(ref_fn.table_file_name(dbdir, fnum))
        b = TableBuilder(w, REF_ICMP, topts)
        for k, v in entries:
            b.add(k, v)
        for _ in range(n_tombs):
            lo = rng.randrange(key_space - 50)
            b.add_tombstone(make_internal_key(
                key_fn(lo), seq, ValueType.RANGE_DELETION),
                key_fn(lo + rng.randrange(10, 50)))
            seq += 1
        props = b.finish()
        w.close()
        metas.append(RefMeta(
            number=fnum,
            file_size=env.get_file_size(ref_fn.table_file_name(dbdir, fnum)),
            smallest=b.smallest_key, largest=b.largest_key,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno))
    return metas, seq


def allocator(base):
    s = [base]

    def alloc():
        s[0] += 1
        return s[0]

    return alloc


def read_bytes(dbdir, outs):
    return [open(ref_fn.table_file_name(dbdir, m.number), "rb").read()
            for m in outs]


def same_meta(ref, port):
    a = dataclasses.asdict(ref)
    b = dataclasses.asdict(port)
    return ({k: v for k, v in a.items() if k in b and k != "number"}
            == {k: v for k, v in b.items() if k != "number"})


def port_job(dbdir, metas, snaps, base, bottommost=True, **kwargs):
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = Compaction(level=0, output_level=2, inputs=inputs,
                   bottommost=bottommost, max_output_file_size=1 << 62)
    topts = table_options_from_plain(_plain_options(RefTO(block_size=BLOCK)))
    tc = TableCache(PosixEnv(), dbdir, ICMP, topts)
    outs, _ = dc.run_device_compaction(
        PosixEnv(), dbdir, ICMP, c, tc, topts, snaps,
        new_file_number=allocator(base), creation_time=7, device_name="cpu",
        **kwargs)
    return outs


def ref_job(dbdir, metas, snaps, base, bottommost=True, cpu_plane=False,
            **kwargs):
    c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=bottommost, max_output_file_size=1 << 62)
    topts = RefTO(block_size=BLOCK)
    tc = RefTableCache(default_env(), dbdir, REF_ICMP, topts)
    run = run_compaction_to_tables if cpu_plane else ref_dc.\
        run_device_compaction
    extra = {} if cpu_plane else {"device_name": "cpu"}
    outs, _ = run(default_env(), dbdir, REF_ICMP, c, tc, topts, snaps,
                  new_file_number=allocator(base), creation_time=7,
                  **kwargs, **extra)
    return outs


def _no_entries(*a, **k):
    raise AssertionError("the columnar route fell back to the per-entry "
                         "route")


@pytest.mark.parametrize("shards", [0, 2])
def test_complex_columnar_job_with_tombstones_and_snapshots(
        tmp_path, monkeypatch, shards):
    dbdir = str(tmp_path)
    rng = random.Random(77 + shards)
    metas, seq = write_complex_inputs(dbdir, rng, (61, 62, 63))
    snaps = sorted(rng.sample(range(1, seq), 200))
    ref_op = UInt64AddOperator()
    op = create_merge_operator(ref_op.name())
    cpu_outs = ref_job(dbdir, metas, snaps, 700, cpu_plane=True,
                       merge_operator=ref_op)
    seen = {}
    if shards:
        monkeypatch.setattr(ref_dc, "_SHARD_MIN_ROWS", 1)
        monkeypatch.setenv("TPULSM_DEVICE_SHARDS", str(shards))
        monkeypatch.setattr(dc, "_SHARD_MIN_ROWS", 1)
    else:
        monkeypatch.delenv("TPULSM_DEVICE_SHARDS", raising=False)
    orig_dispatch = dc._dispatch_shards
    orig_resolve = dc._resolve_complex_stream

    def dispatch(shard_list, *a, **k):
        seen["shards"] = len(shard_list)
        return orig_dispatch(shard_list, *a, **k)

    def resolve(*a, **k):
        seen["resolved"] = True
        return orig_resolve(*a, **k)

    monkeypatch.setattr(dc, "_dispatch_shards", dispatch)
    monkeypatch.setattr(dc, "_resolve_complex_stream", resolve)
    monkeypatch.setattr(ref_dc, "collect_raw_entries", _no_entries)
    monkeypatch.setattr(dc, "collect_raw_entries", _no_entries)
    ref_outs = ref_job(dbdir, metas, snaps, 800, merge_operator=ref_op)
    port_outs = port_job(dbdir, metas, snaps, 900, merge_operator=op,
                         num_shards=shards or None)
    assert seen == {"shards": max(1, shards), "resolved": True}
    assert len(cpu_outs) == len(ref_outs) == len(port_outs) >= 1
    assert read_bytes(dbdir, port_outs) == read_bytes(dbdir, ref_outs) \
        == read_bytes(dbdir, cpu_outs)
    for r, p in zip(ref_outs, port_outs):
        assert same_meta(r, p)
    assert sum(m.num_range_deletions for m in port_outs) > 0


@pytest.mark.parametrize("snaps", [[], [300, 900]])
def test_variable_length_keys_with_merge_rows(tmp_path, monkeypatch, snaps):
    dbdir = str(tmp_path)
    rng = random.Random(5 + len(snaps))
    pool = [b"user%d" % rng.randrange(10 ** rng.randrange(1, 13))
            for _ in range(300)]
    metas, _ = write_complex_inputs(dbdir, rng, (41, 42),
                                    key_space=len(pool),
                                    key_fn=lambda i: pool[i], n_tombs=1)
    ref_op = UInt64AddOperator()
    calls = []
    orig = dc.ck.fused_encode_sort_gc_start
    monkeypatch.setattr(dc.ck, "fused_encode_sort_gc_start",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(ref_dc, "collect_raw_entries", _no_entries)
    monkeypatch.setattr(dc, "collect_raw_entries", _no_entries)
    ref_outs = ref_job(dbdir, metas, snaps, 100, merge_operator=ref_op)
    port_outs = port_job(dbdir, metas, snaps, 200,
                         merge_operator=create_merge_operator("uint64add"))
    assert calls == [1]
    assert ref_outs and len(ref_outs) == len(port_outs)
    assert read_bytes(dbdir, port_outs) == read_bytes(dbdir, ref_outs)
    for r, p in zip(ref_outs, port_outs):
        assert same_meta(r, p)


def _sparse(collect, kv_cls):
    """Wrap a package's _collect_raw_columnar: three unused bytes go into
    the key buffer after row 10, so the buffer is no longer dense."""
    def wrapped(*a, **k):
        kv, rd, shards, parts = collect(*a, **k)
        o = int(kv.key_offs[10])
        buf = np.concatenate([kv.key_buf[:o], np.zeros(3, np.uint8),
                              kv.key_buf[o:]])
        offs = kv.key_offs.copy()
        offs[10:] += 3
        return (kv_cls(buf, offs, kv.key_lens, kv.val_buf, kv.val_offs,
                       kv.val_lens), rd, shards, parts)
    return wrapped


def test_sparse_variable_length_buffer_takes_the_per_entry_route(
        tmp_path, monkeypatch):
    from toplingdb_tpu.ops.columnar_io import ColumnarKV as RefKV

    from toplingdb_tpu_torch.ops.columnar_io import ColumnarKV

    dbdir = str(tmp_path)
    rng = random.Random(21)
    pool = [b"u%d" % rng.randrange(10 ** rng.randrange(1, 10))
            for _ in range(200)]
    metas, _ = write_complex_inputs(dbdir, rng, (41, 42, 43),
                                    key_space=len(pool),
                                    key_fn=lambda i: pool[i])
    monkeypatch.setattr(ref_dc, "_collect_raw_columnar",
                        _sparse(ref_dc._collect_raw_columnar, RefKV))
    monkeypatch.setattr(dc, "_collect_raw_columnar",
                        _sparse(dc._collect_raw_columnar, ColumnarKV))
    entered = []
    for mod, name in ((ref_dc, "ref"), (dc, "port")):
        orig = mod.collect_raw_entries
        monkeypatch.setattr(
            mod, "collect_raw_entries",
            lambda *a, _o=orig, _n=name, **k: entered.append(_n) or _o(
                *a, **k))
    # The two packages run in two directories over the same input files,
    # from the same first file number.
    other = str(tmp_path / "port")
    os.makedirs(other)
    for name in os.listdir(dbdir):
        if name.endswith(".sst"):
            os.link(os.path.join(dbdir, name), os.path.join(other, name))
    before = set(os.listdir(other))
    ref_op = UInt64AddOperator()
    ref_outs = ref_job(dbdir, metas, [250, 700], 100, merge_operator=ref_op,
                       bottommost=False)
    port_outs = port_job(other, metas, [250, 700], 100,
                         merge_operator=create_merge_operator("uint64add"),
                         bottommost=False)
    assert entered == ["ref", "port"]
    assert ref_outs and [m.number for m in port_outs] == [
        m.number for m in ref_outs]
    assert read_bytes(other, port_outs) == read_bytes(dbdir, ref_outs)
    for r, p in zip(ref_outs, port_outs):
        assert same_meta(r, p)
    assert set(os.listdir(other)) == before | {
        f"{m.number:06d}.sst" for m in port_outs}
