"""One compaction job through toplingdb_tpu_torch against toplingdb_tpu:
input SSTs written by the JAX package, the same job compacted by both
packages' run_device_compaction (the port on device_name="cpu", the
reference on JAX's CPU backend through its serial shard path), with and
without range tombstones; the output SST files must be byte-identical and
the FileMetaData equal. Tolerance: bitwise."""

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
from toplingdb_tpu.table.builder import TableBuilder, TableOptions as RefTO

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.utils.status import NotSupported

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()
BLOCK = 512


def plain_options(o) -> dict:
    """The reference options as plain values (scalars, the filter name and
    the compression options)."""
    d = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)
         if isinstance(getattr(o, f.name), (bool, int, float, str))}
    d["filter_policy_name"] = o.filter_policy.name() if o.filter_policy \
        else ""
    d["compression_opts"] = dataclasses.asdict(o.compression_opts)
    return d


def write_inputs(dbdir, rng, n_files=3, per_file=300, key_space=400,
                 p_del=0.1, complex_rows=0, complex_type=ValueType.MERGE,
                 tombstones=(), seq_step=1):
    """Input SSTs written with the JAX package's TableBuilder; returns the
    reference FileMetaData list. The first `complex_rows` rows of each file
    get `complex_type`; point seqnos advance by `seq_step`; each
    (seq, begin, end) range tombstone goes into the file whose seqno span
    holds it."""
    env = default_env()
    topts = RefTO(block_size=BLOCK)
    metas, seq = [], 1
    for fnum in range(41, 41 + n_files):
        entries = []
        seq_lo = seq
        for _ in range(per_file):
            t = (ValueType.DELETION if rng.random() < p_del
                 else ValueType.VALUE)
            if complex_rows and len(entries) < complex_rows:
                t = complex_type
            k = b"key%05d" % rng.randrange(key_space)
            entries.append((make_internal_key(k, seq, t), b"val%06d" % seq))
            seq += seq_step
        entries.sort(key=lambda kv: REF_ICMP.sort_key(kv[0]))
        path = ref_fn.table_file_name(dbdir, fnum)
        w = env.new_writable_file(path)
        b = TableBuilder(w, REF_ICMP, topts)
        for k, v in entries:
            b.add(k, v)
        for t_seq, begin, end in tombstones:
            if seq_lo <= t_seq < seq:
                b.add_tombstone(make_internal_key(
                    begin, t_seq, ValueType.RANGE_DELETION), end)
        props = b.finish()
        w.close()
        metas.append(RefMeta(
            number=fnum, file_size=env.get_file_size(path),
            smallest=b.smallest_key, largest=b.largest_key,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno,
        ))
    return metas, seq


def allocator(base):
    s = [base]

    def alloc():
        s[0] += 1
        return s[0]

    return alloc


def run_ref(dbdir, metas, snaps, bottommost, max_out):
    c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=bottommost, max_output_file_size=max_out)
    topts = RefTO(block_size=BLOCK)
    tc = RefTableCache(default_env(), dbdir, REF_ICMP, topts)
    outs, _ = ref_dc.run_device_compaction(
        default_env(), dbdir, REF_ICMP, c, tc, topts, snaps,
        new_file_number=allocator(100), creation_time=7, device_name="cpu")
    return outs


def run_port(dbdir, metas, snaps, bottommost, max_out, device="cpu",
             num_shards=None, compression=0, **kwargs):
    inputs = [FileMetaData(**{k: v for k, v in dataclasses.asdict(m).items()})
              for m in metas]
    c = Compaction(level=0, output_level=2, inputs=inputs,
                   bottommost=bottommost, max_output_file_size=max_out)
    topts = table_options_from_plain(plain_options(
        RefTO(block_size=BLOCK, compression=compression)))
    tc = TableCache(PosixEnv(), dbdir, ICMP, topts)
    outs, stats = dc.run_device_compaction(
        PosixEnv(), dbdir, ICMP, c, tc, topts, snaps,
        new_file_number=allocator(200), creation_time=7, device_name=device,
        num_shards=num_shards, pipeline=False, **kwargs)
    assert stats.input_records == sum(
        tc.get_reader(m.number).properties.num_entries for m in metas)
    return outs


def read_bytes(dbdir, outs):
    return [open(ref_fn.table_file_name(dbdir, m.number), "rb").read()
            for m in outs]


def same_meta(ref, port):
    a = dataclasses.asdict(ref)
    b = dataclasses.asdict(port)
    a.pop("number")
    b.pop("number")
    return a == b


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("snaps,bottommost,max_out", [
    ([], True, 1 << 30),
    ([150, 420, 777], True, 1 << 30),
    ([300], False, 4096),
])
def test_port_writes_reference_bytes(tmp_path, monkeypatch, shards, snaps,
                                     bottommost, max_out):
    monkeypatch.setenv("TPULSM_PIPELINE", "0")
    monkeypatch.setenv("TPULSM_DEVICE_SHARDS", str(shards))
    monkeypatch.setattr(ref_dc, "_SHARD_MIN_ROWS", 1)
    monkeypatch.setattr(dc, "_SHARD_MIN_ROWS", 1)
    # 900 input rows: a 256-row target gives the port 4 shards too.
    monkeypatch.setattr(dc, "_SHARD_ROWS", 256 if shards > 1 else 1 << 20)
    # Both packages must take their shard paths with `shards` shards.
    from toplingdb_tpu.ops import mesh_compaction as ref_mc

    seen = {}

    def spy(name, fn):
        def wrapped(shard_list, *a, **k):
            seen[name] = len(shard_list)
            return fn(shard_list, *a, **k)
        return wrapped

    monkeypatch.setattr(ref_mc, "dispatch_shards",
                        spy("ref", ref_mc.dispatch_shards))
    monkeypatch.setattr(dc, "_dispatch_shards",
                        spy("port", dc._dispatch_shards))
    dbdir = str(tmp_path)
    metas, _ = write_inputs(dbdir, random.Random(17 + shards))
    ref_outs = run_ref(dbdir, metas, snaps, bottommost, max_out)
    port_outs = run_port(dbdir, metas, snaps, bottommost, max_out)
    assert seen == {"ref": shards, "port": shards}
    assert ref_outs and len(ref_outs) == len(port_outs)
    if max_out < (1 << 20):
        assert len(port_outs) > 1  # output cutting exercised
    assert read_bytes(dbdir, port_outs) == read_bytes(dbdir, ref_outs)
    for r, p in zip(ref_outs, port_outs):
        assert same_meta(r, p)


def test_reference_reads_port_output(tmp_path, monkeypatch):
    """Files cross both ways: the reference's TableReader scans what the
    port wrote, entry for entry."""
    from toplingdb_tpu.table.reader import TableReader as RefReader

    from toplingdb_tpu_torch.table.reader import TableReader

    monkeypatch.setenv("TPULSM_PIPELINE", "0")
    dbdir = str(tmp_path)
    metas, _ = write_inputs(dbdir, random.Random(5))
    port_outs = run_port(dbdir, metas, [200], True, 1 << 30)
    env = default_env()
    for m in port_outs:
        path = ref_fn.table_file_name(dbdir, m.number)
        ref_r = RefReader(env.new_random_access_file(path), REF_ICMP,
                          RefTO(block_size=BLOCK))
        it = ref_r.new_iterator()
        it.seek_to_first()
        ref_entries = list(it.entries())
        port_r = TableReader(PosixEnv().new_random_access_file(path), ICMP)
        pit = port_r.new_iterator()
        pit.seek_to_first()
        assert ref_entries == list(pit.entries())
        assert len(ref_entries) == m.num_entries
        keys = [k for k, _ in ref_entries]
        assert keys == sorted(keys, key=REF_ICMP.sort_key)
        assert all(ref_r.key_may_match(k[:-8]) for k in keys)


def test_default_device_requires_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dbdir = str(tmp_path)
    metas, _ = write_inputs(dbdir, random.Random(3), n_files=1, per_file=20)
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = Compaction(level=0, output_level=2, inputs=inputs, bottommost=True)
    tc = TableCache(PosixEnv(), dbdir, ICMP)
    before = sorted(os.listdir(dbdir))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dc.run_device_compaction(PosixEnv(), dbdir, ICMP, c, tc,
                                 tc._topts, [],
                                 new_file_number=allocator(300))
    assert sorted(os.listdir(dbdir)) == before


class _ReverseComparator:
    """A non-bytewise user comparator (its name is what the port checks)."""

    def name(self):
        return "test.ReverseBytewise"

    def compare(self, a, b):
        return (a < b) - (a > b)


def _long_key_inputs(dbdir):
    """One input SST whose user keys are 130 bytes long."""
    env = default_env()
    path = ref_fn.table_file_name(dbdir, 41)
    w = env.new_writable_file(path)
    b = TableBuilder(w, REF_ICMP, RefTO(block_size=BLOCK))
    for i in range(20):
        b.add(make_internal_key(b"k" * 126 + b"%04d" % i, i + 1,
                                ValueType.VALUE), b"v%d" % i)
    props = b.finish()
    w.close()
    return [RefMeta(number=41, file_size=env.get_file_size(path),
                    smallest=b.smallest_key, largest=b.largest_key,
                    smallest_seqno=props.smallest_seqno,
                    largest_seqno=props.largest_seqno)]


@pytest.mark.parametrize("kind", [
    "single_deletion_rows", "merge_rows", "compressed_options",
    "non_bytewise_comparator", "long_keys_per_entry",
    "over_1024_snapshots"])
def test_unsupported_jobs_raise_without_output(tmp_path, kind):
    """MERGE and SINGLE_DELETION rows and compressed tables, once refused,
    now write the reference's bytes on the columnar route (every table
    format and table option, also once refused, is held against the
    reference in test_torch_table_formats.py and test_torch_zip.py). What
    the port still refuses (a non-bytewise comparator, user keys over 128
    bytes, which reach the per-entry route and are refused there as in the
    reference, and more than 1024 snapshots, refused the same way) raises
    NotSupported and leaves no file behind."""
    from toplingdb_tpu.utils.merge_operator import StringAppendOperator
    from toplingdb_tpu.utils.status import NotSupported as RefNotSupported

    from toplingdb_tpu_torch.utils.merge_operator import (
        create_merge_operator,
    )

    dbdir = str(tmp_path)
    if kind == "long_keys_per_entry":
        metas = _long_key_inputs(dbdir)
    else:
        metas, _ = write_inputs(
            dbdir, random.Random(9), n_files=2, per_file=50, complex_rows=5,
            complex_type=(ValueType.SINGLE_DELETION
                          if kind == "single_deletion_rows"
                          else ValueType.MERGE))
    ref_op = StringAppendOperator()
    if kind in ("single_deletion_rows", "merge_rows", "compressed_options"):
        c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                          bottommost=True)
        # Snappy output for the compressed case (compression type 1).
        ctype = 1 if kind == "compressed_options" else 0
        topts = RefTO(block_size=BLOCK, compression=ctype)
        tc = RefTableCache(default_env(), dbdir, REF_ICMP, topts)
        ref_outs, _ = ref_dc.run_device_compaction(
            default_env(), dbdir, REF_ICMP, c, tc, topts, [],
            merge_operator=ref_op, new_file_number=allocator(100),
            creation_time=7, device_name="cpu")
        port_outs = run_port(dbdir, metas, [], True, 1 << 30,
                             compression=ctype,
                             merge_operator=create_merge_operator(
                                 ref_op.name()))
        assert ref_outs and len(ref_outs) == len(port_outs)
        assert read_bytes(dbdir, port_outs) == read_bytes(dbdir, ref_outs)
        for r, p in zip(ref_outs, port_outs):
            assert same_meta(r, p)
        return
    before = sorted(os.listdir(dbdir))
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    c = Compaction(level=0, output_level=2, inputs=inputs, bottommost=True)
    icmp = ICMP
    topts = table_options_from_plain(plain_options(RefTO(block_size=BLOCK)))
    tc = TableCache(PosixEnv(), dbdir, ICMP, topts)
    if kind == "non_bytewise_comparator":
        icmp = InternalKeyComparator(_ReverseComparator())
    snaps = list(range(1, 1026)) if kind == "over_1024_snapshots" else []
    if kind in ("long_keys_per_entry", "over_1024_snapshots"):
        # The reference refuses the same job on its per-entry route.
        rc = RefCompaction(level=0, output_level=2, inputs=list(metas),
                           bottommost=True)
        with pytest.raises(RefNotSupported):
            ref_dc.run_device_compaction(
                default_env(), dbdir, REF_ICMP, rc,
                RefTableCache(default_env(), dbdir, REF_ICMP,
                              RefTO(block_size=BLOCK)),
                RefTO(block_size=BLOCK), snaps,
                new_file_number=allocator(100), device_name="cpu")
        assert sorted(os.listdir(dbdir)) == before
    with pytest.raises(NotSupported, match={
            "long_keys_per_entry": "device key budget",
            "over_1024_snapshots": "1024 live snapshots",
            "non_bytewise_comparator": "bytewise comparator"}[kind]):
        dc.run_device_compaction(PosixEnv(), dbdir, icmp, c, tc, topts,
                                 snaps, new_file_number=allocator(300),
                                 device_name="cpu")
    assert sorted(os.listdir(dbdir)) == before


# Overlapping range tombstones (point seqnos are odd, tombstone seqnos
# even), several pairs straddling a snapshot of TOMB_SNAPS: an older
# in-stripe tombstone must still delete a row that a newer tombstone above
# the snapshot also covers.
TOMBSTONES = [
    (480, b"key00010", b"key00090"),
    (520, b"key00050", b"key00150"),
    (990, b"key00100", b"key00220"),
    (1010, b"key00200", b"key00260"),
    (1390, b"key00300", b"key00380"),
    (1600, b"key00000", b"key00030"),
]
TOMB_SNAPS = [500, 1000, 1400]


@pytest.mark.parametrize("shards,snaps,bottommost", [
    (1, [], True),
    (4, [], False),
    (1, TOMB_SNAPS, False),
    (4, TOMB_SNAPS, True),
])
def test_range_tombstones_write_reference_bytes(tmp_path, monkeypatch,
                                                shards, snaps, bottommost):
    monkeypatch.setenv("TPULSM_PIPELINE", "0")
    monkeypatch.setenv("TPULSM_DEVICE_SHARDS", str(shards))
    monkeypatch.setattr(ref_dc, "_SHARD_MIN_ROWS", 1)
    monkeypatch.setattr(dc, "_SHARD_MIN_ROWS", 1)
    seen = {}
    orig = dc._dispatch_shards

    def spy(shard_list, cover, *a, **k):
        seen["shards"] = len(shard_list)
        seen["covered_rows"] = int(np.count_nonzero(cover))
        return orig(shard_list, cover, *a, **k)

    monkeypatch.setattr(dc, "_dispatch_shards", spy)
    dbdir = str(tmp_path)
    metas, _ = write_inputs(dbdir, random.Random(31 + shards),
                            tombstones=TOMBSTONES, seq_step=2)
    ref_outs = run_ref(dbdir, metas, snaps, bottommost, 4096)
    port_outs = run_port(dbdir, metas, snaps, bottommost, 4096,
                         num_shards=shards)
    assert seen["shards"] == shards and seen["covered_rows"] > 0
    assert ref_outs and len(ref_outs) == len(port_outs)
    assert read_bytes(dbdir, port_outs) == read_bytes(dbdir, ref_outs)
    for r, p in zip(ref_outs, port_outs):
        assert same_meta(r, p)
    kept = sum(m.num_range_deletions for m in port_outs)
    if not bottommost or snaps:
        # Surviving tombstones keep the job in one output file.
        assert kept > 0 and len(port_outs) == 1
    else:
        assert kept == 0 and len(port_outs) > 1


def test_reference_reads_port_range_del_block(tmp_path, monkeypatch):
    from toplingdb_tpu.db.range_del import RangeTombstone as RefTombstone
    from toplingdb_tpu.table.reader import TableReader as RefReader

    monkeypatch.setenv("TPULSM_PIPELINE", "0")
    dbdir = str(tmp_path)
    metas, _ = write_inputs(dbdir, random.Random(8), tombstones=TOMBSTONES,
                            seq_step=2)
    port_outs = run_port(dbdir, metas, TOMB_SNAPS, False, 1 << 30)
    path = ref_fn.table_file_name(dbdir, port_outs[0].number)
    ref_r = RefReader(default_env().new_random_access_file(path), REF_ICMP,
                      RefTO(block_size=BLOCK))
    frags = [RefTombstone.from_table_entry(b, e)
             for b, e in ref_r.range_del_entries()]
    assert len(frags) == port_outs[0].num_range_deletions > 0
    # Every fragment lies inside one of the input tombstones, at its seqno.
    for f in frags:
        assert any(f.seq == s and b <= f.begin and f.end <= e
                   for s, b, e in TOMBSTONES), f


@pytest.mark.parametrize("snaps,bottommost", [([7], True), ([], False),
                                              ([], True)])
def test_tombstone_only_job_writes_reference_bytes(tmp_path, monkeypatch,
                                                   snaps, bottommost):
    """Inputs that hold range tombstones and no point entries: one output
    with the surviving fragments, or none when all are dropped."""
    monkeypatch.setenv("TPULSM_PIPELINE", "0")
    dbdir = str(tmp_path)
    env = default_env()
    metas = []
    for fnum, (seq, begin, end) in ((41, (5, b"key00010", b"key00050")),
                                    (42, (9, b"key00030", b"key00090"))):
        path = ref_fn.table_file_name(dbdir, fnum)
        w = env.new_writable_file(path)
        b = TableBuilder(w, REF_ICMP, RefTO(block_size=BLOCK))
        b.add_tombstone(make_internal_key(begin, seq,
                                          ValueType.RANGE_DELETION), end)
        props = b.finish()
        w.close()
        metas.append(RefMeta(
            number=fnum, file_size=env.get_file_size(path),
            smallest=b.smallest_key, largest=b.largest_key,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno))
    ref_outs = run_ref(dbdir, metas, snaps, bottommost, 1 << 30)
    port_outs = run_port(dbdir, metas, snaps, bottommost, 1 << 30)
    assert len(ref_outs) == len(port_outs) == (0 if bottommost and not snaps
                                               else 1)
    assert read_bytes(dbdir, port_outs) == read_bytes(dbdir, ref_outs)
    for r, p in zip(ref_outs, port_outs):
        assert same_meta(r, p) and p.num_range_deletions > 0
