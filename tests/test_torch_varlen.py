"""Variable-length keys on the port's device route against toplingdb_tpu:
the port's whole-job program `fused_encode_sort_gc` (plain versions, device
"cpu") against the reference's (JAX, CPU backend) on the same raw key
buffers: order, zero flags, complex flags and has_complex must be equal.
Then whole variable-length jobs through both packages'
run_device_compaction: the output SST files must be byte-identical and the
FileMetaData equal. Tolerance: bitwise."""

import dataclasses
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
from toplingdb_tpu.ops import compaction_kernels as ref_ck
from toplingdb_tpu.ops import device_compaction as ref_dc
from toplingdb_tpu.table.builder import TableBuilder, TableOptions as RefTO

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.ops import compaction_kernels as ck
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.utils.status import NotSupported

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()
BLOCK = 512


def _user_keys(rng, pool):
    """`pool` distinct user keys of 1 to 40 bytes, with shared prefixes
    and keys that are prefixes of others."""
    out = set()
    while len(out) < pool:
        kind = rng.integers(0, 3)
        if kind == 0:
            out.add(b"user%d" % rng.integers(0, 10 ** rng.integers(1, 12)))
        elif kind == 1:
            out.add(bytes(rng.integers(0, 256, rng.integers(1, 41))
                          .astype(np.uint8)))
        else:
            out.add(b"ab" * int(rng.integers(1, 6)))
    return sorted(out)


def _raw_job(seed, n, p_merge=0.0):
    """n internal keys in scan order (3 presorted runs), dense buffers."""
    rng = np.random.default_rng(seed)
    pool = _user_keys(rng, max(8, n // 3))
    seqs = rng.permutation(np.arange(1, n + 1)) * 3
    runs = np.array_split(np.arange(n), 3)
    keys = []
    for rows in runs:
        ents = []
        for i in rows:
            r = rng.random()
            t = (ValueType.DELETION if r < 0.15 else ValueType.MERGE
                 if r < 0.15 + p_merge else ValueType.VALUE)
            uk = pool[rng.integers(0, len(pool))]
            ents.append(make_internal_key(uk, int(seqs[i]), t))
        keys += sorted(ents, key=REF_ICMP.sort_key)
    lens = np.array([len(k) for k in keys], dtype=np.int32)
    buf = np.frombuffer(b"".join(keys), dtype=np.uint8).copy()
    offs = (np.cumsum(lens) - lens).astype(np.int32)
    cover = np.where(rng.random(n) < 0.3,
                     rng.integers(1, 3 * n + 3, n), 0).astype(np.uint64)
    mkb = max(4, int(lens.max()) - 8)
    return buf, offs, lens, mkb, cover


@pytest.mark.parametrize("n,snaps,bottommost,with_cover,p_merge", [
    (777, [], True, False, 0.0),
    (1000, [300, 1200, 2500], True, True, 0.0),
    (1500, [900], False, True, 0.05),
    (3, [1], True, False, 0.0),
    (2049, [100, 4000], False, False, 0.0),
])
def test_fused_encode_sort_gc_matches_reference(n, snaps, bottommost,
                                                with_cover, p_merge):
    buf, offs, lens, mkb, cover = _raw_job(n + len(snaps), n, p_merge)
    cov = cover if with_cover else None
    want = ref_ck.fused_encode_sort_gc(buf, offs, lens, mkb, snaps,
                                       bottommost, cov)
    got = ck.fused_encode_sort_gc(buf, offs, lens, mkb, snaps, bottommost,
                                  cov, device="cpu")
    assert len(got[0]) == len(want[0]) > 0
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3] == (p_merge > 0)
    if bottommost and n > 3:
        assert got[1].any()  # seqno zeroing exercised


def test_fused_encode_sort_gc_refuses_sparse_buffers():
    buf, offs, lens, mkb, _ = _raw_job(5, 64)
    gap = np.concatenate([buf[:int(offs[10])], np.zeros(3, np.uint8),
                          buf[int(offs[10]):]])
    offs2 = offs.copy()
    offs2[10:] += 3
    with pytest.raises(NotSupported, match="densely packed"):
        ck.fused_encode_sort_gc(gap, offs2, lens, mkb, [], True,
                                device="cpu")


def _plain_options(o) -> dict:
    d = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)
         if isinstance(getattr(o, f.name), (bool, int, float, str))}
    d["filter_policy_name"] = o.filter_policy.name() if o.filter_policy \
        else ""
    return d


def write_varlen_inputs(dbdir, rng, n_files, per_file=400, tombstones=(),
                        p_del=0.1):
    """Input SSTs with YCSB-style user keys ("user" + a decimal number
    without padding, 5-16 bytes) written with the JAX package's
    TableBuilder; odd point seqnos, even tombstone seqnos, a p_del share of
    DELETIONs."""
    env = default_env()
    topts = RefTO(block_size=BLOCK)
    pool = [b"user%d" % rng.randrange(10 ** rng.randrange(1, 13))
            for _ in range(500)]
    metas, seq = [], 1
    for fnum in range(41, 41 + n_files):
        entries = []
        seq_lo = seq
        for _ in range(per_file):
            t = (ValueType.DELETION if rng.random() < p_del
                 else ValueType.VALUE)
            entries.append((make_internal_key(rng.choice(pool), seq, t),
                            b"val%06d" % seq if t else b""))
            seq += 2
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
            largest_seqno=props.largest_seqno))
    return metas


def _allocator(base):
    s = [base]

    def alloc():
        s[0] += 1
        return s[0]

    return alloc


TOMBSTONES = [(200, b"user1", b"user3"), (610, b"user5", b"user77"),
              (1000, b"user8", b"user9")]


@pytest.mark.parametrize("n_files,snaps,bottommost,max_out,tombs", [
    (1, [], True, 1 << 30, False),
    (3, [], True, 8192, False),
    (3, [300, 900], False, 1 << 30, True),
    (1, [150], True, 1 << 30, True),
    (3, [], True, 1 << 30, True),
    (3, [500], False, 6000, False),
])
def test_varlen_job_writes_reference_bytes(tmp_path, n_files, snaps,
                                           bottommost, max_out, tombs):
    dbdir = str(tmp_path)
    metas = write_varlen_inputs(dbdir, random.Random(n_files * 7 + len(snaps)),
                                n_files, tombstones=TOMBSTONES if tombs
                                else ())
    c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=bottommost, max_output_file_size=max_out)
    rtopts = RefTO(block_size=BLOCK)
    ref_outs, _ = ref_dc.run_device_compaction(
        default_env(), dbdir, REF_ICMP, c,
        RefTableCache(default_env(), dbdir, REF_ICMP, rtopts), rtopts, snaps,
        new_file_number=_allocator(100), creation_time=7, device_name="cpu")

    topts = table_options_from_plain(_plain_options(rtopts))
    calls = []
    orig = ck.fused_encode_sort_gc_start

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    ck.fused_encode_sort_gc_start = spy
    try:
        port_outs, stats = dc.run_device_compaction(
            PosixEnv(), dbdir, ICMP,
            Compaction(level=0, output_level=2,
                       inputs=[FileMetaData(**dataclasses.asdict(m))
                               for m in metas],
                       bottommost=bottommost, max_output_file_size=max_out),
            TableCache(PosixEnv(), dbdir, ICMP, topts), topts, snaps,
            new_file_number=_allocator(200), creation_time=7,
            device_name="cpu")
    finally:
        ck.fused_encode_sort_gc_start = orig
    assert calls == [1], "the variable-length program did not run"
    assert stats.input_records == 400 * n_files
    assert ref_outs and len(ref_outs) == len(port_outs)
    for r, p in zip(ref_outs, port_outs):
        a, b = dataclasses.asdict(r), dataclasses.asdict(p)
        assert a.pop("number") - 100 == b.pop("number") - 200
        assert a == b
    got = [open(ref_fn.table_file_name(dbdir, m.number), "rb").read()
           for m in port_outs]
    want = [open(ref_fn.table_file_name(dbdir, m.number), "rb").read()
            for m in ref_outs]
    assert got == want
    if max_out < (1 << 20):
        assert len(port_outs) > 1
    if tombs and (snaps or not bottommost):
        assert sum(m.num_range_deletions for m in port_outs) > 0


def test_varlen_job_without_survivors_writes_nothing(tmp_path):
    """Only deletions, bottommost, no snapshots: both packages drop every
    row, write no file and draw no file number."""
    import os

    dbdir = str(tmp_path)
    metas = write_varlen_inputs(dbdir, random.Random(4), 2, per_file=300,
                                p_del=1.0)
    before = sorted(os.listdir(dbdir))
    drawn = {"ref": [], "port": []}
    rtopts = RefTO(block_size=BLOCK)
    ref_outs, _ = ref_dc.run_device_compaction(
        default_env(), dbdir, REF_ICMP,
        RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=True),
        RefTableCache(default_env(), dbdir, REF_ICMP, rtopts), rtopts, [],
        new_file_number=lambda: drawn["ref"].append(1) or 900,
        creation_time=7, device_name="cpu")
    topts = table_options_from_plain(_plain_options(rtopts))
    port_outs, stats = dc.run_device_compaction(
        PosixEnv(), dbdir, ICMP,
        Compaction(level=0, output_level=2,
                   inputs=[FileMetaData(**dataclasses.asdict(m))
                           for m in metas], bottommost=True),
        TableCache(PosixEnv(), dbdir, ICMP, topts), topts, [],
        new_file_number=lambda: drawn["port"].append(1) or 901,
        creation_time=7, device_name="cpu")
    assert ref_outs == port_outs == [] and stats.input_records == 600
    assert drawn == {"ref": [], "port": []}
    assert sorted(os.listdir(dbdir)) == before
