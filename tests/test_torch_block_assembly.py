"""The port's on-device block assembly against toplingdb_tpu's.

(a) `block_assembly.assemble_blocks` against the reference's
    `_assemble_blocks_impl` (JAX CPU backend) on the same prepared shard:
    every output array, bitwise.
(b) Whole jobs, the five cases of tests/test_block_assembly.py with inputs
    built by the JAX package's TableBuilder: the port's
    `run_device_compaction(device_name="cpu", device_blocks=True)` writes the
    bytes the reference writes with TPULSM_DEVICE_BLOCKS=1, and the bytes of
    the port's own packed-download route.
(c) A job the route's gate refuses (values of 128 B or more) takes the
    packed-download route and still writes the reference's bytes.
Tolerance: bitwise for arrays, byte-identical for files.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from toplingdb_tpu.ops import compaction_kernels as ref_ck
from toplingdb_tpu.ops import device_compaction as ref_dc
from toplingdb_tpu.table.builder import TableBuilder, TableOptions as RefTO
from toplingdb_tpu.table.filter import BloomFilterPolicy

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.ops import block_assembly as ba
from toplingdb_tpu_torch.ops import compaction_kernels as ck
from toplingdb_tpu_torch.ops import device_compaction as dc

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()


# ---------------------------------------------------------------------------
# (a) the assembly program
# ---------------------------------------------------------------------------


def _chunk(rng, n, key_space, seq0, p_del):
    """One presorted run of n 16-byte internal keys (8-digit user keys),
    seqnos seq0.., p_del of them DELETIONs; plus per-row value lengths
    (0 for DELETIONs) and the dense value bytes."""
    draws = rng.integers(0, key_space, n)
    seqs = np.arange(seq0, seq0 + n, dtype=np.uint64)
    vt = np.where(rng.random(n) < p_del, 0, 1)
    o = np.lexsort((np.iinfo(np.int64).max - seqs.view(np.int64), draws))
    ik = np.empty((n, 16), dtype=np.uint8)
    for j in range(8):
        ik[:, 7 - j] = (draws[o] // 10 ** j) % 10 + ord("0")
    packed = (seqs[o] << np.uint64(8)) | vt[o].astype(np.uint64)
    ik[:, 8:] = (packed[:, None] >> (np.arange(8) * 8).astype(np.uint64)
                 [None, :]) & np.uint64(0xFF)
    vlens = np.where(vt[o] == 1, rng.integers(1, 40, n), 0).astype(np.uint32)
    vals = rng.integers(0, 256, int(vlens.sum())).astype(np.uint8)
    return ik.reshape(-1), seqs[o], vlens, vals


ASSEMBLY_CASES = [
    # (restart, block size, snapshots, tombstones, bottommost, merge mode,
    #  front-coded upload)
    (4, 256, 0, False, True, "sort", True),
    (8, 512, 2, True, True, "merge", False),
    (16, 4096, 2, False, False, "merge", True),
    (16, 512, 0, True, False, "sort", False),
    (8, 4096, 0, True, True, "merge", True),
]


@pytest.mark.parametrize("R,B,n_snaps,tombs,bottommost,mode,front_code",
                         ASSEMBLY_CASES)
def test_assemble_blocks_matches_reference(R, B, n_snaps, tombs, bottommost,
                                           mode, front_code):
    rng = np.random.default_rng(R * 100 + B + n_snaps)
    chunks, ref_chunks, covers, vl_parts, vb_parts = [], [], [], [], []
    seq0 = 1
    for n in (300, 211, 257):
        kb, seqs, vl, vb = _chunk(rng, n, 250, seq0, 0.15)
        seq0 += n
        chunks.append(ck.prepare_uniform_chunk(kb, n, 16))
        ref_chunks.append(ref_ck.prepare_uniform_chunk(kb, n, 16))
        cov = np.where(rng.random(n) < 0.3,
                       seqs + rng.integers(1, 300, n).astype(np.uint64),
                       np.uint64(0))
        covers.append(cov if tombs else None)
        vl_parts.append(vl)
        vb_parts.append(vb)
    snaps = sorted(int(x) for x in rng.choice(np.arange(1, seq0), n_snaps,
                                              replace=False))
    h = ck.upload_uniform_shard(chunks, covers, front_code=front_code,
                                device="cpu")
    ref_h = ref_ck.upload_uniform_shard(ref_chunks, covers,
                                        front_code=front_code)
    assert (h["tomb_hi"] is not None) == tombs
    p = h["pkb"].shape[0]
    vlens = np.zeros(p, dtype=np.uint32)
    vlens[:seq0 - 1] = np.concatenate(vl_parts)
    vflat = np.concatenate(vb_parts)
    vf = np.zeros(ck._next_pow2(max(8, len(vflat))), dtype=np.uint8)
    vf[:len(vflat)] = vflat
    max_rec, ubp, nbp = ba.budgets(p, 16, vlens, R, B)
    snap_hi, snap_lo = ck._split_snapshots(snaps)
    total = h["total"]

    dummy = np.zeros(1, dtype=np.uint8)
    zero = np.zeros(1, dtype=np.uint32)
    want = ref_ba._assemble_blocks_impl(
        ref_h.get("ukb", dummy), ref_h.get("plens", dummy),
        ref_h.get("sfx", dummy), ref_h["pkb"], ref_h["starts"],
        ref_h["min_his"], ref_h["min_los"], jnp.asarray(vlens),
        jnp.asarray(vf),
        ref_h["tomb_hi"] if tombs else zero,
        ref_h["tomb_lo"] if tombs else zero, snap_hi, snap_lo,
        np.int32(total), 2, 8, bottommost, tombs, front_code, R, B, max_rec,
        ubp, nbp)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                   if a.dtype == np.uint32 else a)
    got = ba.assemble_blocks(
        ck.shard_key_matrix(h), h["pkb"], h["starts"], h["min_his"],
        h["min_los"], t(vlens), t(vf), h["tomb_hi"], h["tomb_lo"],
        t(snap_hi), t(snap_lo), total, 2, 8, bottommost, R, B, max_rec, ubp,
        nbp, run_starts=h["run_starts"], merge_mode=mode)
    names = ("out", "meta", "bcounts", "bpayload", "bfirst", "blast",
             "surv_bitmap")
    meta = np.asarray(want[1])
    assert meta[0] > 1 and meta[1] > 0  # several blocks, some survivors
    total_payload = int(meta[2])
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.numpy()
        if name == "out":
            g, w = g[:total_payload], w[:total_payload]
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


# ---------------------------------------------------------------------------
# (b), (c) whole jobs
# ---------------------------------------------------------------------------


def _build_inputs(dbdir, rng, topts, n_files=3, n_per=350,
                  with_tombstones=False, max_vlen=40):
    """tests/test_block_assembly.py's inputs: 9-byte user keys over 500
    values, 15% DELETIONs, value lengths up to max_vlen, one tombstone per
    file when asked."""
    env = default_env()
    metas = []
    seq = 1
    for fi in range(n_files):
        fnum = 31 + fi
        entries = []
        for _ in range(n_per):
            k = b"key%06d" % rng.randrange(500)
            t = ValueType.VALUE
            if rng.random() < 0.15:
                t = ValueType.DELETION
            v = b"" if t != ValueType.VALUE else b"v%0*d" % (
                rng.randrange(4, max_vlen), seq)
            entries.append((make_internal_key(k, seq, t), v))
            seq += 1
        entries.sort(key=lambda kv: REF_ICMP.sort_key(kv[0]))
        path = ref_fn.table_file_name(dbdir, fnum)
        w = env.new_writable_file(path)
        b = TableBuilder(w, REF_ICMP, topts)
        for k, v in entries:
            b.add(k, v)
        if with_tombstones:
            lo = rng.randrange(400)
            b.add_tombstone(
                make_internal_key(b"key%06d" % lo, seq,
                                  ValueType.RANGE_DELETION),
                b"key%06d" % (lo + 50))
            seq += 1
        props = b.finish()
        w.close()
        metas.append(RefMeta(
            number=fnum, file_size=env.get_file_size(path),
            smallest=b.smallest_key, largest=b.largest_key,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno,
        ))
    return metas, seq


def _alloc(base):
    s = [base]

    def alloc():
        s[0] += 1
        return s[0]

    return alloc


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def _run_both(tmp_path, monkeypatch, topts, metas, snaps):
    """The job through the reference (TPULSM_DEVICE_BLOCKS=1), the port's
    block-assembly request and the port's packed-download route. Returns
    ({route: [file bytes]}, {route: outputs}, ref spy, port spy)."""
    monkeypatch.setenv("TPULSM_DEVICE_BLOCKS", "1")
    monkeypatch.delenv("TPULSM_HOST_SORT", raising=False)
    dbdir = str(tmp_path)
    ref_calls = _spy(monkeypatch, ref_ba, "run_block_assembly")
    port_calls = _spy(monkeypatch, ba, "run_block_assembly")
    c = RefCompaction(level=0, output_level=2, inputs=list(metas),
                      bottommost=True, max_output_file_size=1 << 62)
    tc = RefTableCache(default_env(), dbdir, REF_ICMP, topts)
    ref_outs, _ = ref_dc.run_device_compaction(
        default_env(), dbdir, REF_ICMP, c, tc, topts, snaps,
        new_file_number=_alloc(100), creation_time=9, device_name="cpu-jax")
    d = {f.name: getattr(topts, f.name) for f in dataclasses.fields(topts)
         if isinstance(getattr(topts, f.name), (bool, int, float, str))}
    d["filter_policy_name"] = (topts.filter_policy.name()
                               if topts.filter_policy else "")
    ptopts = table_options_from_plain(d)
    inputs = [FileMetaData(**dataclasses.asdict(m)) for m in metas]
    outs = {"ref": ref_outs}
    for route, blocks, base in (("blocks", True, 200), ("packed", False, 300)):
        c = Compaction(level=0, output_level=2, inputs=inputs,
                       bottommost=True, max_output_file_size=1 << 62)
        tc = TableCache(PosixEnv(), dbdir, ICMP, ptopts)
        outs[route], _ = dc.run_device_compaction(
            PosixEnv(), dbdir, ICMP, c, tc, ptopts, snaps,
            new_file_number=_alloc(base), creation_time=9,
            device_name="cpu", device_blocks=blocks)
        if route == "blocks":
            port_blocks_calls = len(port_calls)
    blobs = {r: [open(ref_fn.table_file_name(dbdir, m.number), "rb").read()
                 for m in o] for r, o in outs.items()}
    return blobs, outs, len(ref_calls), port_blocks_calls


@pytest.mark.parametrize("seed,block_size,restart,tombs,nsnaps,bloom", [
    (1, 512, 16, False, 0, False),
    (2, 512, 4, False, 2, False),
    (3, 4096, 16, False, 0, True),
    (4, 1024, 16, True, 3, False),
    (5, 256, 8, True, 0, True),
])
def test_block_assembly_job_writes_reference_bytes(
        tmp_path, monkeypatch, seed, block_size, restart, tombs, nsnaps,
        bloom):
    rng = random.Random(seed)
    topts = RefTO(block_size=block_size, restart_interval=restart,
                  filter_policy=BloomFilterPolicy() if bloom else None)
    metas, seq_top = _build_inputs(str(tmp_path), rng, topts,
                                   with_tombstones=tombs)
    snaps = sorted(rng.sample(range(1, seq_top), nsnaps))
    blobs, outs, ref_calls, port_calls = _run_both(
        tmp_path, monkeypatch, topts, metas, snaps)
    assert ref_calls == 1 and port_calls == 1, "route not taken"
    assert len(blobs["ref"]) == 1
    assert blobs["blocks"] == blobs["ref"] == blobs["packed"]
    if tombs and nsnaps:
        # Tombstones above a snapshot survive the bottommost level.
        assert outs["blocks"][0].num_range_deletions > 0
    for a, b in zip(outs["ref"], outs["blocks"]):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("smallest", "largest", "num_entries", "num_deletions",
                  "num_range_deletions", "smallest_seqno", "largest_seqno",
                  "file_size"):
            assert a[k] == b[k], k


def test_gate_refused_job_takes_packed_route(tmp_path, monkeypatch):
    rng = random.Random(6)
    topts = RefTO(block_size=512)
    metas, seq_top = _build_inputs(str(tmp_path), rng, topts, n_per=200,
                                   max_vlen=200)
    blobs, _outs, ref_calls, port_calls = _run_both(
        tmp_path, monkeypatch, topts, metas, [seq_top // 2])
    assert ref_calls == 0 and port_calls == 0
    assert blobs["blocks"] == blobs["ref"] == blobs["packed"]
