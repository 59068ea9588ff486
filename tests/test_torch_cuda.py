"""Tests that need an NVIDIA CUDA device (marker `cuda`; they skip where
there is none). This file imports only the port, so it runs on a machine
without JAX: `python -m pytest tests/test_torch_cuda.py -q`.

- each kernel equals its plain PyTorch version bitwise on the card: the
  merge over 1 to 32 runs, 1 to 35 key columns and the layouts its tiling
  must get right, up to 2^22 rows; gc_rows from 1 to 2^20 rows, with 64
  and 1024 snapshot words, with and without tombstone words, on aligned
  and offset slices;
- one compaction job on device_name="cuda" (merge and gc_rows kernels)
  writes the same SST bytes as on device_name="cpu" (plain versions);
- a small block-assembly job with a range tombstone (all three kernels)
  writes the same SST bytes on "cuda" as on "cpu";
- the pipelined plane's shapes (gc_rows and the merge at p = 2^19, R = 8,
  C = 5) bitwise against the plain versions;
- a small pipelined job and a small variable-length job write the same SST
  bytes on "cuda" as on "cpu", and a CUDA error raised inside the
  pipeline's compute thread reaches the caller;
- a small job with MERGE and SINGLE_DELETION groups (columnar route, the
  fold on the host) and a per-entry job with a compaction filter and blob
  GC write the same SST and blob bytes on "cuda" as on "cpu"; the
  per-entry route's GC mask at 1 and 3 rows equals the plain version's;
  a CUDA error inside the per-entry route reaches the caller and leaves no
  file behind;
- compressed jobs (snappy where libsnappy is there, and zstd, through the
  pipeline; zstd with a dictionary through the serial route) write the
  same SST bytes on "cuda" as on "cpu", and the dcompact worker with
  device "cuda" writes the bytes it writes with "cpu-jax"; without a card
  (or with it hidden) a "cuda" worker job fails with no output;
- a zstd zip job over 2^19+ rows through the pipelined plane (both
  kernels, the native zip writer), a protected pipelined job and a
  single_fast job on the per-entry route write the same SST bytes on
  "cuda" as on "cpu";
- a 200,000-key DB whose compactions run on the card through
  DeviceCompactionExecutorFactory(device="cuda") (both kernels launch, no
  job on the host path) has the same get and scan views as the port's DB
  on device="cpu", before and after reopen;
- a DB with two column families, fed by mixed-CF batches, writes the same
  SST bytes (by file number, per CF) with its compactions on "cuda" as on
  "cpu", and every output's properties name its CF;
- a small DB whose compaction goes through the in-process HTTP worker
  service on "cuda" (both kernels launch in the service) and one whose
  compaction goes through a subprocess worker on "cuda" write the SST
  bytes, level files and WAL bytes of the same DB through a "cpu-jax"
  service;
- the merge over 12 runs padded to 16 (4 empty) equals its plain version
  bitwise;
- a small universal DB and a small blob DB with blob GC, their jobs on
  "cuda", read back against a dict oracle and write the SST and blob file
  bytes of the same DBs on "cpu";
- a small protected DB (protection_bytes_per_key=8) whose jobs run on
  "cuda": every output verified per entry, a clean scrub, and the SST
  bytes and scan of the same DB on "cpu";
- a small CSPP-trie DB filled by four unordered writer threads with
  concurrent inserts, its jobs on "cuda": every key reads back, and its
  gets and scan equal the same DB's on "cpu";
- a DB opened by SidePluginRepo.open_db with its jobs on "cuda" records
  an op trace whose replay into a DB opened from the same config leaves
  the same scan, and the induced-stall SLO fires on such a DB and
  resolves;
- a small DB with an LRUCache block cache runs compact_range on "cuda":
  its multi_get, get and async twin (async_reads=True: multi_get,
  get_async, multi_get_async) agree with each other and with the same
  DB's on "cpu";
- a small DB runs compact_files (L0 into L1, then part of L1 into L2) and
  a suggest_compact_range pick after set_options({"disable_auto_
  compactions": False}) on "cuda" (gc_rows and the merge launch, the
  marked branch runs): the SST bytes, level sets and reads equal the
  same DB's on "cpu";
- a DB with preclude_last_level_data_seconds whose young data is pushed
  to the last level by compact_range on "cuda" (the jobs run
  non-bottommost: seqnos and tombstones kept), and a DB of wide-column
  entities with a merge overlay and deletes compacted on "cuda" (the
  complex fold): the SST bytes, level sets and reads equal the same DBs'
  on "cpu";
- a timestamp DB (U64_TS_BYTEWISE) with overwrites, deletes, single
  deletes, a snapshot and increase_full_history_ts_low runs compact_range
  on "cuda" (per-entry jobs, gc_rows launched, the history trim): the SST
  bytes, level sets and reads equal the same DB's on "cpu";
- the mesh route with the card named twice (mesh_devices=[cuda, cuda]),
  on the serial and pipelined routes and with a wedge injected at shard 2,
  writes the single-device bytes and launches both kernels;
- the distributed GC step on NCCL at world size 1 (a spawned rank, a
  file store) equals the same call on a gloo CPU mesh bitwise;
- the driver pair's defaults run on the card: entry()'s forward step
  launches gc_rows and equals its "cpu" step, and dryrun_multichip(1)
  runs one NCCL rank;
- a write_prepared TransactionDB whose compact_range runs on "cuda": a
  snapshot taken while a transaction was prepared reads the
  pre-transaction value after the commit and the card's job (the parked
  guard is in the job's snapshot list), live reads the committed one;
- a CompactionService job on "cuda" (CompactionServiceExecutorFactory(
  InProcessCompactionService(), device="cuda")) launches the kernels and
  writes the SST bytes the device executor writes for the same DB.
"""

import os
import threading


import numpy as np
import pytest
import torch

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.range_del import RangeTombstone
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.ops import compaction_kernels as ck
from toplingdb_tpu_torch.ops import device_compaction as dc
from toplingdb_tpu_torch.ops import kernels
from toplingdb_tpu_torch.ops import pipeline as pl
from toplingdb_tpu_torch.ops.columnar_io import (
    ColumnarKV,
    write_tables_columnar,
)
from toplingdb_tpu_torch.table.builder import TableOptions

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t32(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def test_gc_rows_matches_plain(dev):
    rng = np.random.default_rng(1)
    n = 4096
    seq = rng.integers(0, 1 << 44, n).astype(np.uint64)
    snap_hi, snap_lo = ck._split_snapshots(
        sorted(int(x) for x in rng.integers(0, 1 << 44, 50)))
    tomb = np.where(rng.random(n) < 0.3,
                    rng.integers(0, 1 << 44, n).astype(np.uint64),
                    np.uint64(0))
    hi = lambda x: (x >> np.uint64(32)).astype(np.uint32)
    lo = lambda x: (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    args = [_t32(hi(seq)), _t32(lo(seq)),
            torch.from_numpy(rng.random(n) < 0.4), _t32(hi(tomb)),
            _t32(lo(tomb)),
            torch.from_numpy(rng.choice([0, 1, 2, 7], n).astype(np.int32)),
            _t32(snap_hi), _t32(snap_lo)]
    for a in (args, args[:3] + [None, None] + args[5:]):
        want = kernels.gc_rows(*a)
        got = kernels.gc_rows(*[x if x is None else x.to(dev) for x in a])
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_merge_matches_plain(dev):
    rng = np.random.default_rng(2)
    p, n_runs = 1 << 16, 8
    cuts = np.sort(rng.integers(0, p + 1, n_runs - 1))
    cuts[:3] = cuts[0]  # empty runs
    starts = np.concatenate([[0], cuts, [p]]).astype(np.int32)
    cols = rng.integers(-1, 2, (5, p)).astype(np.int32)  # many equal keys
    for r in range(n_runs):
        s, e = starts[r], starts[r + 1]
        cols[:, s:e] = cols[:, s:e][:, np.lexsort(cols[:, s:e][::-1])]
    want = kernels.merge_runs_perm(torch.from_numpy(cols),
                                   torch.from_numpy(starts), 3)
    before = kernels.merge_runs_perm.launches
    got = kernels.merge_runs_perm(torch.from_numpy(cols).to(dev),
                                  torch.from_numpy(starts).to(dev), 3)
    assert kernels.merge_runs_perm.launches == before + 3
    assert torch.equal(got.cpu(), want)


def _layout_runs(rng, p, n_runs, n_cols, layout):
    """[n_cols, p] int32 presorted runs bounded by [n_runs+1] starts, laid
    out as the merge kernel's tiling has to get right: empty runs leading,
    in the middle or trailing, runs shorter than one tile, one run longer
    than all the others together, and keys equal across every run."""
    if layout == "leading_empty":
        cuts = np.concatenate([np.zeros(n_runs // 2, np.int64), np.sort(
            rng.integers(0, p + 1, n_runs - 1 - n_runs // 2))])
    elif layout == "trailing_empty":
        cuts = np.concatenate([np.sort(rng.integers(
            0, p + 1, n_runs - 1 - n_runs // 2)), np.full(n_runs // 2, p)])
    elif layout == "one_long":
        cuts = rng.integers(p - p // 8, p + 1, n_runs - 1)
    else:
        cuts = np.sort(rng.integers(0, p + 1, n_runs - 1))
        cuts[1: n_runs // 3] = cuts[:1]
    starts = np.concatenate([[0], np.sort(cuts), [p]]).astype(np.int32)
    if layout == "all_equal":
        cols = np.full((n_cols, p), 5, dtype=np.int32)
    else:
        cols = rng.integers(-1, 2, (n_cols, p)).astype(np.int32)
        cols[-1] = rng.integers(-2**31, 2**31, p)
        cols[-1, rng.random(p) < 0.5] = 7
    for r in range(n_runs):
        s, e = starts[r], starts[r + 1]
        if e > s:
            seg = cols[:, s:e]
            cols[:, s:e] = seg[:, np.lexsort(seg[::-1])]
    return cols, starts


@pytest.mark.parametrize("n_runs,n_cols,p,layout", [
    (1, 5, 5000, "middle_empty"),
    (2, 5, 100_003, "middle_empty"),
    (8, 5, 1 << 16, "leading_empty"),
    (8, 5, 70_001, "trailing_empty"),
    (8, 1, 50_001, "middle_empty"),
    (8, 35, 30_001, "middle_empty"),
    (32, 5, 3001, "middle_empty"),  # runs shorter than one tile
    (32, 35, 20_000, "all_equal"),
    (8, 5, 40_000, "all_equal"),
    (4, 5, 100_000, "one_long"),
    (8, 5, 1 << 22, "middle_empty"),
])
def test_merge_matches_plain_layouts(dev, n_runs, n_cols, p, layout):
    rng = np.random.default_rng(n_runs * 1000 + n_cols)
    cols, starts = _layout_runs(rng, p, n_runs, n_cols, layout)
    cols = torch.from_numpy(cols).to(dev)
    starts = torch.from_numpy(starts).to(dev)
    n_rounds = n_runs.bit_length() - 1
    want = kernels.merge_runs_perm_plain(cols, starts, n_rounds)
    before = kernels.merge_runs_perm.launches
    got = kernels.merge_runs_perm(cols, starts, n_rounds)
    torch.cuda.synchronize()
    assert kernels.merge_runs_perm.launches == before + n_rounds
    assert torch.equal(got, want)


TIE_CASES = ((4000, 8, 5), (5000, 8, 1), (3000, 4, 2), (9000, 8, 5),
             (2500, 2, 5), (7000, 8, 3))


@pytest.mark.parametrize("case", range(len(TIE_CASES)))
def test_merge_matches_plain_tie_cases(dev, case):
    """Keys from {-1, 0, 1} in every column, so most compares tie on the
    leading columns, over runs of a few thousand rows (several tiles per
    pair) with empty runs among them: inputs on which a variant of the
    kernel that kept the leading columns in registers lost and repeated
    rows at in-tile boundaries. All cases come from one generator, in
    order."""
    rng = np.random.default_rng(5)
    for p, n_runs, n_cols in TIE_CASES[: case + 1]:
        cuts = np.sort(rng.integers(0, p + 1, n_runs - 1))
        cuts[1: n_runs // 3] = cuts[:1]
        starts = np.concatenate([[0], cuts, [p]]).astype(np.int32)
        cols = rng.integers(-1, 2, (n_cols, p)).astype(np.int32)
    for r in range(n_runs):
        s, e = starts[r], starts[r + 1]
        if e > s:
            seg = cols[:, s:e]
            cols[:, s:e] = seg[:, np.lexsort(seg[::-1])]
    cols = torch.from_numpy(cols).to(dev)
    starts = torch.from_numpy(starts).to(dev)
    n_rounds = n_runs.bit_length() - 1
    want = kernels.merge_runs_perm_plain(cols, starts, n_rounds)
    got = kernels.merge_runs_perm(cols, starts, n_rounds)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _gc_args(rng, n, n_snaps, tombs, offset, dev):
    """gc_rows inputs of n rows on the card, each a slice starting
    `offset` elements into a longer tensor (offset 1: data pointers that
    are not 16-byte aligned). Seqnos repeat and meet the snapshots."""
    seq = np.sort(rng.integers(1, 1 << 36, n + offset).astype(
        np.uint64))[::-1]
    seq[rng.random(n + offset) < 0.3] = np.uint64(1 << 35)
    snaps = sorted(int(x) for x in rng.integers(1, 1 << 36, n_snaps))
    snaps[0] = 1 << 35
    snap_hi, snap_lo = ck._split_snapshots(snaps)
    hi = lambda x: (x >> np.uint64(32)).astype(np.uint32)
    lo = lambda x: (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)[offset:]
    tomb = np.where(rng.random(n + offset) < 0.3,
                    rng.integers(1, 1 << 36, n + offset).astype(np.uint64),
                    np.uint64(0))
    return [t(hi(seq).view(np.int32)), t(lo(seq).view(np.int32)),
            t(rng.random(n + offset) < 0.4),
            t(hi(tomb).view(np.int32)) if tombs else None,
            t(lo(tomb).view(np.int32)) if tombs else None,
            t(rng.choice([0, 1, 2, 7], n + offset).astype(np.int32)),
            torch.from_numpy(snap_hi.view(np.int32)).to(dev),
            torch.from_numpy(snap_lo.view(np.int32)).to(dev)]


@pytest.mark.parametrize("n", [1, 3, 4 * 1000 + 1, 1 << 20])
@pytest.mark.parametrize("n_snaps", [40, 1000])  # buckets of 64 and 1024
def test_gc_rows_matches_plain_shapes(dev, n, n_snaps):
    rng = np.random.default_rng(n + n_snaps)
    for tombs in (True, False):
        for offset in (0, 1):
            args = _gc_args(rng, n, n_snaps, tombs, offset, dev)
            assert args[0].shape[0] == n
            want = kernels.gc_rows_plain(*args)
            before = kernels.gc_rows.launches
            got = kernels.gc_rows(*args)
            torch.cuda.synchronize()
            assert kernels.gc_rows.launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), (tombs, offset)


def test_shared_prefix_matches_plain(dev):
    rng = np.random.default_rng(4)
    for k, n, with_lens in ((16, 100_000, False), (17, 3000, True),
                            (128, 5000, True)):
        vals = np.sort(rng.integers(0, n // 2, n)).astype(np.uint64)
        m = np.full((n, k), ord("p"), dtype=np.uint8)
        for j in range(8):
            m[:, k - 1 - j] = (vals >> np.uint64(8 * j)) & np.uint64(0xFF)
        keys = torch.from_numpy(m)
        lens = (torch.from_numpy(rng.integers(k // 2, k + 1, n).astype(
            np.int32)) if with_lens else None)
        want = kernels.shared_prefix_lengths(keys, lens)
        before = kernels.shared_prefix_lengths.launches
        got = kernels.shared_prefix_lengths(
            keys.to(dev), None if lens is None else lens.to(dev))
        assert kernels.shared_prefix_lengths.launches == before + 1
        assert torch.equal(got.cpu(), want)


def _write_run(env, dbdir, icmp, topts, fnum, rng, n, seq0, tombstones=(),
               mix=None):
    """One presorted run of 8-digit keys (10% deletions, or the value types
    and shares of `mix`) as one SST."""
    draws = rng.integers(0, n, n)
    seqs = np.arange(seq0, seq0 + n, dtype=np.uint64)
    vt = np.where(rng.random(n) < 0.1, 0, 1).astype(np.int32)
    if mix is not None:
        vt = rng.choice(list(mix), n, p=list(mix.values())).astype(np.int32)
    s = np.lexsort((np.iinfo(np.int64).max - seqs.view(np.int64), draws))
    ik = np.empty((n, 16), dtype=np.uint8)
    for j in range(8):
        ik[:, 7 - j] = (draws[s] // 10 ** j) % 10 + ord("0")
    packed = (seqs[s] << np.uint64(8)) | vt[s].astype(np.uint64)
    ik[:, 8:] = packed[:, None] >> (np.arange(8) * 8).astype(
        np.uint64)[None, :] & np.uint64(0xFF)
    vals = np.full((n, 8), ord("v"), dtype=np.uint8)
    kv = ColumnarKV(ik.reshape(-1), np.arange(n, dtype=np.int32) * 16,
                    np.full(n, 16, np.int32), vals.reshape(-1),
                    np.arange(n, dtype=np.int32) * 8, np.full(n, 8, np.int32))
    files = write_tables_columnar(
        env, dbdir, lambda: fnum, icmp, topts, kv,
        np.arange(n, dtype=np.int32), np.full(n, -1, np.int64), vt[s],
        seqs[s], creation_time=1, tombstones=tombstones)
    _, path, props, smallest, largest, _sel = files[0]
    return FileMetaData(number=fnum, file_size=env.get_file_size(path),
                        smallest=smallest, largest=largest,
                        smallest_seqno=props.smallest_seqno,
                        largest_seqno=props.largest_seqno)


def test_cuda_job_writes_the_cpu_bytes(dev, tmp_path, monkeypatch):
    monkeypatch.setattr(dc, "_SHARD_MIN_ROWS", 1)
    monkeypatch.setattr(dc, "_SHARD_ROWS", 1 << 12)  # 4 shards
    env, icmp, topts = PosixEnv(), InternalKeyComparator(), TableOptions()
    dbdir = str(tmp_path)
    rng = np.random.default_rng(3)
    metas = [_write_run(env, dbdir, icmp, topts, 10 + i, rng, 4096,
                        1 + i * 4096) for i in range(4)]
    out = {}
    for device_name, base in (("cuda", 100), ("cpu", 200)):
        c = Compaction(level=0, output_level=2, inputs=list(metas),
                       bottommost=True, max_output_file_size=1 << 16)
        alloc = iter(range(base, base + 100))
        outs, _ = dc.run_device_compaction(
            env, dbdir, icmp, c, TableCache(env, dbdir, icmp, topts), topts,
            [3000, 9000], new_file_number=lambda: next(alloc),
            creation_time=1, device_name=device_name, pipeline=False)
        out[device_name] = [open(f"{dbdir}/{m.number:06d}.sst", "rb").read()
                            for m in outs]
    assert len(out["cuda"]) > 1 and out["cuda"] == out["cpu"]


def test_block_assembly_job_with_tombstone(dev, tmp_path):
    env, icmp, topts = PosixEnv(), InternalKeyComparator(), TableOptions()
    dbdir = str(tmp_path)
    rng = np.random.default_rng(5)
    # Seqnos 1..8192 for points; the tombstone sits between two snapshots.
    tomb = RangeTombstone(5000, b"00000500", b"00002500")
    metas = [_write_run(env, dbdir, icmp, topts, 10 + i, rng, 4096,
                        1 + i * 4096, (tomb,) if i else ())
             for i in range(2)]
    out = {}
    launches = {}
    for device_name, base in (("cuda", 100), ("cpu", 200)):
        c = Compaction(level=0, output_level=2, inputs=list(metas),
                       bottommost=True)
        alloc = iter(range(base, base + 100))
        counts = [kernels.gc_rows.launches, kernels.merge_runs_perm.launches,
                  kernels.shared_prefix_lengths.launches]
        outs, _ = dc.run_device_compaction(
            env, dbdir, icmp, c, TableCache(env, dbdir, icmp, topts), topts,
            [3000, 6000], new_file_number=lambda: next(alloc),
            creation_time=1, device_name=device_name, device_blocks=True)
        launches[device_name] = [
            kernels.gc_rows.launches - counts[0],
            kernels.merge_runs_perm.launches - counts[1],
            kernels.shared_prefix_lengths.launches - counts[2]]
        out[device_name] = [open(f"{dbdir}/{m.number:06d}.sst", "rb").read()
                            for m in outs]
        assert len(outs) == 1 and outs[0].num_range_deletions == 1
    assert out["cuda"] == out["cpu"]
    assert min(launches["cuda"]) > 0 and max(launches["cpu"]) == 0


def test_kernels_at_the_pipeline_shard_shape(dev):
    """The pipelined plane's shard: p = 2^19 rows, 4 presorted runs of
    78,125 rows (a 10M-entry job in 32 shards) plus the pad run and 3 empty
    runs (R = 8), 5 key columns; gc_rows over the same p with 64 snapshot
    words."""
    rng = np.random.default_rng(19)
    p, per_run = 1 << 19, 78_125
    cols = rng.integers(-2**31, 2**31, (5, p)).astype(np.int32)
    cols[:2] = rng.integers(-3, 3, (2, p))  # ties on the leading words
    cols[:, 4 * per_run:] = 2**31 - 1
    starts = np.array([0, per_run, 2 * per_run, 3 * per_run, 4 * per_run,
                       p, p, p, p], dtype=np.int32)
    for r in range(4):
        seg = cols[:, starts[r]:starts[r + 1]]
        cols[:, starts[r]:starts[r + 1]] = seg[:, np.lexsort(seg[::-1])]
    cols_t = torch.from_numpy(cols).to(dev)
    starts_t = torch.from_numpy(starts).to(dev)
    want = kernels.merge_runs_perm_plain(cols_t, starts_t, 3)
    before = kernels.merge_runs_perm.launches
    got = kernels.merge_runs_perm(cols_t, starts_t, 3)
    torch.cuda.synchronize()
    assert kernels.merge_runs_perm.launches == before + 3
    assert torch.equal(got, want)
    for tombs in (False, True):
        args = _gc_args(rng, p, 40, tombs, 0, dev)
        want = kernels.gc_rows_plain(*args)
        got = kernels.gc_rows(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), tombs


def _job(dev_name, env, dbdir, icmp, topts, metas, base, max_out=1 << 16,
         **kw):
    c = Compaction(level=0, output_level=2, inputs=list(metas),
                   bottommost=True, max_output_file_size=max_out)
    alloc = iter(range(base, base + 100))
    outs, stats = dc.run_device_compaction(
        env, dbdir, icmp, c, TableCache(env, dbdir, icmp, topts), topts,
        [3000, 9000], new_file_number=lambda: next(alloc), creation_time=1,
        device_name=dev_name, **kw)
    return [open(f"{dbdir}/{m.number:06d}.sst", "rb").read()
            for m in outs], stats


def test_pipelined_job_writes_the_cpu_bytes(dev, tmp_path, monkeypatch):
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    env, icmp, topts = PosixEnv(), InternalKeyComparator(), TableOptions()
    dbdir = str(tmp_path)
    rng = np.random.default_rng(6)
    metas = [_write_run(env, dbdir, icmp, topts, 10 + i, rng, 4096,
                        1 + i * 4096) for i in range(4)]
    streams = []
    orig = ck.fused_uniform_shard_start

    def spy(h, *a, **k):
        if h["device"].type == "cuda":
            cur = torch.cuda.current_stream(h["device"])
            streams.append(cur != torch.cuda.default_stream(h["device"]))
        return orig(h, *a, **k)

    monkeypatch.setattr(ck, "fused_uniform_shard_start", spy)
    counts = [kernels.gc_rows.launches, kernels.merge_runs_perm.launches]
    got, stats = _job("cuda", env, dbdir, icmp, topts, metas, 100,
                      pipeline_shards=4)
    assert stats.pipelined and kernels.gc_rows.launches - counts[0] == 4
    assert kernels.merge_runs_perm.launches - counts[1] == 12
    assert streams == [True] * 4  # the compute thread's own stream
    want, cstats = _job("cpu", env, dbdir, icmp, topts, metas, 200,
                        pipeline_shards=4)
    assert cstats.pipelined and len(got) > 1 and got == want


def _write_varlen_run(env, dbdir, icmp, topts, fnum, rng, n, seq0):
    """One presorted run of "user" + decimal keys (5-16 bytes, 10%
    deletions) as one SST."""
    draws = rng.integers(0, 10 ** 12, n // 2)[rng.integers(0, n // 2, n)]
    uks = [b"user%d" % d for d in draws]
    seqs = np.arange(seq0, seq0 + n, dtype=np.uint64)
    vt = np.where(rng.random(n) < 0.1, 0, 1).astype(np.int32)
    s = sorted(range(n), key=lambda i: (uks[i], -i))
    keys = [uks[i] + int((int(seqs[i]) << 8) | int(vt[i])).to_bytes(
        8, "little") for i in s]
    klens = np.array([len(k) for k in keys], dtype=np.int32)
    kv = ColumnarKV(np.frombuffer(b"".join(keys), np.uint8).copy(),
                    (np.cumsum(klens) - klens).astype(np.int32), klens,
                    np.full(n * 8, ord("v"), np.uint8),
                    np.arange(n, dtype=np.int32) * 8,
                    np.full(n, 8, np.int32))
    files = write_tables_columnar(
        env, dbdir, lambda: fnum, icmp, topts, kv,
        np.arange(n, dtype=np.int32), np.full(n, -1, np.int64), vt[s],
        seqs[s], creation_time=1)
    _, path, props, smallest, largest, _sel = files[0]
    return FileMetaData(number=fnum, file_size=env.get_file_size(path),
                        smallest=smallest, largest=largest,
                        smallest_seqno=props.smallest_seqno,
                        largest_seqno=props.largest_seqno)


def test_varlen_job_writes_the_cpu_bytes(dev, tmp_path):
    env, icmp, topts = PosixEnv(), InternalKeyComparator(), TableOptions()
    dbdir = str(tmp_path)
    rng = np.random.default_rng(8)
    metas = [_write_varlen_run(env, dbdir, icmp, topts, 10 + i, rng, 4000,
                               1 + i * 4000) for i in range(3)]
    before = kernels.gc_rows.launches
    got, stats = _job("cuda", env, dbdir, icmp, topts, metas, 100)
    assert kernels.gc_rows.launches == before + 1 and not stats.pipelined
    want, _ = _job("cpu", env, dbdir, icmp, topts, metas, 200)
    assert len(got) > 1 and got == want


def test_cuda_error_in_the_compute_thread_reaches_the_caller(
        dev, tmp_path, monkeypatch):
    """A CUDA allocation failure inside the pipeline's compute thread is
    raised to the caller as it is: the serial route never runs, and no
    thread or output file is left behind."""
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    env, icmp, topts = PosixEnv(), InternalKeyComparator(), TableOptions()
    dbdir = str(tmp_path)
    rng = np.random.default_rng(7)
    metas = [_write_run(env, dbdir, icmp, topts, 10 + i, rng, 4096,
                        1 + i * 4096) for i in range(4)]
    before = set(os.listdir(dbdir))
    orig = ck.upload_uniform_shard
    calls, serial = [], []

    def upload(*a, **k):
        calls.append(threading.current_thread().name)
        if len(calls) == 2:
            torch.empty(1 << 50, dtype=torch.uint8, device=dev)
        return orig(*a, **k)

    monkeypatch.setattr(ck, "upload_uniform_shard", upload)
    monkeypatch.setattr(dc, "_collect_raw_columnar",
                        lambda *a, **k: serial.append(1))
    with pytest.raises(torch.OutOfMemoryError):
        _job("cuda", env, dbdir, icmp, topts, metas, 100, pipeline_shards=4)
    assert calls == ["pipeline-compute"] * 2 and not serial
    assert not [t for t in threading.enumerate()
                if t.name.startswith("pipeline-")]
    assert set(os.listdir(dbdir)) == before


# MERGE operands are the runs' 8-byte values ("vvvvvvvv"), folded as u64.
COMPLEX_MIX = {1: 0.6, 2: 0.2, 0: 0.1, 7: 0.1}


def test_complex_job_writes_the_cpu_bytes(dev, tmp_path, monkeypatch):
    from toplingdb_tpu_torch.utils.merge_operator import UInt64AddOperator

    monkeypatch.setattr(dc, "_SHARD_MIN_ROWS", 1)
    env, icmp, topts = PosixEnv(), InternalKeyComparator(), TableOptions()
    dbdir = str(tmp_path)
    rng = np.random.default_rng(12)
    metas = [_write_run(env, dbdir, icmp, topts, 10 + i, rng, 4096,
                        1 + i * 4096, mix=COMPLEX_MIX) for i in range(4)]
    resolved = []
    orig = dc._resolve_complex_stream
    monkeypatch.setattr(dc, "_resolve_complex_stream",
                        lambda *a: resolved.append(1) or orig(*a))
    counts = [kernels.gc_rows.launches, kernels.merge_runs_perm.launches]
    got, stats = _job("cuda", env, dbdir, icmp, topts, metas, 100,
                      merge_operator=UInt64AddOperator(), num_shards=2)
    assert kernels.gc_rows.launches - counts[0] == 2
    # Two or three merge rounds per shard (4 runs, plus the pad run).
    assert 4 <= kernels.merge_runs_perm.launches - counts[1] <= 6
    assert not stats.pipelined and resolved == [1]
    want, _ = _job("cpu", env, dbdir, icmp, topts, metas, 200,
                   merge_operator=UInt64AddOperator(), num_shards=2)
    assert len(got) > 1 and got == want


def _write_blob_inputs(env, dbdir, icmp, topts, rng, n_files=3, n=3000):
    """Inputs of a blob-GC job: runs of 8-digit keys (5% empty values, 10%
    BLOB_INDEX rows into blob files 5 and 6 holding 1 KiB or 300-byte
    values) written with the port's TableBuilder."""
    from toplingdb_tpu_torch.db import blob
    from toplingdb_tpu_torch.db.dbformat import ValueType, make_internal_key
    from toplingdb_tpu_torch.table.builder import TableBuilder

    blobs = {fn: blob.BlobFileBuilder(env, dbdir, fn) for fn in (5, 6)}
    metas, seq = [], 1
    for fnum in range(10, 10 + n_files):
        rows = {}
        for _ in range(n):
            k = b"%08d" % rng.integers(0, n)
            r = rng.random()
            if r < 0.05:
                rows[k, seq] = (ValueType.VALUE, b"")
            elif r < 0.15:
                raw = b"%c" % (65 + seq % 26) * int(rng.choice([300, 1024]))
                rows[k, seq] = (ValueType.BLOB_INDEX,
                                blobs[5 + seq % 2].add(k, raw))
            else:
                rows[k, seq] = (ValueType.VALUE, b"val%05d" % seq)
            seq += 1
        path = f"{dbdir}/{fnum:06d}.sst"
        w = env.new_writable_file(path)
        b = TableBuilder(w, icmp, topts)
        refs = set()
        for (k, sq), (t, v) in sorted(rows.items(),
                                      key=lambda kv: (kv[0][0], -kv[0][1])):
            b.add(make_internal_key(k, sq, t), v)
            if t == ValueType.BLOB_INDEX:
                refs.add(blob.decode_blob_index(v)[0])
        props = b.finish()
        w.close()
        metas.append(FileMetaData(
            number=fnum, file_size=env.get_file_size(path),
            smallest=b.smallest_key, largest=b.largest_key,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno, blob_refs=sorted(refs)))
    for bb in blobs.values():
        bb.finish()
    return metas


def _gc_job(dev_name, env, dbdir, icmp, topts, metas, fail=None):
    from toplingdb_tpu_torch.db import blob
    from toplingdb_tpu_torch.utils.compaction_filter import (
        RemoveEmptyValueCompactionFilter,
    )

    alloc = iter(range(100, 200))
    new_number = lambda: next(alloc)  # noqa: E731
    src = blob.BlobSource(env, dbdir)
    gc = blob.BlobGarbageCollector(
        env, dbdir, [fn for m in metas for fn in m.blob_refs], 0.5, 512,
        src.get, new_number)
    c = Compaction(level=0, output_level=2, inputs=list(metas),
                   bottommost=True, max_output_file_size=1 << 16)
    outs, _ = dc.run_device_compaction(
        env, dbdir, icmp, c, TableCache(env, dbdir, icmp, topts), topts,
        [2000, 6000], new_file_number=new_number, creation_time=1,
        device_name=dev_name, blob_resolver=src.get, blob_gc=gc,
        compaction_filter=RemoveEmptyValueCompactionFilter())
    names = [f"{m.number:06d}.sst" for m in outs]
    names.append(f"{gc.new_blob_file:06d}.blob")
    return [open(f"{dbdir}/{n}", "rb").read() for n in names], outs, gc


def test_per_entry_job_with_filter_and_blob_gc(dev, tmp_path):
    env, icmp, topts = PosixEnv(), InternalKeyComparator(), TableOptions()
    dirs = [str(tmp_path / d) for d in ("cuda", "cpu")]
    os.makedirs(dirs[0])
    metas = _write_blob_inputs(env, dirs[0], icmp, topts,
                               np.random.default_rng(13))
    os.makedirs(dirs[1])
    for name in os.listdir(dirs[0]):
        os.link(f"{dirs[0]}/{name}", f"{dirs[1]}/{name}")
    before = kernels.gc_rows.launches
    got, outs, gc = _gc_job("cuda", env, dirs[0], icmp, topts, metas)
    assert kernels.gc_rows.launches == before + 1
    assert gc.rewritten > 0 and gc.inlined > 0
    want, cpu_outs, _ = _gc_job("cpu", env, dirs[1], icmp, topts, metas)
    assert len(got) > 2 and got == want
    assert [m.blob_refs for m in outs] == [m.blob_refs for m in cpu_outs]


@pytest.mark.parametrize("n", [1, 3])
def test_per_entry_gc_mask_few_rows(dev, n):
    from toplingdb_tpu_torch.db.dbformat import ValueType, make_internal_key
    from toplingdb_tpu_torch.ops.columnar import ColumnarEntries

    icmp = InternalKeyComparator()
    entries = [(make_internal_key(b"k%d" % (i % 2), 10 - i,
                                  ValueType.VALUE if i % 2 else
                                  ValueType.MERGE), b"\x01" * 8)
               for i in range(n)]
    col = ColumnarEntries.from_entries(entries)
    out = {}
    for d in (dev, "cpu"):
        before = kernels.gc_rows.launches
        cols, perm = ck.device_sort(ck.pad_columns(col), d)
        out[str(d)] = (perm,) + ck.gc_mask(cols, [5], None, True)
        if d == dev:
            assert kernels.gc_rows.launches == before + 1
    for a, b in zip(out[str(dev)], out["cpu"]):
        assert np.array_equal(a, b)
    from toplingdb_tpu_torch.utils.merge_operator import UInt64AddOperator

    assert list(dc.device_gc_entries(
        entries, icmp, [5], True, merge_operator=UInt64AddOperator(),
        device_name="cuda")) == list(dc.device_gc_entries(
            entries, icmp, [5], True, merge_operator=UInt64AddOperator(),
            device_name="cpu"))


def test_cuda_error_in_the_per_entry_route_reaches_the_caller(
        dev, tmp_path, monkeypatch):
    """A CUDA allocation failure while the per-entry route masks the job
    on the card is raised to the caller as it is, with no SST and no blob
    file left behind."""
    env, icmp, topts = PosixEnv(), InternalKeyComparator(), TableOptions()
    dbdir = str(tmp_path)
    metas = _write_blob_inputs(env, dbdir, icmp, topts,
                               np.random.default_rng(14), n_files=2, n=500)
    before = set(os.listdir(dbdir))
    orig = ck.gc_mask

    def gc_mask(*a, **k):
        torch.empty(1 << 50, dtype=torch.uint8, device=dev)
        return orig(*a, **k)

    monkeypatch.setattr(ck, "gc_mask", gc_mask)
    with pytest.raises(torch.OutOfMemoryError):
        _gc_job("cuda", env, dbdir, icmp, topts, metas)
    assert set(os.listdir(dbdir)) == before


def _compressed_runs(env, dbdir, icmp, topts, seed, n_runs=4, n=4096):
    rng = np.random.default_rng(seed)
    return [_write_run(env, dbdir, icmp, topts, 10 + i, rng, n,
                       1 + i * n) for i in range(n_runs)]


@pytest.mark.parametrize("codec", ["snappy", "zstd", "zstd-dict"])
def test_compressed_job_writes_the_cpu_bytes(dev, tmp_path, monkeypatch,
                                             codec):
    """Snappy and zstd inputs and outputs through the pipelined plane (the
    native scan inflates inline, the writer compresses natively); zstd
    with a dictionary through the serial route (the pipeline gives up on
    dictionary inputs; Python inflate and per-block writer). The kernels
    launch and the bytes equal the CPU route's."""
    from toplingdb_tpu_torch.table.builder import CompressionOptions
    from toplingdb_tpu_torch.utils import codecs

    if not codecs.available(codec.split("-")[0]):
        pytest.skip(f"lib{codec.split('-')[0]} is not on this host")
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    env, icmp = PosixEnv(), InternalKeyComparator()
    topts = {"snappy": TableOptions(compression=1),
             "zstd": TableOptions(compression=7),
             "zstd-dict": TableOptions(
                 compression=7, compression_opts=CompressionOptions(
                     max_dict_bytes=4096, zstd_max_train_bytes=1 << 15))
             }[codec]
    dbdir = str(tmp_path)
    metas = _compressed_runs(env, dbdir, icmp, topts, 21)
    counts = [kernels.gc_rows.launches, kernels.merge_runs_perm.launches]
    got, stats = _job("cuda", env, dbdir, icmp, topts, metas, 100,
                      max_out=1 << 14, pipeline_shards=4)
    assert stats.pipelined == (codec != "zstd-dict")
    assert kernels.gc_rows.launches > counts[0]
    assert kernels.merge_runs_perm.launches > counts[1]
    want, _ = _job("cpu", env, dbdir, icmp, topts, metas, 200,
                   max_out=1 << 14, pipeline_shards=4)
    assert len(got) > 1 and got == want


def _port_job_dir(root, inputs, device, compression=7):
    import json

    from toplingdb_tpu_torch.compaction.executor import CompactionParams

    job = os.path.join(root, f"job-{device}")
    os.makedirs(os.path.join(job, "out"))
    with open(os.path.join(job, "params.json"), "w") as f:
        f.write(CompactionParams(
            job_id=1, attempt=1, dbname=root,
            output_dir=os.path.join(job, "out"), input_files=inputs,
            output_level=2, bottommost=True, max_output_file_size=1 << 14,
            snapshots=[5000], comparator="tpulsm.BytewiseComparator",
            merge_operator=None, compaction_filter=None,
            compression=compression, block_size=4096, creation_time=1,
            device=device, lease_sec=0.0).to_json())
    return job, lambda: json.load(open(os.path.join(job, "results.json")))


def test_worker_cuda_writes_the_cpu_jax_bytes(dev, tmp_path):
    """A zstd job (libzstd is on the card's host) through the worker."""
    from toplingdb_tpu_torch.compaction import worker

    env, icmp = PosixEnv(), InternalKeyComparator()
    topts = TableOptions(compression=7)
    dbdir = str(tmp_path)
    metas = _compressed_runs(env, dbdir, icmp, topts, 22)
    inputs = [f"{dbdir}/{m.number:06d}.sst" for m in metas]
    out = {}
    for device in ("cuda", "cpu-jax"):
        before = kernels.gc_rows.launches
        job, results = _port_job_dir(dbdir, inputs, device)
        assert worker.run_job(job) == 0
        res = results()
        assert res["status"] == "ok"
        if device == "cuda":
            assert kernels.gc_rows.launches > before
        out[device] = (res["output_files"], [
            open(os.path.join(job, "out", f["path"]), "rb").read()
            for f in res["output_files"]])
    assert len(out["cuda"][1]) > 1 and out["cuda"] == out["cpu-jax"]


def test_cuda_worker_job_without_a_card_fails(tmp_path, monkeypatch):
    """No fallback hides the device: without a card (hidden here when one
    is present) a "cuda" job fails with rc 1 and writes nothing."""
    from toplingdb_tpu_torch.compaction import worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env, icmp = PosixEnv(), InternalKeyComparator()
    topts = TableOptions(compression=7)
    dbdir = str(tmp_path)
    metas = _compressed_runs(env, dbdir, icmp, topts, 23, n_runs=2, n=512)
    inputs = [f"{dbdir}/{m.number:06d}.sst" for m in metas]
    job, results = _port_job_dir(dbdir, inputs, "cuda")
    assert worker.main(["--job-dir", job]) == 1
    assert "no CUDA device" in results()["status"]
    assert os.listdir(os.path.join(job, "out")) == []


def _format_job(dev_name, env, dbdir, icmp, in_topts, out_topts, metas,
                base, snaps=(), max_out=1 << 62, **kw):
    """One bottommost job; returns (output bytes, stats, the kernels'
    launches during it)."""
    c = Compaction(level=0, output_level=2, inputs=list(metas),
                   bottommost=True, max_output_file_size=max_out)
    alloc = iter(range(base, base + 100))
    counts = [kernels.gc_rows.launches, kernels.merge_runs_perm.launches]
    outs, stats = dc.run_device_compaction(
        env, dbdir, icmp, c, TableCache(env, dbdir, icmp, in_topts),
        out_topts, list(snaps), new_file_number=lambda: next(alloc),
        creation_time=1, device_name=dev_name, **kw)
    launches = [kernels.gc_rows.launches - counts[0],
                kernels.merge_runs_perm.launches - counts[1]]
    return ([open(f"{dbdir}/{m.number:06d}.sst", "rb").read()
             for m in outs], stats, launches)


def test_zip_job_writes_the_cpu_bytes(dev, tmp_path):
    """A zstd zip job over 2^19 + rows (4 runs of 140,000) through the
    pipelined plane at its real shard shape: gc_rows once and the merge
    three times per shard on the card, the zip writer on the native plane;
    the bytes equal the "cpu" run's."""
    env, icmp = PosixEnv(), InternalKeyComparator()
    in_topts = TableOptions()
    zip_topts = TableOptions(format="zip", compression=7)
    dbdir = str(tmp_path)
    rng = np.random.default_rng(31)
    metas = [_write_run(env, dbdir, icmp, in_topts, 10 + i, rng, 140_000,
                        1 + i * 140_000) for i in range(4)]
    got, stats, launches = _format_job("cuda", env, dbdir, icmp, in_topts,
                                       zip_topts, metas, 100)
    shards = launches[0]
    assert stats.pipelined and shards >= 2 and launches[1] == 3 * shards
    want, cstats, _ = _format_job("cpu", env, dbdir, icmp, in_topts,
                                  zip_topts, metas, 200)
    assert cstats.pipelined and got == want


def test_protected_job_writes_the_cpu_bytes(dev, tmp_path, monkeypatch):
    """protection_bytes_per_key=8 through the pipelined plane: the outputs
    are verified and equal the unprotected bytes and the "cpu" run's."""
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    env, icmp = PosixEnv(), InternalKeyComparator()
    in_topts = TableOptions()
    topts = TableOptions(protection_bytes_per_key=8)
    dbdir = str(tmp_path)
    rng = np.random.default_rng(32)
    metas = [_write_run(env, dbdir, icmp, in_topts, 10 + i, rng, 4096,
                        1 + i * 4096) for i in range(4)]
    verified = []
    orig = dc.verify_output_table

    def spy(*a, **k):
        verified.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(dc, "verify_output_table", spy)
    got, stats, launches = _format_job(
        "cuda", env, dbdir, icmp, in_topts, topts, metas, 100,
        snaps=[3000, 9000], max_out=1 << 16, pipeline_shards=4)
    assert stats.pipelined and launches == [4, 12]
    assert len(verified) == len(got) > 1
    want, _, _ = _format_job("cpu", env, dbdir, icmp, in_topts, topts,
                             metas, 200, snaps=[3000, 9000],
                             max_out=1 << 16, pipeline_shards=4)
    plain, _, _ = _format_job("cuda", env, dbdir, icmp, in_topts, in_topts,
                              metas, 300, snaps=[3000, 9000],
                              max_out=1 << 16, pipeline_shards=4)
    assert got == want == plain


def test_single_fast_job_writes_the_cpu_bytes(dev, tmp_path):
    """A single_fast job takes the per-entry route: one gc_rows launch on
    the card, and the bytes equal the "cpu" run's."""
    env, icmp = PosixEnv(), InternalKeyComparator()
    in_topts = TableOptions()
    topts = TableOptions(format="single_fast", hash_index=True)
    dbdir = str(tmp_path)
    rng = np.random.default_rng(33)
    metas = [_write_run(env, dbdir, icmp, in_topts, 10 + i, rng, 4096,
                        1 + i * 4096) for i in range(3)]
    got, _, launches = _format_job("cuda", env, dbdir, icmp, in_topts,
                                   topts, metas, 100, snaps=[3000],
                                   max_out=1 << 16)
    assert launches == [1, 0]
    want, _, _ = _format_job("cpu", env, dbdir, icmp, in_topts, topts,
                             metas, 200, snaps=[3000], max_out=1 << 16)
    assert len(got) > 1 and got == want


def _db_views(path, device, n):
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options

    factory = DeviceCompactionExecutorFactory(device=device)
    opts = Options(write_buffer_size=1 << 20, disable_auto_compactions=True,
                   compaction_executor_factory=factory)
    keys = [b"%016d" % (j * 2654435761 % (2 * n)) for j in range(n)]
    db = DB.open(path, opts)
    try:
        for i in range(0, n, 100):
            b = WriteBatch()
            for j in range(i, i + 100):
                b.put(keys[j], b"v%019d" % j)
            db.write(b)
            if i % 50_000 == 0:
                db.delete(keys[i // 2])
        db.flush()
        db.compact_range()
        sched = db._compaction_scheduler
        assert factory.jobs
        assert sched.num_local_jobs == 0 and sched.last_error is None
        probes = keys[::97] + [b"missing"]
        gets = [db.get(k) for k in probes]
        it = db.new_iterator()
        it.seek_to_first()
        scan = list(it.entries())
    finally:
        db.close()
    with DB.open(path, opts) as db:
        assert [db.get(k) for k in probes] == gets
    return gets, scan


def test_db_on_the_card_has_the_cpu_views(dev, tmp_path):
    n = 200_000
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    got = _db_views(str(tmp_path / "cuda"), "cuda", n)
    assert kernels.gc_rows.launches > 0
    assert kernels.merge_runs_perm.launches > 0
    want = _db_views(str(tmp_path / "cpu"), "cpu", n)
    assert got == want
    assert len(got[1]) == n - 4


def _cf_db_files(path, device, n):
    """A DB with CF "aux" beside the default one, fed by batches that
    alternate the CF per key, flushed and compacted (both CFs' jobs on
    `device`). Returns {CF name: {file number: (bytes, (cf id, cf name))}}
    and the jobs' CF ids."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.table.factory import open_table

    factory = DeviceCompactionExecutorFactory(device=device)
    opts = Options(write_buffer_size=1 << 20, disable_auto_compactions=True,
                   compaction_executor_factory=factory)
    env = PosixEnv()
    out = {}
    with DB.open(path, opts) as db:
        aux = db.create_column_family("aux")
        for r in range(3):
            for i in range(0, n, 100):
                b = WriteBatch()
                for j in range(i, i + 100):
                    b.put(b"%016d" % (j * 2654435761 % (2 * n)),
                          b"v%d-%017d" % (r, j), cf=aux.id if j % 2 else 0)
                db.write(b)
            db.flush()
        db.compact_range()
        assert db._compaction_scheduler.last_error is None
        for h in db.list_column_families():
            files = {}
            for _, f in db.versions.cf_current(h.id).all_files():
                fpath = os.path.join(path, "%06d.sst" % f.number)
                props = open_table(env.new_random_access_file(fpath),
                                   InternalKeyComparator()).properties
                files[f.number] = (open(fpath, "rb").read(),
                                   (props.column_family_id,
                                    props.column_family_name))
            out[h.name] = files
    return out, sorted({j["cf_id"] for j in factory.jobs})


def test_cf_db_on_the_card_writes_the_cpu_bytes(dev, tmp_path, monkeypatch):
    _frozen(monkeypatch)
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    got, cfs = _cf_db_files(str(tmp_path / "cuda"), "cuda", 60_000)
    assert kernels.gc_rows.launches > 0
    assert kernels.merge_runs_perm.launches > 0
    want, _ = _cf_db_files(str(tmp_path / "cpu"), "cpu", 60_000)
    assert cfs == [0, 1]
    assert got == want
    for name, cf_id in (("default", 0), ("aux", 1)):
        assert got[name]
        assert {tag for _, tag in got[name].values()} == {(cf_id, name)}


def _remote_db(path, factory):
    """The dcompact tests' workload (tests/test_torch_dcompact.py): 1600
    overwrites of 500 keys, explicit flushes, one remote L0->L1 job.
    Returns the live SSTs by file number, the level files, the WAL bytes
    and the job's stats."""
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils.listener import EventListener

    jobs = []

    class Watch(EventListener):
        def on_compaction_completed(self, db, info):
            jobs.append((info.device, info.reason))

    db = DB.open(path, Options(
        write_buffer_size=1 << 20, disable_auto_compactions=True,
        compaction_executor_factory=factory, listeners=[Watch()]))
    try:
        for i in range(1600):
            db.put(b"mk%05d" % (i % 500), b"mv%07d" % i)
            if i % 400 == 399:
                db.flush()
        db.flush()
        db.compact_range()
        assert db._bg_error is None
        assert db.get(b"mk00499") == b"mv%07d" % 1499
        v = db.versions.current
        levels = [[(f.number, f.smallest, f.largest) for f in lvl]
                  for lvl in v.files]
        ssts = {f.number: open(os.path.join(path, "%06d.sst" % f.number),
                               "rb").read()
                for lvl in v.files for f in lvl}
        wals = {n: open(os.path.join(path, n), "rb").read()
                for n in os.listdir(path) if n.endswith(".log")}
    finally:
        db.close()
    return (levels, ssts, wals), jobs


def _frozen(monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


@pytest.fixture
def cpu_jax_twin(tmp_path, monkeypatch):
    from toplingdb_tpu_torch.compaction.dcompact_service import (
        DcompactWorkerService,
        HttpCompactionExecutorFactory,
    )

    _frozen(monkeypatch)
    svc = DcompactWorkerService(device="cpu-jax")
    port = svc.start()
    try:
        return _remote_db(str(tmp_path / "cpu-jax"),
                          HttpCompactionExecutorFactory(
                              [f"http://127.0.0.1:{port}"],
                              device="cpu-jax"))
    finally:
        svc.stop()


def test_http_service_on_the_card_writes_the_cpu_jax_bytes(
        dev, tmp_path, cpu_jax_twin):
    from toplingdb_tpu_torch.compaction.dcompact_service import (
        DcompactWorkerService,
        HttpCompactionExecutorFactory,
    )

    svc = DcompactWorkerService(device="cuda")
    port = svc.start()
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    try:
        got, jobs = _remote_db(str(tmp_path / "cuda"),
                               HttpCompactionExecutorFactory(
                                   [f"http://127.0.0.1:{port}"]))
    finally:
        svc.stop()
    assert kernels.gc_rows.launches > 0
    assert kernels.merge_runs_perm.launches > 0
    assert svc.jobs_done == 1 and svc.jobs_failed == 0
    assert ("cuda", "manual") in jobs
    assert got == cpu_jax_twin[0]


def test_subprocess_worker_on_the_card_writes_the_cpu_jax_bytes(
        dev, tmp_path, cpu_jax_twin):
    from toplingdb_tpu_torch.compaction.executor import (
        SubprocessCompactionExecutorFactory,
    )

    got, jobs = _remote_db(str(tmp_path / "cuda"),
                           SubprocessCompactionExecutorFactory())
    assert ("cuda", "manual") in jobs
    assert got == cpu_jax_twin[0]
    assert [d for d in os.listdir(str(tmp_path / "cuda" / "dcompact"))
            if d.startswith("job-")] == []


def test_merge_of_12_runs_padded_to_16_matches_plain(dev):
    rng = np.random.default_rng(12)
    p = 3 * (1 << 14)
    cuts = np.sort(rng.integers(0, p + 1, 11))
    starts = np.concatenate([[0], cuts, [p] * 5]).astype(np.int32)
    assert starts.shape[0] == 17
    cols = rng.integers(-3, 4, (5, p)).astype(np.int32)
    for r in range(12):
        s, e = starts[r], starts[r + 1]
        cols[:, s:e] = cols[:, s:e][:, np.lexsort(cols[:, s:e][::-1])]
    want = kernels.merge_runs_perm(torch.from_numpy(cols),
                                   torch.from_numpy(starts), 4)
    before = kernels.merge_runs_perm.launches
    got = kernels.merge_runs_perm(torch.from_numpy(cols).to(dev),
                                  torch.from_numpy(starts).to(dev), 4)
    assert kernels.merge_runs_perm.launches == before + 4
    assert torch.equal(got.cpu(), want)


def _style_db(path, device, n, rounds, **kw):
    """A DB of `kw`'s style fed `rounds` overlapping rounds of n keys, each
    flushed and its compactions waited for, then compact_range. Returns
    the live SST and blob file bytes by name, the get view of every key
    against a dict oracle, and the device jobs."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options

    factory = DeviceCompactionExecutorFactory(device=device)
    opts = Options(write_buffer_size=64 << 20,
                   compaction_executor_factory=factory, **kw)
    want = {}
    with DB.open(path, opts) as db:
        for r in range(rounds):
            for i in range(r, n, 100):
                b = WriteBatch()
                for j in range(i, min(i + 100, n), 1 + r % 2):
                    k = b"%016d" % (j * 2654435761 % (2 * n))
                    v = b"r%d-%d-" % (r, j) * (1 + j % 60)
                    b.put(k, v)
                    want[k] = v
                db.write(b)
            db.flush()
            db.wait_for_compactions()
        db.compact_range()
        sched = db._compaction_scheduler
        assert sched.num_local_jobs == 0 and sched.last_error is None
        for k, v in want.items():
            assert db.get(k) == v, k
        it = db.new_iterator()
        it.seek_to_first()
        assert list(it.entries()) == sorted(want.items())
        metas = [f for _, f in db.versions.current.all_files()]
        names = ["%06d.sst" % f.number for f in metas] + [
            "%06d.blob" % x for x in sorted({x for f in metas
                                             for x in f.blob_refs})]
    files = {}
    for name in names:
        with open(os.path.join(path, name), "rb") as f:
            files[name] = f.read()
    return files, factory.jobs


@pytest.mark.parametrize("style", ["universal", "blob-gc"])
def test_style_db_on_the_card_writes_the_cpu_bytes(dev, tmp_path,
                                                   monkeypatch, style):
    _frozen(monkeypatch)
    kw = (dict(compaction_style="universal",
               level0_file_num_compaction_trigger=3)
          if style == "universal" else
          dict(enable_blob_files=True, min_blob_size=256,
               enable_blob_garbage_collection=True,
               blob_garbage_collection_age_cutoff=0.25))
    n = 40_000 if style == "universal" else 15_000  # per-entry GC jobs
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    got, jobs = _style_db(str(tmp_path / "cuda"), "cuda", n, 5, **kw)
    assert jobs and kernels.gc_rows.launches >= len(jobs)
    if style == "universal":
        assert kernels.merge_runs_perm.launches > 0
        assert {j["reason"] for j in jobs} <= {
            "universal size-ratio", "universal size-amp",
            "universal merge-all", "manual universal"}
    else:
        assert any(name.endswith(".blob") for name in got)
    want, cpu_jobs = _style_db(str(tmp_path / "cpu"), "cpu", n, 5, **kw)
    assert [j["reason"] for j in jobs] == [j["reason"] for j in cpu_jobs]
    assert got == want


def _protected_db(path, device, n, verified):
    """A DB with protection_bytes_per_key=8 whose flushes and compactions
    run on `device`, `verified` collecting every output file the jobs
    verified per entry. Returns its SST bytes by file number and a scan."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options

    factory = DeviceCompactionExecutorFactory(device=device)
    opts = Options(write_buffer_size=1 << 20, disable_auto_compactions=True,
                   protection_bytes_per_key=8,
                   compaction_executor_factory=factory)
    with DB.open(path, opts) as db:
        for r in range(3):
            for i in range(0, n, 100):
                b = WriteBatch(protection_bytes_per_key=8)
                for j in range(i, i + 100):
                    b.put(b"%016d" % (j * 2654435761 % (2 * n)),
                          b"v%d-%017d" % (r, j))
                db.write(b)
            db.flush()
        db.compact_range()
        sched = db._compaction_scheduler
        assert factory.jobs and sched.num_local_jobs == 0
        assert sched.last_error is None and db._bg_error is None
        assert db.scrub()["corruptions"] == []
        files = {f.number: open(os.path.join(path, "%06d.sst" % f.number),
                                "rb").read()
                 for _, f in db.versions.current.all_files()}
        it = db.new_iterator()
        it.seek_to_first()
        scan = list(it.entries())
    assert sorted(verified) == sorted(files), (verified, sorted(files))
    verified.clear()
    return files, scan


def test_protected_db_on_the_card_verifies_its_outputs(dev, tmp_path,
                                                       monkeypatch):
    """A small protected DB (protection 8): its jobs run on "cuda" (gc_rows
    and the merge launch), every output is re-read and verified per entry,
    and its SST bytes and scan equal the same DB's on "cpu"."""
    verified = []
    verify = dc.verify_output_table

    def spy(env, path, *a, **k):
        verified.append(int(os.path.basename(path).split(".")[0]))
        return verify(env, path, *a, **k)

    monkeypatch.setattr(dc, "verify_output_table", spy)
    _frozen(monkeypatch)
    n = 100_000
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    got = _protected_db(str(tmp_path / "cuda"), "cuda", n, verified)
    assert kernels.gc_rows.launches > 0
    assert kernels.merge_runs_perm.launches > 0
    want = _protected_db(str(tmp_path / "cpu"), "cpu", n, verified)
    assert got == want
    assert len(got[1]) == n


def _trie_unordered_db(path, device, n):
    """A CSPP-trie DB filled by 4 unordered writer threads with concurrent
    inserts, its flushes and compactions on `device`. Returns its gets of
    every key, taken after compact_range, and its scan."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options

    factory = DeviceCompactionExecutorFactory(device=device)
    opts = Options(write_buffer_size=1 << 20, memtable_rep="cspp",
                   unordered_write=True,
                   allow_concurrent_memtable_write=True,
                   compaction_executor_factory=factory)
    keys = [b"%016d" % (j * 2654435761 % (2 * n)) for j in range(n)]
    per = n // 4
    errs = []

    def writer(db, t):
        try:
            for i in range(t * per, (t + 1) * per, 100):
                b = WriteBatch()
                for j in range(i, i + 100):
                    b.put(keys[j], b"v%019d" % j)
                db.write(b)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    with DB.open(path, opts) as db:
        ts = [threading.Thread(target=writer, args=(db, t))
              for t in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs
        db.flush()
        db.wait_for_compactions()
        db.compact_range()
        sched = db._compaction_scheduler
        assert factory.jobs and sched.num_local_jobs == 0
        assert sched.last_error is None and db._bg_error is None
        gets = [db.get(k) for k in keys]
        it = db.new_iterator()
        it.seek_to_first()
        scan = list(it.entries())
    return gets, scan


def test_trie_db_with_unordered_writers_on_the_card(dev, tmp_path):
    """A small CSPP-trie DB filled by unordered writers with concurrent
    inserts: its jobs run on "cuda" (gc_rows and the merge launch), every
    key reads back, and its gets and scan equal the same DB's on "cpu"."""
    n = 200_000
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    got = _trie_unordered_db(str(tmp_path / "cuda"), "cuda", n)
    assert kernels.gc_rows.launches > 0
    assert kernels.merge_runs_perm.launches > 0
    assert None not in got[0] and len(got[1]) == n
    want = _trie_unordered_db(str(tmp_path / "cpu"), "cpu", n)
    assert got == want


def _block_cache_db(path, device, n):
    """A small DB with an LRUCache block cache (the Python read chain),
    its compactions on `device`: after compact_range, the answers of
    multi_get (in batches of 128), get, and the async twin (a reopen with
    async_reads=True: multi_get, get_async, multi_get_async) on the same
    probes, and its scan."""
    import random

    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils.cache import LRUCache

    factory = DeviceCompactionExecutorFactory(device=device)

    def opts():
        return Options(write_buffer_size=1 << 20,
                       block_cache=LRUCache(256 * 1024),
                       compaction_executor_factory=factory)

    keys = [b"%016d" % (j * 2654435761 % (2 * n)) for j in range(n)]
    rng = random.Random(7)
    probes = [keys[rng.randrange(n)] for _ in range(4096)] + [b"absent"]
    with DB.open(path, opts()) as db:
        for i, k in enumerate(keys):
            db.put(k, b"v%019d" % i)
            if i % 50_000 == 49_999:
                db.put(keys[i // 2], b"w%019d" % i)  # an overwrite
        db.flush()
        db.wait_for_compactions()
        db.compact_range()
        sched = db._compaction_scheduler
        assert factory.jobs and sched.num_local_jobs == 0
        assert sched.last_error is None and db._bg_error is None
        assert db._nget_lib is None  # a user block cache: Python chain
        mget = [v for i in range(0, len(probes), 128)
                for v in db.multi_get(probes[i:i + 128])]
        gets = [db.get(k) for k in probes]
        it = db.new_iterator()
        it.seek_to_first()
        scan = list(it.entries())
    with DB.open(path, opts(), async_reads=True) as db:
        amget = [v for i in range(0, len(probes), 128)
                 for v in db.multi_get(probes[i:i + 128])]
        aget = [f.result() for f in [db.get_async(k) for k in probes]]
        afut = [v for f in [db.multi_get_async(probes[i:i + 128])
                            for i in range(0, len(probes), 128)]
                for v in f.result()]
    assert mget == gets == amget == aget == afut
    return gets, scan


def test_block_cache_db_on_the_card_has_the_cpu_answers(dev, tmp_path):
    """A small DB with a user block cache runs compact_range on "cuda"
    (gc_rows and the merge launch); its multi_get, get and async twin agree
    with each other and with the same DB's on "cpu"."""
    n = 200_000
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    got = _block_cache_db(str(tmp_path / "cuda"), "cuda", n)
    assert kernels.gc_rows.launches > 0
    assert kernels.merge_runs_perm.launches > 0
    assert got[0][-1] is None and None not in got[0][:-1]
    assert len(got[1]) == n
    want = _block_cache_db(str(tmp_path / "cpu"), "cpu", n)
    assert got == want


def _manual_db(path, device, n):
    """A DB with auto compactions off: five overlapping flushed rounds,
    compact_files of the older L0 files into L1, then of two L1 files into
    L2, then suggest_compact_range over the middle third and
    set_options({"disable_auto_compactions": False}), which runs the
    marked jobs. Returns the live SST bytes by name, the level sets, the
    jobs' reasons and a scan, with every get checked against an
    oracle."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options

    factory = DeviceCompactionExecutorFactory(device=device)
    opts = Options(write_buffer_size=64 << 20, disable_auto_compactions=True,
                   target_file_size_base=256 << 10, max_background_jobs=1,
                   compaction_executor_factory=factory)
    want = {}
    key = lambda j: b"%016d" % (j * 2654435761 % (2 * n))  # noqa: E731
    with DB.open(path, opts) as db:
        for r in range(5):
            for i in range(r, n, 100):
                b = WriteBatch()
                for j in range(i, min(i + 100, n), 1 + r % 2):
                    b.put(key(j), b"r%d-%d" % (r, j))
                    want[key(j)] = b"r%d-%d" % (r, j)
                db.write(b)
            db.flush()
        l0 = [f.number for f in db.versions.current.files[0]]
        db.compact_files(l0[2:3], 1)  # every older L0 file comes along
        l1 = [f.number for f in db.versions.current.files[1]]
        db.compact_files(l1[1:3], 2)
        ordered = sorted(want)
        third = len(ordered) // 3
        assert db.suggest_compact_range(ordered[third],
                                        ordered[2 * third]) > 0
        db.set_options({"disable_auto_compactions": False})
        db.wait_for_compactions()
        sched = db._compaction_scheduler
        assert sched.num_local_jobs == 0 and sched.last_error is None
        for k, v in want.items():
            assert db.get(k) == v, k
        it = db.new_iterator()
        it.seek_to_first()
        scan = list(it.entries())
        assert scan == sorted(want.items())
        levels = [[f.number for f in fl] for fl in db.versions.current.files]
        names = ["%06d.sst" % x for fl in levels for x in fl]
    files = {}
    for name in names:
        with open(os.path.join(path, name), "rb") as f:
            files[name] = f.read()
    return files, levels, [j["reason"] for j in factory.jobs], scan


def test_manual_compactions_on_the_card_write_the_cpu_bytes(dev, tmp_path,
                                                             monkeypatch):
    _frozen(monkeypatch)
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    got = _manual_db(str(tmp_path / "cuda"), "cuda", 30_000)
    assert got[2][:2] == ["compact_files", "compact_files"], got[2]
    assert len(got[2]) > 2, got[2]  # the marked picks ran
    assert kernels.gc_rows.launches >= len(got[2])
    assert kernels.merge_runs_perm.launches > 0
    want = _manual_db(str(tmp_path / "cpu"), "cpu", 30_000)
    assert got[1:] == want[1:]
    assert got[0] == want[0]


def _storage_db(path, device, n, kind):
    """kind "preclude": n keys with deletes in three flushes under
    preclude_last_level_data_seconds=3600, compact_range (young data: the
    jobs keep seqnos and tombstones); kind "entity": n entities of three
    columns, a string-append merge overlay on a tenth, deletes, then
    compact_range. Returns the live SST bytes by name, the level sets,
    the jobs, and the reads checked against an oracle."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils.merge_operator import StringAppendOperator

    factory = DeviceCompactionExecutorFactory(device=device)
    opts = Options(write_buffer_size=64 << 20, disable_auto_compactions=True,
                   compaction_executor_factory=factory,
                   merge_operator=StringAppendOperator(b","),
                   preclude_last_level_data_seconds=(
                       3600 if kind == "preclude" else 0))
    key = lambda j: b"%016d" % (j * 2654435761 % (2 * n))  # noqa: E731
    want = {}
    with DB.open(path, opts) as db:
        for r in range(3):
            for i in range(r, n, 1 + r):
                k = key(i)
                if kind == "entity":
                    cols = {b"": b"d%d-%d" % (r, i), b"c1": b"x" * 20,
                            b"c2": b"y%d" % i}
                    db.put_entity(k, cols)
                    want[k] = cols
                else:
                    db.put(k, b"r%d-%d" % (r, i))
                    want[k] = {b"": b"r%d-%d" % (r, i)}
            for i in range(r, n, 17):
                db.delete(key(i))
                want[key(i)] = None
            if kind == "entity":
                for i in range(r + 1, n, 10):
                    if want[key(i)] is not None:
                        db.merge(key(i), b"m%d" % r)
                        want[key(i)] = dict(want[key(i)])
                        want[key(i)][b""] += b",m%d" % r
            db.flush()
        db.compact_range()
        sched = db._compaction_scheduler
        assert sched.num_local_jobs == 0 and sched.last_error is None
        for k, v in want.items():
            assert db.get_entity(k) == v, k
        levels = [[(f.number, f.smallest_seqno, f.largest_seqno,
                    f.num_entries, f.num_deletions) for f in fl]
                  for fl in db.versions.current.files]
        names = ["%06d.sst" % f[0] for fl in levels for f in fl]
    files = {}
    for name in names:
        with open(os.path.join(path, name), "rb") as f:
            files[name] = f.read()
    return files, levels, len(factory.jobs)


@pytest.mark.parametrize("kind", ["preclude", "entity"])
def test_storage_slice_jobs_on_the_card_write_the_cpu_bytes(dev, tmp_path,
                                                            monkeypatch,
                                                            kind):
    _frozen(monkeypatch)
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    got = _storage_db(str(tmp_path / "cuda"), "cuda", 30_000, kind)
    assert got[2] > 0 and kernels.gc_rows.launches >= got[2]
    assert kernels.merge_runs_perm.launches > 0
    last = [fl for fl in got[1] if fl][-1]
    if kind == "preclude":
        # Young data at the last level: seqnos and tombstones kept.
        assert min(f[1] for f in last) > 0
        assert sum(f[4] for f in last) > 0
    want = _storage_db(str(tmp_path / "cpu"), "cpu", 30_000, kind)
    assert got[1:] == want[1:]
    assert got[0] == want[0]


def _ts_db(path, device, n):
    """A timestamp DB (U64_TS_BYTEWISE): n keys at ts by batch, a fifth
    overwritten at later timestamps, deletes and single deletes, a
    snapshot, increase_full_history_ts_low, compact_range (per-entry jobs
    with the history trim). Returns the live SST bytes by name, the level
    sets, the jobs, and the reads checked against an oracle."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.dbformat import U64_TS_BYTEWISE
    from toplingdb_tpu_torch.options import Options, ReadOptions

    factory = DeviceCompactionExecutorFactory(device=device)
    opts = Options(write_buffer_size=64 << 20, disable_auto_compactions=True,
                   comparator=U64_TS_BYTEWISE,
                   compaction_executor_factory=factory)
    key = lambda j: b"%016d" % (j * 2654435761 % (2 * n))  # noqa: E731
    with DB.open(path, opts) as db:
        for i in range(n):
            db.put(key(i), b"v%d" % i, ts=i // 100 + 1)
        db.flush()
        for i in range(0, n, 5):
            db.put(key(i), b"w%d" % i, ts=1000 + i)
        for i in range(1, n, 17):
            db.delete(key(i), ts=2000 + i)
        for i in range(2, n, 19):
            db.single_delete(key(i), ts=2000 + i)
        snap = db.get_snapshot()
        db.flush()
        db.increase_full_history_ts_low(1500)
        db.compact_range()
        reads = [db.get_with_ts(key(i)) for i in range(0, n, 7)]
        reads += [db.get(key(i), ReadOptions(timestamp=1500))
                  for i in range(0, n, 7)]
        reads.append(db.get(key(0), ReadOptions(snapshot=snap)))
        it = db.new_iterator(ReadOptions(timestamp=1500))
        it.seek_to_first()
        reads.append(sum(1 for _ in it.entries()))
        snap.release()
        for i in range(0, n, 7):
            if i % 17 == 1 or i % 19 == 2:
                want = None
            elif i % 5 == 0:
                want = (b"w%d" % i, 1000 + i)
            else:
                want = (b"v%d" % i, i // 100 + 1)
            assert reads[i // 7] == want, i
        levels = [[(f.number, f.smallest_seqno, f.largest_seqno,
                    f.num_entries, f.num_deletions) for f in fl]
                  for fl in db.versions.current.files]
        files = {}
        for fl in levels:
            for f in fl:
                with open(os.path.join(path, "%06d.sst" % f[0]), "rb") as fh:
                    files[f[0]] = fh.read()
        assert db._compaction_scheduler.num_local_jobs == 0
        jobs = len(factory.jobs)
    return files, levels, jobs, reads


def test_timestamp_db_on_the_card_writes_the_cpu_bytes(dev, tmp_path,
                                                       monkeypatch):
    """A timestamp DB's jobs take the per-entry route on the card (the
    gc_rows kernel, the history trim on the host) and write the SST bytes
    of the same DB on "cpu"."""
    _frozen(monkeypatch)
    kernels.gc_rows.launches = 0
    got = _ts_db(str(tmp_path / "cuda"), "cuda", 20_000)
    assert got[2] > 0 and kernels.gc_rows.launches >= got[2]
    want = _ts_db(str(tmp_path / "cpu"), "cpu", 20_000)
    assert got[1:] == want[1:]
    assert got[0] == want[0]


def _sp_config(path, device, **extra):
    opts = {"create_if_missing": True, "write_buffer_size": 256 << 10,
            "level0_file_num_compaction_trigger": 4,
            "compaction_executor_factory": {
                "class": "device", "params": {"device_name": device}},
            "table_options": {"filter_policy": {
                "class": "bloom", "params": {"bits_per_key": 10}}},
            "statistics": "default", "trace_sample_every": 100,
            "slo_specs": [{"name": "write-stall", "kind": "stall",
                           "objective": 0.99}]}
    opts.update(extra)
    return {"path": path, "options": opts}


def test_sideplugin_db_on_the_card_traces_and_replays(dev, tmp_path):
    """A DB opened by SidePluginRepo.open_db on "cuda" records an op trace
    of its fill and reads (jobs on the card, gc_rows launched, every fill
    group a native commit); the trace replayed into a second DB opened
    from the same config leaves the same full scan."""
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.env import default_env
    from toplingdb_tpu_torch.tools.trace_analyzer import analyze
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.config import SidePluginRepo
    from toplingdb_tpu_torch.utils.trace import Replayer

    repo = SidePluginRepo()
    trace = str(tmp_path / "ops.trace")
    n = 60_000
    key = lambda i: b"%016d" % (i * 2654435761 % (2 * n))  # noqa: E731
    kernels.gc_rows.launches = 0
    try:
        db = repo.open_db(_sp_config(str(tmp_path / "a"), "cuda"), name="a")
        assert db.options.compaction_executor_factory.device == "cuda"
        db.start_trace(trace)
        for i in range(0, n, 100):
            b = WriteBatch()
            for j in range(i, i + 100):
                b.put(key(j), b"v%d" % j)
            db.write(b)
        for i in range(0, n, 7):
            assert db.get(key(i)) == b"v%d" % i
        db.multi_get([key(i) for i in range(32)])
        it = db.new_iterator()
        it.seek(key(5))
        db.end_trace()
        db.flush()
        db.wait_for_compactions()
        t = db.stats.tickers()
        assert t[st.WRITE_GROUP_NATIVE_COMMITS] == t[st.WRITE_GROUP_LED]
        jobs = db.options.compaction_executor_factory.jobs
        assert jobs and kernels.gc_rows.launches >= 1
        assert db._compaction_scheduler.num_local_jobs == 0
        per = analyze(default_env(), trace)["per_op"]
        assert per == {"write_batch": n // 100, "get": len(range(0, n, 7)),
                       "multiget": 1, "iter_seek": 1}
        db_r = repo.open_db(_sp_config(str(tmp_path / "r"), "cuda"),
                            name="r")
        assert Replayer(db_r, trace).replay() == sum(per.values())
        db_r.flush()
        db_r.wait_for_compactions()

        def scan(d):
            it = d.new_iterator()
            it.seek_to_first()
            return list(it.entries())

        rows = scan(db)
        assert len(rows) == n and scan(db_r) == rows
    finally:
        repo.close_all()


def test_induced_stall_slo_fires_on_the_card(dev, tmp_path):
    """The stall SLO of a DB opened from its config on "cuda" (slowdown
    trigger 2): writes ride the delay ramp while the card's jobs drain L0,
    the engine fires, and it resolves once the writers stop. A fake clock
    drives the engine, so the verdict does not depend on the host's
    load."""
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.config import SidePluginRepo

    repo = SidePluginRepo()
    try:
        db = repo.open_db(_sp_config(
            str(tmp_path / "s"), "cuda", level0_slowdown_writes_trigger=2,
            slo_window_sec=2.0), name="s")
        eng = db.slo_engine
        clock = [1000.0]
        eng._clock = lambda: clock[0]
        eng.evaluate()
        fired = False
        jobs = db.options.compaction_executor_factory.jobs
        for r in range(60):
            stalled0 = db.stats.get_ticker_count(st.STALL_MICROS)
            for i in range(2000):
                db.put(b"%016d" % (r * 2000 + i), b"x" * 100)
            clock[0] += 1.0
            eng.evaluate()
            if eng.status()["specs"]["write-stall"]["firing"]:
                fired = fired or (
                    db.stats.get_ticker_count(st.STALL_MICROS) > stalled0)
            if fired and jobs:
                break
        assert fired, "the stall SLO never fired"
        db.wait_for_compactions()
        for _ in range(4):
            clock[0] += 1.0
            eng.evaluate()
        assert not eng.status()["specs"]["write-stall"]["firing"]
        fired_n = db.stats.get_ticker_count(st.SLO_ALERTS_FIRED)
        assert fired_n >= 1
        assert db.stats.get_ticker_count(st.SLO_ALERTS_RESOLVED) == fired_n
        assert db.options.compaction_executor_factory.jobs
        assert db._compaction_scheduler.num_local_jobs == 0
    finally:
        repo.close_all()


def test_mesh_route_on_the_card_named_twice(dev, tmp_path, monkeypatch):
    from toplingdb_tpu_torch.ops import mesh_compaction as mc
    from toplingdb_tpu_torch.parallel import mesh_plan

    monkeypatch.setattr(dc, "_SHARD_MIN_ROWS", 1)
    monkeypatch.setattr(pl, "MIN_PIPELINE_ROWS", 256)
    monkeypatch.setattr(mesh_plan, "DEFAULT_MESH_MIN_ROWS", 1)
    env, icmp, topts = PosixEnv(), InternalKeyComparator(), TableOptions()
    dbdir = str(tmp_path)
    rng = np.random.default_rng(8)
    metas = [_write_run(env, dbdir, icmp, topts, 10 + i, rng, 4096,
                        1 + i * 4096) for i in range(4)]
    card = torch.device("cuda", 0)
    want, _ = _job("cuda", env, dbdir, icmp, topts, metas, 100,
                   pipeline=False, num_shards=4)
    counts = [kernels.gc_rows.launches, kernels.merge_runs_perm.launches]
    got, stats = _job("cuda", env, dbdir, icmp, topts, metas, 200,
                      pipeline=False, num_shards=4,
                      mesh_devices=[card, card])
    assert stats.mesh_chips == 2 and got == want
    piped, pstats = _job("cuda", env, dbdir, icmp, topts, metas, 300,
                         pipeline_shards=4, mesh_devices=[card, card])
    assert pstats.pipelined and pstats.mesh_chips == 2 and piped == want
    assert kernels.gc_rows.launches > counts[0]
    assert kernels.merge_runs_perm.launches > counts[1]
    fired = []

    def wedge(s, _device):
        if s == 2 and not fired:
            fired.append(s)
            raise RuntimeError("injected wedge")

    monkeypatch.setattr(mc, "_FAULT_HOOK", wedge)
    wedged, wstats = _job("cuda", env, dbdir, icmp, topts, metas, 400,
                          pipeline=False, num_shards=4,
                          mesh_devices=[card, card])
    assert fired and wstats.mesh_fallbacks == 1 and wedged == want


def _nccl_vs_gloo_rank(rank, world, job, snaps, out_path):
    import pickle

    from toplingdb_tpu_torch.parallel import distributed_gc as dg

    got = dg.run_distributed_gc(dg.make_mesh(1, 1), [job], snaps, True)
    ref = dg.run_distributed_gc(
        dg.make_mesh(1, 1, device="cpu", backend="gloo"), [job], snaps,
        True)
    with open(out_path, "wb") as f:
        pickle.dump((got, ref), f)


def test_distributed_gc_on_nccl_equals_gloo(dev, tmp_path):
    import pickle

    from toplingdb_tpu_torch.parallel import distributed_gc as dg
    from toplingdb_tpu_torch.parallel import mesh_plan

    job = mesh_plan.make_weak_scaling_job(5000)
    rng = np.random.default_rng(4)
    job["tomb_cover"] = np.where(rng.random(5000) < 0.1,
                                 rng.integers(1, 5001, 5000),
                                 0).astype(np.uint64)
    out = str(tmp_path / "out.pkl")
    dg.spawn_ranks(_nccl_vs_gloo_rank, 1, str(tmp_path),
                   args=(job, [1000, 2500, 4000], out), backend="nccl",
                   timeout=300)
    with open(out, "rb") as f:
        got, ref = pickle.load(f)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert got[0].any()


def test_driver_pair_runs_on_the_card(dev, tmp_path, capfd):
    """entry()'s default forward step runs on the card (gc_rows launched)
    and equals the same step on "cpu" bitwise; dryrun_multichip(1) runs
    one NCCL rank by default."""
    from toplingdb_tpu_torch.parallel import entry

    kernels.gc_rows.launches = 0
    fn, args = entry.entry()
    got = fn(*args)
    assert kernels.gc_rows.launches == 1
    cfn, cargs = entry.entry("cpu")
    for a, b in zip(got, cfn(*cargs)):
        np.testing.assert_array_equal(a, b)
    entry.dryrun_multichip(1, store_dir=str(tmp_path))
    assert "mesh jobs=1 x range=1, 2 jobs validated" in capfd.readouterr().out


def test_write_prepared_guard_through_a_card_compaction(dev, tmp_path):
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.options import Options, ReadOptions
    from toplingdb_tpu_torch.utilities.transactions import TransactionDB

    factory = DeviceCompactionExecutorFactory(device="cuda")
    tdb = TransactionDB.open(str(tmp_path / "db"), Options(
        compaction_executor_factory=factory, write_buffer_size=64 << 10),
        write_policy="write_prepared")
    for i in range(5000):
        tdb.put(b"k%05d" % i, b"pre%05d" % i)
    tdb.db.flush()
    txn = tdb.begin_transaction()
    txn.set_name("t")
    for i in range(0, 5000, 50):
        txn.put(b"k%05d" % i, b"new%05d" % i)
    txn.prepare()
    snap = tdb.db.get_snapshot()
    txn.commit()
    assert len(tdb._parked_guards) == 1
    kernels.gc_rows.launches = 0
    tdb.db.compact_range()
    assert kernels.gc_rows.launches >= 1
    assert factory.jobs and tdb.db._compaction_scheduler.last_error is None
    for i in range(0, 5000, 50):
        k = b"k%05d" % i
        assert tdb.get(k, ReadOptions(snapshot=snap)) == b"pre%05d" % i
        assert tdb.get(k) == b"new%05d" % i
    snap.release()
    tdb.close()


def test_compaction_service_job_on_the_card(dev, tmp_path):
    import time as _time

    from toplingdb_tpu_torch.compaction import compaction_service as cs
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db import db as dbm
    from toplingdb_tpu_torch.options import Options

    def fill(path, factory):
        db = dbm.DB.open(path, Options(write_buffer_size=1 << 16,
                                       disable_auto_compactions=True,
                                       compaction_executor_factory=factory))
        for i in range(20000):
            db.put(b"s%06d" % ((i * 7919) % 12000), b"v%06d" % i)
        db.flush()
        return db

    svc = cs.InProcessCompactionService()
    outs = {}
    real = _time.time
    try:
        _time.time = lambda: 1_700_000_000.0  # tables carry creation_time
        for tag, factory in (
                ("service", cs.CompactionServiceExecutorFactory(
                    svc, device="cuda")),
                ("device", DeviceCompactionExecutorFactory(device="cuda"))):
            path = str(tmp_path / tag)
            db = fill(path, factory)
            kernels.gc_rows.launches = 0
            kernels.merge_runs_perm.launches = 0
            db.compact_range()
            assert kernels.gc_rows.launches >= 1, tag
            assert kernels.merge_runs_perm.launches >= 1, tag
            files = sorted(f for f in os.listdir(path) if f.endswith(".sst"))
            outs[tag] = [open(os.path.join(path, f), "rb").read()
                         for f in files]
            db.close()
    finally:
        _time.time = real
    assert svc.jobs >= 1
    assert outs["service"] == outs["device"]
