#!/usr/bin/env python3
"""Chip smoke run of toplingdb_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build: the native host library and the point read's fastget
     extension (g++) and the three CUDA kernels (one nvcc per source, all
     started together), from the sources in the checkout;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main paths' shapes (bitwise; gc_rows and the merge at the
     pipelined route's p = 2^19, the serial packed route's p = 2^20 and the
     block-assembly route's p = 2^22), with its median time over 25
     launches with the L2 flushed (after one untimed launch of the same
     form), the plain version's time, the least time
     the card could take (bound) and, for the merge, the LSD torch.sort
     passes of the CPU "sort" mode as the library yardstick; then one
     serial-route shard through the whole shard program, timed, with its
     top ops by device time;
  4. the main path, the pipelined plane: bench.py's compaction job (4
     presorted runs, 8-digit keys, 20-byte values, ~2x overwrites,
     N = 10,000,000 entries, written by the port's columnar writer)
     compacted L0 -> L2 bottommost through run_device_compaction(
     device_name="cuda") with its defaults, once without snapshots and once
     with 3 snapshots; the job must run pipelined and launch both kernels,
     every output is read back and held against a numpy oracle of the
     surviving versions, and the serial route (pipeline=False) on the same
     inputs must write the same bytes. Each shard program's CUDA-event time
     is summed over the job's wall as the device's busy share;
  5. the block-assembly route: the same generator at N = 4,000,000 (one
     shard of at most 2^22 rows, the route's envelope) through
     run_device_compaction(device_name="cuda", device_blocks=True,
     num_shards=1), without and with 3 snapshots; each output matches the
     oracle and the serial packed-download route's bytes for the same
     inputs, and all three kernels launch;
  6. variable-length keys: 4,000,000 entries in 4 presorted runs with YCSB
     keys ("user" + the decimal FNV-64 hash of the key number, 5-23 bytes)
     and 100-byte values (one YCSB field, not the 10-field 1 KB record),
     ~10% deletions, without and with 3 snapshots, through the whole-job
     device program: oracle, gc_rows launched, the program's CUDA-event
     time; then 1,000,000 entries of the same generator on "cuda" and on
     "cpu" - identical SST bytes;
  7. range tombstones: a 1,000,000-entry job with 20 range tombstones in
     its inputs, ~10% deletions and 3 snapshots through the block-assembly,
     serial packed and pipelined routes on "cuda" and on "cpu" - six
     byte-identical outputs that match the oracle extended to tombstones,
     with gc_rows launched on tombstone words;
  8. device versus plain: a 1,000,000-entry job with 3 snapshots, ~10%
     deletions and 4 serial shards on "cuda" and on "cpu" - identical SST
     bytes;
  9. complex groups: a 2,000,000-entry job of db_bench's mergerandom kind
     (60% Put, 20% Merge with the uint64add operator, 10% Delete, 10%
     SingleDelete) with 8 range tombstones, without and with 3 snapshots:
     the pipeline's attempt gives up on the complex groups, the serial
     route runs 2 shards at p = 2^20 and folds the groups on the host;
     "cuda" and "cpu" write identical bytes, the entries equal the port's
     CompactionIterator over the host-sorted inputs, and the per-entry
     route is never entered;
 10. the per-entry route: a 1,000,000-entry job with 5% empty values and
     10% BLOB_INDEX rows (1 KiB values in two blob files) and 3 snapshots,
     first on the columnar route (blob_refs equal to the CPU route's),
     then with RemoveEmptyValueCompactionFilter and blob GC (age cutoff
     0.5, min_blob_size 512) on the per-entry route, one gc_rows launch at
     p = 2^20: "cuda" and "cpu" write identical SST and blob bytes, every
     blob index resolves to its value, no filtered empty value survives;
 11. compressed tables and the dcompact worker: the codecs the card's host
     loads are printed, and the headline codec is the first of snappy,
     zstd and zlib that is there (named in every line). (a) bench.py's
     headline job (bench.py:1692-1716): phase 4's generator at N =
     10,000,000 written in the headline codec with 4 KiB blocks, a job dir
     written with the port's CompactionParams (device "cuda", no
     snapshots, a sampled trace context) run through the worker's run_job
     in-process: status ok, pipelined, gc_rows and the merge launched
     (counts set to 0 just before, read just after), every output matches
     the oracle, the serial route writes the same bytes; wall, raw MB/s,
     phases, the worker's spans, file bytes and the compression ratio
     beside phase 4's uncompressed job. (b) the worker's CLI (python -m
     toplingdb_tpu_torch.compaction.worker --job-dir DIR) on a
     1,000,000-entry job: exit code 0, the bytes of an in-process run_job
     of a copy of the job dir, the heartbeat file written. (c) every codec
     the host has (snappy, lz4, lz4hc, zstd, zstd with a 16 KiB
     dictionary, zlib at 1,000,000 entries; bz2 and lzma at 200,000) on
     "cuda" and on "cpu": identical SST bytes; then bench.py's
     compaction_zstd_out shape (bench.py:1778-1785), uncompressed in and
     zstd out, the same.
 12. table formats: (a) bench.py's compaction_zip_out job
     (bench.py:1786-1799): phase 4's generator at N = 10,000,000,
     uncompressed inputs, TableOptions(format="zip", compression=ZSTD)
     outputs, bottommost, no snapshots, through run_device_compaction(
     device_name="cuda"): it must run pipelined, launch gc_rows 32 times
     and the merge 96 times (counts set to 0 just before, read just
     after), every output read back through ZipTableReader.scan_columnar
     matches the oracle, and the serial route writes the same bytes; wall,
     raw MB/s, encode_write_s / pipeline_stall_s, the device busy share,
     file bytes and the ratio beside phase 4's job. (b) the zip job at
     1,000,000 entries on "cuda", "cpu" and with zip_plane=False
     (identical bytes), then with 3 snapshots and 20 range tombstones, the
     same. (c) protection_bytes_per_key=8 at 1,000,000 entries on the
     pipelined, serial and block-assembly routes: each route's bytes equal
     the unprotected job's, and its kernels launch. (d) at 200,000 entries
     each, "cuda" against "cpu" (identical bytes, the oracle, one gc_rows
     launch on the per-entry route): a two-level index with partitioned
     filters, a fixed-prefix extractor on the block format (the columnar
     route), a CompactOnDeletionCollector, single_fast, plain with a
     prefix extractor, cuckoo, and zip inputs. (e) a job dir with
     table_format "zip", prefix_extractor "tpulsm.FixedPrefix.4" and a
     collector, written with the port's CompactionParams, through run_job
     on "cuda" at 200,000 entries: status ok, the oracle, and the bytes of
     an in-process "cpu" run with the job's table options.
 13. the DB on the card: bench.py's DB deployment (bench.py:1366-1420,
     BENCH_DB_N = 1,000,000) through the port's DB, opened with
     Options(write_buffer_size=8 MiB, compaction_executor_factory=
     DeviceCompactionExecutorFactory(device="cuda"), statistics=
     Statistics()) and DB.open's defaults (the native group-commit write
     plane, the native point-read chain, the chunked scan plane) and auto
     compactions on (L0 trigger 4): fillrandom from 4 writer threads in
     WriteBatches of 100 (16-digit keys (t*per + j) * 2654435761 % 2N,
     20-byte values), then flush(), wait_for_compactions() and
     compact_range(). Every fill group must have committed natively
     (WRITE_GROUP_NATIVE_COMMITS = WRITE_GROUP_LED, no fallback). Every
     compaction must have run on the device executor (no job on the host
     path, no scheduler error); gc_rows must have launched at least once
     per device job and the merge whenever a job had more than one input
     file (counts set to 0 just before the open, read just after
     compact_range). Every live SST is then read back with the port's
     table reader: one level holds them, and their rows are the written
     keys in order, each a PUT whose 20 value bytes are compared row by
     row. Then 100,000 readrandom probes (bench.py's Random(5) draw),
     every one decided by the native chain (a wrapper on the instance's
     _native_get counts them; fastget or the ctypes call, as printed), and
     a full forward scan through the chunk plane (ITER_CHUNK_REFILLS > 0,
     no ITER_CHUNK_FALLBACKS), both against the written keys; close() and
     a second handle, reopened (recovery from the MANIFEST) with
     iter_chunk_rows=0 and _nget_lib=None, repeats the first
     DB_OFF_PROBES = 20,000 probes (cut from 100,000: 10.8-28.7 s
     through the Python chain) there and the scan through the per-entry
     DBIter; four fills
     of N/5 keys into fresh DBs without Statistics or compactions time the
     write plane alone, in turns on / off / off / on; last a second
     DB takes 50,000 keys, is dropped without a flush or a close (a
     crash), and its reopen must replay them from the WAL. Printed: fill
     wall and ops/s, native commits, flushes, each device job's rows,
     route and wall, compact_range wall and raw MB/s, readrandom ops/s
     and scan walls with the planes on and off, and the reopen wall.
 14. distributed compaction from the port's DB, the card in the worker.
     (a) the HTTP transport at full width: DcompactWorkerService(
     device="cuda") started in this process (port 0), and phase 13's DB
     deployment (DB_N keys, 8 MiB write buffer, 4 writer threads, batches
     of 100) opened with HttpCompactionExecutorFactory([url],
     device="cuda"), a Statistics and a recording listener; fill, flush,
     wait_for_compactions, compact_range. Every compaction that was not a
     trivial move came back remote on "cuda"; gc_rows launched at least
     once per job and the merge on every multi-input job (counts set to 0
     before the open, read after compact_range); DCOMPACTION_ATTEMPTS
     equals the jobs, RETRIES, JOB_FAILURES and FALLBACK_LOCAL are 0; one
     on_compaction_completed per job; no scheduler error; the live SSTs
     read back row by row against the oracle; 10,000 readrandom probes.
     Printed: fill and compact_range walls, each job's rows,
     work_time_usec and rpc_time_usec, the DCOMPACTION_* histograms'
     counts and medians, beside phase 13's in-process compact_range.
     (b) the service CLI in its own process (python -m
     toplingdb_tpu_torch.compaction.dcompact_service --port 0 --device
     cuda): a DB of SMALL_DB_N keys with distinct values (one writer, 1
     MiB write buffer, auto compactions off) whose one L0->L1 job meets
     DcompactFaultInjector(schedule={0: "drop", 1: "truncate",
     2: "corrupt", 3: "delay"}): RETRIES == 3, JOB_FAILURES == 0, the
     service's /stats jobs_done equals the attempts that reached it (all
     but the dropped one), the live entries equal the oracle; then the
     process is stopped and must be gone. (c) the subprocess transport:
     SubprocessCompactionExecutorFactory(device="cuda") on the same DB
     shape with schedule={0: "kill"}: the first worker process exits 137
     mid-job and its attempt dir is swept, the retry succeeds on the card,
     no job-* dir is left under <db>/dcompact; then a stale attempt dir
     (params, a partial SST, a heartbeat older than lease_sec) is placed
     there, and the reopen sweeps it (DCOMPACTION_ORPHANS_SWEPT == 1).
 15. column families on the card: db_bench's --num_column_families=4
     deployment (CFs "default" and column_family_name_000001-3) at phase
     13's size (DB_N = 1,000,000 keys, 36 bytes a key) through the port's
     DB, opened as in phase 13 (8 MiB write buffer, the "cuda" device
     factory, a Statistics, the default planes, auto compactions on):
     fillrandom from 4 threads in WriteBatches of 100 with phase 13's key
     formula, key index i in CF i % 4 (db_bench's GetCfh), so every batch
     spans the four CFs and every group is a Python commit
     (WRITE_GROUP_FALLBACKS = WRITE_GROUP_LED, as in the reference); then
     flush(), wait_for_compactions() and compact_range(). Device jobs ran
     in all four CFs, none on the host path, no scheduler error; gc_rows
     launched at least once per job and the merge on multi-input jobs
     (counts set to 0 before the open, read after compact_range); every
     live SST of each CF read back row by row against that CF's keys, its
     properties naming the CF's id and name. 100,000 readrandom probes
     (bench.py's Random(5) draw), each in its key's CF, all decided by the
     native chain; a full scan per CF through the chunk plane (refills,
     no fallback). persist_stats(to_db=True) twice: two samples in the
     hidden stats CF. column_family_name_000002 exported and imported
     into a second DB with create_column_family_with_import: 10,000
     probes against the oracle, then 10,000 of its keys rewritten,
     flushed and compacted into the imported files on the card (the SSTs
     against the oracle again). column_family_name_000003 dropped: its
     SSTs leave the disk; close and reopen: default, _000001, _000002 and
     the stats CF listed, the two persisted samples read back, 10,000
     probes per CF. Printed: the fill wall and ops/s, native / Python
     commits, flushes, each device job's CF, rows, route and wall,
     compact_range's wall and raw MB/s, readrandom ops/s, the scan wall
     per CF, the export, import and reopen walls, and the card's busy
     share from open to compact_range's end.
 16. the compaction styles at phase 13's deployment (DB_N keys from 4
     threads in batches of 100, 8 MiB write buffer, the "cuda" device
     factory, a Statistics). (a) universal: db_bench --compaction_style=1
     with RocksDB's universal_compaction.h defaults (size_ratio 1,
     min_merge_width 2, max_merge_width unbounded,
     max_size_amplification_percent 200) and
     level0_file_num_compaction_trigger 4; fill, flush,
     wait_for_compactions, then compact_range (the manual universal job
     into the last level). Every job ran on "cuda" with one output and a
     universal reason (size-ratio / size-amp / merge-all / manual); on each
     job that no other overlapped gc_rows launched, and the merge where
     several runs were merged; L0 is empty after compact_range and the
     last level is one SST, read back row by row against the oracle; then
     100,000 readrandom probes and one full scan. (b) FIFO: db_bench
     --compaction_style=2 with fifo_max_table_files_size a quarter of the
     bytes (a)'s fill flushed: the files left fit the budget, they are the
     newest flushes and the older ones are gone from disk, the surviving
     files' keys read back and every other probe reads NotFound; zero
     device jobs and zero kernel launches, since FIFO runs no kernel;
 17. integrated blob files: db_bench.py's fillrandomblob with RocksDB's
     BlobDB flags (enable_blob_files, min_blob_size 256, 1 KiB values,
     blob_cache 32 MiB = db_bench.py's --blob-cache-size) and RocksDB's
     default 64 MiB write buffer (with bench.py's 8 MiB, ~190 flushes of
     1 KiB values would rewrite all of L1 on every L0 job): BLOB_N =
     250,000 keys (cut from 1,000,000: at 1M the phase alone took 319.8 s
     on the card, 175.9 s of it compact_range's six per-entry GC jobs;
     at 500,000, inside the whole script, about 258 s, 162.0 s of it
     compact_range) from 4 threads, then an overwrite of the first
     BLOB_N / 2 so the blob files hold garbage, with blob GC off (the
     fill's jobs take the columnar blob route); then the DB reopened with
     enable_blob_garbage_collection and
     blob_garbage_collection_age_cutoff 0.25 for flush,
     wait_for_compactions and compact_range (every job takes the per-entry
     route with GC). Every job ran on "cuda", gc_rows launched on each,
     every GC target blob file is gone from disk, the one level's SSTs
     hold one BLOB_INDEX row a key, BLOB_PROBES = 20,000 probes (cut from
     100,000: at 100,000, 21-37 s through the Python get chain, to keep
     the script well inside its limit with phase 18 added) and one full
     scan equal the oracle's values (BLOB_DB_CACHE_* counts printed).
     Printed for both phases: the fill wall and ops/s, the flushes and blob files,
     each device job's reason, input runs, rows, route, wall and
     launches, compact_range's wall and raw MB/s, readrandom ops/s, the
     scan wall, and the card's busy share (the shard programs and the
     per-entry route's device sorts and GC masks by CUDA events).
 18. the integrity plane on the card: phase 13's deployment (INTEGRITY_N
     = 1,000,000 keys from 4 threads in batches of 100, 8 MiB write
     buffer, leveled, the "cuda" device factory, a Statistics, the default
     planes) with the integrity settings users turn on:
     protection_bytes_per_key=8 (RocksDB's
     memtable_protection_bytes_per_key=8), crc32c file checksums and the
     background scrubber every second (integrity_scrub_period_sec=1).
     Fill: every group a native protected commit (WRITE_GROUP_NATIVE_
     COMMITS = WRITE_GROUP_LED, no fallback), every flush through the
     handoff check (one XOR fold of its export equal to the memtable's
     carried fold a flush, no per-entry walk). Compaction: flush,
     wait_for_compactions, compact_range; every job on "cuda", every
     output re-read and verified per entry, gc_rows launched on every job
     and the merge on multi-input jobs (counts set to 0 before the open);
     every live SST read back row by row against the oracle. Reads:
     100,000 readrandom probes (bench.py's Random(5) draw), all decided
     by the native chain; one full scan through the chunk plane with its
     protection bank (refills, no fallback, 0
     INTEGRITY_PROTECTION_MISMATCHES). Verification: verify_file_checksums
     and verify_checksum over the whole DB, timed; the background
     scrubber ran a pass. Corruption round trip: one byte of a live SST
     flipped on disk; scrub() quarantines exactly it
     (INTEGRITY_CORRUPTIONS_DETECTED 1, on_corruption_detected fired), a
     put raises, the bytes restored, a second scrub() reports it
     repaired, resume(), a put and its get. Last, a fill of the same keys
     without protection into a fresh DB. Printed, each beside the card's
     name and power limit: both fill walls and ops/s, the flushes, each
     job's rows, route and wall, compact_range's wall and raw MB/s,
     readrandom ops/s, the scan wall, both verify walls and bytes, the
     scrub pass wall and the card's busy share. Its gc_rows and merge
     launches are added to the kernels line's counts.

Each phase's wall (one summary line) and the script's total wall are
printed before the last three lines of
standard output: the card's name and power limit, one JSON object
{"kernels": [...]}, and the result line
{"ok": true, "device": {...}}. Without a CUDA device, or without the rest
of the repository beside it, the script exits non-zero and prints no
result. Scratch SSTs go to `_smoke/` in the checkout and are removed.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RAW_PER_ENTRY = 28      # 8B user key + 20B value, as bench.py counts
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM 32-bit rate outside the tensor cores
MAIN_N = 10_000_000
BLOCKS_N = 4_000_000
VARLEN_N = 4_000_000
VARLEN_PLAIN_N = 1_000_000
TOMB_N = 1_000_000
PLAIN_N = 1_000_000
COMPLEX_N = 2_000_000
ENTRIES_N = 1_000_000
CODEC_N = 1_000_000     # phase 11 (b) and (c)
SLOW_CODEC_N = 200_000  # phase 11 (c): bz2 and lzma
FORMAT_N = 1_000_000    # phase 12 (b) and (c)
ENTRY_N = 200_000       # phase 12 (d) and (e): the per-entry route
DB_N = 1_000_000        # phase 13: bench.py's BENCH_DB_N
DB_WAL_N = 50_000       # phase 13: the WAL-replay run
DB_RAW_PER_ENTRY = 36   # phase 13: 16B key + 20B value
SMALL_DB_N = 200_000    # phase 14 (b) and (c)
BLOB_N = 250_000        # phase 17, cut from DB_N (see its docstring)
BLOB_PROBES = 20_000    # phase 17's probes, cut from 100,000 (docstring)
DB_OFF_PROBES = 20_000  # phase 13's planes-off probes, cut from 100,000
INTEGRITY_N = 1_000_000  # phase 18: phase 13's deployment


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Inputs: bench.py's generator, written with the port's columnar writer
# ---------------------------------------------------------------------------


def write_runs(env, dbdir, icmp, topts, n_entries, alloc, seed=1234,
               p_del=0.0, num_runs=4, n_tombs=0, mix=None):
    """bench.py's build_inputs (bench.py:78): 8 ASCII decimal digit keys,
    20-byte values, ~2x overwrite factor (key space N/2), one sorted run per
    file (a zip table where `topts.format` is "zip", else block-based). With p_del > 0 that share of rows are DELETIONs (empty values).
    With `mix` ({value type: share}) the rows' types are drawn from it
    instead: MERGE rows carry an 8-byte little-endian operand (seqno % 97),
    DELETION and SINGLE_DELETION rows an empty value. With n_tombs > 0 each
    run's file also holds n_tombs / num_runs range tombstones, each over
    ~1% of the key space at most, whose seqnos are drawn from the run's
    seqno span (the points take the rest). Returns (metas, rows, tombs):
    rows = [(draws, seqs, vtypes)] per run, tombs = [(seq, begin, end)]
    with integer key bounds, end exclusive."""
    from toplingdb_tpu_torch.db.dbformat import ValueType
    from toplingdb_tpu_torch.db.range_del import RangeTombstone
    from toplingdb_tpu_torch.db.version_edit import FileMetaData
    from toplingdb_tpu_torch.ops.columnar_io import (
        ColumnarKV,
        write_tables_columnar,
    )
    from toplingdb_tpu_torch.table.zip_table import write_tables_zip_columnar

    writer = (write_tables_zip_columnar if topts.format == "zip"
              else write_tables_columnar)
    rng = np.random.default_rng(seed)
    key_space = max(n_entries // 2, 1)
    per_run = n_entries // num_runs
    t_per_run = n_tombs // num_runs
    metas, rows, tombs = [], [], []
    for run in range(num_runs):
        n = per_run
        draws = rng.integers(0, key_space, n, dtype=np.int64)
        base = run * (per_run + t_per_run)
        seqs = np.arange(base + 1, base + n + t_per_run + 1, dtype=np.uint64)
        run_tombs = []
        if t_per_run:
            tpos = rng.choice(len(seqs), t_per_run, replace=False)
            for ts in seqs[tpos]:
                lo = int(rng.integers(0, key_space))
                hi = lo + int(rng.integers(1, max(2, key_space // 100)))
                run_tombs.append((int(ts), lo, hi))
            seqs = np.delete(seqs, tpos)
        vt = np.full(n, int(ValueType.VALUE), dtype=np.int32)
        if p_del:
            vt[rng.random(n) < p_del] = int(ValueType.DELETION)
        if mix:
            vt = rng.choice(list(mix), n, p=list(mix.values())).astype(
                np.int32)
        ik = np.empty((n, 16), dtype=np.uint8)
        for j in range(8):
            ik[:, 7 - j] = (draws // 10 ** j) % 10 + ord("0")
        packed = (seqs << np.uint64(8)) | vt.astype(np.uint64)
        ik[:, 8:] = packed[:, None] >> (np.arange(8) * 8).astype(
            np.uint64)[None, :] & np.uint64(0xFF)
        vals = np.full((n, 20), ord("v"), dtype=np.uint8)
        vals[:, 19] = (seqs % 10 + ord("0")).astype(np.uint8)
        # MERGE operands: seqno % 97 as a u64 in the row's first 8 bytes.
        vals[:, :8] = np.where(
            (vt == int(ValueType.MERGE))[:, None],
            (seqs % np.uint64(97)).astype(np.uint64)[:, None]
            >> (np.arange(8) * 8).astype(np.uint64)[None, :]
            & np.uint64(0xFF), vals[:, :8])
        s = np.lexsort((np.iinfo(np.int64).max - seqs.view(np.int64), draws))
        val_lens = np.select(
            [vt[s] == int(ValueType.VALUE), vt[s] == int(ValueType.MERGE)],
            [20, 8], 0).astype(np.int32)
        val_offs = (np.cumsum(val_lens) - val_lens).astype(np.int32)
        kv = ColumnarKV(
            np.ascontiguousarray(ik[s]).reshape(-1),
            np.arange(n, dtype=np.int32) * 16,
            np.full(n, 16, dtype=np.int32),
            vals[s][np.arange(20)[None, :] < val_lens[:, None]],
            val_offs, val_lens,
        )
        files = writer(
            env, dbdir, alloc, icmp, topts, kv,
            np.arange(n, dtype=np.int32), np.full(n, -1, dtype=np.int64),
            vt[s], seqs[s], creation_time=1,
            tombstones=[RangeTombstone(ts, b"%08d" % lo, b"%08d" % hi)
                        for ts, lo, hi in run_tombs],
        )
        for fnum, path, props, smallest, largest, _sel in files:
            metas.append(FileMetaData(
                number=fnum, file_size=env.get_file_size(path),
                smallest=smallest, largest=largest,
                smallest_seqno=props.smallest_seqno,
                largest_seqno=props.largest_seqno,
            ))
        rows.append((draws, seqs, vt))
        tombs += run_tombs
    return metas, rows, tombs


def expected_survivors(rows, snapshots, bottommost=True, tombs=()):
    """Numpy oracle: per (user key, snapshot stripe) the newest version
    survives, unless a range tombstone (seq, begin, end) newer than it in
    the same snapshot stripe covers its key — then no version of that
    stripe survives; at the bottommost level a stripe-0 DELETION is dropped
    and a stripe-0 VALUE has its seqno zeroed. Returns (key, out_seq,
    vtype, orig_seq) in output order (key asc, seqno desc)."""
    key = np.concatenate([r[0] for r in rows])
    seq = np.concatenate([r[1] for r in rows])
    vt = np.concatenate([r[2] for r in rows])
    o = np.lexsort((np.iinfo(np.int64).max - seq.view(np.int64), key))
    key, seq, vt = key[o], seq[o], vt[o]
    snaps = np.asarray(sorted(snapshots), dtype=np.uint64)
    stripe = np.searchsorted(snaps, seq, side="left")
    first = np.ones(len(key), dtype=bool)
    first[1:] = (key[1:] != key[:-1]) | (stripe[1:] != stripe[:-1])
    covered = np.zeros(len(key), dtype=bool)
    for ts, lo, hi in tombs:
        t_stripe = np.searchsorted(snaps, np.uint64(ts), side="left")
        covered |= ((key >= lo) & (key < hi) & (seq < np.uint64(ts))
                    & (stripe == t_stripe))
    keep = first & ~covered
    if bottommost:
        keep = keep & ~((stripe == 0) & (vt == 0))
    out_seq = np.where(bottommost & (stripe == 0) & (vt == 1), 0, seq)
    return key[keep], out_seq[keep], vt[keep], seq[keep]


def scan_output(env, path, icmp):
    """One output SST of any format read back with the port's readers, as
    a ColumnarKV: block-based tables through the native columnar scan, zip
    tables through ZipTableReader.scan_columnar (the native key and
    value-group decoders), the other formats by iteration."""
    from toplingdb_tpu_torch.ops.columnar_io import (
        ColumnarKV,
        scan_table_columnar,
    )
    from toplingdb_tpu_torch.table.factory import open_table
    from toplingdb_tpu_torch.table.reader import TableReader
    from toplingdb_tpu_torch.table.zip_table import ZipTableReader

    r = open_table(env.new_random_access_file(path), icmp)
    try:
        if isinstance(r, TableReader):
            return scan_table_columnar(r)
        if isinstance(r, ZipTableReader):
            kb, ko, kl, vb, vo, vl = r.scan_columnar(0, r.n)
            return ColumnarKV(kb, ko.astype(np.int32), kl.astype(np.int32),
                              vb, vo.astype(np.int32), vl.astype(np.int32))
        it = r.new_iterator()
        it.seek_to_first()
        ents = list(it.entries())
    finally:
        r.close()
    kl = np.array([len(k) for k, _ in ents], dtype=np.int32)
    vl = np.array([len(v) for _, v in ents], dtype=np.int32)
    return ColumnarKV(
        np.frombuffer(b"".join(k for k, _ in ents) or b"\0", np.uint8),
        (np.cumsum(kl) - kl).astype(np.int32), kl,
        np.frombuffer(b"".join(v for _, v in ents) or b"\0", np.uint8),
        (np.cumsum(vl) - vl).astype(np.int32), vl)


def read_outputs(env, dbdir, icmp, outputs):
    """Every output SST read back with the port's readers: (key, seq,
    vtype, value last byte or -1) in file order."""
    from toplingdb_tpu_torch.db import filename

    keys, seqs, vts, vlast = [], [], [], []
    for m in outputs:
        kv = scan_output(env, filename.table_file_name(dbdir, m.number),
                         icmp)
        assert np.all(kv.key_lens == 16), "unexpected key length"
        kb = kv.key_buf.reshape(kv.n, 16)
        digits = kb[:, :8].astype(np.int64) - ord("0")
        keys.append((digits * (10 ** np.arange(7, -1, -1))).sum(axis=1))
        packed = np.ascontiguousarray(kb[:, 8:]).view("<u8").reshape(-1)
        seqs.append(packed >> np.uint64(8))
        vts.append((packed & np.uint64(0xFF)).astype(np.int32))
        has_v = kv.val_lens > 0
        last = np.full(kv.n, -1, dtype=np.int64)
        last[has_v] = kv.val_buf[kv.val_offs[has_v] + kv.val_lens[has_v] - 1]
        vlast.append(last)
        assert m.num_entries == kv.n
    cat = np.concatenate
    return cat(keys), cat(seqs), cat(vts), cat(vlast)


def check_against_oracle(env, dbdir, icmp, outputs, rows, snapshots,
                         tombs=()):
    key, seq, vt, vlast = read_outputs(env, dbdir, icmp, outputs)
    wkey, wseq, wvt, worig = expected_survivors(rows, snapshots, tombs=tombs)
    assert len(key) == len(wkey), f"{len(key)} entries, oracle {len(wkey)}"
    assert np.array_equal(key, wkey), "user keys differ from the oracle"
    assert np.array_equal(seq, wseq), "seqnos differ from the oracle"
    assert np.array_equal(vt, wvt), "value types differ from the oracle"
    want_last = np.where(wvt == 1, (worig % 10).astype(np.int64) + ord("0"),
                         -1)
    assert np.array_equal(vlast, want_last), "values differ from the oracle"
    return len(key)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------


def time_ms(torch, fn, flush, iters=25):
    """Median device time of fn() in ms over `iters` launches (CUDA
    events), with the 50 MB L2 cache flushed before each launch. Three
    plain calls and one untimed launch in the timed form (flush, events,
    sync) come first."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(iters + 1):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i:  # the first is the warm-up
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> float:
    return max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def gc_rows_inputs(torch, rng, n, n_snaps, tombs, device):
    from toplingdb_tpu_torch.ops import compaction_kernels as ck

    seq = np.sort(rng.integers(1, 1 << 34, n).astype(np.uint64))[::-1]
    hi = (seq >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (seq & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    snap_hi, snap_lo = ck._split_snapshots(
        sorted(int(x) for x in rng.integers(1, 1 << 34, n_snaps)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    args = [t(hi), t(lo), t(rng.random(n) < 0.4), None, None,
            t(rng.choice([0, 1, 2, 7], n).astype(np.int32)),
            t(snap_hi.view(np.int32)), t(snap_lo.view(np.int32))]
    if tombs:
        tomb = np.where(rng.random(n) < 0.3,
                        rng.integers(1, 1 << 34, n).astype(np.uint64),
                        np.uint64(0))
        args[3] = t((tomb >> np.uint64(32)).astype(np.uint32).view(np.int32))
        args[4] = t((tomb & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                    .view(np.int32))
    return args


def merge_inputs(torch, rng, p, per_run, device):
    """The main path's merge shape: 4 presorted runs of bench-style keys
    (sharing keys across runs) plus the pad run, R = 8, 5 int32 columns
    (2 key words, key_len, inv_hi, inv_lo)."""
    cols = np.full((5, p), 2**31 - 1, dtype=np.int64)
    starts = [0]
    for run in range(4):
        draws = rng.integers(0, 4 * per_run, per_run)
        seqs = np.arange(run * per_run + 1, (run + 1) * per_run + 1,
                         dtype=np.int64)
        o = np.lexsort((-seqs, draws))
        d = draws[o]
        digits = np.stack([(d // 10 ** (7 - j)) % 10 + ord("0")
                           for j in range(8)], axis=1).astype(np.int64)
        w0 = (digits[:, 0] << 24 | digits[:, 1] << 16 | digits[:, 2] << 8
              | digits[:, 3])
        w1 = (digits[:, 4] << 24 | digits[:, 5] << 16 | digits[:, 6] << 8
              | digits[:, 7])
        packed = (seqs[o] << 8) | 1
        s0 = starts[-1]
        sl = slice(s0, s0 + per_run)
        cols[0, sl] = w0 - 2**31
        cols[1, sl] = w1 - 2**31
        cols[2, sl] = 8
        cols[3, sl] = 2**31 - 1 - (packed >> 32)
        cols[4, sl] = 2**31 - 1 - (packed & 0xFFFFFFFF)
        starts.append(s0 + per_run)
    run_starts = np.array(starts + [p] * 4, dtype=np.int32)
    cols_t = torch.from_numpy(cols.astype(np.int32)).to(device)
    return cols_t, torch.from_numpy(run_starts).to(device)


def gc_rows_case(torch, rng, p, flush):
    """gc_rows at p rows: bitwise against its plain version with S = 64 and
    1024 and tombstone words and in the main path's own form (S = 64, no
    tombstone words), which is then timed. Returns the numbers of the
    kernels JSON line."""
    from toplingdb_tpu_torch.ops import kernels

    for n_snaps, tombs in ((40, True), (1000, True), (3, False)):
        args = gc_rows_inputs(torch, rng, p, n_snaps, tombs, flush.device)
        got = kernels.gc_rows(*args)
        want = kernels.gc_rows_plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        log(f"kernel gc_rows p={p} S={args[6].shape[0]} tombs={tombs}: "
            f"max_abs_err={err}")
        assert err == 0, "gc_rows disagrees with its plain version"
    ms = time_ms(torch, lambda: kernels.gc_rows(*args), flush)
    plain_ms = time_ms(torch, lambda: kernels.gc_rows_plain(*args), flush)
    s = args[6].shape[0]
    n_bytes = p * (4 + 4 + 1 + 4) + 2 * 4 * s + p * (4 + 1 + 1 + 1)
    n_ops = p * (2 * 4 * max(1, s.bit_length() - 1) + 8)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"kernel gc_rows p={p}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def merge_case(torch, rng, p, per_run, flush):
    """The merge over 4 presorted runs of per_run rows plus the pad run
    (R = 8, 5 columns) at p rows: bitwise against its plain version and
    the LSD torch.sort order, then timed beside its bound and the LSD
    passes. Returns the numbers of the kernels JSON line."""
    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops import kernels

    cols, run_starts = merge_inputs(torch, rng, p, per_run, flush.device)
    got = kernels.merge_runs_perm(cols, run_starts, 3)
    want = kernels.merge_runs_perm_plain(cols, run_starts, 3)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [got], [want])
    log(f"kernel merge_runs p={p} R=8 cols=5: max_abs_err={err}")
    assert err == 0, "merge_runs disagrees with its plain version"
    col_list = [cols[c] for c in range(cols.shape[0])]
    lib_perm = ck._sort_perm(col_list)
    assert torch.equal(lib_perm.to(torch.int32), got), \
        "LSD sort order differs from the merge"
    del lib_perm, got, want
    ms = time_ms(torch, lambda: kernels.merge_runs_perm(cols, run_starts, 3),
                 flush)
    plain_ms = time_ms(
        torch, lambda: kernels.merge_runs_perm_plain(cols, run_starts, 3),
        flush)
    library_ms = time_ms(torch, lambda: ck._sort_perm(col_list), flush)
    n_bytes = cols.numel() * 4 + p * 4 + run_starts.numel() * 4
    n_ops = p * 3 * 2 * cols.shape[0]
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"kernel merge_runs p={p}: {ms:.4f} ms (plain {plain_ms:.4f} ms, LSD "
        f"torch.sort {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# The routes' shapes: the pipelined route's shard (p = 2^19, 4 runs of
# 78,125 rows: a 10M-entry job in 32 shards), the serial packed route's
# (p = 2^20, 4 runs of 156,250) and the block-assembly route's (p = 2^22, 4
# runs of 10^6). The JSON line reports the main path's, the first.
SHAPES = ((1 << 19, 78_125), (1 << 20, 156_250), (1 << 22, 1_000_000))


def kernel_phase(torch, device):
    rng = np.random.default_rng(7)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    results = {}
    for p, per_run in SHAPES:
        gc = gc_rows_case(torch, rng, p, flush)
        mr = merge_case(torch, rng, p, per_run, flush)
        if p == SHAPES[0][0]:  # the JSON line's shape: the main path's
            results["gc_rows"] = dict(
                name="gc_rows", route="cuda",
                source="toplingdb_tpu_torch/csrc/gc_rows.cu",
                replaces="toplingdb_tpu/ops/pallas_kernels.py:60", **gc)
            results["merge_runs"] = dict(
                name="merge_runs", route="cuda",
                source="toplingdb_tpu_torch/csrc/merge_runs.cu",
                replaces="toplingdb_tpu/ops/pallas_kernels.py:202", **mr)
    from toplingdb_tpu_torch.ops import kernels

    # shared_prefix_lengths at the block-assembly route's p = 2^22: K = 16
    # without lens (the route's width, timed), K = 128 with lens.
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    pp = 1 << 22
    for k, with_lens in ((128, True), (16, False)):
        keys, lens = prefix_inputs(torch, gen, pp, k, with_lens, device)
        got = kernels.shared_prefix_lengths(keys, lens)
        want = kernels.shared_prefix_lengths_plain(keys, lens)
        torch.cuda.synchronize()
        err = max_abs_err(torch, [got], [want])
        dups = int((want == kernels.KEY_LANES).sum()) if lens is None else 0
        log(f"kernel shared_prefix p={pp} K={k} lens={with_lens}: "
            f"max_abs_err={err} (rows equal to their predecessor: {dups})")
        assert err == 0, "shared_prefix disagrees with its plain version"
        if with_lens:
            del keys, lens, got, want
    ms = time_ms(torch, lambda: kernels.shared_prefix_lengths(keys), flush)
    plain_ms = time_ms(
        torch, lambda: kernels.shared_prefix_lengths_plain(keys), flush)
    n_bytes = pp * (16 + 4)
    n_ops = pp * 4 * 2  # two 8-byte compares and a select per row
    bound_ms, bound_by = bound(n_bytes, n_ops)
    results["shared_prefix"] = dict(
        name="shared_prefix", route="cuda",
        source="toplingdb_tpu_torch/csrc/shared_prefix.cu",
        replaces="toplingdb_tpu/ops/pallas_kernels.py:28",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    log(f"kernel shared_prefix: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by})")
    del flush, keys, got, want
    return results


def prefix_inputs(torch, gen, p, k, with_lens, device):
    """[p, k] uint8 sorted rows with long shared prefixes: a constant head
    of k - 8 bytes, then a big-endian 8-byte counter drawn with repeats
    (key space p/2, so ~40% of rows equal their predecessor); lens
    (int32, k/2..k) when asked."""
    vals = torch.sort(torch.randint(0, p // 2, (p,), generator=gen,
                                    device=device)).values
    keys = torch.full((p, k), ord("p"), dtype=torch.uint8, device=device)
    keys[:, : k // 4] = torch.randint(0, 256, (k // 4,), generator=gen,
                                      device=device).to(torch.uint8)
    for j in range(8):
        keys[:, k - 1 - j] = ((vals >> (8 * j)) & 0xFF).to(torch.uint8)
    lens = None
    if with_lens:
        lens = torch.randint(k // 2, k + 1, (p,), generator=gen,
                             device=device, dtype=torch.int32)
    return keys, lens


def profile_device(torch, fn):
    """Run fn() once under torch.profiler: (device time in us, kinds of
    device events, the 8 largest as text, names cut to the function)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def short(name):
        name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
        return re.split(r"[<(]", name, maxsplit=1)[0].strip()

    dev = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0))
    dev.sort(key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in dev)
    top = ", ".join(f"{short(e.key)} x{e.count} {dev_us(e):.0f}us"
                    for e in dev[:8])
    return total, len(dev), top


def shard_phase(torch, device):
    """One serial-route shard: 4 presorted chunks of 156,250 bench-style rows
    (8-digit keys over a 5M key space), front-coded upload, 3 snapshots,
    bottommost — through the shard program: its device time by CUDA
    events (median of 5, upload excluded) and the ops that take the device
    time, by torch.profiler. Returns the median in ms and the profiled
    device time in us."""
    from toplingdb_tpu_torch.ops import compaction_kernels as ck

    rng = np.random.default_rng(11)
    chunks = []
    for run in range(4):
        n = 156_250
        draws = rng.integers(0, 5_000_000, n)
        seqs = np.arange(run * n + 1, (run + 1) * n + 1, dtype=np.uint64)
        o = np.lexsort((np.iinfo(np.int64).max - seqs.view(np.int64), draws))
        ik = np.empty((n, 16), dtype=np.uint8)
        for j in range(8):
            ik[:, 7 - j] = (draws[o] // 10 ** j) % 10 + ord("0")
        packed = (seqs[o] << np.uint64(8)) | np.uint64(1)
        ik[:, 8:] = packed[:, None] >> (np.arange(8) * 8).astype(
            np.uint64)[None, :] & np.uint64(0xFF)
        chunks.append(ck.prepare_uniform_chunk(ik.reshape(-1), n, 16))
    h = ck.upload_uniform_shard(chunks, device=device)
    snaps = [100_000, 300_000, 500_000]

    def run():
        return ck.fused_uniform_shard_finish(
            ck.fused_uniform_shard_start(h, snaps, True))

    for _ in range(2):
        run()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pending = ck.fused_uniform_shard_start(h, snaps, True)
        end.record()
        ck.fused_uniform_shard_finish(pending)
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    total, n_kinds, top = profile_device(torch, run)
    log(f"shard program (p=2^20, 4 chunks, 3 snapshots): {ms:.3f} ms "
        f"(CUDA events, median of 5); profiler device time {total:.0f}us "
        f"in {n_kinds} kinds of device events; top: {top}")
    return ms, total


# ---------------------------------------------------------------------------
# Compaction jobs
# ---------------------------------------------------------------------------


class HostTimers:
    """Host seconds spent in the named functions while the context is open,
    summed per (thread, function); a function's time includes what it calls
    and any wait for the interpreter lock. Threads are named by role: main,
    compute (pipeline-compute), scan (pipeline-scan-*), pool (others)."""

    def __init__(self, *targets):
        self.targets = targets  # (owner, attribute name) pairs
        self.secs = {}
        self._saved = []

    def _wrap(self, fn, name):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                t = threading.current_thread().name
                role = ("main" if t == "MainThread" else "compute"
                        if t == "pipeline-compute" else "scan"
                        if t.startswith("pipeline-scan") else "pool")
                key = f"{role}/{name}"
                self.secs[key] = (self.secs.get(key, 0.0)
                                  + time.perf_counter() - t0)
        return wrapped

    def __enter__(self):
        for owner, name in self.targets:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()

    def text(self) -> str:
        return json.dumps({k: round(v, 3) for k, v in sorted(self.secs.items())})


def plane_timers():
    """HostTimers over the stages of both uniform-key routes: opening the
    inputs, the pipeline's plan, stage bodies and waits, the shard
    program's host calls, the serial route's scan, shard preparation and
    trailer decode, the variable-length program, and the SST writer with
    its per-file finish."""
    from toplingdb_tpu_torch.db.table_cache import TableCache
    from toplingdb_tpu_torch.ops import columnar_io as cio
    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops import device_compaction as dc
    from toplingdb_tpu_torch.ops import pipeline as pl

    return HostTimers(
        (TableCache, "get_reader"), (cio._ColumnarSST, "finish"),
        (pl, "run_pipelined"), (pl, "_build_plan"), (pl, "_scan_file"),
        (pl, "_device_compute"),
        (pl._Progress, "wait_shard"), (pl, "_put"),
        (pl, "_range_seq_vtype"), (pl, "_cover_for_ranges"),
        (pl, "_ranges_lmap"), (ck, "prepare_uniform_chunk"),
        (ck, "upload_uniform_shard"), (ck, "fused_uniform_shard_start"),
        (ck, "fused_uniform_shard_finish"),
        (cio, "scan_tables_columnar_prealloc"), (cio, "_file_scan_prologue"),
        (dc, "_prepare_uniform_shards"), (dc, "_kv_seq_vtype"),
        (ck, "fused_encode_sort_gc_start"),
        (ck, "fused_encode_sort_gc_finish"), (cio, "write_tables_columnar"))


def entry_timers():
    """HostTimers over the per-entry route's stages: the Python scan, the
    columns' padding, the device sort and GC mask (each ends in a download,
    so its host time holds the device time), the tombstone cover, the whole
    writer loop (`build_outputs`, which drives the survivor stream, the
    host fold, the filter and the blob rewrite), new blob records and each
    output's finish."""
    from toplingdb_tpu_torch.db import blob
    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops import device_compaction as dc
    from toplingdb_tpu_torch.table.builder import TableBuilder

    return HostTimers(
        (dc, "collect_raw_entries"), (ck, "pad_columns"),
        (ck, "device_sort"), (ck, "gc_mask"), (dc, "_tombstone_cover"),
        (dc, "build_outputs"), (blob.BlobFileBuilder, "add"),
        (TableBuilder, "finish"))


class ShardPrograms:
    """While open, times each uniform-key shard program
    (`_uniform_shard_tail`, on the stream that runs it) with CUDA events;
    `log` holds (padded p, start event, end event) per program."""

    def __init__(self, torch):
        self.torch = torch
        self.log = []

    def __enter__(self):
        from toplingdb_tpu_torch.ops import compaction_kernels as ck

        self._ck, self._tail = ck, ck._uniform_shard_tail
        torch, tail, log = self.torch, self._tail, self.log

        def timed_tail(kb, pkb, *a, **k):
            if pkb.device.type != "cuda":
                log.append((pkb.shape[0], None, None))
                return tail(kb, pkb, *a, **k)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = tail(kb, pkb, *a, **k)
            end.record()
            log.append((pkb.shape[0], start, end))
            return out

        ck._uniform_shard_tail = timed_tail
        return self

    def __exit__(self, *exc):
        self._ck._uniform_shard_tail = self._tail

    def busy(self, wall):
        """(summed program ms, a text with the device busy share) — the
        ms is None where the programs ran on the CPU."""
        if not self.log or self.log[0][1] is None:
            return None, "device busy share not measured"
        ms = sum(a.elapsed_time(b) for _, a, b in self.log)
        return ms, (f"{ms:.3f} ms of shard programs by CUDA events, "
                    f"{ms / 1e3 / wall:.4f} of the wall (device busy "
                    "share, derived)")


class Alloc:
    def __init__(self, base):
        self.n = base

    def __call__(self):
        self.n += 1
        return self.n


def compact(env, dbdir, icmp, topts, metas, snapshots, device_name, alloc,
            **kwargs):
    from toplingdb_tpu_torch.compaction.picker import Compaction
    from toplingdb_tpu_torch.db.table_cache import TableCache
    from toplingdb_tpu_torch.ops.device_compaction import (
        run_device_compaction,
    )

    c = Compaction(level=0, output_level=2, inputs=list(metas),
                   bottommost=True, max_output_file_size=1 << 62)
    tc = TableCache(env, dbdir, icmp, topts)
    t0 = time.time()
    outputs, stats = run_device_compaction(
        env, dbdir, icmp, c, tc, topts, snapshots, new_file_number=alloc,
        creation_time=1, device_name=device_name, **kwargs)
    wall = time.time() - t0
    tc.close()
    return outputs, stats, wall


def sst_bytes(dbdir, outs):
    return [open(os.path.join(dbdir, f"{m.number:06d}.sst"), "rb").read()
            for m in outs]


def remove_ssts(dbdir, metas):
    for m in metas:
        os.remove(os.path.join(dbdir, f"{m.number:06d}.sst"))


def main_path(torch, env, dbdir, icmp, topts, n, device_name="cuda"):
    """The main path: the pipelined plane (run_device_compaction's default)
    on bench.py's job, without and with 3 snapshots. The kernels' counts
    are set to 0 just before each pipelined job and read just after; each
    shard program (`_uniform_shard_tail`, on the compute thread's stream)
    is timed with CUDA events. The serial route (pipeline=False) then runs
    the same inputs and must write the same bytes. Returns (launches summed
    over the pipelined jobs, jobs)."""
    from toplingdb_tpu_torch.ops import kernels

    t0 = time.time()
    metas, rows, _ = write_runs(env, dbdir, icmp, topts, n, Alloc(9))
    log(f"main path inputs: {n} entries, {len(metas)} SSTs, "
        f"{sum(m.file_size for m in metas)} bytes ({time.time() - t0:.1f}s)")
    max_seq = n // 4 * 4
    runs = [("no snapshots", []),
            ("3 snapshots", [max_seq // 5, max_seq // 2, 4 * max_seq // 5])]
    launches = {"gc_rows": 0, "merge_runs": 0}
    jobs = []
    for label, snaps in runs:
        kernels.gc_rows.launches = 0
        kernels.merge_runs_perm.launches = 0
        with ShardPrograms(torch) as programs, plane_timers() as timers:
            outputs, stats, wall = compact(env, dbdir, icmp, topts, metas,
                                           snaps, device_name, Alloc(10_000))
        shard_log = programs.log
        gc_n = kernels.gc_rows.launches
        mr_n = kernels.merge_runs_perm.launches
        launches["gc_rows"] += gc_n
        launches["merge_runs"] += mr_n
        assert stats.pipelined, "the main path did not run pipelined"
        mbps = n * RAW_PER_ENTRY / 1e6 / wall
        shard_ps = sorted({p for p, _, _ in shard_log})
        if device_name != "cpu":
            assert gc_n > 0 and mr_n > 0, "a kernel of the path never launched"
        prog_ms, busy = programs.busy(wall)
        log(f"main path job ({label}, pipelined): wall {wall:.3f}s, "
            f"{mbps:.2f} raw MB/s, {stats.output_records} entries in "
            f"{len(outputs)} SSTs, {len(shard_log)} shards padded to p="
            f"{shard_ps}, launches gc_rows={gc_n} merge_runs={mr_n}, {busy}, "
            f"pipeline_stall_usec={stats.pipeline_stall_usec} "
            f"prefetch_hits={stats.prefetch_hits} "
            f"prefetch_misses={stats.prefetch_misses}, "
            f"phases {json.dumps(stats.phase_dict())}; host seconds by "
            f"thread/function {timers.text()}")
        t1 = time.time()
        n_ok = check_against_oracle(env, dbdir, icmp, outputs, rows, snaps)
        log(f"main path job ({label}): {n_ok} entries match the oracle "
            f"({time.time() - t1:.1f}s)")
        with plane_timers() as stimers:
            serial, sstats, swall = compact(env, dbdir, icmp, topts, metas,
                                            snaps, device_name, Alloc(20_000),
                                            pipeline=False)
        assert not sstats.pipelined
        assert sst_bytes(dbdir, serial) == sst_bytes(dbdir, outputs), \
            "the pipelined and serial routes write different bytes"
        smbps = n * RAW_PER_ENTRY / 1e6 / swall
        log(f"serial route, same inputs ({label}): wall {swall:.3f}s, "
            f"{smbps:.2f} raw MB/s, same bytes as the pipelined job; phases "
            f"{json.dumps(sstats.phase_dict())}; host seconds by "
            f"thread/function {stimers.text()}")
        jobs.append(dict(label=label, wall_s=wall, raw_MBps=mbps,
                         serial_wall_s=swall, serial_raw_MBps=smbps,
                         phases=stats.phase_dict(), shards=len(shard_log),
                         shard_p=shard_ps, program_ms=prog_ms,
                         gc_rows=gc_n, merge_runs=mr_n,
                         in_bytes=sum(m.file_size for m in metas),
                         out_bytes=sum(m.file_size for m in outputs)))
        remove_ssts(dbdir, outputs)
        remove_ssts(dbdir, serial)
    remove_ssts(dbdir, metas)
    return launches, jobs


def blocks_path(torch, env, dbdir, icmp, topts, n, device_name="cuda"):
    """The block-assembly route at n entries, one shard, without and with 3
    snapshots: oracle, byte parity with the serial packed-download route,
    and the three kernels' launches (counts set to 0 just before each job).
    The assembly program's device time is read from CUDA events around
    `assemble_blocks`. Returns (launches summed over both jobs, jobs)."""
    from toplingdb_tpu_torch.ops import block_assembly as ba
    from toplingdb_tpu_torch.ops import kernels

    t0 = time.time()
    metas, rows, _ = write_runs(env, dbdir, icmp, topts, n, Alloc(9))
    log(f"block-assembly inputs: {n} entries, {len(metas)} SSTs, "
        f"{sum(m.file_size for m in metas)} bytes ({time.time() - t0:.1f}s)")
    program_ms, enqueue_ms, last_call = [], [], []
    assemble = ba.assemble_blocks

    def timed_assemble(*a, **k):
        last_call[:] = [a, k]
        if device_name == "cpu":
            return assemble(*a, **k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_host = time.time()
        start.record()
        out = assemble(*a, **k)
        end.record()
        enqueue_ms.append((time.time() - t_host) * 1e3)
        end.synchronize()
        program_ms.append(start.elapsed_time(end))
        return out

    max_seq = n // 4 * 4
    runs = [("no snapshots", []),
            ("3 snapshots", [max_seq // 5, max_seq // 2, 4 * max_seq // 5])]
    names = ("gc_rows", "merge_runs_perm", "shared_prefix_lengths")
    total = dict.fromkeys(names, 0)
    jobs = []
    for label, snaps in runs:
        for name in names:
            getattr(kernels, name).launches = 0
        ba.assemble_blocks = timed_assemble
        try:
            outputs, stats, wall = compact(
                env, dbdir, icmp, topts, metas, snaps, device_name,
                Alloc(40_000), device_blocks=True, num_shards=1)
        finally:
            ba.assemble_blocks = assemble
        counts = {name: getattr(kernels, name).launches for name in names}
        mbps = n * RAW_PER_ENTRY / 1e6 / wall
        prog = (f"{program_ms[-1]:.3f} ms on the device (CUDA events), "
                f"{enqueue_ms[-1]:.3f} ms host enqueue" if program_ms
                else "not measured")
        log(f"block-assembly job ({label}): wall {wall:.3f}s, {mbps:.2f} raw "
            f"MB/s, {stats.output_records} entries in {len(outputs)} SSTs, "
            f"assembly program {prog}, launches {json.dumps(counts)}, phases "
            f"{json.dumps(stats.phase_dict())}")
        if snaps and device_name != "cpu":
            # Where the program's device time goes: the same call again,
            # traced, after the job (its result and launches are dropped).
            a, k = last_call
            total_us, n_kinds, top = profile_device(
                torch, lambda: assemble(*a, **k))
            log(f"assembly program (p=2^22, {label}): profiler device time "
                f"{total_us:.0f}us in {n_kinds} kinds of device events; "
                f"top: {top}")
        last_call.clear()
        if device_name != "cpu":
            assert min(counts.values()) > 0, \
                "a kernel of the block-assembly route never launched"
        for name in names:
            total[name] += counts[name]
        packed, pstats, pwall = compact(env, dbdir, icmp, topts, metas, snaps,
                                        device_name, Alloc(50_000),
                                        pipeline=False)
        log(f"packed-download job, same inputs ({label}): wall {pwall:.3f}s,"
            f" {n * RAW_PER_ENTRY / 1e6 / pwall:.2f} raw MB/s, phases "
            f"{json.dumps(pstats.phase_dict())}")
        assert outputs and sst_bytes(dbdir, outputs) == sst_bytes(
            dbdir, packed), "block-assembly and packed-download bytes differ"
        t1 = time.time()
        n_ok = check_against_oracle(env, dbdir, icmp, outputs, rows, snaps)
        log(f"block-assembly job ({label}): {n_ok} entries match the oracle "
            f"and the packed-download bytes ({time.time() - t1:.1f}s)")
        jobs.append(dict(label=label, wall_s=wall, raw_MBps=mbps,
                         packed_wall_s=pwall, program_ms=program_ms[-1:],
                         phases=stats.phase_dict(), launches=counts))
        remove_ssts(dbdir, outputs)
        remove_ssts(dbdir, packed)
    remove_ssts(dbdir, metas)
    return total, jobs


# ---------------------------------------------------------------------------
# Variable-length keys: YCSB's key names
# ---------------------------------------------------------------------------

YCSB_KEY_WIDTH = 23  # "user" + at most 19 decimal digits
YCSB_VALUE_LEN = 100  # one field of YCSB's default record (fieldlength)


def ycsb_user_keys(knums):
    """YCSB CoreWorkload.buildKeyName(keynum) with hashed inserts and
    zeropadding=1: "user" + Long.toString(Utils.fnvhash64(keynum)), the FNV-1a
    hash of the key number's 8 little-endian bytes, sign dropped (5-23
    bytes). Returns ([n, 23] uint8 zero-padded key bytes, int64 lengths)."""
    v = knums.astype(np.uint64)
    h = np.full(len(v), 0xCBF29CE484222325, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            h *= np.uint64(1099511628211)
            v >>= np.uint64(8)
    a = np.abs(h.view(np.int64))
    assert (a >= 0).all(), "a hash of Long.MIN_VALUE has no such key"
    a = a.astype(np.uint64)
    nd = np.ones(len(a), dtype=np.int64)
    for k in range(1, 19):
        nd += a >= np.uint64(10 ** k)
    keys = np.zeros((len(a), YCSB_KEY_WIDTH), dtype=np.uint8)
    keys[:, :4] = np.frombuffer(b"user", dtype=np.uint8)
    rows = np.arange(len(a))
    for k in range(19):
        m = nd > k
        keys[rows[m], 3 + nd[m] - k] = (a[m] // np.uint64(10 ** k)
                                         % np.uint64(10)) + ord("0")
    return keys, 4 + nd


def ikey_buffer(keys, klen, knum, packed):
    """Dense internal-key bytes for rows of key numbers `knum` (user key +
    8-byte little-endian packed trailer) and their lengths."""
    ul = klen[knum]
    lens = ul + 8
    offs = np.cumsum(lens) - lens
    buf = np.empty(int(lens.sum()), dtype=np.uint8)
    for j in range(YCSB_KEY_WIDTH):
        m = ul > j
        buf[offs[m] + j] = keys[knum[m], j]
    for j in range(8):
        buf[offs + ul + j] = (packed >> np.uint64(8 * j)) & np.uint64(0xFF)
    return buf, lens.astype(np.int32)


def write_varlen_runs(env, dbdir, icmp, topts, n_entries, alloc, seed=4321,
                      p_del=0.1, num_runs=4):
    """num_runs presorted runs of YCSB-keyed rows (key space N/2, ~2x
    overwrites, p_del DELETIONs), one SST each, written with the port's
    columnar writer. Values: 100 bytes, the last the seqno's last digit.
    Returns (metas, rows, keys, klen, by_rank): rows = [(rank, seqs, vtypes)]
    with rank the key's place in byte order, by_rank[rank] = key number."""
    from toplingdb_tpu_torch.db.dbformat import ValueType
    from toplingdb_tpu_torch.db.version_edit import FileMetaData
    from toplingdb_tpu_torch.ops.columnar_io import (
        ColumnarKV,
        write_tables_columnar,
    )

    rng = np.random.default_rng(seed)
    key_space = max(n_entries // 2, 1)
    keys, klen = ycsb_user_keys(np.arange(key_space))
    wide = np.zeros((key_space, 24), dtype=np.uint8)
    wide[:, :YCSB_KEY_WIDTH] = keys
    be = wide.view(">u8").reshape(key_space, 3)  # zero padding sorts first
    by_rank = np.lexsort((be[:, 2], be[:, 1], be[:, 0]))
    rank = np.empty(key_space, dtype=np.int64)
    rank[by_rank] = np.arange(key_space)
    per_run = n_entries // num_runs
    metas, rows = [], []
    for run in range(num_runs):
        n = per_run
        draws = rng.integers(0, key_space, n)
        seqs = np.arange(run * n + 1, run * n + n + 1, dtype=np.uint64)
        vt = np.where(rng.random(n) < p_del, int(ValueType.DELETION),
                      int(ValueType.VALUE)).astype(np.int32)
        s = np.lexsort((np.iinfo(np.int64).max - seqs.view(np.int64),
                        rank[draws]))
        packed = (seqs[s] << np.uint64(8)) | vt[s].astype(np.uint64)
        kbuf, klens = ikey_buffer(keys, klen, draws[s], packed)
        has_v = vt[s] == int(ValueType.VALUE)
        vals = np.full((int(has_v.sum()), YCSB_VALUE_LEN), ord("v"),
                       dtype=np.uint8)
        vals[:, -1] = (seqs[s][has_v] % 10 + ord("0")).astype(np.uint8)
        val_lens = np.where(has_v, YCSB_VALUE_LEN, 0).astype(np.int32)
        kv = ColumnarKV(
            kbuf, (np.cumsum(klens) - klens).astype(np.int32), klens,
            vals.reshape(-1), (np.cumsum(val_lens) - val_lens).astype(
                np.int32), val_lens)
        files = write_tables_columnar(
            env, dbdir, alloc, icmp, topts, kv, np.arange(n, dtype=np.int32),
            np.full(n, -1, dtype=np.int64), vt[s], seqs[s], creation_time=1)
        for fnum, path, props, smallest, largest, _sel in files:
            metas.append(FileMetaData(
                number=fnum, file_size=env.get_file_size(path),
                smallest=smallest, largest=largest,
                smallest_seqno=props.smallest_seqno,
                largest_seqno=props.largest_seqno))
        rows.append((rank[draws], seqs, vt))
    return metas, rows, keys, klen, by_rank


def check_varlen_against_oracle(env, dbdir, icmp, outputs, rows, snapshots,
                                keys, klen, by_rank):
    """Every output read back with the port's reader and held, byte for
    byte, against the oracle's internal keys (user key + zeroed or kept
    seqno + type), and the values' lengths and last bytes."""
    from toplingdb_tpu_torch.db import filename
    from toplingdb_tpu_torch.ops.columnar_io import scan_table_columnar
    from toplingdb_tpu_torch.table.reader import TableReader

    kbufs, vlens, vlast = [], [], []
    for m in outputs:
        r = TableReader(env.new_random_access_file(
            filename.table_file_name(dbdir, m.number)), icmp)
        kv = scan_table_columnar(r)
        r.close()
        assert m.num_entries == kv.n
        kbufs.append(kv.key_buf[: int(kv.key_lens.sum())])
        has_v = kv.val_lens > 0
        last = np.full(kv.n, -1, dtype=np.int64)
        last[has_v] = kv.val_buf[kv.val_offs[has_v] + kv.val_lens[has_v] - 1]
        vlens.append(kv.val_lens)
        vlast.append(last)
    wrank, wseq, wvt, worig = expected_survivors(rows, snapshots)
    want, _ = ikey_buffer(keys, klen, by_rank[wrank],
                          (wseq << np.uint64(8)) | wvt.astype(np.uint64))
    got = np.concatenate(kbufs)
    assert len(got) == len(want) and np.array_equal(got, want), \
        "internal keys differ from the oracle"
    assert np.array_equal(np.concatenate(vlens),
                          np.where(wvt == 1, YCSB_VALUE_LEN, 0)), \
        "value lengths differ from the oracle"
    assert np.array_equal(np.concatenate(vlast), np.where(
        wvt == 1, (worig % 10).astype(np.int64) + ord("0"), -1)), \
        "values differ from the oracle"
    return len(wrank)


def varlen_path(torch, env, dbdir, icmp, topts, n, n_plain,
                device_name="cuda"):
    """Variable-length keys at n entries, without and with 3 snapshots,
    through the whole-job device program (the pipeline gives up on
    non-uniform keys, as the reference's does): oracle, gc_rows launched
    (its count set to 0 just before each job), the program's CUDA-event
    time. Then n_plain entries of the same generator on `device_name` and
    on the CPU: identical bytes. Returns (gc_rows launches over the n-entry
    jobs, jobs)."""
    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops import kernels

    t0 = time.time()
    metas, rows, keys, klen, by_rank = write_varlen_runs(
        env, dbdir, icmp, topts, n, Alloc(9))
    log(f"variable-length inputs: {n} entries, YCSB keys of "
        f"{int(klen.min())}-{int(klen.max())} bytes, {YCSB_VALUE_LEN}-byte "
        f"values (one YCSB field; cut from the 10-field 1 KB record), "
        f"{len(metas)} SSTs, {sum(m.file_size for m in metas)} bytes "
        f"({time.time() - t0:.1f}s)")
    impl = ck._fused_encode_sort_gc_impl
    program_ms = []

    def timed_impl(kb, *a, **k):
        if kb.device.type != "cuda":
            return impl(kb, *a, **k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = impl(kb, *a, **k)
        end.record()
        end.synchronize()
        program_ms.append(start.elapsed_time(end))
        return out

    max_seq = n // 4 * 4
    runs = [("no snapshots", []),
            ("3 snapshots", [max_seq // 5, max_seq // 2, 4 * max_seq // 5])]
    total, jobs = 0, []
    for label, snaps in runs:
        program_ms.clear()
        kernels.gc_rows.launches = 0
        ck._fused_encode_sort_gc_impl = timed_impl
        try:
            with plane_timers() as timers:
                outputs, stats, wall = compact(env, dbdir, icmp, topts, metas,
                                               snaps, device_name,
                                               Alloc(70_000))
        finally:
            ck._fused_encode_sort_gc_impl = impl
        gc_n = kernels.gc_rows.launches
        total += gc_n
        assert not stats.pipelined
        if device_name != "cpu":
            assert gc_n > 0, "gc_rows never launched on variable-length keys"
        prog = (f"{program_ms[0]:.3f} ms on the device (CUDA events, host "
                "enqueue inside)" if program_ms else "not measured")
        log(f"variable-length job ({label}): wall {wall:.3f}s, "
            f"{stats.output_records} entries in {len(outputs)} SSTs, program "
            f"{prog}, launches gc_rows={gc_n}, phases "
            f"{json.dumps(stats.phase_dict())}; host seconds by "
            f"thread/function (the pipeline's attempt included) "
            f"{timers.text()}")
        t1 = time.time()
        n_ok = check_varlen_against_oracle(env, dbdir, icmp, outputs, rows,
                                           snaps, keys, klen, by_rank)
        log(f"variable-length job ({label}): {n_ok} entries match the oracle "
            f"({time.time() - t1:.1f}s)")
        jobs.append(dict(label=label, wall_s=wall, program_ms=program_ms[:1],
                         phases=stats.phase_dict(), gc_rows=gc_n))
        remove_ssts(dbdir, outputs)
    remove_ssts(dbdir, metas)

    metas, rows, *_ = write_varlen_runs(env, dbdir, icmp, topts, n_plain,
                                        Alloc(9), seed=99)
    snaps = [n_plain // 5, n_plain // 2, 4 * n_plain // 5]
    out_dev, _, wall_dev = compact(env, dbdir, icmp, topts, metas, snaps,
                                   device_name, Alloc(80_000))
    out_cpu, _, wall_cpu = compact(env, dbdir, icmp, topts, metas, snaps,
                                   "cpu", Alloc(90_000))
    assert out_dev and sst_bytes(dbdir, out_dev) == sst_bytes(
        dbdir, out_cpu), "variable-length outputs differ on cuda and cpu"
    log(f"variable-length device vs plain: {n_plain} entries, {len(out_dev)} "
        f"SSTs byte-identical ({device_name} {wall_dev:.3f}s, cpu "
        f"{wall_cpu:.3f}s)")
    for o in (out_dev, out_cpu, metas):
        remove_ssts(dbdir, o)
    return total, jobs


def tombstone_path(torch, env, dbdir, icmp, topts, n, device_name="cuda"):
    """Range tombstones through the block-assembly, serial packed and
    pipelined routes on `device_name` and on the CPU: six byte-identical
    outputs, the device's matching the oracle with tombstones, and gc_rows
    launched on tombstone words."""
    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops import kernels

    metas, rows, tombs = write_runs(env, dbdir, icmp, topts, n, Alloc(9),
                                    seed=77, p_del=0.1, n_tombs=20)
    max_seq = n + len(tombs)
    snaps = [max_seq // 5, max_seq // 2, 4 * max_seq // 5]
    # Observe the GC mask's calls: each launches gc_rows once, with the
    # tombstone words it is given.
    gc_mask = ck._gc_mask
    with_tombs = []

    def spy(*a, **k):
        with_tombs.append(a[7] is not None and a[7].device.type == "cuda")
        return gc_mask(*a, **k)

    outs, walls, phases = {}, {}, {}
    base = 60_000
    kernels.gc_rows.launches = 0
    ck._gc_mask = spy
    routes = {"blocks": dict(device_blocks=True, num_shards=1),
              "packed": dict(pipeline=False), "pipelined": {}}
    try:
        for dev in (device_name, "cpu"):
            for route, kw in routes.items():
                base += 1000
                o, st, walls[(dev, route)] = compact(
                    env, dbdir, icmp, topts, metas, snaps, dev, Alloc(base),
                    **kw)
                assert st.pipelined == (route == "pipelined"), route
                outs[(dev, route)] = o
                phases[(dev, route)] = st.phase_dict()
    finally:
        ck._gc_mask = gc_mask
    ref = sst_bytes(dbdir, outs[(device_name, "blocks")])
    for key, o in outs.items():
        assert sst_bytes(dbdir, o) == ref, f"{key} writes other bytes"
    n_rd = sum(m.num_range_deletions for m in outs[(device_name, "blocks")])
    assert n_rd > 0, "no range tombstone survived into the output"
    if device_name != "cpu":
        assert any(with_tombs) and kernels.gc_rows.launches > 0, \
            "gc_rows never launched on tombstone words"
    n_ok = 0
    for route in routes:
        n_ok = check_against_oracle(env, dbdir, icmp,
                                    outs[(device_name, route)], rows, snaps,
                                    tombs)
    log(f"range tombstones: {n} entries, {len(tombs)} tombstones, "
        f"{n_rd} fragments kept; the three routes on {device_name} and cpu "
        f"write identical bytes, {n_ok} entries match the oracle; gc_rows "
        f"launches {kernels.gc_rows.launches}, {sum(with_tombs)} of them on "
        f"tombstone words; walls "
        + ", ".join(f"{d}/{r} {w:.3f}s" for (d, r), w in walls.items())
        + "; phases on " + ", ".join(
            f"{d}/{r} {json.dumps(ph)}"
            for (d, r), ph in phases.items() if d == device_name))
    for o in outs.values():
        remove_ssts(dbdir, o)
    remove_ssts(dbdir, metas)


def device_vs_plain(env, dbdir, icmp, topts, n, device_name="cuda"):
    from toplingdb_tpu_torch.ops import device_compaction as dc

    metas, rows, _ = write_runs(env, dbdir, icmp, topts, n, Alloc(9),
                                seed=99, p_del=0.1)
    snaps = [n // 5, n // 2, 4 * n // 5]
    n_shards = 4
    assert n >= dc._SHARD_MIN_ROWS, "the job would run as one shard"
    out_cuda, _, wall_cuda = compact(env, dbdir, icmp, topts, metas, snaps,
                                     device_name, Alloc(20_000),
                                     num_shards=n_shards, pipeline=False)
    out_cpu, _, wall_cpu = compact(env, dbdir, icmp, topts, metas, snaps,
                                   "cpu", Alloc(30_000), num_shards=n_shards,
                                   pipeline=False)
    assert out_cuda and sst_bytes(dbdir, out_cuda) == sst_bytes(
        dbdir, out_cpu), "cuda and cpu outputs differ"
    n_ok = check_against_oracle(env, dbdir, icmp, out_cuda, rows, snaps)
    log(f"device vs plain: {n} entries, {n_shards} shards, {len(out_cuda)} "
        f"SSTs byte-identical (cuda {wall_cuda:.3f}s, cpu {wall_cpu:.3f}s), "
        f"{n_ok} entries match the oracle")


# ---------------------------------------------------------------------------
# MERGE / SINGLE_DELETION groups, and the per-entry route
# ---------------------------------------------------------------------------

# db_bench's mergerandom mix with deletions: Put, Merge (uint64add), Delete,
# SingleDelete.
COMPLEX_MIX = {1: 0.6, 2: 0.2, 0: 0.1, 7: 0.1}


class ListIter:
    """A sorted (internal key, value) list as the iterator the
    CompactionIterator reads."""

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


def complex_oracle(rows, tombs, snapshots, icmp, merge_operator):
    """The survivor stream of the port's CompactionIterator over the
    host-sorted inputs (the device plane is not involved): [(internal key,
    value)] in output order."""
    import struct

    from toplingdb_tpu_torch.compaction.compaction_iterator import (
        CompactionIterator,
    )
    from toplingdb_tpu_torch.db.range_del import (
        RangeDelAggregator,
        RangeTombstone,
    )

    key = np.concatenate([r[0] for r in rows])
    seq = np.concatenate([r[1] for r in rows])
    vt = np.concatenate([r[2] for r in rows])
    o = np.lexsort((np.iinfo(np.int64).max - seq.view(np.int64), key))
    items = []
    for k, sq, t in zip(key[o].tolist(), seq[o].tolist(), vt[o].tolist()):
        v = (b"v" * 19 + b"%d" % (sq % 10) if t == 1
             else struct.pack("<Q", sq % 97) if t == 2 else b"")
        items.append((b"%08d" % k + ((sq << 8) | t).to_bytes(8, "little"),
                      v))
    rd = RangeDelAggregator(icmp.user_comparator)
    for ts, lo, hi in tombs:
        rd.add(RangeTombstone(ts, b"%08d" % lo, b"%08d" % hi))
    ci = CompactionIterator(ListIter(items), icmp, snapshots,
                            bottommost_level=True,
                            merge_operator=merge_operator, range_del_agg=rd)
    return list(ci.entries())


def read_entries(env, dbdir, icmp, outputs):
    """Every output's (internal key, value) pairs in file order."""
    from toplingdb_tpu_torch.db import filename
    from toplingdb_tpu_torch.ops.columnar_io import scan_table_columnar
    from toplingdb_tpu_torch.table.reader import TableReader

    out = []
    for m in outputs:
        r = TableReader(env.new_random_access_file(
            filename.table_file_name(dbdir, m.number)), icmp)
        kv = scan_table_columnar(r)
        r.close()
        out += [(kv.ikey(i), kv.value(i)) for i in range(kv.n)]
    return out


def complex_path(torch, env, dbdir, icmp, topts, n, card,
                 device_name="cuda"):
    """MERGE / SINGLE_DELETION groups at n entries (COMPLEX_MIX, 8 range
    tombstones), without and with 3 snapshots: the pipeline's attempt gives
    up on the complex groups, the serial route runs 2 shards and folds the
    groups on the host. The kernels' counts are set to 0 just before each
    job and read just after; collect_raw_entries must stay uncalled. The
    card's bytes equal the CPU route's, and the card's entries equal the
    CompactionIterator oracle's. Returns the jobs' numbers."""
    from toplingdb_tpu_torch.ops import device_compaction as dc
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.utils.merge_operator import UInt64AddOperator

    t0 = time.time()
    metas, rows, tombs = write_runs(env, dbdir, icmp, topts, n, Alloc(9),
                                    seed=55, n_tombs=8, mix=COMPLEX_MIX)
    key = np.concatenate([r[0] for r in rows])
    vt = np.concatenate([r[2] for r in rows])
    n_groups = len(np.unique(key[(vt == 2) | (vt == 7)]))
    log(f"complex inputs: {n} entries (60% Put, 20% Merge, 10% Delete, 10% "
        f"SingleDelete), {len(tombs)} range tombstones, {len(metas)} SSTs, "
        f"{n_groups} user keys with MERGE or SINGLE_DELETION rows "
        f"({time.time() - t0:.1f}s)")

    def no_entries(*a, **k):
        raise AssertionError("the complex job left the columnar route")

    max_seq = n + len(tombs)
    runs = [("no snapshots", []),
            ("3 snapshots", [max_seq // 5, max_seq // 2, 4 * max_seq // 5])]
    jobs = []
    collect = dc.collect_raw_entries
    dc.collect_raw_entries = no_entries
    try:
        for label, snaps in runs:
            kernels.gc_rows.launches = 0
            kernels.merge_runs_perm.launches = 0
            with plane_timers() as timers:
                outs, stats, wall = compact(
                    env, dbdir, icmp, topts, metas, snaps, device_name,
                    Alloc(100_000), merge_operator=UInt64AddOperator(),
                    num_shards=2)
            counts = {"gc_rows": kernels.gc_rows.launches,
                      "merge_runs": kernels.merge_runs_perm.launches}
            assert not stats.pipelined and stats.resolve_usec > 0
            if device_name != "cpu":
                assert min(counts.values()) > 0, \
                    "a kernel of the complex job never launched"
            cpu, cstats, cwall = compact(
                env, dbdir, icmp, topts, metas, snaps, "cpu", Alloc(110_000),
                merge_operator=UInt64AddOperator(), num_shards=2)
            assert outs and sst_bytes(dbdir, outs) == sst_bytes(dbdir, cpu), \
                f"complex job ({label}): {device_name} and cpu bytes differ"
            t1 = time.time()
            want = complex_oracle(rows, tombs, snaps, icmp,
                                  UInt64AddOperator())
            got = read_entries(env, dbdir, icmp, outs)
            assert got == want, f"complex job ({label}) differs from the " \
                "CompactionIterator oracle"
            mbps = n * RAW_PER_ENTRY / 1e6 / wall
            log(f"complex job ({label}) [{card}]: wall {wall:.3f}s, "
                f"{mbps:.2f} raw MB/s, {stats.output_records} entries in "
                f"{len(outs)} SSTs, {n_groups} complex groups folded in "
                f"{stats.resolve_usec / 1e6:.3f}s (resolve), launches "
                f"{json.dumps(counts)} (the pipeline's attempt included), "
                f"phases {json.dumps(stats.phase_dict())}; cpu route "
                f"{cwall:.3f}s, same bytes, phases "
                f"{json.dumps(cstats.phase_dict())}; {len(got)} entries "
                f"match the "
                f"oracle ({time.time() - t1:.1f}s); host seconds by "
                f"thread/function {timers.text()}")
            jobs.append(dict(label=label, wall_s=wall, raw_MBps=mbps,
                             cpu_wall_s=cwall, phases=stats.phase_dict(),
                             launches=counts, groups=n_groups))
            remove_ssts(dbdir, outs)
            remove_ssts(dbdir, cpu)
    finally:
        dc.collect_raw_entries = collect
    remove_ssts(dbdir, metas)
    return jobs


BLOB_LEN = 1024
BLOB_FILES = (7, 8)


def write_blob_runs(env, dbdir, icmp, topts, n_entries, alloc, seed=66,
                    num_runs=4):
    """bench.py's key shape (8-digit keys, key space N/2, num_runs presorted
    runs) with 5% empty values and 10% BLOB_INDEX rows whose 1 KiB values
    (the letter 'A' + seqno % 26, repeated) live in two blob files; the
    rest are bench.py's 20-byte values. Returns (metas, rows) with rows =
    [(draws, seqs, vtypes, empty)] per run."""
    from toplingdb_tpu_torch.db import blob
    from toplingdb_tpu_torch.db.version_edit import FileMetaData
    from toplingdb_tpu_torch.ops.columnar_io import (
        ColumnarKV,
        write_tables_columnar,
    )

    rng = np.random.default_rng(seed)
    key_space = max(n_entries // 2, 1)
    per_run = n_entries // num_runs
    builders = {fn: blob.BlobFileBuilder(env, dbdir, fn) for fn in BLOB_FILES}
    metas, rows = [], []
    for run in range(num_runs):
        n = per_run
        draws = rng.integers(0, key_space, n)
        seqs = np.arange(run * n + 1, run * n + n + 1, dtype=np.uint64)
        r = rng.random(n)
        empty = r < 0.05
        is_blob = (r >= 0.05) & (r < 0.15)
        vt = np.where(is_blob, 0x11, 1).astype(np.int32)
        s = np.lexsort((np.iinfo(np.int64).max - seqs.view(np.int64), draws))
        vals, refs = [], set()
        for d, sq, b, e in zip(draws[s].tolist(), seqs[s].tolist(),
                               is_blob[s].tolist(), empty[s].tolist()):
            if b:
                fn = BLOB_FILES[sq % 2]
                refs.add(fn)
                vals.append(builders[fn].add(
                    b"%08d" % d, bytes([65 + sq % 26]) * BLOB_LEN))
            else:
                vals.append(b"" if e else b"v" * 19 + b"%d" % (sq % 10))
        ik = np.empty((n, 16), dtype=np.uint8)
        for j in range(8):
            ik[:, 7 - j] = (draws[s] // 10 ** j) % 10 + ord("0")
        packed = (seqs[s] << np.uint64(8)) | vt[s].astype(np.uint64)
        ik[:, 8:] = packed[:, None] >> (np.arange(8) * 8).astype(
            np.uint64)[None, :] & np.uint64(0xFF)
        val_lens = np.array([len(v) for v in vals], dtype=np.int32)
        kv = ColumnarKV(
            ik.reshape(-1), np.arange(n, dtype=np.int32) * 16,
            np.full(n, 16, dtype=np.int32),
            np.frombuffer(b"".join(vals), dtype=np.uint8).copy(),
            (np.cumsum(val_lens) - val_lens).astype(np.int32), val_lens)
        files = write_tables_columnar(
            env, dbdir, alloc, icmp, topts, kv, np.arange(n, dtype=np.int32),
            np.full(n, -1, dtype=np.int64), vt[s], seqs[s], creation_time=1)
        for fnum, path, props, smallest, largest, _sel in files:
            metas.append(FileMetaData(
                number=fnum, file_size=env.get_file_size(path),
                smallest=smallest, largest=largest,
                smallest_seqno=props.smallest_seqno,
                largest_seqno=props.largest_seqno, blob_refs=sorted(refs)))
        rows.append((draws, seqs, vt, empty))
    for b in builders.values():
        b.finish()
    return metas, rows


def check_blob_outputs(env, dbdir, icmp, outputs, filtered_to=None):
    """Every surviving blob index resolves to its original 1 KiB value,
    each output's blob_refs are the files its blob indexes name, and, with
    `filtered_to` (the earliest snapshot of a job that ran
    RemoveEmptyValueCompactionFilter), no empty VALUE at or below it
    survives. Returns (blob indexes, empty values kept)."""
    from toplingdb_tpu_torch.db import blob

    src = blob.BlobSource(env, dbdir)
    n_blob = n_empty = 0
    for m in outputs:
        refs = set()
        for k, v in read_entries(env, dbdir, icmp, [m]):
            sq, t = int.from_bytes(k[-8:], "little") >> 8, k[-8]
            if t == 0x11:
                refs.add(blob.decode_blob_index(v)[0])
                assert src.get(v) == bytes([65 + sq % 26]) * BLOB_LEN, \
                    "a blob index does not resolve to its value"
                n_blob += 1
            elif t == 1 and not v:
                assert filtered_to is None or sq > filtered_to, \
                    "an empty value survived the filter"
                n_empty += 1
        assert sorted(refs) == m.blob_refs, "blob_refs disagree"
    src.close()
    return n_blob, n_empty


def entries_path(torch, env, dbdir, icmp, topts, n, card,
                 device_name="cuda"):
    """Blob values at n entries with 3 snapshots. First the columnar route
    (no filter, no blob GC): the card's outputs and blob_refs equal the
    CPU route's. Then RemoveEmptyValueCompactionFilter and a
    BlobGarbageCollector (age cutoff 0.5, min_blob_size 512): the per-entry
    route (collect_raw_entries, device_gc_entries with one gc_rows launch,
    the GC rewrite, build_outputs), on the card and on the CPU in twin
    directories: the same SST and blob bytes, blob indexes resolving to
    their values, no empty VALUE at or below the earliest snapshot.
    Returns the jobs' numbers."""
    from toplingdb_tpu_torch.db import blob
    from toplingdb_tpu_torch.ops import device_compaction as dc
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.utils.compaction_filter import (
        RemoveEmptyValueCompactionFilter,
    )

    t0 = time.time()
    metas, rows = write_blob_runs(env, dbdir, icmp, topts, n, Alloc(9))
    log(f"blob inputs: {n} entries (5% empty values, 10% BLOB_INDEX rows of "
        f"{BLOB_LEN} B values in 2 blob files), {len(metas)} SSTs "
        f"({time.time() - t0:.1f}s)")
    snaps = [n // 5, n // 2, 4 * n // 5]
    kernels.gc_rows.launches = 0
    outs, stats, wall = compact(env, dbdir, icmp, topts, metas, snaps,
                                device_name, Alloc(120_000))
    col_launches = kernels.gc_rows.launches
    cpu, _, cwall = compact(env, dbdir, icmp, topts, metas, snaps, "cpu",
                            Alloc(130_000))
    assert sst_bytes(dbdir, outs) == sst_bytes(dbdir, cpu), \
        "blob job: columnar bytes differ"
    assert [m.blob_refs for m in outs] == [m.blob_refs for m in cpu] and \
        set().union(*(m.blob_refs for m in outs)) == set(BLOB_FILES)
    n_blob, _ = check_blob_outputs(env, dbdir, icmp, outs)
    route = "pipelined" if stats.pipelined else "serial"
    log(f"blob job, columnar route ({route}) [{card}]: wall {wall:.3f}s, {stats.output_records} entries in "
        f"{len(outs)} SSTs, {n_blob} blob indexes, blob_refs equal the cpu "
        f"route's (cpu {cwall:.3f}s, same bytes), gc_rows launches "
        f"{col_launches}, phases {json.dumps(stats.phase_dict())}")
    remove_ssts(dbdir, outs)
    remove_ssts(dbdir, cpu)

    twin = dbdir + "_cpu"
    shutil.rmtree(twin, ignore_errors=True)
    os.makedirs(twin)
    for name in os.listdir(dbdir):
        os.link(os.path.join(dbdir, name), os.path.join(twin, name))
    entered = []
    collect = dc.collect_raw_entries
    dc.collect_raw_entries = lambda *a, **k: entered.append(1) or collect(
        *a, **k)
    res = {}
    try:
        for dev, d in ((device_name, dbdir), ("cpu", twin)):
            alloc = Alloc(140_000)
            src = blob.BlobSource(env, d)
            gc = blob.BlobGarbageCollector(
                env, d, [fn for m in metas for fn in m.blob_refs], 0.5, 512,
                src.get, alloc)
            kernels.gc_rows.launches = 0
            with entry_timers() as timers:
                o, st, w = compact(
                    env, d, icmp, topts, metas, snaps, dev, alloc,
                    compaction_filter=RemoveEmptyValueCompactionFilter(),
                    blob_gc=gc, blob_resolver=src.get)
            res[dev] = (o, st, w, gc, kernels.gc_rows.launches, timers)
            src.close()
    finally:
        dc.collect_raw_entries = collect
    o, st, w, gc, launches, timers = res[device_name]
    co, _, cw, cgc, _, ctimers = res["cpu"]
    assert entered == [1, 1], "the filter job did not take the per-entry route"
    if device_name != "cpu":
        assert launches == 1, f"gc_rows launched {launches} times"
    assert gc.new_blob_file == cgc.new_blob_file is not None
    names = [f"{m.number:06d}.sst" for m in o] + [
        f"{gc.new_blob_file:06d}.blob"]
    assert [m.number for m in o] == [m.number for m in co]
    for name in names:
        with open(os.path.join(dbdir, name), "rb") as a, \
                open(os.path.join(twin, name), "rb") as b:
            assert a.read() == b.read(), f"{name} differs on cuda and cpu"
    n_blob, n_empty = check_blob_outputs(env, dbdir, icmp, o, min(snaps))
    assert gc.rewritten > 0
    mbps = n * RAW_PER_ENTRY / 1e6 / w
    log(f"blob GC job, per-entry route [{card}]: wall {w:.3f}s, "
        f"{mbps:.2f} raw MB/s, {st.output_records} entries in {len(o)} SSTs, "
        f"{gc.rewritten} values rewritten into blob file {gc.new_blob_file}, "
        f"{n_blob} blob indexes resolve, {n_empty} empty values kept above "
        f"the earliest snapshot, gc_rows launches {launches}, phases "
        f"{json.dumps(st.phase_dict())}; host seconds by function "
        f"{timers.text()}; cpu {cw:.3f}s, the same SST and blob bytes, host "
        f"seconds by function {ctimers.text()}")
    shutil.rmtree(twin, ignore_errors=True)
    for m in o:
        os.remove(os.path.join(dbdir, f"{m.number:06d}.sst"))
    os.remove(os.path.join(dbdir, f"{gc.new_blob_file:06d}.blob"))
    remove_ssts(dbdir, metas)
    for fn in BLOB_FILES:
        os.remove(os.path.join(dbdir, f"{fn:06d}.blob"))
    return [dict(label="columnar", wall_s=wall, cpu_wall_s=cwall,
                 phases=stats.phase_dict(), pipelined=stats.pipelined),
            dict(label="per-entry, filter + blob GC", wall_s=w,
                 raw_MBps=mbps, cpu_wall_s=cw, phases=st.phase_dict(),
                 gc_rows=launches, rewritten=gc.rewritten)]


# ---------------------------------------------------------------------------
# Compressed tables and the dcompact worker
# ---------------------------------------------------------------------------


def write_job_dir(job, inputs, compression, device, trace=None):
    """A dcompact job dir (params.json, an empty out/) written with the
    port's CompactionParams: one L0 -> L2 bottommost job, no snapshots,
    4 KiB blocks, one output file per job (bench.py's setting)."""
    from toplingdb_tpu_torch.compaction.executor import CompactionParams

    os.makedirs(os.path.join(job, "out"))
    with open(os.path.join(job, "params.json"), "w") as f:
        f.write(CompactionParams(
            job_id=11, attempt=1, dbname=os.path.dirname(inputs[0]),
            output_dir=os.path.join(job, "out"), input_files=inputs,
            output_level=2, bottommost=True, max_output_file_size=1 << 62,
            snapshots=[], comparator="tpulsm.BytewiseComparator",
            merge_operator=None, compaction_filter=None,
            compression=compression, block_size=4096, creation_time=1,
            device=device, lease_sec=30.0, trace=trace).to_json())


def job_outputs(job):
    """(results dict, FileMetaData list, output bytes list) of a run job."""
    from toplingdb_tpu_torch.compaction.executor import decode_file_meta

    with open(os.path.join(job, "results.json")) as f:
        res = json.load(f)
    metas = [decode_file_meta(d, int(d["path"][:6]))
             for d in res["output_files"]]
    return res, metas, sst_bytes(os.path.join(job, "out"), metas)


def compressed_path(torch, env, dbdir, icmp, n, n_each, n_slow, main_jobs,
                    device_name="cuda"):
    """Phase 11: (a) the headline job at n entries in the headline codec
    through the worker's run_job, (b) the worker's CLI at n_each entries,
    (c) every available codec at n_each entries (bz2 and lzma at n_slow)
    on the card and on the CPU, then uncompressed in and zstd out.
    `main_jobs`: phase 4's jobs (its uncompressed numbers, same N)."""
    from toplingdb_tpu_torch.compaction import worker
    from toplingdb_tpu_torch.compaction.compaction_job import CompactionStats
    from toplingdb_tpu_torch.compaction.resilience import HEARTBEAT_FILE
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.table import format as fmt
    from toplingdb_tpu_torch.table.builder import (
        CompressionOptions,
        TableOptions,
    )
    from toplingdb_tpu_torch.utils import codecs

    # The job dir's device name: the card, or (a CPU rehearsal) the same
    # data plane through the kernels' plain versions.
    job_device = "cuda" if device_name == "cuda" else "cpu-jax"
    have = {c: codecs.available(c) for c in ("snappy", "lz4", "zstd")}
    ctype = {"snappy": fmt.SNAPPY_COMPRESSION, "zstd": fmt.ZSTD_COMPRESSION,
             "zlib": fmt.ZLIB_COMPRESSION}
    head = next(c for c in ("snappy", "zstd", "zlib")
                if c == "zlib" or have[c])
    log(f"codecs on this host: {json.dumps(have)} (zlib, bz2, lzma: "
        f"stdlib); headline codec: {head}")

    # (a) the headline job through the worker's run_job.
    topts = TableOptions(block_size=4096, compression=ctype[head])
    t0 = time.time()
    metas, rows, _ = write_runs(env, dbdir, icmp, topts, n, Alloc(9))
    inputs = [os.path.join(dbdir, f"{m.number:06d}.sst") for m in metas]
    in_bytes = sum(m.file_size for m in metas)
    log(f"[{head}] headline inputs: {n} entries, {len(metas)} SSTs, "
        f"{in_bytes} bytes ({time.time() - t0:.1f}s)")
    job = os.path.join(dbdir, "job-headline")
    write_job_dir(job, inputs, ctype[head], job_device,
                  trace={"trace_id": "chipsmoke11", "span_id": 1,
                         "sampled": 1})
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    with ShardPrograms(torch) as programs, plane_timers() as timers:
        t0 = time.time()
        rc = worker.run_job(job)
        wall = time.time() - t0
    gc_n = kernels.gc_rows.launches
    mr_n = kernels.merge_runs_perm.launches
    res, outs, out_bytes = job_outputs(job)
    assert rc == 0 and res["status"] == "ok", res["status"]
    assert res["stats"]["pipelined"], "the headline job did not pipeline"
    if device_name != "cpu":
        assert gc_n > 0 and mr_n > 0, "a kernel of the path never launched"
    stats = CompactionStats(**res["stats"])
    mbps = n * RAW_PER_ENTRY / 1e6 / wall
    out_size = sum(len(b) for b in out_bytes)
    spans = {}  # name -> [count, seconds]
    for sp in res["spans"]:
        c = spans.setdefault(sp["name"], [0, 0.0])
        c[0] += 1
        c[1] = round(c[1] + sp["dur_us"] / 1e6, 3)
    _, busy = programs.busy(wall)
    log(f"[{head}] headline job, worker run_job on {job_device!r}: wall "
        f"{wall:.3f}s, {mbps:.2f} raw MB/s, {stats.output_records} entries "
        f"in {len(outs)} SSTs, launches gc_rows={gc_n} merge_runs={mr_n}, "
        f"{len(programs.log)} shard programs, {busy}, "
        f"prefetch_hits={stats.prefetch_hits} "
        f"prefetch_misses={stats.prefetch_misses}, phases "
        f"{json.dumps(stats.phase_dict())}, worker spans [count, seconds] "
        f"{json.dumps(spans)}; host seconds by thread/function "
        f"{timers.text()}")
    t1 = time.time()
    n_ok = check_against_oracle(env, os.path.join(job, "out"), icmp, outs,
                                rows, [])
    log(f"[{head}] headline job: {n_ok} entries match the oracle "
        f"({time.time() - t1:.1f}s)")
    serial, sstats, swall = compact(env, dbdir, icmp, topts, metas, [],
                                    device_name, Alloc(20_000),
                                    pipeline=False)
    assert not sstats.pipelined
    assert sst_bytes(dbdir, serial) == out_bytes, \
        "the serial route writes other bytes than the worker's job"
    remove_ssts(dbdir, serial)
    plain = next(j for j in main_jobs if j["label"] == "no snapshots")
    log(f"[{head}] headline job: input files {in_bytes} B, output files "
        f"{out_size} B, raw {n * RAW_PER_ENTRY} B (ratio raw/output "
        f"{n * RAW_PER_ENTRY / out_size:.3f}); serial route {swall:.3f}s, "
        f"same bytes; phase 4's uncompressed job at the same N: wall "
        f"{plain['wall_s']:.3f}s, {plain['raw_MBps']:.2f} raw MB/s, input "
        f"files {plain['in_bytes']} B, output files {plain['out_bytes']} B")
    shutil.rmtree(job)
    remove_ssts(dbdir, metas)

    # (b) the CLI in a subprocess, against an in-process twin.
    metas, _, _ = write_runs(env, dbdir, icmp, topts, n_each, Alloc(9))
    inputs = [os.path.join(dbdir, f"{m.number:06d}.sst") for m in metas]
    job = os.path.join(dbdir, "job-cli")
    twin = os.path.join(dbdir, "job-twin")
    write_job_dir(job, inputs, ctype[head], job_device)
    write_job_dir(twin, inputs, ctype[head], job_device)
    env_vars = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "toplingdb_tpu_torch.compaction.worker",
         "--job-dir", job], cwd=REPO, env=env_vars, capture_output=True,
        text=True, timeout=600)
    cli_wall = time.time() - t0
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert worker.run_job(twin) == 0
    cres, couts, cbytes = job_outputs(job)
    tres, _, tbytes = job_outputs(twin)
    assert cres["status"] == tres["status"] == "ok"
    assert cres["output_files"] == tres["output_files"] and cbytes == tbytes
    assert os.path.exists(os.path.join(job, HEARTBEAT_FILE))
    log(f"[{head}] worker CLI, {n_each} entries: exit 0 in {cli_wall:.3f}s "
        f"(process start included), the bytes of an in-process run_job, "
        f"heartbeat written")
    shutil.rmtree(job)
    shutil.rmtree(twin)
    remove_ssts(dbdir, metas)

    # (c) every codec on the card and on the CPU.
    cases = [("snappy", fmt.SNAPPY_COMPRESSION, None, have["snappy"]),
             ("lz4", fmt.LZ4_COMPRESSION, None, have["lz4"]),
             ("lz4hc", fmt.LZ4HC_COMPRESSION, None, have["lz4"]),
             ("zstd", fmt.ZSTD_COMPRESSION, None, have["zstd"]),
             ("zstd-dict", fmt.ZSTD_COMPRESSION,
              CompressionOptions(max_dict_bytes=16384), have["zstd"]),
             ("zlib", fmt.ZLIB_COMPRESSION, None, True),
             ("bz2", fmt.BZIP2_COMPRESSION, None, True),
             ("lzma", fmt.LZMA_COMPRESSION, None, True),
             ("none in, zstd out", fmt.ZSTD_COMPRESSION, None,
              have["zstd"])]
    for name, c, copts, ok in cases:
        if not ok:
            log(f"[{name}] skipped: its library is not on this host")
            continue
        cn = n_slow if name in ("bz2", "lzma") else n_each
        out_opts = TableOptions(block_size=4096, compression=c)
        if copts is not None:
            out_opts.compression_opts = copts
        in_opts = TableOptions(block_size=4096) \
            if name.startswith("none") else out_opts
        metas, rows, _ = write_runs(env, dbdir, icmp, in_opts, cn, Alloc(9))
        kernels.gc_rows.launches = 0
        kernels.merge_runs_perm.launches = 0
        o, st, w = compact(env, dbdir, icmp, out_opts, metas, [],
                           device_name, Alloc(30_000))
        c_gc, c_mr = (kernels.gc_rows.launches,
                      kernels.merge_runs_perm.launches)
        if device_name != "cpu":
            assert c_gc > 0 and c_mr > 0, \
                f"[{name}] a kernel of the path never launched"
        co, _, cw = compact(env, dbdir, icmp, out_opts, metas, [], "cpu",
                            Alloc(40_000))
        got = sst_bytes(dbdir, o)
        assert got == sst_bytes(dbdir, co), \
            f"[{name}] cuda and cpu write different bytes"
        check_against_oracle(env, dbdir, icmp, o, rows, [])
        size = sum(len(b) for b in got)
        log(f"[{name}] {cn} entries: {device_name} {w:.3f}s (pipelined="
            f"{st.pipelined}, launches gc_rows={c_gc} merge_runs={c_mr}), "
            f"cpu {cw:.3f}s, identical bytes, oracle matched, input files "
            f"{sum(m.file_size for m in metas)} B, output files {size} B")
        remove_ssts(dbdir, o)
        remove_ssts(dbdir, co)
        remove_ssts(dbdir, metas)


def zip_options(**kw):
    """bench.py's compaction_zip_out output options (bench.py:1786-1799):
    zip tables, zstd values, the default compression options."""
    from toplingdb_tpu_torch.table import format as fmt
    from toplingdb_tpu_torch.table.builder import TableOptions

    return TableOptions(format="zip", compression=fmt.ZSTD_COMPRESSION, **kw)


def counted(kernels):
    """Set both kernels' counts to 0; returns a reader of (gc_rows,
    merge_runs) launches since."""
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    return lambda: (kernels.gc_rows.launches,
                    kernels.merge_runs_perm.launches)


def formats_path(torch, env, dbdir, icmp, n_main, n_each, n_entry,
                 main_jobs, device_name="cuda"):
    """Phase 12, table formats: (a) bench.py's zip job at n_main entries
    through the pipelined plane, (b) the zip job at n_each entries on the
    card, on the CPU and on the numpy encoders, then with snapshots and
    range tombstones, (c) per-entry protection at n_each entries on the
    pipelined, serial and block-assembly routes, (d) the per-entry formats
    and options at n_entry entries, card against CPU, (e) the worker with
    zip outputs, a prefix extractor and a collector. `main_jobs`: phase
    4's jobs (its uncompressed numbers, same N)."""
    from toplingdb_tpu_torch.compaction import worker
    from toplingdb_tpu_torch.compaction.executor import (
        CompactionParams,
        table_options_from_params,
    )
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.table.builder import TableOptions
    from toplingdb_tpu_torch.utils.slice_transform import (
        FixedPrefixTransform,
    )
    from toplingdb_tpu_torch.utils.table_properties_collector import (
        CompactOnDeletionCollectorFactory,
    )

    card = device_name != "cpu"
    plain_topts = TableOptions()

    # (a) the zip headline job.
    t0 = time.time()
    metas, rows, _ = write_runs(env, dbdir, icmp, plain_topts, n_main,
                                Alloc(9))
    in_bytes = sum(m.file_size for m in metas)
    log(f"[zip] headline inputs: {n_main} entries, {len(metas)} SSTs, "
        f"{in_bytes} bytes ({time.time() - t0:.1f}s)")
    launched = counted(kernels)
    with ShardPrograms(torch) as programs, plane_timers() as timers:
        outs, stats, wall = compact(env, dbdir, icmp, zip_options(), metas,
                                    [], device_name, Alloc(10_000))
    gc_n, mr_n = launched()
    assert stats.pipelined, "the zip job did not run pipelined"
    if card:
        assert gc_n > 0, "a kernel of the path never launched"
        assert mr_n == 3 * gc_n == 3 * len(programs.log), (gc_n, mr_n)
        if n_main == MAIN_N:
            assert (gc_n, mr_n) == (32, 96), (gc_n, mr_n)
    mbps = n_main * RAW_PER_ENTRY / 1e6 / wall
    out_size = sum(m.file_size for m in outs)
    _, busy = programs.busy(wall)
    ph = stats.phase_dict()
    plain = next(j for j in main_jobs if j["label"] == "no snapshots")
    log(f"[zip] headline job (pipelined, {device_name}): wall {wall:.3f}s, "
        f"{mbps:.2f} raw MB/s, {stats.output_records} entries in "
        f"{len(outs)} SSTs, launches gc_rows={gc_n} merge_runs={mr_n}, "
        f"{busy}, encode_write_s={ph.get('encode_write_s', 0)} "
        f"pipeline_stall_s={ph.get('pipeline_stall_s', 0)}, phases "
        f"{json.dumps(ph)}; host seconds by thread/function "
        f"{timers.text()}")
    t1 = time.time()
    n_ok = check_against_oracle(env, dbdir, icmp, outs, rows, [])
    log(f"[zip] headline job: {n_ok} entries read back through "
        f"ZipTableReader.scan_columnar match the oracle "
        f"({time.time() - t1:.1f}s)")
    serial, sstats, swall = compact(env, dbdir, icmp, zip_options(), metas,
                                    [], device_name, Alloc(20_000),
                                    pipeline=False)
    assert not sstats.pipelined
    assert sst_bytes(dbdir, serial) == sst_bytes(dbdir, outs), \
        "the pipelined and serial zip routes write different bytes"
    log(f"[zip] headline job: input files {in_bytes} B, output files "
        f"{out_size} B, raw {n_main * RAW_PER_ENTRY} B (ratio raw/output "
        f"{n_main * RAW_PER_ENTRY / out_size:.3f}); serial route "
        f"{swall:.3f}s ({n_main * RAW_PER_ENTRY / 1e6 / swall:.2f} raw "
        f"MB/s), same bytes, phases {json.dumps(sstats.phase_dict())}; "
        f"phase 4's uncompressed job at the same N: wall "
        f"{plain['wall_s']:.3f}s, {plain['raw_MBps']:.2f} raw MB/s, output "
        f"files {plain['out_bytes']} B")
    remove_ssts(dbdir, outs)
    remove_ssts(dbdir, serial)
    remove_ssts(dbdir, metas)

    # (b) the zip job at n_each: card, CPU, numpy encoders; then with
    # snapshots and range tombstones.
    max_seq = n_each // 4 * 4
    snaps3 = [max_seq // 5, max_seq // 2, 4 * max_seq // 5]
    zip_b = None
    for label, snaps, n_tombs, p_del in (("plain", [], 0, 0.0),
                                          ("3 snapshots, 20 tombstones",
                                           snaps3, 20, 0.1)):
        metas, rows, tombs = write_runs(env, dbdir, icmp, plain_topts,
                                        n_each, Alloc(9), p_del=p_del,
                                        n_tombs=n_tombs)
        launched = counted(kernels)
        o, st, w = compact(env, dbdir, icmp, zip_options(), metas, snaps,
                           device_name, Alloc(30_000))
        gc_n, mr_n = launched()
        if card:
            assert gc_n > 0 and mr_n > 0, "[zip] a kernel never launched"
        got = sst_bytes(dbdir, o)
        co, _, cw = compact(env, dbdir, icmp, zip_options(), metas, snaps,
                            "cpu", Alloc(40_000))
        no, nst, nw = compact(env, dbdir, icmp, zip_options(), metas, snaps,
                              device_name, Alloc(50_000), zip_plane=False)
        assert got == sst_bytes(dbdir, co) == sst_bytes(dbdir, no), \
            f"[zip] {label}: cuda, cpu and the numpy encoders differ"
        check_against_oracle(env, dbdir, icmp, o, rows, snaps, tombs)
        log(f"[zip] {n_each} entries, {label}: {device_name} {w:.3f}s "
            f"(pipelined={st.pipelined}, launches gc_rows={gc_n} "
            f"merge_runs={mr_n}), cpu {cw:.3f}s, numpy encoders {nw:.3f}s "
            f"(pipelined={nst.pipelined}): identical bytes, oracle matched, "
            f"output files {sum(len(b) for b in got)} B")
        if zip_b is None:
            zip_b = got
        for x in (o, co, no):
            remove_ssts(dbdir, x)
        remove_ssts(dbdir, metas)

    # (c) protection on the pipelined, serial and block-assembly routes.
    metas, rows, _ = write_runs(env, dbdir, icmp, plain_topts, n_each,
                                Alloc(9), p_del=0.1)
    base, _, bw = compact(env, dbdir, icmp, plain_topts, metas, snaps3,
                          device_name, Alloc(30_000))
    want = sst_bytes(dbdir, base)
    prot = TableOptions(protection_bytes_per_key=8)
    for i, (route, kw) in enumerate((
            ("pipelined", {}), ("serial", dict(pipeline=False)),
            ("block assembly", dict(device_blocks=True, num_shards=1)))):
        launched = counted(kernels)
        sp0 = kernels.shared_prefix_lengths.launches
        o, st, w = compact(env, dbdir, icmp, prot, metas, snaps3,
                           device_name, Alloc(40_000 + 10_000 * i), **kw)
        gc_n, mr_n = launched()
        sp_n = kernels.shared_prefix_lengths.launches - sp0
        if card:
            assert gc_n > 0 and mr_n > 0, f"[protection] {route}: no launch"
            if route == "block assembly":
                assert sp_n > 0, "[protection] shared_prefix never launched"
        assert st.pipelined == (route == "pipelined")
        assert sst_bytes(dbdir, o) == want, \
            f"[protection] {route}: other bytes than the unprotected job"
        log(f"[protection] {n_each} entries, {route}: {device_name} "
            f"{w:.3f}s (every output re-read and verified; unprotected "
            f"{bw:.3f}s), launches gc_rows={gc_n} merge_runs={mr_n} "
            f"shared_prefix={sp_n}, the unprotected bytes")
        remove_ssts(dbdir, o)
    remove_ssts(dbdir, base)
    remove_ssts(dbdir, metas)

    # (d) the per-entry formats and options, card against CPU.
    cases = [
        ("two-level index, partitioned filters", plain_topts,
         TableOptions(index_type="two_level", partition_filters=True)),
        ("block, fixed-prefix extractor", plain_topts,
         TableOptions(prefix_extractor=FixedPrefixTransform(5))),
        ("collectors", plain_topts, TableOptions(
            properties_collector_factories=[
                CompactOnDeletionCollectorFactory(128, 8)])),
        ("single_fast", plain_topts, TableOptions(format="single_fast")),
        ("plain, prefix extractor", plain_topts, TableOptions(
            format="plain", prefix_extractor=FixedPrefixTransform(6))),
        ("cuckoo", plain_topts, TableOptions(format="cuckoo")),
        ("zip inputs", zip_options(), plain_topts),
    ]
    for name, in_opts, out_opts in cases:
        metas, rows, _ = write_runs(env, dbdir, icmp, in_opts, n_entry,
                                    Alloc(9), p_del=0.1)
        launched = counted(kernels)
        o, st, w = compact(env, dbdir, icmp, out_opts, metas, [],
                           device_name, Alloc(30_000))
        gc_n, mr_n = launched()
        # A prefix extractor alone keeps the job on the columnar route
        # (its writer writes a whole-key filter); the rest go per entry.
        route = "columnar" if name.startswith("block,") else "per-entry"
        if card and route == "columnar":
            assert gc_n > 0 and mr_n > 0, (name, gc_n, mr_n)
        elif card:
            assert (gc_n, mr_n) == (1, 0), (name, gc_n, mr_n)
        co, _, cw = compact(env, dbdir, icmp, out_opts, metas, [], "cpu",
                            Alloc(40_000))
        got = sst_bytes(dbdir, o)
        assert got == sst_bytes(dbdir, co), \
            f"[{name}] cuda and cpu write different bytes"
        check_against_oracle(env, dbdir, icmp, o, rows, [])
        log(f"[{name}] {n_entry} entries ({route} route): {device_name} "
            f"{w:.3f}s, launches "
            f"gc_rows={gc_n} merge_runs={mr_n}, cpu {cw:.3f}s, identical "
            f"bytes, oracle matched, output files "
            f"{sum(len(b) for b in got)} B in {len(o)} SSTs")
        remove_ssts(dbdir, o)
        remove_ssts(dbdir, co)
        remove_ssts(dbdir, metas)

    # (e) the worker: zip outputs, a prefix extractor and a collector.
    metas, rows, _ = write_runs(env, dbdir, icmp, plain_topts, n_entry,
                                Alloc(9), p_del=0.1)
    inputs = [os.path.join(dbdir, f"{m.number:06d}.sst") for m in metas]
    job = os.path.join(dbdir, "job-formats")
    os.makedirs(os.path.join(job, "out"))
    params = CompactionParams(
        job_id=12, attempt=1, dbname=dbdir,
        output_dir=os.path.join(job, "out"), input_files=inputs,
        output_level=2, bottommost=True, max_output_file_size=1 << 62,
        snapshots=[], comparator="tpulsm.BytewiseComparator",
        merge_operator=None, compaction_filter=None,
        compression=zip_options().compression, block_size=4096,
        creation_time=1, table_format="zip",
        prefix_extractor="tpulsm.FixedPrefix.4",
        collectors=[CompactOnDeletionCollectorFactory(128, 8).serialize()],
        device="cuda" if card else "cpu-jax", lease_sec=0.0)
    with open(os.path.join(job, "params.json"), "w") as f:
        f.write(params.to_json())
    launched = counted(kernels)
    t0 = time.time()
    rc = worker.run_job(job)
    wall = time.time() - t0
    gc_n, mr_n = launched()
    res, wouts, wbytes = job_outputs(job)
    assert rc == 0 and res["status"] == "ok", res["status"]
    if card:
        assert gc_n == 1, gc_n
    co, _, cw = compact(env, dbdir, icmp, table_options_from_params(params),
                        metas, [], "cpu", Alloc(40_000))
    assert wbytes == sst_bytes(dbdir, co), \
        "[worker] the job's bytes differ from the in-process cpu run"
    check_against_oracle(env, os.path.join(job, "out"), icmp, wouts, rows,
                         [])
    log(f"[worker] {n_entry} entries, zip + FixedPrefix.4 + "
        f"CompactOnDeletionCollector, run_job on {params.device!r}: status "
        f"ok in {wall:.3f}s, launches gc_rows={gc_n} merge_runs={mr_n}, the "
        f"bytes of the in-process cpu run ({cw:.3f}s), oracle matched")
    shutil.rmtree(job)
    remove_ssts(dbdir, co)
    remove_ssts(dbdir, metas)


# ---------------------------------------------------------------------------
# Phase 13: the DB on the card
# ---------------------------------------------------------------------------


def db_key(i: int, n: int) -> bytes:
    """bench.py's fillrandom / readrandom key of index i at N = n."""
    return b"%016d" % (i * 2654435761 % (2 * n))


def threaded_fill(db, n_keys, kv, n_threads=4, batch=100, pb=0) -> float:
    """bench.py's fill: n_threads writer threads, thread t writing indices
    [t * n_keys / n_threads, (t + 1) * n_keys / n_threads) in WriteBatches
    of `batch` (with per-entry protection of `pb` bytes a key), kv(i)
    giving index i's (key, value). Returns its wall."""
    from toplingdb_tpu_torch.db.write_batch import WriteBatch

    per_t = n_keys // n_threads
    errs = []

    def worker(t):
        end = (t + 1) * per_t
        try:
            for i in range(t * per_t, end, batch):
                b = WriteBatch(protection_bytes_per_key=pb)
                for j in range(i, min(i + batch, end)):
                    b.put(*kv(j))
                db.write(b)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t,))
          for t in range(n_threads)]
    t0 = time.time()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    return time.time() - t0


def crash(db) -> None:
    """Drop a DB without flushing its memtable (the WAL is synced and
    closed, the background threads joined), as a killed process leaves
    it."""
    db._compaction_scheduler.shutdown()
    db._wal.sync()
    db._wal.close()
    db.versions.close()
    db.table_cache.close()
    db._closed = True


def db_files_against_oracle(db, want, value, cf=None) -> int:
    """Every live SST of the compacted DB (of column family `cf`, a
    handle; None: the default one) read back with the port's table reader:
    one level holds them all, and their rows, in file order, are the user
    keys `want` in order, each a PUT whose value bytes equal `value`, row
    by row. With `cf`, every file's properties name that CF's id and
    name."""
    from toplingdb_tpu_torch.db import filename
    from toplingdb_tpu_torch.table.factory import open_table

    version = db.versions.cf_current(cf.id if cf is not None else 0)
    levels = [fl for fl in version.files if fl]
    assert len(levels) == 1, version.describe()
    ukeys, vtypes, vals = [], [], []
    width = len(want[0]) + 8
    for m in levels[0]:
        path = filename.table_file_name(db.dbname, m.number)
        if cf is not None:
            props = open_table(db.env.new_random_access_file(path),
                               db.icmp).properties
            assert (props.column_family_id, props.column_family_name) == \
                (cf.id, cf.name), (m.number, props.column_family_id,
                                   props.column_family_name)
        kv = scan_output(db.env, path, db.icmp)
        assert m.num_entries == kv.n
        assert np.all(kv.key_lens == width), "unexpected key length"
        assert np.all(kv.val_lens == len(value)), "unexpected value length"
        kb = kv.key_buf.reshape(kv.n, width)
        ukeys.append(kb[:, :-8])
        trailer = np.ascontiguousarray(kb[:, -8:]).view("<u8").reshape(-1)
        vtypes.append(trailer & np.uint64(0xFF))
        vals.append(kv.val_buf[kv.val_offs[:, None].astype(np.int64)
                               + np.arange(len(value))])
    ukeys, vtypes, vals = (np.concatenate(a) for a in (ukeys, vtypes, vals))
    wkeys = np.frombuffer(b"".join(want), np.uint8).reshape(len(want), -1)
    assert ukeys.shape == wkeys.shape, (ukeys.shape, wkeys.shape)
    assert np.array_equal(ukeys, wkeys), "user keys differ from the oracle"
    assert np.all(vtypes == 1), "a row is not a PUT"
    assert np.array_equal(vals, np.broadcast_to(
        np.frombuffer(value, np.uint8), vals.shape)), \
        "values differ from the oracle"
    return len(levels[0])


def db_path(torch, root, n, n_wal, device_name="cuda"):
    """Phase 13: bench.py's DB deployment through the port's DB, opened
    with its default host planes (the native group commit, the native
    point-read chain, the chunked scan plane), with its compactions on
    `device_name`; then the read, recovery and WAL-replay checks, and the
    reads again on a second handle with the native chain and the scan
    plane off. Returns the launches of the fill + compactions."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils import statistics as st

    value = b"v" * 20
    n_threads, batch = 4, 100
    per = n // n_threads
    dbdir = os.path.join(root, "db")
    factory = DeviceCompactionExecutorFactory(device=device_name)
    stats = st.Statistics()
    opts = Options(create_if_missing=True, write_buffer_size=8 << 20,
                   compaction_executor_factory=factory, statistics=stats)

    def fillrandom(db, n_keys):
        """bench.py's fill of n_keys keys; returns its wall."""
        return threaded_fill(db, n_keys, lambda i: (db_key(i, n_keys), value))

    launched = counted(kernels)
    with ShardPrograms(torch) as programs:
        t_open = time.time()
        db = DB.open(dbdir, opts)
        fill = fillrandom(db, n)
        n_auto = len(factory.jobs)
        groups = stats.get_ticker_count(st.WRITE_GROUP_LED)
        commits = stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS)
        fallbacks = stats.get_ticker_count(st.WRITE_GROUP_FALLBACKS)
        assert commits == groups > 0 and fallbacks == 0, \
            (groups, commits, fallbacks)
        log(f"[db] fillrandom {n_threads * per} keys from {n_threads} "
            f"threads in batches of {batch}: {fill:.3f}s, "
            f"{n_threads * per / fill:.0f} ops/s, {db.num_flushes} flushes, "
            f"{n_auto} device jobs during the fill; write plane: {commits} "
            f"native commits of {groups} groups, {fallbacks} fallbacks")
        t0 = time.time()
        db.flush()
        db.wait_for_compactions()
        t1 = time.time()
        db.compact_range()
        crw = time.time() - t1
        gc_n, mr_n = launched()
    _, busy = programs.busy(time.time() - t_open)
    sched = db._compaction_scheduler
    jobs = factory.jobs
    assert jobs, "no compaction ran on the device executor"
    assert sched.num_local_jobs == 0, \
        f"{sched.num_local_jobs} compactions ran on the host path"
    assert sched.last_error is None, sched.last_error
    if device_name != "cpu":
        assert gc_n >= len(jobs), (gc_n, len(jobs))
        if any(j["input_files"] > 1 for j in jobs):
            assert mr_n > 0, "no merge launch for a multi-run job"
    for k, j in enumerate(jobs):
        log(f"[db] device job {k}: L{j['level']}->L{j['output_level']}, "
            f"{j['input_files']} input files, {j['rows']} rows, "
            f"{'pipelined' if j['pipelined'] else 'serial'} route, wall "
            f"{j['wall_s']:.3f}s")
    log(f"[db] flush + wait_for_compactions {t1 - t0:.3f}s; compact_range "
        f"{crw:.3f}s, {n * DB_RAW_PER_ENTRY / 1e6 / crw:.2f} raw MB/s; "
        f"{db.num_flushes} flushes, {len(jobs)} device jobs, "
        f"{sched.num_trivial_moves} trivial moves, launches gc_rows={gc_n} "
        f"merge_runs={mr_n}; open to compact_range's end: {busy}; levels "
        f"{db.versions.current.describe()!r}")
    want = sorted(db_key(i, n) for i in range(n_threads * per))
    t0 = time.time()
    n_files = db_files_against_oracle(db, want, value)
    log(f"[db] {n_files} live SSTs read back with the table reader: "
        f"{len(want)} rows, keys, PUT types and value bytes equal to the "
        f"oracle row by row, {time.time() - t0:.3f}s")

    import random

    rng = random.Random(5)
    probes = [db_key(rng.randrange(n), n) for _ in range(min(100_000, n))]

    def counted_gets(db):
        """Wrap the instance's native chain: counts the gets it decided."""
        calls = {"native": 0, "python": 0}
        chain = db._native_get

        def spy(*a):
            r = chain(*a)
            calls["native" if r[0] else "python"] += 1
            return r

        db._native_get = spy
        return calls

    def readrandom(db, keys=probes):
        t0 = time.time()
        for k in keys:
            v = db.get(k)
            assert v == value, (k, v)
        return time.time() - t0

    def full_scan(db):
        before = stats.tickers()
        t0 = time.time()
        it = db.new_iterator()
        it.seek_to_first()
        got = 0
        for (k, v), w in zip(it.entries(), want):
            assert k == w and v == value, (k, w)
            got += 1
        wall = time.time() - t0
        assert got == len(want) and not it.valid(), (got, len(want))
        after = stats.tickers()
        return wall, {t: after.get(t, 0) - before.get(t, 0)
                      for t in (st.ITER_CHUNK_REFILLS,
                                st.ITER_CHUNK_FALLBACKS)}, it

    calls = counted_gets(db)
    rr = readrandom(db)
    assert calls == {"native": len(probes), "python": 0}, calls
    decided = calls["native"]
    served_by = ("fastget" if db._nget_tl.states[0].fast is not None
                 else "ctypes")
    assert db.get(b"%016d" % (2 * n + 1)) is None
    scan, chunks, it = full_scan(db)
    assert it._plane is not None, "the scan left the chunk plane"
    assert chunks[st.ITER_CHUNK_REFILLS] > 0, chunks
    assert chunks[st.ITER_CHUNK_FALLBACKS] == 0, chunks
    log(f"[db] planes on: readrandom {len(probes)} probes {rr:.3f}s, "
        f"{len(probes) / rr:.0f} ops/s, all found, {decided} of "
        f"{len(probes)} decided by the native chain (through {served_by}); "
        f"full scan {len(want)} keys {scan:.3f}s in order, "
        f"{chunks[st.ITER_CHUNK_REFILLS]} chunk refills, "
        f"{chunks[st.ITER_CHUNK_FALLBACKS]} fallbacks")
    t0 = time.time()
    db.close()
    # The second handle: the scan plane off by its open argument, the
    # native chain off on the instance before its first get.
    db = DB.open(dbdir, opts, iter_chunk_rows=0)
    reopen = time.time() - t0
    try:
        db._nget_lib = None
        calls = counted_gets(db)
        probes_off = probes[:DB_OFF_PROBES]
        rr_off = readrandom(db, probes_off)
        assert calls == {"native": 0, "python": len(probes_off)}, calls
        scan_off, chunks, it = full_scan(db)
        assert it._plane is None and not any(chunks.values()), chunks
    finally:
        db.close()
    log(f"[db] close + reopen (MANIFEST recovery) {reopen:.3f}s; planes "
        f"off (second handle, iter_chunk_rows=0, _nget_lib=None): "
        f"readrandom {len(probes_off)} probes {rr_off:.3f}s, "
        f"{len(probes_off) / rr_off:.0f} ops/s, all found through the "
        f"Python chain; full scan {scan_off:.3f}s through the per-entry "
        f"DBIter; planes on / off: readrandom "
        f"{rr_off / len(probes_off) / (rr / len(probes)):.2f}x a probe, scan "
        f"{scan_off / scan:.2f}x faster")

    # The write plane alone, in turns (on, off, off, on): fills of n // 5
    # keys into fresh DBs with no Statistics and no compaction, so the
    # walls are the write path's.
    walls = {True: [], False: []}
    for k, on in enumerate((True, False, False, True)):
        abdir = os.path.join(root, f"fill-ab{k}")
        ab = DB.open(abdir, Options(
            create_if_missing=True, write_buffer_size=8 << 20,
            compaction_executor_factory=factory,
            disable_auto_compactions=True), write_plane=on)
        try:
            walls[on].append(fillrandom(ab, n // 5))
        finally:
            ab.close()
        shutil.rmtree(abdir)
    log(f"[db] write plane A/B, {n // 5} keys from {n_threads} threads, no "
        f"Statistics, no compaction, in turns on/off/off/on: on "
        f"{walls[True][0]:.3f}s / {walls[True][1]:.3f}s, off "
        f"{walls[False][0]:.3f}s / {walls[False][1]:.3f}s")

    waldir = os.path.join(root, "wal")
    db = DB.open(waldir, opts)
    keys = [db_key(i, n_wal) for i in range(n_wal)]
    for i in range(0, n_wal, batch):
        b = WriteBatch()
        for k in keys[i:i + batch]:
            b.put(k, value)
        db.write(b)
    crash(db)
    assert not [f for f in os.listdir(waldir) if f.endswith(".sst")], \
        "the WAL-replay run flushed before the crash"
    t0 = time.time()
    with DB.open(waldir, opts) as db:
        replay = time.time() - t0
        for k in keys:
            assert db.get(k) == value, k
        assert db.num_flushes == 1
    log(f"[db] WAL replay: {n_wal} keys written, dropped without a flush, "
        f"reopened in {replay:.3f}s (replay + one flush), all read back")
    return gc_n, mr_n, crw


# ---------------------------------------------------------------------------
# Phase 14: distributed compaction from the port's DB
# ---------------------------------------------------------------------------


def recorded_jobs(factory):
    """Wrap `factory`'s executors so every job that came back records its
    CompactionStats' route fields. Returns the list they append to."""
    jobs = []
    make = factory.new_executor

    def new_executor(c):
        ex = make(c)
        if ex is None:
            return None
        run = ex.execute

        def execute(db, comp, snaps, alloc):
            outs, st = run(db, comp, snaps, alloc)
            jobs.append(dict(
                level=comp.level, output_level=comp.output_level,
                input_files=comp.num_input_files(), rows=st.input_records,
                remote=st.remote, device=st.device,
                work_us=st.work_time_usec, rpc_us=st.rpc_time_usec))
            return outs, st

        ex.execute = execute
        return ex

    factory.new_executor = new_executor
    return jobs


def job_events():
    """A listener that records compactions and dcompact attempts (its
    class is built here: the script imports no package code before it
    checks for a card)."""
    from toplingdb_tpu_torch.utils.listener import EventListener

    class Recorder(EventListener):
        def __init__(self):
            self.completed, self.attempts = [], []

        def on_compaction_completed(self, db, info):
            self.completed.append(info)

        def on_dcompact_attempt(self, db, info):
            self.attempts.append(info)

    return Recorder()


def dcompact_histograms(stats) -> str:
    from toplingdb_tpu_torch.utils import statistics as st

    out = []
    for name in (st.DCOMPACTION_ATTEMPT_MICROS, st.DCOMPACTION_TIME_MICROS,
                 st.DCOMPACTION_RPC_MICROS, st.DCOMPACTION_PREPARE_MICROS,
                 st.DCOMPACTION_WAITING_MICROS):
        h = stats.get_histogram(name)
        med = h.percentile(50) if h.count else 0.0
        out.append(f"{name} count {h.count} median {med:.0f}us")
    return "; ".join(out)


def small_db(path, opts, n):
    """SMALL_DB_N distinct keys with distinct values from one writer, a
    flush, then compact_range; returns the oracle."""
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch

    want = {}
    db = DB.open(path, opts)
    try:
        for i in range(0, n, 100):
            b = WriteBatch()
            for j in range(i, i + 100):
                k, v = db_key(j, n), b"%020d" % j
                b.put(k, v)
                want[k] = v
            db.write(b)
        db.flush()
        db.compact_range()
        sched = db._compaction_scheduler
        assert sched.last_error is None and db._bg_error is None
        assert sched.num_local_jobs == 0
        it = db.new_iterator()
        it.seek_to_first()
        got = list(it.entries())
        assert got == sorted(want.items()), "live entries differ"
    finally:
        db.close()
    return want


def dcompact_path(torch, root, n, n_small, in_process_crw,
                  device_name="cuda"):
    """Phase 14: (a) the in-process HTTP service at full width, (b) the
    service CLI in its own process under a fault schedule, (c) the
    subprocess transport with a killed worker and the orphan sweep."""
    import random
    import urllib.request

    from toplingdb_tpu_torch.compaction.dcompact_service import (
        DcompactWorkerService,
        HttpCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.compaction.executor import (
        SubprocessCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.compaction.resilience import (
        DcompactFaultInjector,
        DcompactOptions,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils import statistics as st

    # (a) ---------------------------------------------------------------
    value = b"v" * 20
    n_threads, batch = 4, 100
    per = n // n_threads
    svc = DcompactWorkerService(device=device_name)
    url = f"http://127.0.0.1:{svc.start(port=0)}"
    factory = HttpCompactionExecutorFactory([url], device=device_name)
    jobs = recorded_jobs(factory)
    events = job_events()
    stats = st.Statistics()
    opts = Options(create_if_missing=True, write_buffer_size=8 << 20,
                   compaction_executor_factory=factory, statistics=stats,
                   listeners=[events])

    def writer(db, t, errs):
        try:
            for i in range(0, per, batch):
                b = WriteBatch()
                for j in range(i, i + batch):
                    b.put(db_key(t * per + j, n), value)
                db.write(b)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    try:
        launched = counted(kernels)
        with ShardPrograms(torch) as programs:
            t_open = time.time()
            db = DB.open(os.path.join(root, "http"), opts)
            try:
                errs = []
                ts = [threading.Thread(target=writer, args=(db, t, errs))
                      for t in range(n_threads)]
                t0 = time.time()
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                fill = time.time() - t0
                assert not errs, errs
                db.flush()
                db.wait_for_compactions()
                t1 = time.time()
                db.compact_range()
                crw = time.time() - t1
                gc_n, mr_n = launched()
            except BaseException:
                db.close()
                raise
        _, busy = programs.busy(time.time() - t_open)
        try:
            sched = db._compaction_scheduler
            assert sched.last_error is None and db._bg_error is None
            assert sched.num_local_jobs == 0
            assert jobs, "no compaction went through the HTTP transport"
            bad = [j for j in jobs
                   if not j["remote"] or j["device"] != device_name]
            assert not bad, bad
            rewrites = [i for i in events.completed if i.device != "move"]
            assert len(rewrites) == len(jobs), (len(rewrites), len(jobs))
            assert all(i.device == device_name for i in rewrites)
            t = stats.tickers()
            assert t.get(st.DCOMPACTION_ATTEMPTS, 0) == len(jobs), t
            for name in (st.DCOMPACTION_RETRIES, st.DCOMPACTION_JOB_FAILURES,
                         st.DCOMPACTION_FALLBACK_LOCAL):
                assert t.get(name, 0) == 0, (name, t)
            if device_name == "cuda":
                assert gc_n >= len(jobs), (gc_n, len(jobs))
                if any(j["input_files"] > 1 for j in jobs):
                    assert mr_n > 0, "no merge launch for a multi-run job"
            for k, j in enumerate(jobs):
                log(f"[dcompact-http] job {k}: L{j['level']}->"
                    f"L{j['output_level']}, {j['input_files']} input files, "
                    f"{j['rows']} rows, remote on {j['device']}, "
                    f"work_time_usec {j['work_us']}, rpc_time_usec "
                    f"{j['rpc_us']}")
            want = sorted(db_key(i, n) for i in range(n_threads * per))
            n_files = db_files_against_oracle(db, want, value)
            rng = random.Random(5)
            probes = [db_key(rng.randrange(n), n) for _ in range(10_000)]
            for k in probes:
                assert db.get(k) == value, k
            log(f"[dcompact-http] fillrandom {n_threads * per} keys from "
                f"{n_threads} threads: {fill:.3f}s, "
                f"{n_threads * per / fill:.0f} ops/s; compact_range "
                f"{crw:.3f}s ({n * DB_RAW_PER_ENTRY / 1e6 / crw:.2f} raw "
                f"MB/s; phase 13's in-process compact_range "
                f"{in_process_crw:.3f}s); {len(jobs)} remote jobs, "
                f"{len(events.completed) - len(rewrites)} trivial moves, "
                f"launches gc_rows={gc_n} merge_runs={mr_n}; open to "
                f"compact_range's end: {busy}; {n_files} live SSTs equal to "
                f"the oracle row by row; 10000 probes found; service "
                f"jobs_done {svc.jobs_done}")
            log(f"[dcompact-http] {dcompact_histograms(stats)}")
        finally:
            db.close()
    finally:
        svc.stop()

    # (b) ---------------------------------------------------------------
    # Four attempts, and a breaker that stays closed through the three
    # failures (its default threshold of 3 would open it before the last).
    policy = DcompactOptions(max_attempts=4, backoff_base=0.01,
                             attempt_timeout=600.0,
                             breaker_failure_threshold=10)
    proc = subprocess.Popen(
        [sys.executable, "-m", "toplingdb_tpu_torch.compaction.dcompact_service",
         "--port", "0", "--host", "127.0.0.1", "--device", device_name],
        stdout=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on [\d.]+:(\d+)", line)
        assert m, f"no port in the service's first line: {line!r}"
        url = f"http://127.0.0.1:{m.group(1)}"
        inj = DcompactFaultInjector(
            schedule={0: "drop", 1: "truncate", 2: "corrupt", 3: "delay"})
        factory = HttpCompactionExecutorFactory([url], device=device_name,
                                                policy=policy,
                                                fault_injector=inj)
        jobs = recorded_jobs(factory)
        stats = st.Statistics()
        t0 = time.time()
        small_db(os.path.join(root, "cli"), Options(
            create_if_missing=True, write_buffer_size=1 << 20,
            disable_auto_compactions=True,
            compaction_executor_factory=factory, statistics=stats,
            dcompact=policy), n_small)
        wall = time.time() - t0
        t = stats.tickers()
        served = json.loads(urllib.request.urlopen(
            url + "/stats", timeout=60).read())
        drops = inj.injected_counts().get("drop", 0)
        assert inj.injected_counts() == {
            "drop": 1, "truncate": 1, "corrupt": 1, "delay": 1}, \
            inj.injected_counts()
        assert t.get(st.DCOMPACTION_RETRIES, 0) == 3, t
        assert t.get(st.DCOMPACTION_JOB_FAILURES, 0) == 0, t
        assert all(j["remote"] and j["device"] == device_name for j in jobs)
        assert served["jobs_done"] == t[st.DCOMPACTION_ATTEMPTS] - drops, \
            (served, t)
        assert served["device"] == device_name
        log(f"[dcompact-cli] service process on {device_name}: "
            f"{n_small} keys, {len(jobs)} job(s), attempts "
            f"{t[st.DCOMPACTION_ATTEMPTS]}, retries "
            f"{t[st.DCOMPACTION_RETRIES]} (drop, truncate, corrupt; delay "
            f"succeeds), service jobs_done {served['jobs_done']}, live "
            f"entries equal the oracle; {wall:.3f}s open to close; "
            f"{dcompact_histograms(stats)}")
    finally:
        proc.terminate()
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=60)
    assert proc.poll() is not None and rc == 0, rc
    log(f"[dcompact-cli] service process stopped (rc {rc})")

    # (c) ---------------------------------------------------------------
    policy = DcompactOptions(max_attempts=3, backoff_base=0.01,
                             attempt_timeout=600.0, lease_sec=30.0)
    inj = DcompactFaultInjector(schedule={0: "kill"})
    factory = SubprocessCompactionExecutorFactory(
        device=device_name, policy=policy, fault_injector=inj)
    jobs = recorded_jobs(factory)
    events = job_events()
    path = os.path.join(root, "subprocess")
    t0 = time.time()
    small_db(path, Options(
        create_if_missing=True, write_buffer_size=1 << 20,
        disable_auto_compactions=True, compaction_executor_factory=factory,
        statistics=st.Statistics(), dcompact=policy, listeners=[events]),
        n_small)
    wall = time.time() - t0
    killed = [a for a in events.attempts if not a.ok]
    assert inj.injected_counts() == {"kill": 1}
    assert len(killed) == 1 and "rc=137" in killed[0].error, killed
    assert killed[0].will_retry
    assert not os.path.exists(os.path.join(
        path, "dcompact", f"job-{killed[0].job_id:05d}", "att-00"))
    assert jobs and all(j["remote"] and j["device"] == device_name
                        for j in jobs)
    job_dirs = [d for d in os.listdir(os.path.join(path, "dcompact"))
                if d.startswith("job-")]
    assert job_dirs == [], job_dirs
    att = os.path.join(path, "dcompact", "job-99999", "att-00")
    os.makedirs(os.path.join(att, "out"))
    with open(os.path.join(att, "params.json"), "w") as fh:
        json.dump({"job_id": 99999, "attempt": 0}, fh)
    with open(os.path.join(att, "out", "000001.sst"), "wb") as fh:
        fh.write(b"\0" * 4096)
    with open(os.path.join(att, "heartbeat"), "w") as fh:
        fh.write("1 0.0\n")
    old = time.time() - 10 * policy.lease_sec
    for name in ("params.json", "heartbeat"):
        os.utime(os.path.join(att, name), (old, old))
    stats = st.Statistics()
    with DB.open(path, Options(
            compaction_executor_factory=factory, statistics=stats,
            dcompact=policy, disable_auto_compactions=True)):
        swept = stats.get_ticker_count(st.DCOMPACTION_ORPHANS_SWEPT)
    assert swept == 1 and not os.path.exists(att), swept
    log(f"[dcompact-subprocess] {n_small} keys: worker killed mid-job "
        f"({killed[0].error[:60]!r}), attempt dir swept, retry on "
        f"{jobs[0]['device']} ({jobs[0]['rows']} rows, work_time_usec "
        f"{jobs[0]['work_us']}, rpc_time_usec {jobs[0]['rpc_us']}), no job "
        f"dir left, {wall:.3f}s open to close; a stale attempt dir swept "
        f"on reopen (DCOMPACTION_ORPHANS_SWEPT {swept})")


# ---------------------------------------------------------------------------
# Phase 15: column families on the card
# ---------------------------------------------------------------------------

# db_bench's --num_column_families=4 names (db_bench_tool.cc
# ColumnFamilyName): the default CF and three more.
CF_NAMES = ["default"] + ["column_family_name_%06d" % i for i in (1, 2, 3)]
STATS_CF = "__tpulsm_stats__"


def cf_path(torch, root, n, n_probe=10_000, device_name="cuda"):
    """Phase 15: phase 13's DB deployment over db_bench's four column
    families, key index i in CF i % 4 inside every batch; then the
    per-CF reads and scans, the stats CF, export / import, drop and
    reopen. Returns the launches of the fill + compactions and
    compact_range's wall."""
    import random

    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.import_column_family_job import (
        export_column_family,
    )
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils import statistics as st

    value = b"v" * 20
    n_threads, batch, n_cf = 4, 100, len(CF_NAMES)
    per = n // n_threads
    dbdir = os.path.join(root, "db")
    factory = DeviceCompactionExecutorFactory(device=device_name)
    stats = st.Statistics()
    opts = Options(create_if_missing=True, write_buffer_size=8 << 20,
                   compaction_executor_factory=factory, statistics=stats)

    launched = counted(kernels)
    with ShardPrograms(torch) as programs:
        t_open = time.time()
        db = DB.open(dbdir, opts)
        handles = [db.default_cf] + [db.create_column_family(name)
                                     for name in CF_NAMES[1:]]
        ids = [h.id for h in handles]
        errs = []

        def worker(t):
            try:
                for i in range(t * per, (t + 1) * per, batch):
                    b = WriteBatch()
                    for j in range(i, i + batch):
                        b.put(db_key(j, n), value, cf=ids[j % n_cf])
                    db.write(b)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(t,))
              for t in range(n_threads)]
        t0 = time.time()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        fill = time.time() - t0
        assert not errs, errs
        n_auto = len(factory.jobs)
        groups = stats.get_ticker_count(st.WRITE_GROUP_LED)
        commits = stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS)
        fallbacks = stats.get_ticker_count(st.WRITE_GROUP_FALLBACKS)
        # Every batch spans the four CFs: every group is a Python commit,
        # as in the reference.
        assert fallbacks == groups > 0 and commits == 0, \
            (groups, commits, fallbacks)
        log(f"[cf] fillrandom {n_threads * per} keys over {n_cf} column "
            f"families (key i in CF i % {n_cf}) from {n_threads} threads in "
            f"batches of {batch}: {fill:.3f}s, {n_threads * per / fill:.0f} "
            f"ops/s, {db.num_flushes} flushes, {n_auto} device jobs during "
            f"the fill; commits: {commits} native, {fallbacks} Python of "
            f"{groups} groups")
        t0 = time.time()
        db.flush()
        db.wait_for_compactions()
        t1 = time.time()
        db.compact_range()
        crw = time.time() - t1
        gc_n, mr_n = launched()
    _, busy = programs.busy(time.time() - t_open)
    sched = db._compaction_scheduler
    jobs = factory.jobs
    assert {j["cf_id"] for j in jobs} == set(ids), \
        sorted({j["cf_id"] for j in jobs})
    assert sched.num_local_jobs == 0, \
        f"{sched.num_local_jobs} compactions ran on the host path"
    assert sched.last_error is None, sched.last_error
    if device_name != "cpu":
        assert gc_n >= len(jobs), (gc_n, len(jobs))
        if any(j["input_files"] > 1 for j in jobs):
            assert mr_n > 0, "no merge launch for a multi-run job"
    for k, j in enumerate(jobs):
        log(f"[cf] device job {k}: CF {CF_NAMES[ids.index(j['cf_id'])]}, "
            f"L{j['level']}->L{j['output_level']}, {j['input_files']} input "
            f"files, {j['rows']} rows, "
            f"{'pipelined' if j['pipelined'] else 'serial'} route, wall "
            f"{j['wall_s']:.3f}s")
    log(f"[cf] flush + wait_for_compactions {t1 - t0:.3f}s; compact_range "
        f"{crw:.3f}s, {n * DB_RAW_PER_ENTRY / 1e6 / crw:.2f} raw MB/s; "
        f"{db.num_flushes} flushes, {len(jobs)} device jobs "
        f"({', '.join(str(sum(j['cf_id'] == i for j in jobs)) for i in ids)}"
        f" by CF), {sched.num_trivial_moves} trivial moves, launches "
        f"gc_rows={gc_n} merge_runs={mr_n}; open to compact_range's end: "
        f"{busy}")
    wants = [sorted(db_key(i, n) for i in range(k, n_threads * per, n_cf))
             for k in range(n_cf)]
    t0 = time.time()
    n_files = [db_files_against_oracle(db, want, value, cf=h)
               for h, want in zip(handles, wants)]
    log(f"[cf] live SSTs read back per CF with the table reader: "
        f"{n_files} files, {[len(w) for w in wants]} rows, keys, PUT types "
        f"and value bytes equal to each CF's oracle row by row, properties "
        f"naming each CF, {time.time() - t0:.3f}s")

    rng = random.Random(5)
    probe_idx = [rng.randrange(n) for _ in range(min(100_000, n))]
    probes = [(db_key(i, n), handles[i % n_cf]) for i in probe_idx]
    calls = {"native": 0, "python": 0}
    chain = db._native_get

    def spy(*a):
        r = chain(*a)
        calls["native" if r[0] else "python"] += 1
        return r

    db._native_get = spy
    t0 = time.time()
    for k, h in probes:
        v = db.get(k, cf=h)
        assert v == value, (k, h, v)
    rr = time.time() - t0
    assert calls == {"native": len(probes), "python": 0}, calls
    decided = calls["native"]
    i0 = probe_idx[0]
    assert db.get(db_key(i0, n), cf=handles[(i0 + 1) % n_cf]) is None
    scans = []
    for h, want in zip(handles, wants):
        before = stats.tickers()
        t0 = time.time()
        it = db.new_iterator(cf=h)
        it.seek_to_first()
        got = 0
        for (k, v), w in zip(it.entries(), want):
            assert k == w and v == value, (h.name, k, w)
            got += 1
        wall = time.time() - t0
        assert got == len(want) and not it.valid(), (h.name, got)
        assert it._plane is not None, "the scan left the chunk plane"
        after = stats.tickers()
        refills = (after.get(st.ITER_CHUNK_REFILLS, 0)
                   - before.get(st.ITER_CHUNK_REFILLS, 0))
        fallbacks = (after.get(st.ITER_CHUNK_FALLBACKS, 0)
                     - before.get(st.ITER_CHUNK_FALLBACKS, 0))
        assert refills > 0 and fallbacks == 0, (h.name, refills, fallbacks)
        scans.append((wall, refills))
        del it
    log(f"[cf] readrandom {len(probes)} probes, each in its key's CF: "
        f"{rr:.3f}s, {len(probes) / rr:.0f} ops/s, all found, "
        f"{decided} decided by the native chain; full scan per CF "
        + ", ".join(f"{name} {w:.3f}s ({r} refills)"
                    for name, (w, r) in zip(CF_NAMES, scans)))

    db.persist_stats(to_db=True)
    db.persist_stats(to_db=True)
    stats_cf = db.get_column_family(STATS_CF)
    assert stats_cf is not None
    it = db.new_iterator(cf=stats_cf)
    it.seek_to_first()
    n_stats = sum(1 for _ in it.entries())
    del it
    hist = db.get_stats_history(include_persisted=True)
    assert n_stats == 2 and len(hist) >= 2, (n_stats, len(hist))

    exp = os.path.join(root, "export")
    t0 = time.time()
    meta = export_column_family(db, handles[2], exp)
    t_export = time.time() - t0
    factory2 = DeviceCompactionExecutorFactory(device=device_name)
    db2 = DB.open(os.path.join(root, "import"), Options(
        create_if_missing=True, write_buffer_size=8 << 20,
        compaction_executor_factory=factory2))
    try:
        t0 = time.time()
        h2 = db2.create_column_family_with_import(CF_NAMES[2], exp)
        t_import = time.time() - t0
        rng = random.Random(7)
        for _ in range(n_probe):
            i = rng.randrange(n)
            want = value if i % n_cf == 2 else None
            assert db2.get(db_key(i, n), cf=h2) == want, i
        # One compaction of the imported CF on the card: overwrite some
        # of its keys (same value), flush, and push them down into the
        # imported files.
        launched2 = counted(kernels)
        for i in range(2, 2 + n_cf * n_probe, n_cf * batch):
            b = WriteBatch()
            for j in range(i, i + n_cf * batch, n_cf):
                b.put(db_key(j, n), value, cf=h2.id)
            db2.write(b)
        db2.flush()
        t0 = time.time()
        db2.compact_range()
        t_icr = time.time() - t0
        gc2, mr2 = launched2()
        jobs2 = factory2.jobs
        assert jobs2 and {j["cf_id"] for j in jobs2} == {h2.id}, jobs2
        assert db2._compaction_scheduler.num_local_jobs == 0
        if device_name != "cpu":
            assert gc2 >= len(jobs2), (gc2, len(jobs2))
        db_files_against_oracle(db2, wants[2], value, cf=h2)
    finally:
        db2.close()
    log(f"[cf] export {CF_NAMES[2]} ({len(meta.files)} SSTs) {t_export:.3f}"
        f"s; import into a second DB {t_import:.3f}s, {n_probe} probes "
        f"against the oracle; {len(jobs2)} device jobs of the imported CF "
        f"(rows {[j['rows'] for j in jobs2]}, compact_range {t_icr:.3f}s, "
        f"launches gc_rows={gc2} merge_runs={mr2}), its SSTs equal to the "
        f"oracle")

    gone = db.versions.cf_current(handles[3].id)
    numbers = [f.number for _, f in gone.all_files()]
    del gone
    db.drop_column_family(handles[3])
    left = [x for x in numbers
            if os.path.exists(os.path.join(dbdir, "%06d.sst" % x))]
    assert numbers and not left, left
    t0 = time.time()
    db.close()
    db = DB.open(dbdir, opts)
    reopen = time.time() - t0
    try:
        names = [h.name for h in db.list_column_families()]
        assert names == CF_NAMES[:3] + [STATS_CF], names
        assert len(db.get_stats_history(include_persisted=True)) == 2
        rng = random.Random(9)
        for k in range(3):
            h = db.get_column_family(CF_NAMES[k])
            for _ in range(n_probe):
                key = wants[k][rng.randrange(len(wants[k]))]
                assert db.get(key, cf=h) == value, (k, key)
    finally:
        db.close()
    log(f"[cf] stats CF: 2 samples persisted and read back; "
        f"{CF_NAMES[3]} dropped, its {len(numbers)} SSTs gone from disk; "
        f"close + reopen {reopen:.3f}s: {names}, {n_probe} probes per CF")
    return gc_n, mr_n, crw


# ---------------------------------------------------------------------------
# Phases 16 and 17: the compaction styles and integrated blob files
# ---------------------------------------------------------------------------

UNIVERSAL_REASONS = {"universal size-ratio", "universal size-amp",
                     "universal merge-all", "manual universal"}


class JobLog:
    """While open, wraps a device factory's executors: per job its reason,
    level pair, input files, rows, route ("per-entry" when the job's thread
    ran the per-entry route's device sort, else "pipelined" or "serial"),
    device, outputs, wall, and the kernel launches between its start and
    end (a job's own only where no other job overlapped it). The per-entry
    route's device sort and GC mask are timed with CUDA events on a card,
    for the busy share beside ShardPrograms'."""

    def __init__(self, torch, factory, kernels):
        self.torch, self.factory, self.kernels = torch, factory, kernels
        self.jobs = []
        self.entry_events = []

    def __enter__(self):
        from toplingdb_tpu_torch.ops import compaction_kernels as ck

        torch, kernels, jobs, events = (self.torch, self.kernels, self.jobs,
                                        self.entry_events)
        tl = threading.local()
        on_card = torch is not None and torch.cuda.is_available()
        self._ck, self._sort, self._mask = ck, ck.device_sort, ck.gc_mask
        self._make = self.factory.new_executor

        def timed(fn, per_entry):
            def call(*a, **k):
                if per_entry:
                    tl.per_entry = True
                if not on_card:
                    return fn(*a, **k)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **k)
                end.record()
                events.append((start, end))
                return out
            return call

        ck.device_sort = timed(self._sort, True)
        ck.gc_mask = timed(self._mask, False)
        make = self._make

        def new_executor(c):
            ex = make(c)
            run = ex.execute

            def execute(db, comp, snaps, alloc):
                tl.per_entry = False
                g0 = kernels.gc_rows.launches
                m0 = kernels.merge_runs_perm.launches
                t0 = time.time()
                outs, st = run(db, comp, snaps, alloc)
                route = ("per-entry" if tl.per_entry else
                         "pipelined" if st.pipelined else "serial")
                jobs.append(dict(
                    reason=comp.reason, level=comp.level,
                    output_level=comp.output_level,
                    input_files=comp.num_input_files(),
                    rows=st.input_records, route=route, device=st.device,
                    outputs=len(outs), t0=t0, t1=time.time(),
                    gc=kernels.gc_rows.launches - g0,
                    merge=kernels.merge_runs_perm.launches - m0))
                return outs, st

            ex.execute = execute
            return ex

        self.factory.new_executor = new_executor
        return self

    def __exit__(self, *exc):
        self._ck.device_sort, self._ck.gc_mask = self._sort, self._mask
        self.factory.new_executor = self._make

    def entry_ms(self):
        return sum(a.elapsed_time(b) for a, b in self.entry_events)

    def check(self, device_name, tag):
        """Every job ran on `device_name`; on a card, each job that no
        other overlapped launched gc_rows, and the merge where its columnar
        route merged several input files. Logs one line a job."""
        for k, j in enumerate(self.jobs):
            j["alone"] = not any(o is not j and o["t0"] < j["t1"]
                                 and j["t0"] < o["t1"] for o in self.jobs)
            assert j["device"] == device_name, j
            if device_name != "cpu" and j["alone"]:
                assert j["gc"] >= 1, j
                if j["route"] != "per-entry" and j["input_files"] > 1:
                    assert j["merge"] >= 1, j
            log(f"[{tag}] device job {k}: {j['reason']}, L{j['level']}->"
                f"L{j['output_level']}, {j['input_files']} input runs, "
                f"{j['rows']} rows, {j['route']} route, {j['outputs']} "
                f"outputs, wall {j['t1'] - j['t0']:.3f}s, launches gc_rows="
                f"{j['gc']} merge_runs={j['merge']}"
                f"{'' if j['alone'] else ' (overlapped another job)'}")


def busy_text(programs, joblog, wall) -> str:
    ms, _ = programs.busy(wall)
    if ms is None:
        return "device busy share not measured"
    ms += joblog.entry_ms()
    return (f"{ms:.3f} ms of shard programs and per-entry device sorts and "
            f"GC masks by CUDA events, {ms / 1e3 / wall:.4f} of the wall "
            f"(device busy share, derived)")


def probe_and_scan(db, keys, value_of, n, tag, n_probe=100_000):
    """n_probe readrandom probes (bench.py's Random(5) draw over indices
    of n keys) against the oracle `value_of` (key -> value, or None where
    the key must read NotFound), then one full scan that must give the
    sorted `keys` with their values. Returns the two walls, the probe
    count and the probes found."""
    import random

    rng = random.Random(5)
    probes = [db_key(rng.randrange(n), n) for _ in range(min(n_probe, n))]
    t0 = time.time()
    found = 0
    for k in probes:
        v = db.get(k)
        assert v == value_of(k), (tag, k, None if v is None else v[:32])
        found += v is not None
    rr = time.time() - t0
    t0 = time.time()
    it = db.new_iterator()
    it.seek_to_first()
    got = 0
    for (k, v), wk in zip(it.entries(), keys):
        assert k == wk and v == value_of(wk), (tag, k, wk)
        got += 1
    scan = time.time() - t0
    assert got == len(keys) and not it.valid(), (tag, got, len(keys))
    del it
    return rr, scan, len(probes), found


def styles_path(torch, root, n, device_name="cuda"):
    """Phase 16: (a) universal compaction and (b) FIFO compaction at phase
    13's deployment. Returns the flush bytes of (a)'s fill."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.listener import EventListener

    value = b"v" * 20
    keys = sorted(db_key(i, n) for i in range(n))

    # (a) universal ----------------------------------------------------
    factory = DeviceCompactionExecutorFactory(device=device_name)
    stats = st.Statistics()
    opts = Options(
        create_if_missing=True, write_buffer_size=8 << 20,
        compaction_executor_factory=factory, statistics=stats,
        compaction_style="universal", universal_size_ratio=1,
        universal_min_merge_width=2, universal_max_merge_width=2**31 - 1,
        universal_max_size_amplification_percent=200,
        level0_file_num_compaction_trigger=4)
    launched = counted(kernels)
    with ShardPrograms(torch) as programs, \
            JobLog(torch, factory, kernels) as joblog:
        t_open = time.time()
        db = DB.open(os.path.join(root, "universal"), opts)
        fill = threaded_fill(db, n, lambda i: (db_key(i, n), value))
        n_auto = len(joblog.jobs)
        db.flush()
        db.wait_for_compactions()
        flush_bytes = stats.get_ticker_count(st.FLUSH_WRITE_BYTES)
        t1 = time.time()
        db.compact_range()
        crw = time.time() - t1
        gc_n, mr_n = launched()
        wall = time.time() - t_open
    sched = db._compaction_scheduler
    jobs = joblog.jobs
    assert jobs and len(jobs) == len(factory.jobs), (len(jobs),
                                                     len(factory.jobs))
    assert sched.num_local_jobs == 0 and sched.last_error is None, \
        (sched.num_local_jobs, sched.last_error)
    assert {j["reason"] for j in jobs} <= UNIVERSAL_REASONS, jobs
    assert jobs[-1]["reason"] == "manual universal", jobs[-1]
    assert all(j["outputs"] == 1 for j in jobs), "a universal job was cut"
    joblog.check(device_name, "universal")
    if device_name != "cpu":
        assert gc_n >= len(jobs) and mr_n > 0, (gc_n, mr_n)
    v = db.versions.current
    assert not v.files[0] and len(v.files[-1]) == 1, v.describe()
    assert not any(v.files[1:-1]), v.describe()
    log(f"[universal] fillrandom {n} keys from 4 threads in batches of 100:"
        f" {fill:.3f}s, {n / fill:.0f} ops/s, {db.num_flushes} flushes "
        f"({flush_bytes} bytes), {n_auto} device jobs during the fill; "
        f"compact_range (one manual universal job) {crw:.3f}s, "
        f"{n * DB_RAW_PER_ENTRY / 1e6 / crw:.2f} raw MB/s; {len(jobs)} "
        f"device jobs, launches gc_rows={gc_n} merge_runs={mr_n}; open to "
        f"compact_range's end: {busy_text(programs, joblog, wall)}; levels "
        f"{v.describe()!r}")
    t0 = time.time()
    db_files_against_oracle(db, keys, value)
    log(f"[universal] the last level's one SST read back with the table "
        f"reader: {n} rows equal to the oracle, {time.time() - t0:.3f}s")
    rr, scan, n_probe, found = probe_and_scan(db, keys, lambda k: value, n,
                                              "universal")
    assert found == n_probe
    log(f"[universal] readrandom {n_probe} probes {rr:.3f}s, "
        f"{n_probe / rr:.0f} ops/s, all found; full scan {n} keys "
        f"{scan:.3f}s")
    db.close()

    # (b) FIFO ---------------------------------------------------------
    class Flushes(EventListener):
        def __init__(self):
            self.files = []

        def on_flush_completed(self, db, info):
            self.files.append(info.file_number)

    budget = flush_bytes // 4
    flushes = Flushes()
    factory = DeviceCompactionExecutorFactory(device=device_name)
    opts = Options(
        create_if_missing=True, write_buffer_size=8 << 20,
        compaction_executor_factory=factory, statistics=st.Statistics(),
        compaction_style="fifo", fifo_max_table_files_size=budget,
        listeners=[flushes])
    launched = counted(kernels)
    db = DB.open(os.path.join(root, "fifo"), opts)
    fill = threaded_fill(db, n, lambda i: (db_key(i, n), value))
    db.flush()
    db.wait_for_compactions()
    gc_n, mr_n = launched()
    sched = db._compaction_scheduler
    assert sched.last_error is None, sched.last_error
    assert factory.jobs == [] and sched.num_local_jobs == 0, factory.jobs
    assert gc_n == 0 and mr_n == 0, (gc_n, mr_n)
    v = db.versions.current
    live = sorted(f.number for f in v.files[0])
    total = v.total_bytes(0)
    assert 0 < total <= budget and not any(v.files[1:]), v.describe()
    assert live == sorted(flushes.files)[-len(live):], (live, flushes.files)
    dropped = sorted(flushes.files)[:-len(live)]
    assert dropped, "FIFO dropped nothing"
    left = [x for x in dropped
            if os.path.exists(os.path.join(db.dbname, "%06d.sst" % x))]
    assert not left, left
    survivors = set()
    for f in v.files[0]:
        kv = scan_output(db.env, os.path.join(db.dbname, "%06d.sst"
                                              % f.number), db.icmp)
        survivors.update(row.tobytes()
                         for row in kv.key_buf.reshape(kv.n, -1)[:, :-8])
    rr, scan, n_probe, found = probe_and_scan(
        db, sorted(survivors), lambda k: value if k in survivors else None,
        n, "fifo")
    log(f"[fifo] fillrandom {n} keys: {fill:.3f}s, {n / fill:.0f} ops/s, "
        f"{db.num_flushes} flushes; budget {budget} bytes (a quarter of "
        f"(a)'s flush bytes): {len(live)} files, {total} bytes left, "
        f"{len(dropped)} oldest files dropped and gone from disk; "
        f"{len(factory.jobs)} device jobs, launches gc_rows={gc_n} "
        f"merge_runs={mr_n}: FIFO runs no kernel; readrandom {n_probe} "
        f"probes {rr:.3f}s, {found} found in the surviving files, "
        f"{n_probe - found} NotFound; full scan {len(survivors)} keys "
        f"{scan:.3f}s")
    db.close()
    return flush_bytes


def blob_path(torch, root, n, device_name="cuda"):
    """Phase 17: integrated blob files with blob GC: the fill and the
    overwrite with GC off (columnar blob jobs), then the DB reopened with
    the GC flags for flush, wait_for_compactions and compact_range
    (per-entry jobs with GC)."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db import blob as blob_mod
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils import statistics as st

    def old(i):
        k = db_key(i, n)
        return k, k * 64  # 1 KiB

    def new(i):
        k = db_key(i, n)
        return k, (b"o" + k[1:]) * 64

    newer = {db_key(i, n) for i in range(n // 2)}
    keys = sorted(db_key(i, n) for i in range(n))

    def value_of(k):
        return ((b"o" + k[1:]) if k in newer else k) * 64

    dbdir = os.path.join(root, "blob")
    stats = st.Statistics()
    base = dict(create_if_missing=True, write_buffer_size=64 << 20,
                statistics=stats, enable_blob_files=True, min_blob_size=256,
                blob_cache=32 << 20)
    blob_files = lambda: sorted(  # noqa: E731
        x for x in os.listdir(dbdir) if x.endswith(".blob"))
    launched = counted(kernels)
    with ShardPrograms(torch) as programs:
        factory = DeviceCompactionExecutorFactory(device=device_name)
        with JobLog(torch, factory, kernels) as fill_log:
            t_open = time.time()
            db = DB.open(dbdir, Options(compaction_executor_factory=factory,
                                        **base))
            fill = threaded_fill(db, n, old)
            over = threaded_fill(db, n // 2, new)
            db.flush()
            db.wait_for_compactions()
            n_flush, n_blob = db.num_flushes, len(blob_files())
            db.close()
        gc_factory = DeviceCompactionExecutorFactory(device=device_name)
        collectors = []
        make_gc = blob_mod.maybe_new_blob_gc

        def spy_gc(*a, **k):
            c = make_gc(*a, **k)
            if c is not None:
                collectors.append(c)
            return c

        blob_mod.maybe_new_blob_gc = spy_gc
        try:
            with JobLog(torch, gc_factory, kernels) as gc_log:
                db = DB.open(dbdir, Options(
                    compaction_executor_factory=gc_factory,
                    enable_blob_garbage_collection=True,
                    blob_garbage_collection_age_cutoff=0.25, **base))
                db.flush()
                db.wait_for_compactions()
                before = blob_files()
                t1 = time.time()
                db.compact_range()
                crw = time.time() - t1
        finally:
            blob_mod.maybe_new_blob_gc = make_gc
        gc_n, mr_n = launched()
        wall = time.time() - t_open
    sched = db._compaction_scheduler
    assert sched.num_local_jobs == 0 and sched.last_error is None, \
        (sched.num_local_jobs, sched.last_error)
    assert fill_log.jobs and gc_log.jobs
    assert all(j["route"] != "per-entry" for j in fill_log.jobs), \
        "a job of the fill took the per-entry route"
    assert all(j["route"] == "per-entry" for j in gc_log.jobs), \
        "a GC job took the columnar route"
    fill_log.check(device_name, "blob fill")
    gc_log.check(device_name, "blob gc")
    if device_name != "cpu":
        n_jobs = len(fill_log.jobs) + len(gc_log.jobs)
        assert gc_n >= n_jobs, (gc_n, n_jobs)
    targets = set()
    for c in collectors:
        targets |= c.gc_files
    after = blob_files()
    gone = ["%06d.blob" % x for x in sorted(targets)]
    assert targets and not set(gone) & set(after), (gone, after)
    v = db.versions.current
    levels = [fl for fl in v.files if fl]
    assert len(levels) == 1 and v.files[-1], v.describe()
    log(f"[blob] fillrandomblob {n} keys of 1 KiB values from 4 threads: "
        f"{fill:.3f}s, {n / fill:.0f} ops/s; overwrite of the first "
        f"{n // 2}: {over:.3f}s, {n // 2 / over:.0f} ops/s; {n_flush} "
        f"flushes, {n_blob} blob files on disk after the fill, "
        f"{len(fill_log.jobs)} device jobs of the fill (GC off)")
    log(f"[blob] reopened with GC (cutoff 0.25): compact_range {crw:.3f}s, "
        f"{n * 1040 / 1e6 / crw:.2f} raw MB/s (16-byte key, 1 KiB "
        f"value), {len(gc_log.jobs)} per-entry device jobs, "
        f"{sum(c.rewritten for c in collectors)} blobs rewritten and "
        f"{sum(c.inlined for c in collectors)} inlined; blob files "
        f"{len(before)} before, {len(after)} after, the {len(gone)} GC "
        f"targets gone from disk; launches gc_rows={gc_n} merge_runs={mr_n};"
        f" open to compact_range's end: {busy_text(programs, gc_log, wall)}"
        f" (the fill's per-entry time: {fill_log.entry_ms():.3f} ms)")
    t0 = time.time()
    rows = 0
    for m in levels[0]:
        kv = scan_output(db.env, os.path.join(dbdir, "%06d.sst" % m.number),
                         db.icmp)
        kb = kv.key_buf.reshape(kv.n, -1)
        trailer = np.ascontiguousarray(kb[:, -8:]).view("<u8").reshape(-1)
        assert np.all(trailer & np.uint64(0xFF) == 0x11), \
            "a row is not a BLOB_INDEX"
        rows += kv.n
    assert rows == n, (rows, n)
    log(f"[blob] {len(levels[0])} live SSTs read back: {rows} BLOB_INDEX rows, one "
        f"per key, {time.time() - t0:.3f}s")
    s0 = {t: stats.get_ticker_count(t) for t in (
        st.BLOB_DB_CACHE_HIT, st.BLOB_DB_CACHE_MISS,
        st.BLOB_DB_CACHE_BYTES_READ, st.BLOB_DB_CACHE_BYTES_WRITE,
        st.BLOB_DB_BLOB_FILE_BYTES_READ)}
    rr, scan, n_probe, found = probe_and_scan(db, keys, value_of, n, "blob",
                                              n_probe=BLOB_PROBES)
    assert found == n_probe
    counts = ", ".join(f"{t} {stats.get_ticker_count(t) - c}"
                       for t, c in s0.items())
    log(f"[blob] readrandom {n_probe} probes {rr:.3f}s, "
        f"{n_probe / rr:.0f} ops/s, all equal to the oracle's values; full "
        f"scan {n} keys {scan:.3f}s; probes and scan: {counts}")
    db.close()

# ---------------------------------------------------------------------------
# Phase 18: the integrity plane on the card
# ---------------------------------------------------------------------------


def integrity_path(torch, root, n, card, device_name="cuda"):
    """Phase 18: phase 13's deployment with the integrity settings users
    turn on (protection_bytes_per_key=8, crc32c file checksums, the
    background scrubber every second): the fill, the card's compactions
    with every output verified, the reads, the two verification passes,
    a corruption round trip through scrub / quarantine / resume(), and a
    fill of the same keys without protection. Returns the (gc_rows,
    merge_runs) launches from the open to compact_range's end."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db import flush_job
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.ops import device_compaction as dc
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.listener import EventListener

    value = b"v" * 20
    n_threads, batch, pb = 4, 100, 8
    per = n // n_threads
    dbdir = os.path.join(root, "db")
    factory = DeviceCompactionExecutorFactory(device=device_name)
    stats = st.Statistics()
    events = []

    class Corruptions(EventListener):
        def on_corruption_detected(self, db, info):
            events.append(info)

    base = dict(create_if_missing=True, write_buffer_size=8 << 20,
                compaction_executor_factory=factory, statistics=stats)
    opts = Options(protection_bytes_per_key=pb, file_checksum="crc32c",
                   integrity_scrub_period_sec=1, listeners=[Corruptions()],
                   **base)

    def kv(i):
        return db_key(i, n), value

    # Spies: every columnar flush's XOR fold of its export against the
    # memtable's carried fold, the per-entry walk that names a culprit,
    # every job's outputs and every verified output file.
    folds, walks, outputs, verified = [], [], [], []
    fold, walk = flush_job._columnar_protect_xor, flush_job._verify_flush_entry
    run_job, verify = dc.run_device_compaction, dc.verify_output_table

    def spy_fold(*a, **k):
        r = fold(*a, **k)
        folds.append(r)
        return r

    def spy_walk(*a, **k):
        walks.append(1)
        return walk(*a, **k)

    def spy_job(*a, **k):
        outs, jstats = run_job(*a, **k)
        outputs.extend(m.number for m in outs)
        return outs, jstats

    def spy_verify(env, path, *a, **k):
        verified.append(int(os.path.basename(path).split(".")[0]))
        return verify(env, path, *a, **k)

    flush_job._columnar_protect_xor = spy_fold
    flush_job._verify_flush_entry = spy_walk
    dc.run_device_compaction = spy_job
    dc.verify_output_table = spy_verify
    launched = counted(kernels)
    try:
        with ShardPrograms(torch) as programs:
            t_open = time.time()
            db = DB.open(dbdir, opts)
            fill = threaded_fill(db, n, kv, n_threads, batch, pb=pb)
            groups = stats.get_ticker_count(st.WRITE_GROUP_LED)
            commits = stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS)
            fallbacks = stats.get_ticker_count(st.WRITE_GROUP_FALLBACKS)
            assert commits == groups > 0 and fallbacks == 0, \
                (groups, commits, fallbacks)
            n_fill_flush = db.num_flushes
            t0 = time.time()
            db.flush()
            db.wait_for_compactions()
            t1 = time.time()
            db.compact_range()
            crw = time.time() - t1
            gc_n, mr_n = launched()
        _, busy = programs.busy(time.time() - t_open)
    finally:
        flush_job._columnar_protect_xor = fold
        flush_job._verify_flush_entry = walk
        dc.run_device_compaction = run_job
        dc.verify_output_table = verify
    sched = db._compaction_scheduler
    jobs = factory.jobs
    assert jobs, "no compaction ran on the device executor"
    assert sched.num_local_jobs == 0 and sched.last_error is None, \
        (sched.num_local_jobs, sched.last_error)
    assert db._bg_error is None, db._bg_error
    assert len(folds) == db.num_flushes and None not in folds, \
        (len(folds), db.num_flushes)
    assert not walks, f"{len(walks)} flush entries took the per-entry walk"
    assert outputs and sorted(verified) == sorted(outputs), \
        (sorted(outputs), sorted(verified))
    if device_name != "cpu":
        assert gc_n >= len(jobs), (gc_n, len(jobs))
        if any(j["input_files"] > 1 for j in jobs):
            assert mr_n > 0, "no merge launch for a multi-run job"
    log(f"[integrity] fillrandom {n_threads * per} keys from {n_threads} "
        f"threads in protected batches of {batch} (protection 8): "
        f"{fill:.3f}s, {n_threads * per / fill:.0f} ops/s; {commits} "
        f"native protected commits of {groups} groups, {fallbacks} "
        f"fallbacks; {n_fill_flush} flushes in the fill [{card}]")
    for k, j in enumerate(jobs):
        log(f"[integrity] device job {k}: L{j['level']}->"
            f"L{j['output_level']}, {j['input_files']} input files, "
            f"{j['rows']} rows, {'pipelined' if j['pipelined'] else 'serial'}"
            f" route, wall {j['wall_s']:.3f}s, outputs verified per entry "
            f"[{card}]")
    log(f"[integrity] flush + wait_for_compactions {t1 - t0:.3f}s; "
        f"compact_range {crw:.3f}s, {n * DB_RAW_PER_ENTRY / 1e6 / crw:.2f} "
        f"raw MB/s; {db.num_flushes} flushes, each through the handoff "
        f"check ({len(folds)} XOR folds equal to the carried fold, 0 "
        f"per-entry walks); {len(jobs)} device jobs, {len(outputs)} outputs"
        f", all {len(verified)} verified; launches gc_rows={gc_n} "
        f"merge_runs={mr_n}; open to compact_range's end: {busy} [{card}]")
    want = sorted(db_key(i, n) for i in range(n_threads * per))
    n_files = db_files_against_oracle(db, want, value)

    import random

    rng = random.Random(5)
    probes = [db_key(rng.randrange(n), n) for _ in range(min(100_000, n))]
    calls = {"native": 0, "python": 0}
    chain = db._native_get

    def spy_get(*a):
        r = chain(*a)
        calls["native" if r[0] else "python"] += 1
        return r

    db._native_get = spy_get
    t0 = time.time()
    for k in probes:
        assert db.get(k) == value, k
    rr = time.time() - t0
    assert calls == {"native": len(probes), "python": 0}, calls
    before = stats.tickers()
    t0 = time.time()
    it = db.new_iterator()
    assert it._plane is not None and it._plane._prot_bank is not None
    it.seek_to_first()
    got = 0
    for (k, v), w in zip(it.entries(), want):
        assert k == w and v == value, (k, w)
        got += 1
    scan = time.time() - t0
    assert got == len(want) and not it.valid(), (got, len(want))
    after = stats.tickers()
    delta = {t: after.get(t, 0) - before.get(t, 0) for t in (
        st.ITER_CHUNK_REFILLS, st.ITER_CHUNK_FALLBACKS,
        st.INTEGRITY_PROTECTION_MISMATCHES)}
    assert delta[st.ITER_CHUNK_REFILLS] > 0, delta
    assert delta[st.ITER_CHUNK_FALLBACKS] == 0, delta
    assert delta[st.INTEGRITY_PROTECTION_MISMATCHES] == 0, delta
    log(f"[integrity] {n_files} live SSTs read back row by row against "
        f"the oracle; readrandom {len(probes)} probes {rr:.3f}s, "
        f"{len(probes) / rr:.0f} ops/s, all decided by the native chain; "
        f"full scan {got} keys {scan:.3f}s through the chunk plane with "
        f"its protection bank: {delta[st.ITER_CHUNK_REFILLS]} refills, "
        f"{delta[st.ITER_CHUNK_FALLBACKS]} fallbacks, "
        f"{delta[st.INTEGRITY_PROTECTION_MISMATCHES]} mismatches [{card}]")
    del it

    t0 = time.time()
    res = db.verify_file_checksums()
    vfc = time.time() - t0
    assert res["files_verified"] >= n_files and res["files_skipped"] == 0, \
        res
    t0 = time.time()
    db.verify_checksum()
    vc = time.time() - t0
    scrubber = db._integrity_scrubber
    deadline = time.time() + 30
    while scrubber.passes == 0 and time.time() < deadline:
        time.sleep(0.1)
    bg_passes = scrubber.passes
    assert bg_passes >= 1, "the background scrubber ran no pass"
    # The round trip below scrubs by hand, with a scrubber of its own (a
    # stopped scrubber's passes end at once).
    scrubber.stop()
    db._integrity_scrubber = None
    live_bytes = sum(f.file_size for _, f in db.versions.current.all_files())
    log(f"[integrity] verify_file_checksums {vfc:.3f}s over "
        f"{res['files_verified']} files, {res['bytes_verified']} bytes "
        f"(crc32c); verify_checksum {vc:.3f}s over {live_bytes} bytes "
        f"(every block and its CRC); the background scrubber ran "
        f"{bg_passes} passes, the last {scrubber.last_pass_micros / 1e6:.3f}s"
        f" [{card}]")

    # The corruption round trip.
    victim = db.versions.current.files[-1][len(
        db.versions.current.files[-1]) // 2]
    path = os.path.join(dbdir, "%06d.sst" % victim.number)
    with open(path, "rb") as f:
        orig = f.read()
    buf = bytearray(orig)
    buf[len(buf) // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(buf)
    t0 = time.time()
    rep = db.scrub()
    scrub_wall = time.time() - t0
    assert [c["file_number"] for c in rep["corruptions"]] == \
        [victim.number], rep["corruptions"]
    assert rep["quarantined"] == [victim.number], rep
    assert stats.get_ticker_count(st.INTEGRITY_CORRUPTIONS_DETECTED) == 1
    assert [e.file_number for e in events] == [victim.number]
    blocked = None
    try:
        db.put(b"blocked", value)
    except Exception as e:  # noqa: BLE001 - the HARD latch
        blocked = e
    assert blocked is not None and "background error pending" in str(
        blocked), f"a put went through the quarantine latch: {blocked!r}"
    assert db._bg_error_severity.name == "HARD_ERROR"
    blocked = type(blocked).__name__
    with open(path, "wb") as f:
        f.write(orig)
    rep2 = db.scrub()
    assert not rep2["corruptions"] and rep2["repaired"] == \
        [victim.number], rep2
    db.resume()
    db.put(b"resumed", value)
    assert db.get(b"resumed") == value
    log(f"[integrity] corruption round trip: one byte of {victim.number:06d}"
        f".sst flipped; scrub {scrub_wall:.3f}s ({rep['files_scanned']} "
        f"files, {rep['bytes_verified']} bytes verified) quarantined "
        f"exactly it, INTEGRITY_CORRUPTIONS_DETECTED 1, "
        f"on_corruption_detected fired; a put raised {blocked}; bytes "
        f"restored, the re-scrub repaired it; resume(), a put and its get "
        f"[{card}]")
    db.close()

    # The same keys without protection, scrubber or checksums on, for the
    # fill's wall.
    offdir = os.path.join(root, "off")
    off_factory = DeviceCompactionExecutorFactory(device=device_name)
    off = DB.open(offdir, Options(
        create_if_missing=True, write_buffer_size=8 << 20,
        compaction_executor_factory=off_factory,
        statistics=st.Statistics()))
    try:
        fill_off = threaded_fill(off, n, kv, n_threads, batch)
    finally:
        off.close()
    shutil.rmtree(offdir)
    log(f"[integrity] fill A/B in one call, {n_threads * per} keys: "
        f"protection 8 + crc32c checksums + 1 s scrubber {fill:.3f}s "
        f"({n_threads * per / fill:.0f} ops/s), unprotected {fill_off:.3f}s "
        f"({n_threads * per / fill_off:.0f} ops/s), {fill / fill_off:.2f}x "
        f"[{card}]")
    return gc_n, mr_n


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from toplingdb_tpu_torch import native
    from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
    from toplingdb_tpu_torch.env import PosixEnv
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.table.builder import TableOptions

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = card_line()
    log(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    host = {}
    th = threading.Thread(target=lambda: host.update(
        lib=native.lib(), fastget=native.fastget()))
    th.start()
    secs = kernels.build()
    th.join()
    assert host.get("lib") is not None, "native host library failed to build"
    log(f"build: kernels {json.dumps({k: round(v, 1) for k, v in secs.items()})}"
        f" s, total {time.time() - t0:.1f}s; the point read's fastget "
        f"extension {'built' if host['fastget'] else 'unavailable (ctypes)'}")

    walls = {"build": round(time.time() - t0, 1)}

    def phase(name, fn, *args):
        """Runs one phase and keeps its wall for the summary line."""
        t = time.time()
        out = fn(*args)
        walls[name] = round(time.time() - t, 1)
        return out

    results = phase("3 kernels", kernel_phase, torch, device)
    phase("shard", shard_phase, torch, device)

    dbdir = os.path.join(REPO, "_smoke")
    shutil.rmtree(dbdir, ignore_errors=True)
    os.makedirs(dbdir)
    env = PosixEnv()
    icmp = InternalKeyComparator()
    topts = TableOptions()
    try:
        launches, _jobs = phase("4 main", main_path, torch, env, dbdir,
                                icmp, topts, MAIN_N)
        blk_launches, _bjobs = phase("5 blocks", blocks_path, torch, env,
                                     dbdir, icmp, topts, BLOCKS_N)
        phase("6 varlen", varlen_path, torch, env, dbdir, icmp, topts,
              VARLEN_N, VARLEN_PLAIN_N)
        phase("7 tombstones", tombstone_path, torch, env, dbdir, icmp,
              topts, TOMB_N)
        phase("8 plain", device_vs_plain, env, dbdir, icmp, topts, PLAIN_N)
        phase("9 complex", complex_path, torch, env, dbdir, icmp, topts,
              COMPLEX_N, smi)
        phase("10 entries", entries_path, torch, env, dbdir, icmp, topts,
              ENTRIES_N, smi)
        phase("11 codecs", compressed_path, torch, env, dbdir, icmp, MAIN_N,
              CODEC_N, SLOW_CODEC_N, _jobs)
        phase("12 formats", formats_path, torch, env, dbdir, icmp, MAIN_N,
              FORMAT_N, ENTRY_N, _jobs)
        _gc, _mr, db_crw = phase("13 db", db_path, torch,
                                 os.path.join(dbdir, "db13"), DB_N, DB_WAL_N)
        phase("14 dcompact", dcompact_path, torch,
              os.path.join(dbdir, "db14"), DB_N, SMALL_DB_N, db_crw)
        phase("15 cf", cf_path, torch, os.path.join(dbdir, "db15"), DB_N)
        phase("16 styles", styles_path, torch, os.path.join(dbdir, "db16"),
              DB_N)
        phase("17 blob", blob_path, torch, os.path.join(dbdir, "db17"),
              BLOB_N)
        int_gc, int_mr = phase("18 integrity", integrity_path, torch,
                               os.path.join(dbdir, "db18"), INTEGRITY_N, smi)
        log(f"[integrity] phase 18 wall {walls['18 integrity']:.1f}s "
            f"[{smi}]")
    finally:
        shutil.rmtree(dbdir, ignore_errors=True)
        shutil.rmtree(dbdir + "_cpu", ignore_errors=True)

    # Launches on each kernel's own main path: the pipelined plane for
    # gc_rows and the merge, the block-assembly route for shared_prefix.
    launches["shared_prefix"] = blk_launches["shared_prefix_lengths"]
    # Phase 18's protected DB runs gc_rows and the merge on its own path.
    launches["gc_rows"] += int_gc
    launches["merge_runs"] += int_mr
    for name, r in results.items():
        r["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"phase walls (s): {json.dumps(walls)}")
    log(f"chip_smoke total wall: {time.time() - t_start:.1f}s")
    log(smi)
    log(json.dumps({"kernels": [{k: r[k] for k in keys}
                                for r in results.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
