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
     is summed over the job's wall as the device's busy share. The job
     without snapshots also runs through the host twins (host_sort=True:
     the pipelined host route, the native run merge with its inline GC per
     shard): no kernel launch, the device route's bytes; its wall, raw MB/s
     and host_compute_usec beside the card route's;
  5. the block-assembly route: the same generator at N = 4,000,000 (one
     shard of at most 2^22 rows, the route's envelope) through
     run_device_compaction(device_name="cuda", device_blocks=True,
     num_shards=1), without and with 3 snapshots; each output matches the
     oracle and the serial packed-download route's bytes for the same
     inputs, and all three kernels launch;
  6. variable-length keys: 2,000,000 entries (cut from 4,000,000 when
     phase 23 came, to keep the script inside its limit) in 4 presorted
     runs with YCSB
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
  9. complex groups: a 500,000-entry job of db_bench's mergerandom kind
     (cut from 2,000,000 to 1,000,000 when phase 20 came and to 500,000
     when phase 23 came, to keep the script inside its limit; the host
     fold is ~90% of the job)
     (60% Put, 20% Merge with the uint64add operator, 10% Delete, 10%
     SingleDelete) with 8 range tombstones, without and with 3 snapshots:
     the pipeline's attempt gives up on the complex groups, the serial
     route runs 2 shards at p = 2^18 and folds the groups on the host;
     "cuda" and "cpu" write identical bytes, the entries equal the port's
     CompactionIterator over the host-sorted inputs, and the per-entry
     route is never entered;
 10. the per-entry route: a 500,000-entry job (cut from 1,000,000 when
     phase 23 came) with 5% empty values and
     10% BLOB_INDEX rows (1 KiB values in two blob files) and 3 snapshots,
     first on the columnar route (blob_refs equal to the CPU route's),
     then with RemoveEmptyValueCompactionFilter and blob GC (age cutoff
     0.5, min_blob_size 512) on the per-entry route, one gc_rows launch at
     p = 2^19: "cuda" and "cpu" write identical SST and blob bytes, every
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
     250,000-entry job (CODEC_N, cut from 1,000,000 to 500,000 when
     phase 23 came and to 250,000 when phase 24 came):
     exit code 0, the bytes of an in-process run_job
     of a copy of the job dir, the heartbeat file written. (c) every codec
     the host has (snappy, lz4, lz4hc, zstd, zstd with a 16 KiB
     dictionary, zlib at CODEC_N entries; bz2 and lzma at 200,000) on
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
     FORMAT_N = 600,000 entries (cut from 1,000,000 when phase 23 came;
     the pipeline needs more than 2^19 rows) on "cuda", "cpu" and with
     zip_plane=False
     (identical bytes), then with 3 snapshots and 20 range tombstones, the
     same. (c) protection_bytes_per_key=8 at FORMAT_N entries on the
     pipelined, serial and block-assembly routes: each route's bytes equal
     the unprotected job's, and its kernels launch. (d) at ENTRY_N =
     100,000 entries each (cut from 200,000 when phase 27 came: the
     seven cases ran card and CPU twins of 1.6-2.4 s each at 200K, ~25 s
     of the phase, and half the rows run the same per-entry code),
     "cuda" against "cpu" (identical bytes, the oracle, one gc_rows
     launch on the per-entry route): a two-level index with partitioned
     filters, a fixed-prefix extractor on the block format (the columnar
     route), a CompactOnDeletionCollector, single_fast, plain with a
     prefix extractor, cuckoo, and zip inputs. (e) a job dir with
     table_format "zip", prefix_extractor "tpulsm.FixedPrefix.4" and a
     collector, written with the port's CompactionParams, through run_job
     on "cuda" at ENTRY_N entries: status ok, the oracle, and the bytes of
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
     125,000 keys (cut from 250,000 when phase 26 came: a slow host's
     whole run took 1,140.0 s, phase 17 133.9 s of it; before that cut
     from 1,000,000: at 1M the phase alone took 319.8 s
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
     = 200,000 keys, cut from 1,000,000 to keep the script inside its
     limit, to 500,000 with phase 20 added, to 300,000 with phase 22 and
     to 200,000 with phase 24,
     since the jobs' Python output verification costs ~10 us a row;
     from 4 threads in batches of 100,
     8 MiB write buffer, leveled, the "cuda" device factory, a Statistics, the default
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
 19. the rest of the write path on the card, each DB on phase 13's
     settings (8 MiB write buffer, leveled, the "cuda" device factory, a
     Statistics, the default planes) unless said otherwise, the gc_rows
     and merge counts set to 0 before each open:
     (a) the CSPP-role trie (bench.py's fillrandom_cspp_ops_s row):
     memtable_rep="cspp", WRITE_N = 500,000 (cut from 1,000,000 when
     phase 24 came, to keep the script inside its limit) 16-digit keys
     with 20-byte
     values from 4 threads in batches of 100; every group a native commit
     into the trie, every flush one tpulsm_trie_export; flush,
     wait_for_compactions, compact_range, every job on "cuda" with gc_rows
     launched; every live SST read back against the oracle; then
     WRITE_OVERLAY_N = 20,000 keys rewritten into the trie memtable, and
     100,000 readrandom probes (bench.py's Random(5) draw), every one
     decided by the native chain through its trie branch, and a full scan
     through the chunk plane; then crash() and a reopen whose WAL replay
     into a trie memtable (one trie export) gives the same reads;
     (b) unordered writes (bench.py's fillrandom_unordered_ops_s row):
     unordered_write=True, allow_concurrent_memtable_write=True on the
     skiplist, the same fill, compact_range and read-back;
     (c) ToplingDB's published write deployment (SURVEY.md:506, db_bench
     fillrandom at 45.3M ops/s): memtable_rep="cspp", unordered_write,
     allow_concurrent_memtable_write and WriteOptions(disable_wal=True),
     WRITE_N 8-byte keys (bench.py's index permutation, packed
     big-endian) with 20-byte values in batches of 500; 4 writer threads,
     cut from the source's 64 because the writers are Python threads;
     compact_range on "cuda", every key read back (the SSTs against the
     oracle, and a scan);
     (d) pipelined writes through the async WAL (bench.py's
     fillrandom_sync_ops_s rows): enable_pipelined_write=True,
     enable_async_wal=True, WRITE_SYNC_N = 20,000 keys (bench.py's
     n // 50) from 4 threads with WriteOptions(sync=True) in protected
     batches of 100 and 1,000 on the checkout's disk, and the inline-fsync
     twin in the same call; WRITE_GROUP_FSYNCS_COALESCED above 0, and a
     reopen reads every acknowledged key;
     (e) a WriteBufferManager of 4 MiB (half of one write buffer) shared
     by two DBs of (a)'s shape filled at once, WBM_N = 100,000 keys each:
     the budget forces flushes of memtables below their write buffer,
     flush() leaves a residual charge under 4096 bytes a DB, close() none.
     Fills' walls and ops/s, flushes, each job's rows, route and wall,
     compact_range's wall and raw MB/s, (a)'s readrandom ops/s and scan
     wall, (d)'s fsyncs and coalesced fsyncs and the card's busy share are
     printed beside the card's name and power limit. Its gc_rows and merge
     launches are added to the kernels line's counts.

 20. the read path on the card: (a) multireadrandom (bench.py:1531-1541)
     on phase 13's deployment, its compacted DB reopened from disk (built
     anew at READ_N = 1,000,000 keys when absent): READ_OVERLAY_N = 20,000
     keys rewritten with their own value, compact_range on "cuda", then
     READ_PROBES = 100,000 probes (bench.py's Random(5) draw) as multi_get
     batches of 128, equal to the per-key gets and the fill's oracle, with
     the share of keys the native whole-batch call decided; (b) the same
     DB reopened with a user block cache, so its reads take the Python
     chain: LRUCache(8 MiB, db_bench's --cache_size, about a fifth of the
     data) over a PersistentCache(64 MiB), READ_CACHE_PROBES = 4,000 gets
     and 4,000 keys of multi_get (cut from 100,000, as phase 13's
     planes-off probes were, from 20,000 when phase 23 came and from
     8,000 when phase 27 came: each of the three caches' gets and
     multi_gets ran 2.1-2.8 s at 8,000 on the Python chain, ~16 s of the
     phase); the
     tier closed and reopened recovers the
     same index and serves every record from disk with its bytes; then
     the DB over the recovered tier; then a SimCache(ClockCache(8 MiB,
     secondary=CompressedSecondaryCache(32 MiB)), 64 MiB) with a
     BlockCacheTracer, whose analyzer's hit count equals the cache's own
     (clock hits + tier hits); every answer equal to (a)'s; (c) the cold
     async twin (bench.py:1158-1232): COLD_N = 30,000 keys filled with a
     128 KiB write buffer (its jobs on "cuda"), a DelayedReadEnv of
     200 us, LRUCache(64 KiB), COLD_PROBES = 2,048 probes in multi_get
     batches of 128 (cut from 4,096 when phase 27 came: the synchronous
     twin reads ~870 keys a second through its 200 us delays, so the
     three rounds and the async_io pass spent ~20 s of the phase on it),
     async_reads=True and False in 3 interleaved rounds
     with equal views; get_async, multi_get_async and
     ReadOptions(async_io=True) on the same probes, and full scans plain,
     with readahead_size=256 KiB and with ring windows, all equal; no
     reader-ring thread after close(); (d) every job of the phase on
     "cuda", gc_rows launched. Printed beside the card's name and power
     limit: compact_range's wall, both multireadrandom and readrandom
     ops/s, the native share, each cache's gets and multi_get ops/s and
     hit rates, the tiers' stats, the BLOCK_CACHE_* and PERSISTENT_CACHE_*
     tickers, the analyzer's counts, both cold-twin ops/s, their ratio,
     READ_ASYNC_BATCHES and READ_ASYNC_COALESCED, the scans' walls and the
     card's busy share from open to the last read. Its gc_rows and merge
     launches are added to the kernels line's counts.
 21. the DB's manual and introspection entry points and its WAL plane, on
     phase 13's deployment (MANUAL_N = 750,000 16-digit keys, cut from
     1,000,000 when phase 27 came: a later run on a slow host passed 950
     s, and the phase's two full scans and its fill take ~15 s at 1M; at
     750K the 5% slice still holds whole 512 KiB files; with
     20-byte values from 4 threads in batches of 100, 8 MiB write buffer,
     leveled, the "cuda" device factory; SSTs of 512 KiB, so that a 5% key
     slice holds whole files, and an L0 trigger of 16, so that the jobs
     set_options starts come from the marks): (a) the fill with auto
     compactions off, so L0 piles up; compact_files of the older half of
     L0 into L1, then of two L1 files into L2; suggest_compact_range over
     the middle third of the key space, then
     set_options({"disable_auto_compactions": False}), whose jobs run
     while tpulsm.threads is polled (each pick logged: the first has
     marked inputs with L0 below its trigger); delete_range over a 5%
     slice, delete_files_in_range over it (whole files dropped) and
     compact_range over it (RocksDB's recipe, which clears the boundary
     data and the tombstone); each call's wall, device jobs and input /
     output bytes (COMPACT_READ_BYTES / COMPACT_WRITE_BYTES) printed;
     MANUAL_PROBES = 100,000 probes (bench.py's Random(5) draw) through
     multi_get batches of 128 (the share the native whole-batch call took)
     and a full scan equal the oracle; pause_background_work, a
     MANUAL_OVERLAY_N = 100,000-key overlay and write_stall_state ("none",
     not drainable), continue_background_work, wait, the state again and
     the probes again; (b) on the same DB: get_approximate_sizes over 64
     equal key ranges beside the live bytes of those ranges (the scan's
     keys in each times the live bytes an entry), the whole key range
     within 20% of tpulsm.estimate-live-data-size; every get_property
     name; the backup recipe: disable_file_deletions, get_live_files and
     get_sorted_wal_files, the files copied with the MANIFEST truncated at
     manifest_file_size, enable_file_deletions, and the copy opened on
     "cuda" scans equal to the source; the DB reopened with the uint64add
     operator (which takes scans off the chunk plane, so only here) for a
     MANUAL_MERGE_N = 10,000-key merge overlay (a put, flushed, then two
     merges) read back by get_merge_operands as [base, 1, 2];
     promote_l0(6) on a second DB filled in 10 disjoint sequential runs
     with a flush after each (10,000 probes and a reopen); (c) db_bench's
     fillrandom of RECYCLE_N = 500,000 keys (cut from MANUAL_N when phase
     27 came: the two fills of 1M keys, the reopen and its scan took ~20 s
     of the phase, and at 500K the fill still spans several recycled
     WALs) from 4 writers with
     recycle_log_file_num=2 and with 0 (ops/s and the WALs reused, counted
     at the env's reuse_writable_file), the recycled DB dropped without a
     flush and reopened, so that recovery reads its recycled WALs (the
     live one a reused file): 20,000 probes and a full scan equal the
     oracle; a fill of MANUAL_N / 5 keys with wal_ttl_seconds=3600:
     get_wal_files lists archived and live WALs, the archive aged with
     os.utime, and the next switch purges it; (d) every job of the phase
     on "cuda", gc_rows launched by each job that no other overlapped; the
     launches and the card's busy share from open to the last read printed
     beside the card's name and power limit. Its gc_rows and merge
     launches are added to the kernels line's counts.
 22. the storage-pressure plane, the seqno-to-time mapping and
     wide-column entities, every DB on phase 13's deployment (8 MiB write
     buffer, leveled, 16-digit keys with 20-byte values from 4 writers in
     batches of 100, the "cuda" device factory): (a) RocksDB's
     SstFileManager with SetMaxAllowedSpaceUsage and a paced trash deleter
     (include/rocksdb/sst_file_manager.h): a shared
     SstFileManager(bytes_per_sec_delete=64 MiB/s) through
     Options.sst_file_manager with max_allowed_space_usage B =
     STORAGE_BUDGET_X = 1.5 x the raw bytes of STORAGE_N = 1,000,000 keys
     (36 MB), the DB's default flush headroom (2 write buffers) and
     free_space_poll_period_sec=0.05; the fill gets compactions refused and
     a flush refused by the preflight (a SOFT no_space latch; the writers
     whose writes raised wait and write again), then B is raised to 4B:
     the latch clears with no resume() call and card jobs run; the levels
     passed, NO_SPACE_PREFLIGHT_BLOCKS, NO_SPACE_ERRORS, the time to
     recover, the tracked bytes against the bytes on disk, and every
     acked key read back; (b) the plain-DB leg of toplingdb_tpu's disk-full
     soak (tests/test_disk_pressure.py:475) on FaultInjectionEnv(
     PosixEnv()) with set_disk_budget("*", FULL_BUDGET_X = 0.8 x the raw
     bytes), FULL_N = 200,000 keys (cut from 1,000,000: the budget must be
     reached and refilled): the fill until a genuine ENOSPC (torn short
     writes) and a SOFT no_space latch, every acked key read while
     latched, add_disk_budget, the auto-clear, FULL_POST_N = 20,000 more
     keys, flush and compact_range on the card, a reopen on a plain
     PosixEnv against the oracle; (c) RocksDB's tiered-storage option
     preclude_last_level_data_seconds = 3600
     (include/rocksdb/advanced_options.h): PRECLUDE_N = 500,000 keys (cut
     from STORAGE_N when phase 27 came: at 1M the part took ~25 s, 11.5 s
     of it the fill) and a 1% delete
     overlay, compact_range on the card (young data: every last-level
     file keeps smallest_seqno > 0 and every tombstone, rows equal the
     oracle by db_files_against_oracle), an OVERLAY_PRECLUDE_N = 50,000-key
     re-put overlay, close, the SEQNO_TIME.json samples moved back 7200 s,
     reopen, compact_range again: the bottommost job zeroes every seqno and
     drops the tombstones, rows equal the oracle; (d) RocksDB's
     DB::PutEntity / GetEntity (include/rocksdb/db.h): ENTITY_N = 100,000
     entities of three 20-byte columns, the default one included (cut
     from 1,000,000 to 250,000: every entity group takes the Python
     commit; and to 100,000 when phase 24 came), a
     ENTITY_MERGE_N = 10,000-key string-append merge overlay (the complex
     fold), compact_range on the card, ENTITY_PROBES = 5,000 get_entity
     probes (cut from 20,000 when phase 27 came: 20,000 get_entity probes
     and their multi_get twin took 7.8-13.2 s on the Python chain), the same
     keys through multi_get and a scan with columns()
     against the oracle; (e) every job of the phase on "cuda"; the
     launches and the card's busy share. Its gc_rows and merge launches
     are added to the kernels line's counts.
 23. user-defined timestamps, read replicas, tailers and repair, every
     DB on phase 13's deployment and the "cuda" device factory: (a)
     RocksDB's user-defined timestamps as db_bench's
     --user_timestamp_size=8 runs them (tools/db_bench_tool.cc), with
     Options(comparator=U64_TS_BYTEWISE): TS_N = 100,000 keys (cut from
     1,000,000 to 500,000: every job of the DB takes the per-entry route,
     and at 1M the part took over 230 s on the H100's host; then to
     100,000 when phase 24 came: at 500K the part took 156.4 s on a slow
     host, and the script passed its limit) at ts 1-1,000 (one a batch
     of 100), 20%
     overwritten at ts TS_OVERWRITE_BASE = 20,001-30,000;
     increase_full_history_ts_low(20,000) and compact_range on the card:
     the live SSTs hold TS_N + the overwrites rows, each against the
     oracle (ts_files_against_oracle); TS_PROBES = 20,000 get_with_ts
     probes at the newest ts and 20,000 gets at ReadOptions(timestamp=
     20,000), a scan at that ts, against a dict oracle; the trim raised
     above every ts (after one new version of the smallest and the
     largest key, so that compact_range, which pushes data down, reaches
     the last level) and compact_range again: TS_N rows left; a reopen
     keeps the trim point and a read below it raises InvalidArgument;
     every job of the part per-entry, each launching gc_rows; (b)
     RocksDB's secondary instance and tailing iterator: a primary fills
     REPLICA_N = 500,000 keys (cut from 1,000,000 when phase 24 came)
     in 10 rounds with a fifth writer's
     LOG_N = 100,000 sequential log/ keys; a SecondaryDB opened at the
     start catches up after every round and reads SECONDARY_READS = 2,000
     acked keys, with the primary's background work paused (a secondary
     pins none of the primary's files, so a job that ends after the
     catch-up could delete a table it is about to open); a
     ReadOptions(tailing=True) iterator in a reader thread, polling every
     TAIL_POLL_S, sees every log key once, in order; after close,
     ReadOnlyDB.open serves RO_PROBES = 20,000 probes and a full scan
     against the oracle and refuses a put; a DB with an 8-byte fixed
     prefix extractor (PREFIX_N = 100,000 keys, 10 a prefix) answers
     PREFIX_SEEKS = 1,000 prefix_same_as_start seeks with the rest of the
     seek's prefix; (c) RocksDB's RepairDB on a copy of (b)'s DB with its
     MANIFEST and CURRENT deleted: the report and wall, every key against
     the oracle, compact_range on the card; (d) every job of the phase on
     "cuda"; the launches and the card's busy share. Its gc_rows and
     merge launches are added to the kernels line's counts.
 24. the SidePlugin deployment on the card: phase 13's deployment (8 MiB
     write buffer, leveled, L0 trigger 4, 16-digit keys with 20-byte
     values from 4 writers in batches of 100) opened by
     SidePluginRepo.open_db from a JSON config (ToplingDB's SidePlugin
     and rockside's config) naming the "device" factory on "cuda", a
     10-bit bloom filter, a default Statistics with a 60 s histogram
     window, trace_sample_every 1000, a latency SLO on DB_GET_MICROS and
     a stall SLO, and slo_eval_period_sec 1, served by start_http(0):
     (a) a poller GETs /metrics, /slo, /health, /db and /levels every
     0.5 s during the fill (every answer a 200 that parses); after
     flush, wait_for_compactions and compact_range, /levels equals the
     version's files, /stats carries COMPACT_WRITE_BYTES > 0, /metrics
     the tpulsm_slo_* gauges and the _recent quantiles (its scrape
     timed), /traces the sampled flush and compaction trees, POST /scrub
     a pass with no corruption, and options_to_config of the open DB
     equals the config; (b) the op trace (RocksDB's DB::StartTrace,
     trace_replay/trace_replay.cc) from before the fill: a mix of
     SP_GETS gets, SP_OVERWRITE_N = 20,000 overwrites in batches of 100,
     SP_SEEKS = 1,000 seeks of 10 nexts and SP_MGETS = 1,000 multi_gets
     of 32 keys, then end_trace and the same gets untraced; the
     analyzer's counts per op equal the calls made; a Replayer (one
     thread, fast_forward) into a second DB opened from the same config
     on the card, whose full scan equals the first's row for row; the
     fill under the trace keeps its native commits; (c) a third DB of
     SP_STALL_N = 200,000 keys with level0_slowdown_writes_trigger 2,
     level0_file_num_compaction_trigger 4 and slo_window_sec 2, filled
     in rounds until /slo reads firing, must read resolved within 3
     windows after the writers stop and the jobs drain, with an
     on_slo_alert listener seeing both transitions and SLO_ALERTS_FIRED /
     RESOLVED each at least 1; (d) SP_DEBUG_N = 100,000 keys of (a)'s
     deployment with the async WAL and the 1 s scrubber, filled with
     lock debug off and then on (utils.concurrency.set_debug): no
     LockInversionError, a lock-order graph with edges and no cycle, no
     lock held over 1 s, and registry.check_leaks(owner=db) empty after
     every close; (e) every job of the phase on "cuda", gc_rows launched
     by each job that no other overlapped, the launches and the card's
     busy share. SP_N was cut from 250,000 to 100,000 and SP_GETS
     from 50,000 to 20,000 when phase 26 came (a slow host's whole run
     took 1,140.0 s, phase 24 101.5 s of it); from 500,000 to 250,000
     when phase 25 came (a slow host's whole run took 1,101.6 s, phase 24 109.7 s of
     it, its replay 59.8 s); before that SP_N was cut from
     1,000,000 to 500,000 and SP_GETS from
     100,000 to 50,000 (the mix first, then N) when the
     phase first took 102.8 s at full size on the card: the replay of
     the fill's 10,200 batches alone took 41.4 s, since a batch read
     back from a trace takes the Python commit (as in the reference),
     and the whole script would have passed 1,050 s on a slow host.
     Printed: the fill's ops/s with the trace on beside phase 13's
     (off), readrandom ops/s with the trace on and off, the replay's
     ops/s, a /metrics scrape's wall, the microseconds of one
     SLOEngine.evaluate pass, the fill's ops/s with lock debug on and
     off, and each figure beside the card's name and power limit. Its
     gc_rows and merge launches are added to the kernels line's counts.
 25. the parallel plane (placement on one card; it measures no
     multi-card scaling): (a) the mesh route: phase 4's generator at
     PARALLEL_N = 2,000,000 entries, no snapshots, through the serial route
     in PARALLEL_SHARDS = 8 shards on the card alone; then with the card's
     own device list (mesh_devices=[cuda:0], one entry: one
     `single-device` mesh fallback), with the card named twice
     (mesh_devices=[cuda:0, cuda:0]: the plan's placement and its
     UPLOAD_DEPTH x 2 window on real CUDA uploads) on the serial route and
     on the pipelined route (the per-entry lookahead), and with a wedge
     injected through ops/mesh_compaction's fault seam at shard 3 (one
     mesh_fallbacks, the shards moved to the other entry). Every run
     writes the single-device bytes; the gc_rows and merge launches of
     the mesh runs (counts set to 0 before them) are added to the kernels
     line's counts. (b) distributed GC (parallel/distributed_gc.py) on
     NCCL at world size 1: a (jobs=1, range=1) mesh over a file store in
     the run's scratch directory, a DGC_ROWS = 2^20-row job (12-digit
     keys, values, deletions and merges) with 3 snapshots and tombstone
     covers; its keep / zero_seq / sorted idx / is_complex arrays equal
     the same call on a gloo CPU mesh in the same process bitwise, and
     the step's CUDA-event time (median of 5) is printed beside the
     card's name and power limit. (c) the driver pair
     (parallel/entry.py) with its defaults: entry()'s forward step runs
     on the card (one gc_rows launch, added to the kernels line's counts)
     and equals the same step on "cpu" bitwise; dryrun_multichip(1) runs
     one NCCL rank and checks its jobs against the single-device GC.
 26. the utilities, the CompactionService and the wrapper Envs, on phase
     13's deployment (8 MiB memtables, leveled, 16-digit keys, 20-byte
     values; every compaction on "cuda" through one
     DeviceCompactionExecutorFactory under a JobLog, or through the
     service): (a) db_bench's randomtransaction shape: a pessimistic
     TransactionDB (write_committed), 4 writer threads, each transaction
     putting 100 keys, TXN_N = 200,000 keys (cut from 1,000,000 for
     time), compact_range on the card, 20,000 gets and a full scan
     against a dict oracle; a write_prepared TransactionDB: WP_TXNS =
     500 2PC transactions of 100 keys (cut from 1,000; set_name, prepare,
     commit; 4
     threads), a snapshot taken while 10 of them are prepared, their
     commit, flush and compact_range on the card: the snapshot reads
     every pre-transaction value of those 10 (their guards parked in the
     jobs' snapshot lists), the live scan the new ones; then 5
     transactions prepared, the DB closed and reopened, the 5 recovered,
     3 committed and 2 rolled back, every key checked; (b) a
     CKPT_OVERLAY_N = 20,000-key overlay flushed over (a)'s compacted
     level, create_checkpoint of (a)'s live DB, opened on the card and
     compact_range there: its scan equals the source's; two
     BackupEngine backups, the second after BACKUP_MORE_N = 10,000 more
     writes (the SSTs the two share printed), verify, restore of the
     second, opened, its scan equals the source's; (c) SstFileWriter
     writes 4 external files of INGEST_N = 50,000 sorted keys (cut from
     100,000), two
     interleaved with (a)'s key range, two past it; ingest_external_file
     of each, compact_range on the card, 20,000 gets and the scan against
     the oracle in which ingested values win; (d) a TtlDB of TTL_N =
     50,000 keys (cut from 200,000: TtlDB.put is a single-key write,
     7,907 a second from one writer on the card's host, and single-key
     writes from several Python threads convoy on the group commit: 4,099
     a second) whose injected clock
     expires the first half: compact_range's jobs all take the per-entry
     route on the card, one gc_rows launch a job that no other
     overlapped, no expired key survives, the survivors are the
     oracle's; (e) a DB of SVC_N = 200,000 keys whose jobs run through
     CompactionServiceExecutorFactory(InProcessCompactionService(),
     device="cuda") launches both kernels and scans equal to its twin on
     the device executor; one job of a SVC_SUB_N = 20,000-key DB's L0
     files through SubprocessCompactionService (python -m
     toplingdb_tpu_torch.compaction.compaction_service) exits 0 on the
     card; (f) ENC_N = 200,000 keys over EncryptedEnv(PosixEnv(),
     CTRCipher(...)): fill, flush, compact_range on the card, no 16-digit
     run (a plaintext key) in any file on disk; reopened with the key,
     ENC_GETS = 2,000 gets (the Python chain, which decrypts every block
     it reads) and a full scan equal the oracle; the wrong key raises
     Corruption; IO_N = 100,000 keys over IOTracingEnv filled and
     compacted, the parsed per-op counts printed. Each part prints its
     walls, rates and launches beside the card's name and power limit;
     the phase's gc_rows and merge launches are added to the kernels
     line's counts. The cuts of WP_TXNS, INGEST_N and TTL_N (to 100,000
     first, then 50,000) came after a slow host's whole run took
     1,140.0 s, phase 26 76.7 s of it: 2PC runs 82-286 transactions a
     second on the card host's disk, an ingest rewrites each entry, and
     TtlDB puts run ~7,700-8,400 a second.
 27. the shared SST store and the replication plane, on phase 13's
     deployment (bench.py's db_path_rows, bench.py:1366-1420: 8 MiB
     memtables, leveled, 16-digit keys, 20-byte values, 4 writers in
     batches of 100; every compaction on "cuda" through one
     DeviceCompactionExecutorFactory under a JobLog, or through the
     subprocess worker on "cuda") under ToplingDB's two data-sharing
     deployments: dcompact's shared storage (compaction_job.cc:921-1152)
     and RocksDB's secondary instance (db_impl_secondary.cc). STORE_N =
     REPL_N = 100,000 keys, cut from bench.py's 1,000,000 for the time
     limit (to 200,000 first; then to 100,000, the first cut when a whole
     run passed 950 s: 1,020.2 s on a slow host, phase 27 38.5 s of it),
     each fill in 4 flushed rounds (at these sizes an 8 MiB memtable
     never fills; the flushes give L0 its trigger of 4, so the card
     compacts during the fill). (a) A DB on Options(shared_store=<run
     dir>/store): fill (its last round left in the memtable), then
     compact_range on the card (its flush makes L0's fourth file and its
     jobs run on the card); STORE_PUBLISHES
     at least the live tables, every live SST's address in the store and
     verify_payload passed on its bytes, STORE_GETS = 20,000 gets and a
     full scan equal a dict oracle; the fill's ops/s, compact_range's
     wall, its jobs and launches and the /store/<name> view's counts
     printed. (b) A STORE_OVERLAY_N = 20,000-key overlay, then
     create_checkpoint of the live DB in reference mode: 0 SST bytes in
     its directory, its refs table names every table; restore_to a new
     directory, opened on the store, compact_range on the card (the
     tables materialize through the cache tier); its scan equals the
     source's; both walls printed. (c) STORE_MORE_N = 20,000 more keys
     and a flush, then one job (compact_files of L0 with the level
     beneath) through SubprocessCompactionExecutorFactory(device="cuda")
     in store mode: the job dir holds 0 SST bytes when the worker ends,
     the outputs come back as store_addr and are adopted, the worker's
     results name its device and route, the scan equals the oracle; beside
     it, at the same time, the same job in path mode on a twin DB of the
     same writes without the store: both jobs' rpc_time_usec and
     work_time_usec printed. (d) A StoreServer over the store and a
     second DB on shared_store="http://127.0.0.1:<port>" from a
     reference-mode restore: STORE_HTTP_GETS = 2,000 gets and a scan
     equal the oracle, every fetch over HTTP; STORE_MISSES,
     STORE_BYTES_FETCHED and the STORE_FETCH_MICROS median printed. (e)
     (b)'s checkpoint and restore dropped, mark_sweep over the two DBs
     still open: only unreferenced addresses go (STORE_GC_SWEPT printed),
     and each root reopens with the scan of its oracle. (f) A primary of
     REPL_N keys with the device executor, a FollowerDB sharing its
     directory and a standalone FollowerDB through HttpTransport ->
     ReplicationServer, both tailing every 50 ms while 4 writers fill and
     the card compacts: the lag (primary sequence minus applied sequence)
     sampled every 100 ms, its median and max and the time to zero after
     the fill stops; REPL_GETS = 20,000 gets through ReplicaRouter, each
     batch's keys read with its token RYW_DELAY = 25 batches later, all
     reading their own writes (the share served by followers printed);
     both followers' scans equal the primary's; a third, standalone
     follower opened after the primary's WAL GC bootstraps from a
     checkpoint; the primary closed, POST /promote on a SidePluginRepo
     promotes the shared follower, which takes REPL_PROMOTE_N = 10,000
     writes and runs compact_range on the card. Every figure is printed
     beside the card's name and power limit; the phase's gc_rows and
     merge launches are added to the kernels line's counts. Past 950 s in
     all, phase 27's own sizes are the first to cut. To make room, phases
     12 and 20-22 were cut when it came: ENTRY_N (12), READ_CACHE_PROBES
     and COLD_PROBES (20), RECYCLE_N (21), PRECLUDE_N and ENTITY_PROBES
     (22), each named at its phase.

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
VARLEN_N = 2_000_000     # phase 6, cut from 4,000,000 (docstring)
VARLEN_PLAIN_N = 1_000_000
TOMB_N = 1_000_000
PLAIN_N = 1_000_000
COMPLEX_N = 500_000     # phase 9, cut from 2,000,000 (docstring)
ENTRIES_N = 500_000     # phase 10, cut from 1,000,000 (docstring)
CODEC_N = 250_000       # phase 11 (b) and (c), cut from 1,000,000
SLOW_CODEC_N = 200_000  # phase 11 (c): bz2 and lzma
FORMAT_N = 600_000      # phase 12 (b) and (c), cut from 1,000,000
ENTRY_N = 100_000       # phase 12 (d) and (e): cut from 200,000 (docstring)
DB_N = 1_000_000        # phase 13: bench.py's BENCH_DB_N
DB_WAL_N = 50_000       # phase 13: the WAL-replay run
DB_RAW_PER_ENTRY = 36   # phase 13: 16B key + 20B value
SMALL_DB_N = 200_000    # phase 14 (b) and (c)
BLOB_N = 125_000        # phase 17, cut from DB_N (see its docstring)
BLOB_PROBES = 20_000    # phase 17's probes, cut from 100,000 (docstring)
DB_OFF_PROBES = 20_000  # phase 13's planes-off probes, cut from 100,000
INTEGRITY_N = 200_000   # phase 18: phase 13's deployment, cut (docstring)
WRITE_N = 500_000       # phase 19 (a)-(c): cut from 1,000,000 (docstring)
WRITE_OVERLAY_N = 20_000  # phase 19 (a): keys rewritten into the trie
WRITE_SYNC_N = 20_000   # phase 19 (d): bench.py's sync rows, n // 50
WBM_N = 100_000         # phase 19 (e): keys a DB
WBM_BUDGET = 4 << 20    # phase 19 (e): half of one 8 MiB write buffer
READ_N = 1_000_000      # phase 20 (a)-(b): phase 13's deployment
READ_OVERLAY_N = 20_000  # phase 20 (a): keys rewritten before compact_range
READ_PROBES = 100_000   # phase 20 (a): multireadrandom probes
READ_CACHE_PROBES = 4_000  # phase 20 (b): cut from 100,000 (docstring)
COLD_N = 30_000         # phase 20 (c): bench.py's cold async twin
COLD_PROBES = 2_048     # phase 20 (c): cut from 4,096 (docstring)
MANUAL_N = 750_000      # phase 21: cut from 1,000,000 (docstring)
MANUAL_OVERLAY_N = 100_000  # phase 21 (a): keys written while paused
MANUAL_PROBES = 100_000  # phase 21 (a): probes through multi_get
MANUAL_MERGE_N = 10_000  # phase 21 (b): the uint64add merge overlay
MANUAL_TARGET_FILE = 512 << 10  # phase 21: SST size (docstring)
RECYCLE_N = 500_000     # phase 21 (c): cut from MANUAL_N (docstring)
STORAGE_N = 1_000_000   # phase 22 (a) and (c): phase 13's deployment
STORAGE_BUDGET_X = 0.85  # phase 22 (a): B over the raw bytes (docstring)
FULL_N = 200_000        # phase 22 (b): cut from 1,000,000 (docstring)
FULL_BUDGET_X = 0.8     # phase 22 (b): the fault env's budget over raw
FULL_POST_N = 20_000    # phase 22 (b): keys written after the recovery
OVERLAY_PRECLUDE_N = 50_000  # phase 22 (c): the re-put overlay
PRECLUDE_N = 500_000    # phase 22 (c): cut from STORAGE_N (docstring)
ENTITY_N = 100_000      # phase 22 (d): cut from 1,000,000 (docstring)
ENTITY_MERGE_N = 10_000  # phase 22 (d): the merge overlay
ENTITY_PROBES = 5_000   # phase 22 (d): cut from 20,000 (docstring)
TS_N = 100_000          # phase 23 (a): cut from 1,000,000 (docstring)
TS_OVERWRITE_BASE = 20_001  # phase 23 (a): the overwrites' first ts
TS_PROBES = 20_000      # phase 23 (a): get_with_ts probes and ts gets
REPLICA_N = 500_000     # phase 23 (b): cut from 1,000,000 (docstring)
LOG_N = 100_000         # phase 23 (b): the fifth writer's log/ keys
SECONDARY_READS = 2_000  # phase 23 (b): reads after each catch-up
TAIL_POLL_S = 0.02      # phase 23 (b): the tailer's wait at the end
RO_PROBES = 20_000      # phase 23 (b): the read-only open's probes
PREFIX_N = 100_000      # phase 23 (b): keys of the prefix DB
PREFIX_SEEKS = 1_000    # phase 23 (b): prefix_same_as_start seeks
SP_N = 100_000          # phase 24 (a)-(b): cut from 1,000,000 (docstring)
SP_GETS = 20_000        # phase 24 (b): cut from 100,000 (docstring)
SP_OVERWRITE_N = 20_000  # phase 24 (b): overwrites, in batches of 100
SP_SEEKS = 1_000        # phase 24 (b): seeks, 10 nexts each
SP_MGETS = 1_000        # phase 24 (b): multi_gets of 32 keys
SP_STALL_N = 200_000    # phase 24 (c): the stalled DB's keys
SP_DEBUG_N = 100_000    # phase 24 (d): the lock-debug DB's keys
FIGURES = {}            # phase 13's fill ops/s, printed beside phase 24's
MANUAL_L0_TRIGGER = 16  # phase 21: L0 jobs start from marks (docstring)
PARALLEL_N = 2_000_000  # phase 25 (a): phase 4's generator, 8 shards
PARALLEL_SHARDS = 8     # phase 25 (a)
DGC_ROWS = 1 << 20      # phase 25 (b): the distributed GC job's rows
TXN_N = 200_000         # phase 26 (a): cut from 1,000,000 (docstring)
WP_TXNS = 500           # phase 26 (a): cut from 1,000 (docstring)
BACKUP_MORE_N = 10_000  # phase 26 (b): writes between the two backups
INGEST_N = 50_000       # phase 26 (c): cut from 100,000 (docstring)
TTL_N = 50_000          # phase 26 (d): cut from 200,000 (docstring)
SVC_N = 200_000         # phase 26 (e): the service DB's keys
SVC_SUB_N = 20_000      # phase 26 (e): the CLI job's DB
ENC_N = 200_000         # phase 26 (f): the encrypted DB's keys
IO_N = 100_000          # phase 26 (f): the traced DB's keys
ENC_GETS = 2_000        # phase 26 (f): gets on the encrypted DB
CKPT_OVERLAY_N = 20_000  # phase 26 (b): keys rewritten before the checkpoint
STORE_N = 100_000       # phase 27 (a)-(e): cut from 1,000,000 (docstring)
STORE_GETS = 20_000     # phase 27 (a): gets against the oracle
STORE_OVERLAY_N = 20_000  # phase 27 (b): keys rewritten before the checkpoint
STORE_MORE_N = 20_000   # phase 27 (c): keys written before the dcompact job
STORE_HTTP_GETS = 2_000  # phase 27 (d): gets on the HTTP store's DB
REPL_N = 100_000        # phase 27 (f): cut from 1,000,000 (docstring)
REPL_GETS = 20_000      # phase 27 (f): read-your-writes gets via the router
REPL_PROMOTE_N = 10_000  # phase 27 (f): writes into the promoted DB
RYW_DELAY = 25          # phase 27 (f): batches between a write and its reads


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
        if not snaps:
            host_twin_run(torch, env, dbdir, icmp, topts, metas, outputs, n,
                          wall, stats, device_name)
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


def host_twin_run(torch, env, dbdir, icmp, topts, metas, dev_outputs, n,
                  dev_wall, dev_stats, device_name):
    """Phase 4's host-twin job: the same inputs through the pipelined host
    route (host_sort=True: the native run merge with its inline GC per
    shard); no kernel may launch, and the bytes must be the device
    route's."""
    from toplingdb_tpu_torch.ops import kernels

    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    outs, hstats, hwall = compact(env, dbdir, icmp, topts, metas, [],
                                  device_name, Alloc(30_000), host_sort=True)
    assert hstats.pipelined, "the host twins did not run pipelined"
    assert kernels.gc_rows.launches == kernels.merge_runs_perm.launches == 0
    assert sst_bytes(dbdir, outs) == sst_bytes(dbdir, dev_outputs), \
        "the host twins and the device route write different bytes"
    card = card_line() if device_name != "cpu" else "cpu rehearsal"
    log(f"main path job (no snapshots, host twins, host_sort=True): wall "
        f"{hwall:.3f}s, {n * RAW_PER_ENTRY / 1e6 / hwall:.2f} raw MB/s, "
        f"host_compute_usec={hstats.host_compute_usec}, the device route's "
        f"bytes; the device route: wall {dev_wall:.3f}s, "
        f"{n * RAW_PER_ENTRY / 1e6 / dev_wall:.2f} raw MB/s, "
        f"host_compute_usec={dev_stats.host_compute_usec}, "
        f"device_wait_usec={dev_stats.device_wait_usec} [{card}]")
    remove_ssts(dbdir, outs)


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


def threaded_fill(db, n_keys, kv, n_threads=4, batch=100, pb=0,
                  wopts=None) -> float:
    """bench.py's fill: n_threads writer threads, thread t writing indices
    [t * n_keys / n_threads, (t + 1) * n_keys / n_threads) in WriteBatches
    of `batch` (an int, or a tuple of sizes taken in turn; with per-entry
    protection of `pb` bytes a key) written with `wopts` (None: the
    defaults), kv(i) giving index i's (key, value). Returns its wall."""
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import WriteOptions

    per_t = n_keys // n_threads
    sizes = batch if isinstance(batch, tuple) else (batch,)
    wopts = wopts or WriteOptions()
    errs = []

    def worker(t):
        end = (t + 1) * per_t
        try:
            i, k = t * per_t, 0
            while i < end:
                b = WriteBatch(protection_bytes_per_key=pb)
                stop = min(i + sizes[k % len(sizes)], end)
                for j in range(i, stop):
                    b.put(*kv(j))
                db.write(b, wopts)
                i, k = stop, k + 1
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


def db_files_against_oracle(db, want, value, cf=None, tombstones=()) -> int:
    """Every live SST of the compacted DB (of column family `cf`, a
    handle; None: the default one) read back with the port's table reader:
    one level holds them all, and their rows, in file order, are the user
    keys `want` in order, each a PUT whose value bytes equal `value`, row
    by row. With `tombstones` (user keys, kept by a job that was not
    bottommost), the rows are `want` and `tombstones` merged in order,
    each of those a DELETE with an empty value. With `cf`, every file's
    properties name that CF's id and name."""
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
        kb = kv.key_buf.reshape(kv.n, width)
        ukeys.append(kb[:, :-8])
        trailer = np.ascontiguousarray(kb[:, -8:]).view("<u8").reshape(-1)
        t = trailer & np.uint64(0xFF)
        vtypes.append(t)
        put = t == 1
        assert np.all(kv.val_lens[put] == len(value)), \
            "unexpected value length"
        assert np.all(kv.val_lens[~put] == 0), "a tombstone has a value"
        vals.append(kv.val_buf[kv.val_offs[put][:, None].astype(np.int64)
                               + np.arange(len(value))])
    ukeys, vtypes, vals = (np.concatenate(a) for a in (ukeys, vtypes, vals))
    rows = sorted([(k, 1) for k in want] + [(k, 0) for k in tombstones])
    wkeys = np.frombuffer(b"".join(k for k, _ in rows), np.uint8).reshape(
        len(rows), -1)
    assert ukeys.shape == wkeys.shape, (ukeys.shape, wkeys.shape)
    assert np.array_equal(ukeys, wkeys), "user keys differ from the oracle"
    assert np.array_equal(vtypes, np.array([t for _, t in rows],
                                           dtype=np.uint64)), \
        "a row's type differs from the oracle (PUT / DELETE)"
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
        FIGURES["13 fill ops/s"] = n_threads * per / fill
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


# ---------------------------------------------------------------------------
# Phase 19: the rest of the write path on the card
# ---------------------------------------------------------------------------


def count_trie_exports():
    """Wraps NativeTrieRep.export_columnar (tpulsm_trie_export): returns
    the list of its results, True where a flush got a columnar export,
    and a restore callable."""
    from toplingdb_tpu_torch.db.memtable import NativeTrieRep

    orig = NativeTrieRep.export_columnar
    got = []

    def spy(self):
        r = orig(self)
        got.append(r is not None)
        return r

    NativeTrieRep.export_columnar = spy

    def restore():
        NativeTrieRep.export_columnar = orig

    return got, restore


def native_get_calls(db):
    """Wraps the instance's native chain: counts the gets it decided."""
    calls = {"native": 0, "python": 0}
    chain = db._native_get

    def spy(*a):
        r = chain(*a)
        calls["native" if r[0] else "python"] += 1
        return r

    db._native_get = spy
    return calls


def write_fill_part(torch, root, tag, n, kv, card, device_name, extra,
                    batch=100, wopts=None, raw_per_key=DB_RAW_PER_ENTRY):
    """One fill of phase 19 into a fresh DB on phase 13's settings plus
    `extra` Options fields: the fill from 4 threads, flush,
    wait_for_compactions and compact_range under a JobLog (every job on
    `device_name`, gc_rows launched). Returns the open DB, its Statistics
    and the (gc_rows, merge_runs) launches."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils import statistics as st

    factory = DeviceCompactionExecutorFactory(device=device_name)
    stats = st.Statistics()
    opts = Options(create_if_missing=True, write_buffer_size=8 << 20,
                   compaction_executor_factory=factory, statistics=stats,
                   **extra)
    launched = counted(kernels)
    with ShardPrograms(torch) as programs, \
            JobLog(torch, factory, kernels) as joblog:
        t_open = time.time()
        db = DB.open(os.path.join(root, tag), opts)
        fill = threaded_fill(db, n, kv, 4, batch, wopts=wopts)
        n_fill_flush = db.num_flushes
        t0 = time.time()
        db.flush()
        db.wait_for_compactions()
        t1 = time.time()
        db.compact_range()
        crw = time.time() - t1
        gc_n, mr_n = launched()
        wall = time.time() - t_open
    sched = db._compaction_scheduler
    assert joblog.jobs, f"[{tag}] no compaction ran on the device executor"
    assert sched.num_local_jobs == 0 and sched.last_error is None, \
        (tag, sched.num_local_jobs, sched.last_error)
    assert db._bg_error is None, db._bg_error
    joblog.check(device_name, f"write {tag}")
    if device_name != "cpu":
        assert gc_n >= len(joblog.jobs), (tag, gc_n, len(joblog.jobs))
    groups = stats.get_ticker_count(st.WRITE_GROUP_LED)
    commits = stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS)
    fallbacks = stats.get_ticker_count(st.WRITE_GROUP_FALLBACKS)
    log(f"[write {tag}] fill {n} keys from 4 threads in batches of "
        f"{batch}: {fill:.3f}s, {n / fill:.0f} ops/s; {commits} native "
        f"commits of {groups} groups, {fallbacks} fallbacks; "
        f"{n_fill_flush} flushes in the fill [{card}]")
    log(f"[write {tag}] flush + wait_for_compactions {t1 - t0:.3f}s; "
        f"compact_range {crw:.3f}s, {n * raw_per_key / 1e6 / crw:.2f} raw "
        f"MB/s; {db.num_flushes} flushes, {len(joblog.jobs)} device jobs, "
        f"launches gc_rows={gc_n} merge_runs={mr_n}; open to "
        f"compact_range's end: {busy_text(programs, joblog, wall)}; levels "
        f"{db.versions.current.describe()!r} [{card}]")
    return db, stats, (gc_n, mr_n)


def write_path(torch, root, n, card, device_name="cuda"):
    """Phase 19 (see the module docstring): (a) the CSPP-role trie, (b)
    unordered writes with concurrent inserts, (c) ToplingDB's published
    write deployment (memtable_rep="cspp", unordered writes, concurrent
    inserts, no WAL, 8-byte keys, batches of 500; 4 writer threads, cut
    from the source's 64 because the writers are Python threads), (d)
    pipelined sync writes through the async WAL beside their inline-fsync
    twin, (e) a WriteBufferManager shared by two DBs. Returns the
    (gc_rows, merge_runs) launches of every part."""
    import random
    import struct

    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.memtable import NativeTrieRep
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options, WriteOptions
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.rate_limiter import WriteBufferManager

    value = b"v" * 20
    total = [0, 0]

    def add(launches):
        total[0] += launches[0]
        total[1] += launches[1]

    def kv(i):
        return db_key(i, n), value

    want = sorted(db_key(i, n) for i in range(n))

    # (a) The CSPP-role trie.
    exports, restore = count_trie_exports()
    try:
        db, stats, launches = write_fill_part(
            torch, root, "a", n, kv, card, device_name,
            dict(memtable_rep="cspp"))
        add(launches)
        assert isinstance(db.mem._rep, NativeTrieRep)
        groups = stats.get_ticker_count(st.WRITE_GROUP_LED)
        assert stats.get_ticker_count(
            st.WRITE_GROUP_NATIVE_COMMITS) == groups > 0, groups
        assert exports == [True] * db.num_flushes, \
            (len(exports), db.num_flushes)
        n_files = db_files_against_oracle(db, want, value)
        # The overlay: rewritten keys stay in the trie memtable, so the
        # probes walk the trie branch with data in it.
        fresh = b"w" * 20
        overlay = {db_key(i, n) for i in range(WRITE_OVERLAY_N)}
        flushes = db.num_flushes
        for i in range(0, WRITE_OVERLAY_N, 100):
            b = WriteBatch()
            for j in range(i, i + 100):
                b.put(db_key(j, n), fresh)
            db.write(b)
        assert db.num_flushes == flushes and len(db.mem._rep) == \
            WRITE_OVERLAY_N, "the overlay left the trie memtable"

        def value_of(k):
            return fresh if k in overlay else value

        rng = random.Random(5)
        probes = [db_key(rng.randrange(n), n) for _ in range(min(100_000, n))]
        calls = native_get_calls(db)
        t0 = time.time()
        for k in probes:
            assert db.get(k) == value_of(k), k
        rr = time.time() - t0
        assert calls == {"native": len(probes), "python": 0}, calls
        in_trie = sum(k in overlay for k in probes)
        before = stats.tickers()
        t0 = time.time()
        it = db.new_iterator()
        it.seek_to_first()
        got = 0
        for (k, v), w in zip(it.entries(), want):
            assert k == w and v == value_of(w), (k, w)
            got += 1
        scan = time.time() - t0
        assert got == len(want) and not it.valid(), (got, len(want))
        assert it._plane is not None, "the scan left the chunk plane"
        del it
        after = stats.tickers()
        refills = after.get(st.ITER_CHUNK_REFILLS, 0) - before.get(
            st.ITER_CHUNK_REFILLS, 0)
        fallbacks = after.get(st.ITER_CHUNK_FALLBACKS, 0) - before.get(
            st.ITER_CHUNK_FALLBACKS, 0)
        assert refills > 0 and fallbacks == 0, (refills, fallbacks)
        log(f"[write a] {n_files} live SSTs read back against the oracle; "
            f"{WRITE_OVERLAY_N} keys rewritten into the trie memtable; "
            f"readrandom {len(probes)} probes {rr:.3f}s, "
            f"{len(probes) / rr:.0f} ops/s, all decided by the native "
            f"chain ({in_trie} found in the trie); full scan {got} keys "
            f"{scan:.3f}s through the chunk plane, {refills} refills, "
            f"{fallbacks} fallbacks; {db.num_flushes} flushes, each one "
            f"tpulsm_trie_export, and {len(exports) - db.num_flushes} "
            f"export(s) of the trie memtable by the scan plane [{card}]")
        dbdir = db.dbname
        opts = db.options
        crash(db)
        n_exports = len(exports)
        t0 = time.time()
        db = DB.open(dbdir, opts)
        replay = time.time() - t0
        try:
            assert exports[n_exports:] == [True], exports[n_exports:]
            calls = native_get_calls(db)
            for k in sorted(overlay) + probes[:10_000]:
                assert db.get(k) == value_of(k), k
            assert calls["python"] == 0, calls
        finally:
            db.close()
        log(f"[write a] crash() and reopen {replay:.3f}s: the WAL's "
            f"{WRITE_OVERLAY_N} keys replayed into a trie memtable and "
            f"flushed through one tpulsm_trie_export; the overlay and "
            f"10000 probes read the same, natively [{card}]")
    finally:
        restore()

    # (b) Unordered writes with concurrent inserts, on the skiplist.
    db, stats, launches = write_fill_part(
        torch, root, "b", n, kv, card, device_name,
        dict(unordered_write=True, allow_concurrent_memtable_write=True))
    add(launches)
    try:
        assert db.versions.last_sequence == n == db._seq_alloc
        n_files = db_files_against_oracle(db, want, value)
    finally:
        db.close()
    log(f"[write b] {n_files} live SSTs read back against the oracle "
        f"[{card}]")

    # (c) ToplingDB's published write deployment.
    def kv8(i):
        return struct.pack(">Q", i * 2654435761 % (2 * n)), value

    want8 = sorted(kv8(i)[0] for i in range(n))
    exports, restore = count_trie_exports()
    try:
        db, stats, launches = write_fill_part(
            torch, root, "c", n, kv8, card, device_name,
            dict(memtable_rep="cspp", unordered_write=True,
                 allow_concurrent_memtable_write=True),
            batch=500, wopts=WriteOptions(disable_wal=True),
            raw_per_key=RAW_PER_ENTRY)
    finally:
        restore()
    add(launches)
    try:
        assert stats.get_ticker_count(st.WAL_BYTES) == 0
        assert exports == [True] * db.num_flushes, \
            (len(exports), db.num_flushes)
        n_files = db_files_against_oracle(db, want8, value)
        t0 = time.time()
        it = db.new_iterator()
        it.seek_to_first()
        got = 0
        for (k, v), w in zip(it.entries(), want8):
            assert k == w and v == value, (k, w)
            got += 1
        scan = time.time() - t0
        assert got == n and not it.valid(), got
        del it
    finally:
        db.close()
    log(f"[write c] no WAL byte written; {n_files} live SSTs read back "
        f"against the oracle, every key scanned back in {scan:.3f}s "
        f"[{card}]")

    # (d) Pipelined sync writes through the async WAL, and the inline twin.
    n_sync = WRITE_SYNC_N
    sync = {}
    for label, async_wal in (("async WAL", True), ("inline fsync", False)):
        d = os.path.join(root, "d-" + label.split()[0])
        stats = st.Statistics()
        opts = Options(
            create_if_missing=True, write_buffer_size=8 << 20,
            compaction_executor_factory=DeviceCompactionExecutorFactory(
                device=device_name),
            statistics=stats, protection_bytes_per_key=8,
            enable_pipelined_write=True, enable_async_wal=async_wal)
        db = DB.open(d, opts)
        try:
            wall = threaded_fill(db, n_sync, kv, 4, (100, 1000), pb=8,
                                 wopts=WriteOptions(sync=True))
            ring = db._wal_ring
            fsyncs = ring.fsyncs if ring is not None else \
                stats.get_ticker_count(st.WAL_SYNCS)
            coalesced = stats.get_ticker_count(
                st.WRITE_GROUP_FSYNCS_COALESCED)
            groups = stats.get_ticker_count(st.WRITE_GROUP_LED)
        finally:
            db.close()
        with DB.open(d, opts) as db:
            per_t = n_sync // 4
            for i in range(4 * per_t):
                assert db.get(db_key(i, n)) == value, i
        sync[label] = wall
        log(f"[write d] {label}: {4 * per_t} keys from 4 threads, "
            f"sync=True, pipelined, protected batches of 100 and 1000: "
            f"{wall:.3f}s, {4 * per_t / wall:.0f} ops/s; {groups} groups, "
            f"{fsyncs} fsyncs, {coalesced} coalesced fsyncs; the reopen "
            f"read every acknowledged key [{card}]")
        if async_wal:
            assert coalesced > 0, "no fsync coalesced in the async WAL"
    log(f"[write d] async WAL / inline fsync wall "
        f"{sync['async WAL'] / sync['inline fsync']:.2f}x [{card}]")

    # (e) A WriteBufferManager shared by two DBs of (a)'s shape.
    wbm = WriteBufferManager(WBM_BUDGET)
    dbs, switches = [], []
    launched = counted(kernels)
    for tag in ("e1", "e2"):
        db = DB.open(os.path.join(root, tag), Options(
            create_if_missing=True, write_buffer_size=8 << 20,
            compaction_executor_factory=DeviceCompactionExecutorFactory(
                device=device_name),
            statistics=st.Statistics(), memtable_rep="cspp",
            write_buffer_manager=wbm))
        switch = db._switch_memtable

        def spy(db=db, switch=switch):
            # The active memtables' memory at the switch: below the write
            # buffer, the switch is the shared budget's.
            switches.append(sum(c.mem.approximate_memory_usage()
                                for c in db._cfs.values()))
            switch()

        db._switch_memtable = spy
        dbs.append(db)
    try:
        walls = [0.0, 0.0]

        def fill_one(k):
            walls[k] = threaded_fill(
                dbs[k], WBM_N, lambda i: (db_key(i, WBM_N), value))

        ts = [threading.Thread(target=fill_one, args=(k,)) for k in (0, 1)]
        t0 = time.time()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.time() - t0
        peak_switches = list(switches)
        by_budget = sum(m < (8 << 20) for m in peak_switches)
        assert by_budget > 0, "the shared budget forced no flush"
        flushed = [db.num_flushes for db in dbs]
        for db in dbs:
            db.wait_for_compactions()
            assert db._compaction_scheduler.last_error is None
        for k, db in enumerate(dbs):
            for i in range(0, WBM_N, 997):
                assert db.get(db_key(i, WBM_N)) == value, (k, i)
        usage_before = wbm.memory_usage()
        for db in dbs:
            db.flush()
        residual = wbm.memory_usage()
        assert residual < 4096 * len(dbs), residual
    finally:
        for db in dbs:
            db.close()
    assert wbm.memory_usage() == 0, wbm.memory_usage()
    gc_n, mr_n = launched()
    total[0] += gc_n
    total[1] += mr_n
    log(f"[write e] WriteBufferManager({WBM_BUDGET}) over two DBs of "
        f"(a)'s shape, {WBM_N} keys each filled at once: {wall:.3f}s "
        f"({2 * WBM_N / wall:.0f} ops/s); {flushed} flushes, "
        f"{by_budget} of {len(peak_switches)} memtable switches below the "
        f"8 MiB write buffer (the budget's); charge {usage_before} bytes "
        f"before flush(), {residual} after, 0 after close(); launches "
        f"gc_rows={gc_n} merge_runs={mr_n} [{card}]")
    return total[0], total[1]


# ---------------------------------------------------------------------------
# Phase 20: the read path
# ---------------------------------------------------------------------------


def cache_tickers(stats, st) -> str:
    """The BLOCK_CACHE_* and PERSISTENT_CACHE_* tickers, by name."""
    names = [n for n in dir(st) if n.startswith(
        ("BLOCK_CACHE_", "PERSISTENT_CACHE_")) and isinstance(
            getattr(st, n), str)]
    return json.dumps({n: stats.get_ticker_count(getattr(st, n))
                       for n in sorted(names)})


def read_path(torch, root, n, card, device_name="cuda", db13=None):
    """Phase 20 (see the module docstring): (a) multireadrandom on phase
    13's deployment (its compacted DB under `db13` when still on disk,
    else built anew), (b) a user block cache with its tiers, (c) the
    cold async twin. Every DB of the phase opens with one device factory,
    under one JobLog. Returns the (gc_rows, merge_runs) launches."""
    import random

    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.env import PosixEnv
    from toplingdb_tpu_torch.env.fault_injection import DelayedReadEnv
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options, ReadOptions
    from toplingdb_tpu_torch.tools.block_cache_analyzer import analyze
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.cache import (
        BlockCacheTracer,
        ClockCache,
        CompressedSecondaryCache,
        LRUCache,
        SimCache,
    )
    from toplingdb_tpu_torch.utils.persistent_cache import PersistentCache

    value = b"v" * 20
    os.makedirs(root, exist_ok=True)
    factory = DeviceCompactionExecutorFactory(device=device_name)

    def options(**kw):
        return Options(create_if_missing=True, write_buffer_size=8 << 20,
                       compaction_executor_factory=factory, **kw)

    rng = random.Random(5)
    probes = [db_key(rng.randrange(n), n) for _ in range(READ_PROBES)]
    absent = [b"%016d" % (2 * n + 1 + i) for i in range(128)]
    launched = counted(kernels)
    with ShardPrograms(torch) as programs, \
            JobLog(torch, factory, kernels) as joblog:
        t_open = time.time()
        # (a) multireadrandom on phase 13's deployment.
        src = os.path.join(db13, "db") if db13 else None
        if src and os.path.exists(os.path.join(src, "CURRENT")):
            dbdir, origin = src, "phase 13's compacted DB, reopened"
            db = DB.open(dbdir, options(statistics=st.Statistics()))
        else:
            dbdir, origin = os.path.join(root, "db"), "built anew"
            db = DB.open(dbdir, options(statistics=st.Statistics()))
            threaded_fill(db, n, lambda i: (db_key(i, n), value))
            db.flush()
            db.wait_for_compactions()
        # Rewrite READ_OVERLAY_N keys with their own value: compact_range
        # then merges a flushed run into the last level on the card.
        for i in range(0, READ_OVERLAY_N, 100):
            b = WriteBatch()
            for j in range(i, min(i + 100, READ_OVERLAY_N)):
                b.put(db_key(j, n), value)
            db.write(b)
        db.flush()
        t0 = time.time()
        db.compact_range()
        crw = time.time() - t0
        jobs_a = len(joblog.jobs)
        assert jobs_a > 0, "compact_range ran no device job"
        # Keys the native whole-batch call took, and those of them it
        # could not decide (re-resolved in Python).
        native_keys, undecided = [0], [0]
        whole_batch = db._native_multi_get
        resolve = db._mg_resolve_fallbacks

        def counted_batch(cfd, keys, *a):
            r = whole_batch(cfd, keys, *a)
            native_keys[0] += len(keys) if r[0] else 0
            return r

        def counted_resolve(out, *a):
            undecided[0] += sum(v is False for v in out)
            return resolve(out, *a)

        db._native_multi_get = counted_batch
        db._mg_resolve_fallbacks = counted_resolve
        t0 = time.time()
        got = [v for i in range(0, len(probes), 128)
               for v in db.multi_get(probes[i:i + 128])]
        mg = time.time() - t0
        assert got == [value] * len(probes), "multi_get differs from oracle"
        decided = (native_keys[0] - undecided[0]) / len(probes)
        assert db.multi_get(absent) == [None] * len(absent)
        calls = native_get_calls(db)
        t0 = time.time()
        singles = [db.get(k) for k in probes]
        rr = time.time() - t0
        assert singles == got and calls["python"] == 0, calls
        served_by = ("the C extension" if db._nget_tl.states[0].fast_mg
                     is not None else "ctypes")
        db.close()
        log(f"[read a] {origin}: {READ_OVERLAY_N} keys rewritten, "
            f"compact_range {crw:.3f}s ({jobs_a} device jobs in (a)); "
            f"multireadrandom {len(probes)} probes in batches of 128 "
            f"{mg:.3f}s, {len(probes) / mg:.0f} ops/s, "
            f"{decided:.4f} of the keys decided by the native whole-batch "
            f"call (through {served_by}); per-key "
            f"readrandom {rr:.3f}s, {len(probes) / rr:.0f} ops/s; every "
            f"answer equal to the get's and the oracle's [{card}]")

        # (b) A user block cache: the Python chain on both routes.
        want = [value] * READ_CACHE_PROBES
        pb, mb = probes[:READ_CACHE_PROBES], \
            probes[READ_CACHE_PROBES:2 * READ_CACHE_PROBES]
        pdir = os.path.join(root, "pcache")

        def cached_reads(bc, tag, stats):
            db = DB.open(dbdir, options(block_cache=bc, statistics=stats))
            assert db._nget_lib is None, "the native chain ran under a cache"
            st.perf_level = 1
            ctx = st.perf_context()
            ctx.reset()
            try:
                t0 = time.time()
                assert [db.get(k) for k in pb] == want, tag
                g = time.time() - t0
                t0 = time.time()
                assert [v for i in range(0, len(mb), 128)
                        for v in db.multi_get(mb[i:i + 128])] == want, tag
                m = time.time() - t0
                perf = dict(hits=ctx.block_cache_hit_count,
                            misses=ctx.block_cache_miss_count,
                            reads=ctx.block_read_count)
            finally:
                st.perf_level = 0
            db.close()
            return g, m, perf

        sec = PersistentCache(pdir, 64 << 20)
        lru = LRUCache(8 << 20, secondary=sec)
        s1 = st.Statistics()
        g, m, perf = cached_reads(lru, "lru", s1)
        sec.flush()
        index_before = dict(sec._index)
        # Every record read back from its file: the bytes the reopened
        # tier must give.
        records = {k: sec.lookup(k) for k in index_before}
        sec.close()
        log(f"[read b] LRUCache(8 MiB, secondary=PersistentCache(64 MiB)): "
            f"{len(pb)} gets {g:.3f}s, {len(pb) / g:.0f} ops/s; "
            f"{len(mb)} keys of multi_get in batches of 128 {m:.3f}s, "
            f"{len(mb) / m:.0f} ops/s; primary hit rate "
            f"{lru.hit_rate():.4f}, usage {lru.usage()}; secondary "
            f"{json.dumps(sec.stats())}; PerfContext {json.dumps(perf)}; "
            f"tickers {cache_tickers(s1, st)} [{card}]")
        sec = PersistentCache(pdir, 64 << 20)
        assert sec._index == index_before, "the tier's index changed"
        files = sec.stats()["files"]
        t0 = time.time()
        assert all(sec.lookup(k) == v for k, v in records.items()), \
            "a recovered record's bytes changed"
        rec_s = time.time() - t0
        assert sec.hits == len(records) > 0, (sec.hits, len(records))
        # The reopened DB keys its blocks under a new per-open session (as
        # the reference's TableCache does), so its lookups meet the records
        # its own evictions spill, not the recovered ones.
        lru = LRUCache(8 << 20, secondary=sec)
        s2 = st.Statistics()
        g, m, perf = cached_reads(lru, "lru reopened", s2)
        sec.close()
        log(f"[read b] closed and reopened: the persistent tier recovered "
            f"{len(index_before)} records from {files} files with the same "
            f"index, each served from disk with the bytes it held before "
            f"close ({rec_s:.3f}s); the DB reopened over it: gets "
            f"{g:.3f}s, {len(pb) / g:.0f} ops/s; multi_get {m:.3f}s, "
            f"{len(mb) / m:.0f} ops/s; primary hit rate "
            f"{lru.hit_rate():.4f}; secondary {json.dumps(sec.stats())}; "
            f"tickers {cache_tickers(s2, st)} [{card}]")
        trace = os.path.join(root, "bc.trace")
        tracer = BlockCacheTracer(trace)
        tier = CompressedSecondaryCache(32 << 20)
        clock = ClockCache(8 << 20, secondary=tier, tracer=tracer)
        sim = SimCache(clock, 64 << 20)
        s3 = st.Statistics()
        g, m, perf = cached_reads(sim, "clock", s3)
        tracer.close()
        report = analyze(trace, top_n=3)
        served = clock.hits + tier.hits
        assert report["hits"] == served, (report["hits"], served)
        log(f"[read b] SimCache(ClockCache(8 MiB, secondary="
            f"CompressedSecondaryCache(32 MiB)), 64 MiB) with a "
            f"BlockCacheTracer: gets {g:.3f}s, {len(pb) / g:.0f} ops/s; "
            f"multi_get {m:.3f}s, {len(mb) / m:.0f} ops/s; clock hit rate "
            f"{clock.hit_rate():.4f}, compressed tier {tier.hits} hits / "
            f"{tier.misses} misses, usage {tier.usage()}; simulated 64 MiB "
            f"hit rate {sim.sim_hit_rate():.4f}; the analyzer: "
            f"{report['accesses']} accesses, {report['hits']} hits = the "
            f"cache's own {clock.hits} + {tier.hits} from the tier, "
            f"{report['unique_blocks']} blocks; every answer equal to "
            f"(a)'s [{card}]")

        # (c) The cold async twin (bench.py's async_read_rows).
        cold = os.path.join(root, "cold")
        db = DB.open(cold, Options(
            create_if_missing=True, write_buffer_size=128 * 1024,
            compaction_executor_factory=factory))
        ckey = lambda i: b"%016d" % ((i * 2654435761) % (COLD_N * 2))  # noqa: E731
        for i in range(COLD_N):
            db.put(ckey(i), b"value-%016d" % i)
        db.flush()
        db.wait_for_compactions()
        db.close()
        oracle = {ckey(i): b"value-%016d" % i for i in range(COLD_N)}
        crng = random.Random(11)
        cprobes = [ckey(crng.randrange(COLD_N)) for _ in range(COLD_PROBES)]
        cwant = [oracle[k] for k in cprobes]

        def cold_open(async_reads, stats=None):
            env = DelayedReadEnv(PosixEnv(), delay_sec=0.0002)
            return DB.open(cold, Options(
                block_cache=LRUCache(64 * 1024),
                compaction_executor_factory=factory, statistics=stats),
                env=env, async_reads=async_reads)

        def cold_run(async_reads):
            stats = st.Statistics()
            dbr = cold_open(async_reads, stats)
            t0 = time.time()
            out = [v for i in range(0, len(cprobes), 128)
                   for v in dbr.multi_get(cprobes[i:i + 128])]
            dt = time.time() - t0
            dbr.close()
            return len(cprobes) / dt, out, stats

        best = {True: 0.0, False: 0.0}
        ticks = {}
        for _ in range(3):
            for a in (True, False):
                rate, out, stats = cold_run(a)
                assert out == cwant, f"cold twin async_reads={a} differs"
                best[a] = max(best[a], rate)
                ticks[a] = [stats.get_ticker_count(t) for t in (
                    st.READ_ASYNC_BATCHES, st.READ_ASYNC_COALESCED,
                    st.READ_ASYNC_FALLBACKS)]
        assert ticks[True][0] > 0 and ticks[False] == [0, 0, 0], ticks
        dba = cold_open(True)
        dbs = cold_open(False)
        try:
            futs = [dba.get_async(k) for k in cprobes[:512]]
            assert [f.result() for f in futs] == cwant[:512]
            mfs = [dba.multi_get_async(cprobes[i:i + 128])
                   for i in range(0, len(cprobes), 128)]
            assert [v for f in mfs for v in f.result()] == cwant
            aio = [v for i in range(0, len(cprobes), 128)
                   for v in dbs.multi_get(cprobes[i:i + 128],
                                          ReadOptions(async_io=True))]
            assert aio == cwant
            scans = {}
            for tag, d, ro in (("plain", dbs, ReadOptions()),
                               ("readahead 256 KiB", dbs,
                                ReadOptions(readahead_size=256 * 1024)),
                               ("ring windows", dba, ReadOptions())):
                t0 = time.time()
                it = d.new_iterator(ro)
                it.seek_to_first()
                scans[tag] = (list(it.entries()), time.time() - t0)
                del it
            assert scans["plain"][0] == sorted(oracle.items())
            assert all(s[0] == scans["plain"][0] for s in scans.values())
            assert any(t.name.startswith("tpt-read")
                       for t in threading.enumerate())
        finally:
            dba.close()
            dbs.close()
        t_last = time.time()
        survivors = [t.name for t in threading.enumerate()
                     if "tpt-read" in t.name or "tpulsm-read" in t.name]
        assert not survivors, survivors
        log(f"[read c] cold twin: {COLD_N} keys, DelayedReadEnv 200 us, "
            f"LRUCache(64 KiB), {len(cprobes)} probes in batches of 128, "
            f"best of 3 interleaved rounds: async_reads=True "
            f"{best[True]:.0f} ops/s, False {best[False]:.0f} ops/s, ratio "
            f"{best[True] / best[False]:.3f}; READ_ASYNC_BATCHES "
            f"{ticks[True][0]}, READ_ASYNC_COALESCED {ticks[True][1]}, "
            f"READ_ASYNC_FALLBACKS {ticks[True][2]} a round; views equal; "
            f"get_async, multi_get_async and ReadOptions(async_io=True) "
            f"equal; full scans plain {scans['plain'][1]:.3f}s, "
            f"readahead 256 KiB {scans['readahead 256 KiB'][1]:.3f}s, "
            f"ring windows {scans['ring windows'][1]:.3f}s, all equal; no "
            f"tpt-read thread after close() [{card}]")
        gc_n, mr_n = launched()
    assert joblog.jobs, "no compaction ran on the device executor"
    joblog.check(device_name, "read")
    if device_name != "cpu":
        assert gc_n >= len(joblog.jobs), (gc_n, len(joblog.jobs))
    log(f"[read d] {len(joblog.jobs)} device jobs in the phase ({jobs_a} "
        f"in (a), the rest in (c)'s fill), launches gc_rows={gc_n} "
        f"merge_runs={mr_n}; open to the last read: "
        f"{busy_text(programs, joblog, t_last - t_open)} [{card}]")
    return gc_n, mr_n


# ---------------------------------------------------------------------------
# Phase 21: the manual and introspection entry points, WAL recycling and
# archiving
# ---------------------------------------------------------------------------


def manual_path(torch, root, n, card, device_name="cuda", wbuf=8 << 20,
                target_file=MANUAL_TARGET_FILE):
    """Phase 21 (see the module docstring): (a) manual compaction on the
    card, (b) introspection, (c) WAL recycling and archiving. Every DB of
    the phase opens with one device factory, under one JobLog; `wbuf` and
    `target_file` are the write buffer and SST sizes. Returns the
    (gc_rows, merge_runs) launches."""
    import itertools
    import random
    import struct

    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.merge_operator import UInt64AddOperator

    value, over = b"v" * 20, b"o" * 20
    os.makedirs(root, exist_ok=True)
    factory = DeviceCompactionExecutorFactory(device=device_name)

    def options(**kw):
        return Options(create_if_missing=True, write_buffer_size=wbuf,
                       compaction_executor_factory=factory, **kw)

    def kv(i):
        return db_key(i, n), value

    # The 5% slice that delete_range and delete_files_in_range clear, and
    # the 100,000-key overlay written while background work is paused.
    lo, hi = b"%016d" % (2 * n * 40 // 100), b"%016d" % (2 * n * 45 // 100)
    overlay = {db_key(i, n) for i in range(min(MANUAL_OVERLAY_N, n))}
    written = {"overlay": False}

    def value_of(k):
        if written["overlay"] and k in overlay:
            return over
        return None if lo <= k < hi else value

    rng = random.Random(5)
    probes = [db_key(rng.randrange(n), n) for _ in range(MANUAL_PROBES)]
    launched = counted(kernels)
    with ShardPrograms(torch) as programs, \
            JobLog(torch, factory, kernels) as joblog:
        t_open = time.time()
        # (a) Manual compaction on the card.
        stats = st.Statistics()
        dbdir = os.path.join(root, "db")
        db = DB.open(dbdir, options(
            statistics=stats, disable_auto_compactions=True,
            target_file_size_base=target_file,
            level0_file_num_compaction_trigger=MANUAL_L0_TRIGGER))
        fill = threaded_fill(db, n, kv)
        db.flush()
        l0 = [f.number for f in db.versions.current.files[0]]
        assert len(l0) >= 4, f"L0 holds {len(l0)} files after the fill"
        log(f"[manual a] fillrandom {n} keys, auto compactions off: "
            f"{fill:.3f}s, {n / fill:.0f} ops/s, {len(l0)} L0 files "
            f"[{card}]")

        def call(tag, fn, *args):
            """One entry point: its wall, device jobs and the bytes its
            jobs read and wrote."""
            j0 = len(joblog.jobs)
            r0 = stats.get_ticker_count(st.COMPACT_READ_BYTES)
            w0 = stats.get_ticker_count(st.COMPACT_WRITE_BYTES)
            t0 = time.time()
            out = fn(*args)
            wall = time.time() - t0
            jobs = len(joblog.jobs) - j0
            rd = stats.get_ticker_count(st.COMPACT_READ_BYTES) - r0
            wr = stats.get_ticker_count(st.COMPACT_WRITE_BYTES) - w0
            log(f"[manual a] {tag}: {wall:.3f}s, {jobs} device jobs, "
                f"{rd} bytes in, {wr} bytes out [{card}]")
            return out, jobs

        _, jobs = call(f"compact_files of the older {len(l0) // 2} of "
                       f"{len(l0)} L0 files into L1", db.compact_files,
                       l0[len(l0) - len(l0) // 2:], 1)
        assert jobs == 1 and not set(l0[len(l0) - len(l0) // 2:]) & {
            f.number for f in db.versions.current.files[0]}
        l1 = [f.number for f in db.versions.current.files[1]]
        assert len(l1) >= 3, l1
        _, jobs = call(f"compact_files of L1 files {l1[1:3]} into L2",
                       db.compact_files, l1[1:3], 2)
        assert {f.number for f in db.versions.current.files[2]}
        marked, _ = call(
            "suggest_compact_range over the middle third",
            db.suggest_compact_range, b"%016d" % (2 * n // 3),
            b"%016d" % (4 * n // 3))
        assert marked > 0
        # Each pick that follows: its reason, the marked files among its
        # inputs and L0's file count, which stays below the L0 trigger, so
        # the first pick comes from the marks.
        picks = []
        picker = db._compaction_scheduler.picker
        pick = picker.pick_compaction

        def logged_pick(version):
            c = pick(version)
            if c is not None:
                picks.append((c.reason, sum(
                    f.marked_for_compaction for _, f in c.all_inputs()),
                    len(version.files[0])))
            return c

        picker.pick_compaction = logged_pick
        seen_threads = []

        def enable_and_wait():
            db.set_options({"disable_auto_compactions": False})
            sched = db._compaction_scheduler
            while sched._running or sched._pending:
                rows = json.loads(db.get_property("tpulsm.threads"))
                seen_threads.extend(r["operation"] for r in rows)
                time.sleep(0.005)
            db.wait_for_compactions()

        _, jobs = call(f"set_options(disable_auto_compactions=False) and "
                       f"the jobs of {marked} marked files",
                       enable_and_wait)
        picker.pick_compaction = pick
        reasons = [j["reason"] for j in joblog.jobs]
        assert jobs > 0 and not any(
            f.marked_for_compaction
            for _, f in db.versions.current.all_files()), reasons
        assert picks and picks[0][1] > 0, picks
        assert picks[0][2] < MANUAL_L0_TRIGGER, picks
        log(f"[manual a] the picks after set_options (reason, marked "
            f"inputs, L0 files): {picks} [{card}]")
        db.delete_range(lo, hi)
        dropped, _ = call("delete_range + delete_files_in_range over a 5% "
                          "slice", db.delete_files_in_range, lo, hi)
        assert dropped > 0, "no whole file inside the 5% slice"
        # RocksDB's recipe: a compaction of the slice then clears the
        # boundary files' data and the tombstone.
        call("compact_range over the slice", db.compact_range, lo, hi)
        log(f"[manual a] {dropped} files dropped; job reasons "
            f"{json.dumps(reasons)}; threads seen by tpulsm.threads "
            f"during the jobs: {sorted(set(seen_threads))}; levels "
            f"{db.versions.current.describe()!r} [{card}]")

        native_keys = [0]
        whole_batch = db._native_multi_get

        def counted_batch(cfd, keys, *a):
            r = whole_batch(cfd, keys, *a)
            native_keys[0] += len(keys) if r[0] else 0
            return r

        db._native_multi_get = counted_batch

        def check_reads(tag):
            native_keys[0] = 0
            t0 = time.time()
            got = [v for i in range(0, len(probes), 128)
                   for v in db.multi_get(probes[i:i + 128])]
            mg = time.time() - t0
            assert got == [value_of(k) for k in probes], tag
            return mg, native_keys[0] / len(probes)

        mg, share = check_reads("after the manual jobs")
        fill_keys = sorted(db_key(i, n) for i in range(n))
        want = [k for k in fill_keys if value_of(k) is not None]
        t0 = time.time()
        it = db.new_iterator()
        it.seek_to_first()
        got = 0
        buckets = [0] * 64
        for (k, v), wk in zip(it.entries(), want):
            assert k == wk and v == value_of(wk), (k, wk)
            buckets[min(63, int(k) * 64 // (2 * n))] += 1
            got += 1
        scan = time.time() - t0
        assert got == len(want) and not it.valid(), (got, len(want))
        del it
        log(f"[manual a] {len(probes)} probes through multi_get (batches "
            f"of 128) {mg:.3f}s, {len(probes) / mg:.0f} ops/s, {share:.4f} "
            f"of the keys taken by the native whole-batch call; full scan "
            f"{len(want)} keys {scan:.3f}s; both equal to the oracle "
            f"[{card}]")

        db.pause_background_work()
        t0 = time.time()
        threaded_fill(db, len(overlay),
                      lambda i: (db_key(i, n), over))
        ov = time.time() - t0
        written["overlay"] = True
        paused = db.write_stall_state()
        assert paused["drainable"] is False and paused["state"] == "none"
        t0 = time.time()
        db.continue_background_work()
        db.wait_for_compactions()
        resumed = time.time() - t0
        after = db.write_stall_state()
        assert after["drainable"] is True
        mg2, share2 = check_reads("after the overlay")
        log(f"[manual a] paused: {len(overlay)}-key overlay {ov:.3f}s, "
            f"write_stall_state {json.dumps(paused)}; continue + wait "
            f"{resumed:.3f}s, write_stall_state {json.dumps(after)}; "
            f"{len(probes)} probes {mg2:.3f}s ({share2:.4f} native) equal "
            f"to the oracle [{card}]")

        # (b) Introspection on the same DB.
        live = int(db.get_property("tpulsm.estimate-live-data-size"))
        entries = sum(f.num_entries
                      for _, f in db.versions.current.all_files())
        per_entry = live / max(1, entries)
        ranges = [(b"%016d" % (2 * n * r // 64),
                   b"%016d" % (2 * n * (r + 1) // 64)) for r in range(64)]
        t0 = time.time()
        sizes = db.get_approximate_sizes(ranges)
        whole = db.get_approximate_sizes([(b"0" * 16, b":")])[0]
        appx = time.time() - t0
        assert abs(whole - live) <= 0.2 * live, (whole, live)
        ratios = [s / (b * per_entry) for s, b in zip(sizes, buckets) if b]
        log(f"[manual b] get_approximate_sizes over 64 ranges {appx:.3f}s: "
            f"{sizes}; live bytes of those ranges (keys in the scan x "
            f"{per_entry:.2f} bytes a live entry): "
            f"{[round(b * per_entry) for b in buckets]}; ratio min "
            f"{min(ratios):.3f} max {max(ratios):.3f}; the whole key range "
            f"{whole} against estimate-live-data-size {live} "
            f"({whole / live:.4f}) [{card}]")
        names = ["tpulsm.stats", "tpulsm.levelstats", "tpulsm.num-files",
                 "tpulsm.background-errors", "tpulsm.bg-error-severity",
                 "tpulsm.estimate-num-keys",
                 "tpulsm.cur-size-all-mem-tables", "tpulsm.num-snapshots",
                 "tpulsm.estimate-live-data-size",
                 "tpulsm.num-running-compactions", "tpulsm.threads"] + [
                     f"tpulsm.num-files-at-level{k}" for k in range(7)]
        props = {name: db.get_property(name) for name in names}
        assert all(v is not None for v in props.values()), props
        assert props["tpulsm.background-errors"] == "0"
        log(f"[manual b] get_property: {json.dumps(props)}")

        # The backup recipe.
        cdir = os.path.join(root, "copy")
        os.makedirs(cdir)
        t0 = time.time()
        db.disable_file_deletions()
        try:
            files, msize = db.get_live_files()
            wals = db.get_sorted_wal_files()
            copied = 0
            for f in files + wals:
                shutil.copy2(os.path.join(dbdir, f), os.path.join(cdir, f))
                if f.startswith("MANIFEST-"):
                    with open(os.path.join(cdir, f), "r+b") as mf:
                        mf.truncate(msize)
                copied += os.path.getsize(os.path.join(cdir, f))
        finally:
            db.enable_file_deletions()
        backup = time.time() - t0
        # No compaction on the copy: its scan is read beside the source's.
        copy = DB.open(cdir, options(disable_auto_compactions=True))
        try:
            t0 = time.time()
            src_it, cp_it = db.new_iterator(), copy.new_iterator()
            src_it.seek_to_first()
            cp_it.seek_to_first()
            n_cmp = 0
            for a, b in itertools.zip_longest(src_it.entries(),
                                              cp_it.entries()):
                assert a == b, (n_cmp, a, b)
                n_cmp += 1
            assert n_cmp == len(want) + len(
                [k for k in overlay if lo <= k < hi]), n_cmp
            cmp_s = time.time() - t0
            del src_it, cp_it
        finally:
            copy.close()
        log(f"[manual b] backup: disable_file_deletions, get_live_files "
            f"({len(files)} files, MANIFEST truncated at {msize} bytes), "
            f"get_sorted_wal_files ({len(wals)}), {copied} bytes copied, "
            f"enable_file_deletions: {backup:.3f}s; the copy opened on "
            f"{device_name!r}, its scan of {n_cmp} entries equal to the "
            f"source's {cmp_s:.3f}s [{card}]")
        # The merge overlay needs the operator, which takes scans off the
        # chunk plane: the DB is reopened with it for this part only.
        db.close()
        db = DB.open(dbdir, options(
            statistics=stats, target_file_size_base=target_file,
            level0_file_num_compaction_trigger=MANUAL_L0_TRIGGER,
            merge_operator=UInt64AddOperator()))
        u64 = struct.Struct("<Q").pack
        mkeys = [b"m%015d" % i for i in range(MANUAL_MERGE_N)]
        t0 = time.time()
        for i in range(0, len(mkeys), 100):
            b = WriteBatch()
            for k in mkeys[i:i + 100]:
                b.put(k, u64(7))
            db.write(b)
        db.flush()
        for step in (1, 2):
            for i in range(0, len(mkeys), 100):
                b = WriteBatch()
                for k in mkeys[i:i + 100]:
                    b.merge(k, u64(step))
                db.write(b)
        mw = time.time() - t0
        t0 = time.time()
        for k in mkeys:
            assert db.get_merge_operands(k) == [u64(7), u64(1), u64(2)], k
        gmo = time.time() - t0
        assert all(db.get(k) == u64(10) for k in mkeys[::97])
        log(f"[manual b] uint64add overlay of {len(mkeys)} keys (a put, "
            f"flushed, then two merges) {mw:.3f}s; get_merge_operands of "
            f"every key {gmo:.3f}s, {len(mkeys) / gmo:.0f} calls/s, each "
            f"[base, 1, 2] [{card}]")

        db.close()

        # promote_l0 on a second DB of 10 disjoint sequential runs.
        pdir = os.path.join(root, "promote")
        pdb = DB.open(pdir, options(disable_auto_compactions=True))
        per_run = n // 50
        t0 = time.time()
        for r in range(10):
            for i in range(r * per_run, (r + 1) * per_run, 100):
                b = WriteBatch()
                for j in range(i, i + 100):
                    b.put(b"%016d" % j, value)
                pdb.write(b)
            pdb.flush()
        pfill = time.time() - t0
        assert len(pdb.versions.current.files[0]) == 10
        t0 = time.time()
        pdb.promote_l0(6)
        promote = time.time() - t0
        assert not pdb.versions.current.files[0]
        assert len(pdb.versions.current.files[6]) == 10
        prng = random.Random(9)
        for j in (prng.randrange(10 * per_run) for _ in range(10_000)):
            assert pdb.get(b"%016d" % j) == value, j
        pdb.close()
        with DB.open(pdir, options()) as pdb:
            assert len(pdb.versions.current.files[6]) == 10
            assert pdb.get(b"%016d" % (10 * per_run - 1)) == value
        log(f"[manual b] promote_l0: {10 * per_run} sequential keys in 10 "
            f"flushed runs {pfill:.3f}s; promote_l0(6) of 10 L0 files "
            f"{promote * 1e3:.3f} ms (metadata only), 10,000 probes and a "
            f"reopen equal [{card}]")

        # (c) WAL recycling and archiving.
        rates, reused = {}, {}
        rn = min(n, RECYCLE_N)
        rkeys = sorted(db_key(i, rn) for i in range(rn))
        for recycle in (2, 0):
            rdir = os.path.join(root, f"recycle{recycle}")
            rdb = DB.open(rdir, options(recycle_log_file_num=recycle))
            reuses = []
            reuse = rdb.env.reuse_writable_file

            def counted_reuse(old, new, reuse=reuse, reuses=reuses):
                reuses.append(new)
                return reuse(old, new)

            rdb.env.reuse_writable_file = counted_reuse
            wall = threaded_fill(rdb, rn, lambda i: (db_key(i, rn), value))
            rates[recycle] = rn / wall
            reused[recycle] = len(reuses)
            if recycle:
                live = os.path.join(rdir, "%06d.log" % rdb._wal_number)
                assert live in reuses, "the live WAL is not a reused file"
                crash(rdb)
                t0 = time.time()
                rdb = DB.open(rdir, options(recycle_log_file_num=recycle))
                rec = time.time() - t0
                rr, rscan, n_rp, found = probe_and_scan(
                    rdb, rkeys, lambda k: value, rn, "recycled reopen",
                    n_probe=20_000)
                assert found == n_rp
            rdb.close()
            shutil.rmtree(rdir)
        assert reused[2] > 0 and reused[0] == 0, reused
        log(f"[manual c] fillrandom {rn} keys, 4 writers: "
            f"recycle_log_file_num=2 {rates[2]:.0f} ops/s, {reused[2]} "
            f"WALs reused; recycle_log_file_num=0 {rates[0]:.0f} ops/s, "
            f"0 reused; ratio {rates[2] / rates[0]:.3f}; the recycled DB "
            f"dropped without a flush and reopened in {rec:.3f}s (its "
            f"live WAL a reused file): {n_rp} probes {rr:.3f}s and a full "
            f"scan {rscan:.3f}s equal to the oracle [{card}]")
        adir = os.path.join(root, "archive")
        adb = DB.open(adir, options(wal_ttl_seconds=3600.0))
        an = n // 5
        t0 = time.time()
        threaded_fill(adb, an, lambda i: (db_key(i, an), value))
        adb.flush()
        afill = time.time() - t0
        files = adb.get_wal_files()
        archived = [p for _n, p, a in files if a]
        assert archived and any(not a for _n, _p, a in files), files
        for p in archived:
            os.utime(p, (1, 1))
        adb.put(b"%016d" % (2 * an + 1), value)  # a key of the fill's width
        adb.flush()  # the switch archives the old WAL and purges the aged
        left = [p for _n, p, a in adb.get_wal_files() if a]
        assert not set(archived) & set(left), (archived, left)
        assert adb.get(db_key(an - 1, an)) == value
        adb.close()
        log(f"[manual c] wal_ttl_seconds=3600: fill of {an} keys + flush "
            f"{afill:.3f}s; get_wal_files listed {len(archived)} archived "
            f"and {len(files) - len(archived)} live WALs; the archive aged "
            f"by os.utime, the next switch purged all {len(archived)} "
            f"({len(left)} newly archived left) [{card}]")
        t_last = time.time()
        gc_n, mr_n = launched()
    joblog.check(device_name, "manual")
    assert joblog.jobs, "no compaction ran on the device executor"
    if device_name != "cpu":
        assert gc_n >= len(joblog.jobs), (gc_n, len(joblog.jobs))
    log(f"[manual d] {len(joblog.jobs)} device jobs in the phase, launches "
        f"gc_rows={gc_n} merge_runs={mr_n}; open to the last read: "
        f"{busy_text(programs, joblog, t_last - t_open)} [{card}]")
    return gc_n, mr_n




def storage_fill(db, keys_of, n, value_of, retry_gate=None, n_threads=4,
                 batch=100):
    """bench.py's fill of n keys (n_threads writers, batches of `batch`)
    that survives a full disk: a write that raises no-space counts as not
    acknowledged; with `retry_gate` (an Event) the writer waits for it and
    writes the batch again (puts are idempotent), else goes on. Returns
    (acked key set, failed writes, the first no-space error seen)."""
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.utils.status import is_no_space

    per_t = n // n_threads
    acked, failed, first, errs = set(), [0], [], []
    mu = threading.Lock()

    def worker(t):
        try:
            for i in range(t * per_t, (t + 1) * per_t, batch):
                ks = [keys_of(j) for j in range(i, min(i + batch,
                                                        (t + 1) * per_t))]
                while True:
                    b = WriteBatch()
                    for k in ks:
                        b.put(k, value_of(k))
                    try:
                        db.write(b)
                    except Exception as e:  # noqa: BLE001
                        if not is_no_space(e):
                            raise
                        with mu:
                            failed[0] += 1
                            if not first:
                                first.append(e)
                        if retry_gate is None:
                            break
                        retry_gate.wait()
                        continue
                    with mu:
                        acked.update(ks)
                    break
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t,))
          for t in range(n_threads)]
    for t in ts:
        t.start()
    return ts, acked, failed, first, errs


def read_back(db, keys, value_of, tag) -> float:
    """Every key in `keys` through multi_get batches of 10,000 against
    value_of; returns the wall."""
    keys = sorted(keys)
    t0 = time.time()
    for i in range(0, len(keys), 10_000):
        part = keys[i:i + 10_000]
        for k, v in zip(part, db.multi_get(part)):
            assert v == value_of(k), (tag, k, v)
    return time.time() - t0


def storage_path(torch, root, n, card, device_name="cuda", n_full=FULL_N,
                 n_entity=ENTITY_N):
    """Phase 22 (see the module docstring): (a) a disk budget through a
    shared SstFileManager, (b) a disk that really fills, (c)
    preclude_last_level_data_seconds, (d) wide-column entities. Every DB
    of the phase opens with one device factory, under one JobLog. Returns
    the (gc_rows, merge_runs) launches."""
    import random

    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.wide_columns import encode_entity
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.env import PosixEnv
    from toplingdb_tpu_torch.env.fault_injection import FaultInjectionEnv
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.listener import EventListener
    from toplingdb_tpu_torch.utils.merge_operator import StringAppendOperator
    from toplingdb_tpu_torch.utils.rate_limiter import SstFileManager

    class Watch(EventListener):
        """Pressure transitions and recoveries of one DB."""

        def __init__(self):
            self.levels = []
            self.recovered = []

        def on_disk_pressure(self, db, info):
            self.levels.append(f"{info.prev_level}->{info.level}")

        def on_error_recovery_completed(self, db, info):
            self.recovered.append((info.reason, info.auto))

    value = b"v" * 20
    wbuf = 8 << 20
    os.makedirs(root, exist_ok=True)
    factory = DeviceCompactionExecutorFactory(device=device_name)

    def options(**kw):
        return Options(create_if_missing=True, write_buffer_size=wbuf,
                       compaction_executor_factory=factory, **kw)

    def key_n(m):
        return lambda i: db_key(i, m)

    def wait_for(cond, timeout, what):
        t0 = time.time()
        while not cond():
            assert time.time() - t0 < timeout, what
            time.sleep(0.005)
        return time.time() - t0

    def disk_bytes(d):
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                   if f.endswith((".sst", ".log", ".blob")))

    launched = counted(kernels)
    with ShardPrograms(torch) as programs, \
            JobLog(torch, factory, kernels) as joblog:
        t_open = time.time()
        # (a) A disk budget: SetMaxAllowedSpaceUsage and a paced trash
        # deleter, shared through Options.sst_file_manager.
        t_a = time.time()
        budget = int(STORAGE_BUDGET_X * n * DB_RAW_PER_ENTRY)
        sfm = SstFileManager(bytes_per_sec_delete=64 << 20,
                             max_allowed_space_usage=budget,
                             flush_headroom_bytes=2 * wbuf,
                             free_space_poll_period_sec=0.05)
        stats = st.Statistics()
        watch = Watch()
        adir = os.path.join(root, "budget")
        db = DB.open(adir, options(sst_file_manager=sfm, statistics=stats,
                                   listeners=[watch]))
        sched = db._compaction_scheduler
        refused = [0]
        space_refused = sched._space_refused

        def counting_refusal(c):
            r = space_refused(c)
            refused[0] += r
            return r

        sched._space_refused = counting_refusal
        gate = threading.Event()
        ts, acked, failed, first, errs = storage_fill(
            db, key_n(n), n, lambda k: value, retry_gate=gate)
        wait_for(lambda: first or not any(t.is_alive() for t in ts), 600,
                 "the budgeted fill never ended")
        assert first, (f"B = {budget} never latched: calibrate "
                       f"STORAGE_BUDGET_X (tracked {sfm.total_size()})")
        wait_for(lambda: db._bg_error is not None, 30, "no latch")
        latch = (db._bg_error_reason, db._bg_error_severity.name)
        assert latch == ("no_space", "SOFT_ERROR"), latch
        blocks = stats.get_ticker_count(st.NO_SPACE_PREFLIGHT_BLOCKS)
        assert refused[0] >= 1, "no compaction was refused before the latch"
        at_latch = (sfm.total_size(), sfm.pressure(),
                    len(db.versions.current.files[0]))
        jobs_before = len(joblog.jobs)
        t_raise = time.time()
        sfm.set_max_allowed_space_usage(4 * budget)
        ttr = wait_for(lambda: db._bg_error is None, 60,
                       "the no_space latch never cleared")
        gate.set()
        for t in ts:
            t.join()
        assert not errs, errs
        assert len(acked) == n - n % 4, len(acked)
        db.flush()
        db.wait_for_compactions()
        after = [j for j in joblog.jobs[jobs_before:] if j["t0"] >= t_raise]
        assert after and all(j["device"] == device_name for j in after), \
            "no card job after the latch cleared"
        assert watch.recovered and all(a for _r, a in watch.recovered), \
            watch.recovered
        sfm.wait_for_deletes()
        tracked, on_disk = sfm.total_size(), disk_bytes(adir)
        rb = read_back(db, acked, lambda k: value, "budget")
        errs_n = stats.get_ticker_count(st.NO_SPACE_ERRORS)
        db.close()
        sfm.close()
        log(f"[storage a] B = {STORAGE_BUDGET_X} x {n} x "
            f"{DB_RAW_PER_ENTRY} B = {budget} bytes "
            f"(max_allowed_space_usage, flush headroom {2 * wbuf}); the fill "
            f"latched at {at_latch[0]} tracked bytes, pressure "
            f"{at_latch[1]}, {at_latch[2]} L0 files; levels passed "
            f"{' '.join(watch.levels) or 'none'}; "
            f"NO_SPACE_PREFLIGHT_BLOCKS={blocks} (compactions refused "
            f"{refused[0]}) NO_SPACE_ERRORS={errs_n}; latch {latch[0]} "
            f"{latch[1]}, {failed[0]} writes refused and retried; budget "
            f"raised to 4B: latch cleared in {ttr:.3f}s (time to recover) "
            f"with 0 resume() calls ({len(watch.recovered)} auto), "
            f"{len(after)} device jobs after it on {device_name}; tracked "
            f"{tracked} bytes against {on_disk} on disk; {len(acked)} acked "
            f"keys read back in {rb:.3f}s; wall {time.time() - t_a:.3f}s "
            f"[{card}]")

        # (b) A disk that really fills: FaultInjectionEnv's byte budget.
        t_b = time.time()
        fe = FaultInjectionEnv(PosixEnv())
        fbudget = int(FULL_BUDGET_X * n_full * DB_RAW_PER_ENTRY)
        fe.set_disk_budget("*", fbudget)
        stats = st.Statistics()
        watch = Watch()
        bdir = os.path.join(root, "full")
        db = DB.open(bdir, options(free_space_poll_period_sec=0.05,
                                   statistics=stats, listeners=[watch]),
                     env=fe)
        ts, acked, failed, first, errs = storage_fill(
            db, key_n(n_full), n_full, lambda k: value)
        for t in ts:
            t.join()
        assert not errs, errs
        assert fe.enospc_injected >= 1, "no genuine ENOSPC"
        # The fill's first latch (its memtable switch refused by the
        # preflight) cleared itself while the disk still had room. The
        # disk is full now: with 64 KiB freed (so the WAL's sync can land)
        # a flush is refused by the preflight and the latch holds at red.
        early = list(watch.recovered)
        assert fe.disk_budget_remaining("*") == 0
        fe.add_disk_budget("*", 64 << 10)
        try:
            db.flush()
            raise AssertionError("a flush on the full disk succeeded")
        except Exception as e:  # noqa: BLE001
            from toplingdb_tpu_torch.utils.status import is_no_space

            assert is_no_space(e), repr(e)
        wait_for(lambda: db._bg_error is not None, 30, "no latch")
        time.sleep(0.3)  # the recover loop parks on the headroom gate
        assert db._bg_error is not None, "the latch cleared on a full disk"
        latch = (db._bg_error_reason, db._bg_error_severity.name,
                 db.disk_pressure())
        assert latch == ("no_space", "SOFT_ERROR", "red"), latch
        rl = read_back(db, acked, lambda k: value, "full, latched")
        t_raise = time.time()
        fe.add_disk_budget("*", 64 << 20)
        ttr = wait_for(lambda: db._bg_error is None, 60,
                       "the ENOSPC latch never cleared")
        post = [b"%016d" % (2 * n_full + 1 + 2 * i)
                for i in range(FULL_POST_N)]
        oracle = set(acked) | set(post)
        for i in range(0, len(post), 100):
            b = WriteBatch()
            for k in post[i:i + 100]:
                b.put(k, value)
            db.write(b)
        db.flush()
        jobs_before = len(joblog.jobs)
        db.compact_range()
        assert len(joblog.jobs) > jobs_before, "no card job after ENOSPC"
        native = stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS)
        fallbacks = stats.get_ticker_count(st.WRITE_GROUP_FALLBACKS)
        enospc = fe.enospc_injected
        db.close()
        db = DB.open(bdir, options())  # a plain PosixEnv
        rr = read_back(db, oracle, lambda k: value, "full, reopened")
        it = db.new_iterator()
        it.seek_to_first()
        attempted = {db_key(i, n_full) for i in range(n_full)} | set(post)
        extra = 0
        for k, v in it.entries():
            assert k in attempted and v == value, k
            extra += k not in oracle
        del it
        db.close()
        log(f"[storage b] FaultInjectionEnv(PosixEnv()) budget "
            f"{FULL_BUDGET_X} x {n_full} x {DB_RAW_PER_ENTRY} B = {fbudget} "
            f"bytes: {len(acked)} of {n_full} keys acked, {failed[0]} "
            f"writes failed, {enospc} genuine ENOSPC (torn short writes), "
            f"{len(early)} preflight latch of the fill cleared on its own "
            f"while room was left; on the full disk, 64 KiB freed, a flush "
            f"latched {latch[0]} {latch[1]} at pressure {latch[2]}; every "
            f"acked key read while "
            f"latched ({rl:.3f}s); add_disk_budget(64 MiB): latch cleared "
            f"in {ttr:.3f}s, {len(watch.recovered)} auto recoveries in all; "
            f"{FULL_POST_N} more keys, flush, compact_range on "
            f"{device_name}; reopened on PosixEnv: {len(oracle)} keys equal "
            f"the oracle ({rr:.3f}s), {extra} keys of writes that raised "
            f"after their commit; WRITE_GROUP_NATIVE_COMMITS={native} "
            f"WRITE_GROUP_FALLBACKS={fallbacks} under the fault env; wall "
            f"{time.time() - t_b:.3f}s [{card}]")

        # (c) preclude_last_level_data_seconds=3600.
        t_c = time.time()
        cdir = os.path.join(root, "preclude")
        copts = dict(preclude_last_level_data_seconds=3600)
        db = DB.open(cdir, options(**copts))
        pn = min(n, PRECLUDE_N)
        fill = threaded_fill(db, pn, lambda i: (db_key(i, pn), value))
        rng = random.Random(22)
        keys = sorted(db_key(i, pn) for i in range(pn))
        dead = sorted(rng.sample(keys, pn // 100))
        for i in range(0, len(dead), 100):
            b = WriteBatch()
            for k in dead[i:i + 100]:
                b.delete(k)
            db.write(b)
        db.flush()
        db.wait_for_compactions()
        live = sorted(set(keys) - set(dead))
        j0 = len(joblog.jobs)
        t0 = time.time()
        db.compact_range()
        w1 = time.time() - t0
        jobs1 = joblog.jobs[j0:]
        assert jobs1, "no card job in the precluded compact_range"
        last = db.versions.current.files[-1]
        assert last and min(f.smallest_seqno for f in last) > 0, \
            "young data lost its seqnos"
        n_files = db_files_against_oracle(db, live, value, tombstones=dead)
        kept = sum(f.num_deletions for f in last)
        assert kept == len(dead), (kept, len(dead))
        overlay = rng.sample(live, OVERLAY_PRECLUDE_N)
        for i in range(0, len(overlay), 100):
            b = WriteBatch()
            for k in overlay[i:i + 100]:
                b.put(k, value)
            db.write(b)
        db.flush()
        db.close()
        side = os.path.join(cdir, "SEQNO_TIME.json")
        with open(side) as f:
            pairs = json.load(f)
        with open(side, "w") as f:
            f.write(json.dumps([[q, t - 7200] for q, t in pairs]))
        db = DB.open(cdir, options(**copts))
        j0 = len(joblog.jobs)
        t0 = time.time()
        db.compact_range()
        w2 = time.time() - t0
        jobs2 = joblog.jobs[j0:]
        assert any(j["output_level"] == db.versions.current.num_levels - 1
                   for j in jobs2), jobs2
        last = db.versions.current.files[-1]
        assert max(f.largest_seqno for f in last) == 0, \
            "aged data kept its seqnos"
        n_files2 = db_files_against_oracle(db, live, value)
        db.close()
        log(f"[storage c] preclude_last_level_data_seconds=3600: fill of "
            f"{pn} keys {fill:.3f}s, {len(dead)} deletes; compact_range "
            f"{w1:.3f}s in {len(jobs1)} device jobs (non-bottommost): "
            f"{n_files} last-level files, smallest_seqno > 0, "
            f"{kept} tombstones kept, rows equal the oracle; a "
            f"{OVERLAY_PRECLUDE_N}-key overlay, close, the sidecar's "
            f"{len(pairs)} samples moved back 7200 s, reopen: compact_range "
            f"{w2:.3f}s in {len(jobs2)} device jobs, the last level's "
            f"{n_files2} files zeroed (largest_seqno 0), tombstones dropped, "
            f"rows equal the oracle; wall {time.time() - t_c:.3f}s [{card}]")

        # (d) Wide-column entities with a merge overlay (the complex fold).
        t_d = time.time()
        ddir = os.path.join(root, "entity")
        db = DB.open(ddir, options(
            merge_operator=StringAppendOperator(b",")))
        ekeys = [db_key(i, n_entity) for i in range(n_entity)]

        def cols(k):
            return {b"": b"d" + k[-19:].rjust(19, b"0"),
                    b"c1": b"a" + k[-19:].rjust(19, b"0"),
                    b"c2": b"b" + k[-19:].rjust(19, b"0")}

        per_t = n_entity // 4
        errs = []

        def ent_worker(t):
            try:
                for i in range(t * per_t, (t + 1) * per_t, 100):
                    b = WriteBatch()
                    for k in ekeys[i:min(i + 100, (t + 1) * per_t)]:
                        b.put_entity(k, encode_entity(cols(k)))
                    db.write(b)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=ent_worker, args=(t,))
              for t in range(4)]
        t0 = time.time()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        efill = time.time() - t0
        assert not errs, errs
        want = {k: cols(k) for k in ekeys}
        db.flush()
        for k in rng.sample(ekeys, ENTITY_MERGE_N):
            db.merge(k, b"m")
            want[k] = dict(want[k])
            want[k][b""] += b",m"
        db.flush()
        db.wait_for_compactions()
        j0 = len(joblog.jobs)
        t0 = time.time()
        db.compact_range()
        w3 = time.time() - t0
        jobs3 = joblog.jobs[j0:]
        assert jobs3, "no card job over the entities"
        probes = rng.sample(ekeys, ENTITY_PROBES)
        t0 = time.time()
        for k in probes:
            assert db.get_entity(k) == want[k], k
        pr = time.time() - t0
        t0 = time.time()
        for i in range(0, len(probes), 128):
            part = probes[i:i + 128]
            assert db.multi_get(part) == [want[k][b""] for k in part]
        mg = time.time() - t0
        t0 = time.time()
        it = db.new_iterator()
        it.seek_to_first()
        got = 0
        for k in sorted(ekeys):
            assert it.valid() and it.key() == k, k
            assert it.columns() == want[k] and it.value() == want[k][b""]
            it.next()
            got += 1
        assert not it.valid()
        del it
        sc = time.time() - t0
        db.close()
        log(f"[storage d] {n_entity} entities of three 20-byte columns "
            f"from 4 writers {efill:.3f}s ({n_entity / efill:.0f} ops/s, "
            f"the Python commit), a {ENTITY_MERGE_N}-key string-append "
            f"merge overlay; compact_range {w3:.3f}s in {len(jobs3)} device "
            f"jobs; {ENTITY_PROBES} get_entity probes {pr:.3f}s, the same "
            f"keys through multi_get batches of 128 {mg:.3f}s, a scan of "
            f"{got} entities with columns() {sc:.3f}s, all equal the oracle "
            f"[{card}]")
        t_last = time.time()
        gc_n, mr_n = launched()
    joblog.check(device_name, "storage")
    assert joblog.jobs, "no compaction ran on the device executor"
    if device_name != "cpu":
        assert gc_n >= len(joblog.jobs), (gc_n, len(joblog.jobs))
    log(f"[storage e] {len(joblog.jobs)} device jobs in the phase, launches "
        f"gc_rows={gc_n} merge_runs={mr_n}; open to the last read: "
        f"{busy_text(programs, joblog, t_last - t_open)} [{card}]")
    return gc_n, mr_n


def ts_files_against_oracle(db, rows) -> int:
    """Every live SST of a compacted timestamp DB read back with the
    port's table reader: one level holds them all, and their rows, in file
    order, are the (stored key, value) pairs `rows` (sorted by stored key),
    each a PUT. Returns the file count."""
    from toplingdb_tpu_torch.db import filename

    version = db.versions.current
    levels = [fl for fl in version.files if fl]
    assert len(levels) == 1, version.describe()
    width = len(rows[0][0]) + 8
    vlen = len(rows[0][1])
    ukeys, vtypes, vals = [], [], []
    for m in levels[0]:
        kv = scan_output(db.env, filename.table_file_name(db.dbname,
                                                          m.number), db.icmp)
        assert m.num_entries == kv.n
        assert np.all(kv.key_lens == width), "unexpected key length"
        assert np.all(kv.val_lens == vlen), "unexpected value length"
        kb = kv.key_buf.reshape(kv.n, width)
        ukeys.append(kb[:, :-8])
        trailer = np.ascontiguousarray(kb[:, -8:]).view("<u8").reshape(-1)
        vtypes.append(trailer & np.uint64(0xFF))
        vals.append(kv.val_buf[kv.val_offs[:, None].astype(np.int64)
                               + np.arange(vlen)])
    ukeys, vtypes, vals = (np.concatenate(a) for a in (ukeys, vtypes, vals))
    wkeys = np.frombuffer(b"".join(k for k, _ in rows), np.uint8).reshape(
        len(rows), -1)
    wvals = np.frombuffer(b"".join(v for _, v in rows), np.uint8).reshape(
        len(rows), -1)
    assert ukeys.shape == wkeys.shape, (ukeys.shape, wkeys.shape)
    assert np.array_equal(ukeys, wkeys), "stored keys differ from the oracle"
    assert np.all(vtypes == 1), "a row is not a PUT"
    assert np.array_equal(vals, wvals), "values differ from the oracle"
    return len(levels[0])


def ts_part(root, n, factory, joblog, card, rng):
    """Phase 23 (a): user-defined timestamps. Returns the part's jobs."""
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.dbformat import (
        U64_TS_BYTEWISE,
        encode_ts_key,
    )
    from toplingdb_tpu_torch.options import Options, ReadOptions
    from toplingdb_tpu_torch.utils.status import InvalidArgument

    value, wvalue, xvalue = b"v" * 20, b"w" * 20, b"x" * 20
    n_ow = n // 5  # the overwritten 20%: keys 5j, j < n_ow
    low1 = TS_OVERWRITE_BASE - 1

    def base_ts(i):
        return i // 100 + 1  # one timestamp a batch of 100

    def ow_ts(j):
        return TS_OVERWRITE_BASE + j * 10_000 // n_ow

    opts = Options(create_if_missing=True, write_buffer_size=8 << 20,
                   comparator=U64_TS_BYTEWISE,
                   compaction_executor_factory=factory)
    tdir = os.path.join(root, "ts")
    j_start = len(joblog.jobs)
    db = DB.open(tdir, opts)
    assert db._write_plane is None  # Python commits, as in the reference
    keys = [db_key(i, n) for i in range(n)]
    fill = threaded_fill(db, n, lambda i: (encode_ts_key(keys[i], base_ts(i)),
                                           value))
    ow = threaded_fill(db, n_ow, lambda j: (
        encode_ts_key(keys[5 * j], ow_ts(j)), wvalue))
    db.increase_full_history_ts_low(low1)
    db.wait_for_compactions()
    j0 = len(joblog.jobs)
    t0 = time.time()
    db.compact_range()
    cr1 = time.time() - t0
    jobs1 = joblog.jobs[j0:]
    # The trim at low1 keeps both versions of an overwritten key (the old
    # one is the value visible at low1): n + n_ow rows.
    rows = sorted([(encode_ts_key(keys[i], base_ts(i)), value)
                   for i in range(n)]
                  + [(encode_ts_key(keys[5 * j], ow_ts(j)), wvalue)
                     for j in range(n_ow)])
    files1 = ts_files_against_oracle(db, rows)
    del rows

    def newest(i):
        if i % 5 == 0 and i // 5 < n_ow:
            return wvalue, ow_ts(i // 5)
        return value, base_ts(i)

    probes = [rng.randrange(2 * n) for _ in range(TS_PROBES)]
    t0 = time.time()
    for i in probes:
        want = newest(i) if i < n else None
        got = db.get_with_ts(db_key(i, n))
        assert got == want, (i, got, want)
    p1 = time.time() - t0
    ro = ReadOptions(timestamp=low1)
    t0 = time.time()
    for i in probes:
        got = db.get(db_key(i, n), ro)
        assert got == (value if i < n else None), (i, got)
    p2 = time.time() - t0
    t0 = time.time()
    it = db.new_iterator(ro)
    it.seek_to_first()
    order = sorted(range(n), key=lambda i: keys[i])
    for i in order:
        assert it.valid() and it.key() == keys[i], i
        assert it.value() == value and it.timestamp() == base_ts(i), i
        it.next()
    assert not it.valid()
    del it
    sc = time.time() - t0
    # Raise the trim point above every timestamp. compact_range pushes
    # data down and never rewrites the last level on its own, so the
    # smallest and the largest key get a new version first: the last
    # hop then rewrites every last-level file under the new trim.
    lo_k, hi_k = keys[order[0]], keys[order[-1]]
    db.put(lo_k, xvalue, ts=TS_OVERWRITE_BASE + 10_000)
    db.put(hi_k, xvalue, ts=TS_OVERWRITE_BASE + 10_000)
    low2 = TS_OVERWRITE_BASE + 10_001
    db.increase_full_history_ts_low(low2)
    j1 = len(joblog.jobs)
    t0 = time.time()
    db.compact_range()
    cr2 = time.time() - t0
    jobs2 = joblog.jobs[j1:]
    rows = []
    for i in range(n):
        v, ts = newest(i)
        if keys[i] in (lo_k, hi_k):
            v, ts = xvalue, TS_OVERWRITE_BASE + 10_000
        rows.append((encode_ts_key(keys[i], ts), v))
    rows.sort()
    files2 = ts_files_against_oracle(db, rows)
    assert len(rows) == n
    del rows
    db.close()
    db = DB.open(tdir, Options(comparator=U64_TS_BYTEWISE,
                               compaction_executor_factory=factory))
    assert db.options.full_history_ts_low == low2
    try:
        db.get(keys[0], ReadOptions(timestamp=low1))
        raise AssertionError("a read below the trim point was served")
    except InvalidArgument:
        pass
    assert db.get_with_ts(keys[order[len(order) // 2]]) is not None
    db.close()
    jobs = joblog.jobs[j_start:]
    assert jobs and all(j["route"] == "per-entry" for j in jobs), \
        [j["route"] for j in jobs]
    log(f"[ts a] {n} keys at ts 1-{base_ts(n - 1)} from 4 writers in "
        f"batches of 100 {fill:.3f}s ({n / fill:.0f} ops/s, Python "
        f"commits), {n_ow} overwrites at ts {ow_ts(0)}-{ow_ts(n_ow - 1)} "
        f"{ow:.3f}s ({n_ow / ow:.0f} ops/s); "
        f"increase_full_history_ts_low({low1}), compact_range {cr1:.3f}s in "
        f"{len(jobs1)} per-entry device jobs ({sum(j['rows'] for j in jobs1)}"
        f" rows in): {n + n_ow} rows in {files1} files equal the oracle; "
        f"{TS_PROBES} get_with_ts probes at the newest ts {p1:.3f}s, "
        f"{TS_PROBES} gets at ts {low1} {p2:.3f}s, a scan of {n} keys at "
        f"ts {low1} {sc:.3f}s, all equal the oracle; trim raised to {low2}, "
        f"compact_range {cr2:.3f}s in {len(jobs2)} jobs: {n} rows in "
        f"{files2} files; reopened: the trim point kept, a read below it "
        f"InvalidArgument; {len(jobs)} jobs in the part, all per-entry "
        f"[{card}]")
    return jobs


def replica_part(root, n, n_log, factory, card, rng):
    """Phase 23 (b): a secondary and a tailer on a primary's fill, then a
    read-only open. Returns the primary's directory and its oracle keys."""
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.db_readonly import ReadOnlyDB, SecondaryDB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options, ReadOptions
    from toplingdb_tpu_torch.utils.status import NotSupported

    value = b"v" * 20
    pdir = os.path.join(root, "primary")
    db = DB.open(pdir, Options(create_if_missing=True,
                               write_buffer_size=8 << 20,
                               compaction_executor_factory=factory))
    sec = SecondaryDB.open(pdir)
    # 16 bytes, as the fill's keys: the jobs keep the uniform-key routes.
    log_keys = [b"log/%012d" % i for i in range(n_log)]
    seen, terr = [], []
    t_deadline = time.time() + 900

    def tailer():
        try:
            it = db.new_iterator(ReadOptions(tailing=True,
                                             iterate_upper_bound=b"log0"))
            it.seek(b"log/")
            while len(seen) < n_log and time.time() < t_deadline:
                if it.valid():
                    seen.append(it.key())
                else:
                    time.sleep(TAIL_POLL_S)  # a consumer's poll interval
                it.next()  # past the view's end: the catch-up
        except Exception as e:  # noqa: BLE001
            terr.append(e)

    th = threading.Thread(target=tailer, name="tailer")
    th.start()
    rounds = 10
    per, per_log = n // rounds, n_log // rounds
    catch, reads, fills = [], [], []
    for r in range(rounds):
        lerr = []

        def log_writer(r=r):
            try:
                part = log_keys[r * per_log:(r + 1) * per_log]
                for i in range(0, len(part), 100):
                    b = WriteBatch()
                    for k in part[i:i + 100]:
                        b.put(k, value)
                    db.write(b)
            except Exception as e:  # noqa: BLE001
                lerr.append(e)

        lw = threading.Thread(target=log_writer, name="log-writer")
        t0 = time.time()
        lw.start()
        threaded_fill(db, per, lambda j, r=r: (db_key(r * per + j, n),
                                                value))
        lw.join()
        fills.append(time.time() - t0)
        assert not lerr, lerr
        # Every key of rounds 0..r is acked. The catch-up and the reads
        # run with the primary's background work paused: a secondary pins
        # none of the primary's files, so a job that ends after the
        # catch-up could delete a table the secondary is about to open
        # (tests/test_torch_read_only.py).
        db.pause_background_work()
        try:
            t0 = time.time()
            sec.try_catch_up_with_primary()
            catch.append(time.time() - t0)
            t0 = time.time()
            for _ in range(SECONDARY_READS):
                i = rng.randrange((r + 1) * per)
                got = sec.get(db_key(i, n))
                assert got == value, (r, i, got)
            reads.append(time.time() - t0)
        finally:
            db.continue_background_work()
    th.join(timeout=max(1.0, t_deadline - time.time()))
    assert not th.is_alive() and not terr, terr
    assert seen == log_keys, (len(seen), seen[:3], seen[-3:])
    db.wait_for_compactions()
    sec.close()
    db.close()
    want = sorted([db_key(i, n) for i in range(n)] + log_keys)
    log(f"[replicas b] primary: {n} keys from 4 writers in batches of 100 "
        f"and {n_log} sequential log/ keys from a fifth (batches of 100 "
        f"too), in {rounds} rounds "
        f"({sum(fills):.3f}s, {(n + n_log) / sum(fills):.0f} ops/s); the "
        f"secondary caught up after each round (median "
        f"{statistics.median(catch):.3f}s, max {max(catch):.3f}s) with the "
        f"primary's background work paused and read {SECONDARY_READS} acked "
        f"keys each time (median {statistics.median(reads):.3f}s), all "
        f"equal; the tailing iterator saw {len(seen)} of {n_log} log/ keys "
        f"once each, in order [{card}]")

    t0 = time.time()
    rdb = ReadOnlyDB.open(pdir)
    t_open = time.time() - t0
    try:
        rdb.put(b"x", value)
        raise AssertionError("a read-only put was served")
    except NotSupported:
        pass
    probes = [rng.randrange(2 * n) for _ in range(RO_PROBES)]
    t0 = time.time()
    for i in probes:
        got = rdb.get(db_key(i, n))
        assert got == (value if i < n else None), (i, got)
    pr = time.time() - t0
    t0 = time.time()
    it = rdb.new_iterator()
    it.seek_to_first()
    got = 0
    for (k, v), wk in zip(it.entries(), want):
        assert k == wk and v == value, (k, wk)
        got += 1
    assert got == len(want) and not it.valid()
    del it
    sc = time.time() - t0
    rdb.close()
    log(f"[replicas b] ReadOnlyDB.open {t_open:.3f}s, put NotSupported, "
        f"{RO_PROBES} probes {pr:.3f}s and a scan of {got} keys {sc:.3f}s "
        f"equal the oracle [{card}]")
    return pdir, want


def prefix_part(root, factory, card, rng):
    """Phase 23 (b): prefix_same_as_start over an 8-byte fixed prefix."""
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.options import Options, ReadOptions
    from toplingdb_tpu_torch.utils.slice_transform import (
        FixedPrefixTransform,
    )

    db = DB.open(os.path.join(root, "prefix"), Options(
        create_if_missing=True, write_buffer_size=8 << 20,
        prefix_extractor=FixedPrefixTransform(8),
        compaction_executor_factory=factory))
    per = 10  # keys a prefix: suffixes 0, 3, ..., 27
    n_p = PREFIX_N // per

    def key(i):
        return b"%08d%08d" % (i // per, 3 * (i % per))

    fill = threaded_fill(db, PREFIX_N, lambda i: (key(i), b"v" * 20))
    db.compact_range()
    t0 = time.time()
    total = 0
    for _ in range(PREFIX_SEEKS):
        p, j0 = rng.randrange(n_p), rng.randrange(30)
        it = db.new_iterator(ReadOptions(prefix_same_as_start=True))
        it.seek(b"%08d%08d" % (p, j0))
        got = [k for k, _ in it.entries()]
        want = [b"%08d%08d" % (p, 3 * j) for j in range(per) if 3 * j >= j0]
        assert got == want, (p, j0, got[:3])
        total += len(got)
    sk = time.time() - t0
    db.close()
    log(f"[replicas b] {PREFIX_N} keys of {n_p} 8-byte prefixes "
        f"{fill:.3f}s; {PREFIX_SEEKS} seeks with prefix_same_as_start "
        f"{sk:.3f}s, each stopped at the end of its prefix ({total} keys) "
        f"[{card}]")


def repair_part(root, pdir, want, factory, card):
    """Phase 23 (c): repair_db on a copy of the primary."""
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.repair import repair_db
    from toplingdb_tpu_torch.options import Options

    value = b"v" * 20
    rdir = os.path.join(root, "repaired")
    shutil.copytree(pdir, rdir)
    lost = [f for f in os.listdir(rdir)
            if f.startswith("MANIFEST") or f == "CURRENT"]
    for f in lost:
        os.remove(os.path.join(rdir, f))
    t0 = time.time()
    report = repair_db(rdir, Options())
    rw = time.time() - t0
    assert report["tables_dropped"] == 0 and report["wal_errors"] == 0, report

    def scan(db):
        it = db.new_iterator()
        it.seek_to_first()
        got = 0
        for (k, v), wk in zip(it.entries(), want):
            assert k == wk and v == value, (k, wk)
            got += 1
        assert got == len(want) and not it.valid()

    db = DB.open(rdir, Options(write_buffer_size=8 << 20,
                               compaction_executor_factory=factory))
    l0 = len(db.versions.current.files[0])
    t0 = time.time()
    scan(db)
    s1 = time.time() - t0
    t0 = time.time()
    db.compact_range()
    cr = time.time() - t0
    scan(db)
    db.close()
    log(f"[repair c] MANIFEST and CURRENT deleted ({len(lost)} files); "
        f"repair_db {rw:.3f}s, report {json.dumps(report)}; reopened with "
        f"{l0} L0 tables, a scan of {len(want)} keys {s1:.3f}s equal the "
        f"oracle; compact_range on the card {cr:.3f}s, the scan again equal "
        f"[{card}]")


def replica_path(torch, root, card, device_name="cuda", ts_n=TS_N,
                 n=REPLICA_N, n_log=LOG_N):
    """Phase 23 (see the module docstring): (a) user-defined timestamps,
    (b) a secondary, a tailer, a read-only open and prefix seeks, (c)
    repair, (d) the jobs and launches. Every DB of the phase opens with
    one device factory, under one JobLog. Returns the (gc_rows,
    merge_runs) launches."""
    import random

    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.ops import kernels

    os.makedirs(root, exist_ok=True)
    rng = random.Random(23)
    factory = DeviceCompactionExecutorFactory(device=device_name)
    launched = counted(kernels)
    walls = {}
    with ShardPrograms(torch) as programs, \
            JobLog(torch, factory, kernels) as joblog:
        t_open = time.time()
        t0 = time.time()
        ts_jobs = ts_part(root, ts_n, factory, joblog, card, rng)
        walls["a"] = time.time() - t0
        t0 = time.time()
        pdir, want = replica_part(root, n, n_log, factory, card, rng)
        prefix_part(root, factory, card, rng)
        walls["b"] = time.time() - t0
        t0 = time.time()
        repair_part(root, pdir, want, factory, card)
        walls["c"] = time.time() - t0
        t_last = time.time()
        gc_n, mr_n = launched()
    joblog.check(device_name, "replicas")
    assert joblog.jobs, "no compaction ran on the device executor"
    if device_name != "cpu":
        for j in ts_jobs:
            assert j["gc"] >= 1 or not j["alone"], j
        assert gc_n >= len(joblog.jobs), (gc_n, len(joblog.jobs))
    log(f"[replicas d] {len(joblog.jobs)} device jobs in the phase "
        f"({len(ts_jobs)} per-entry timestamp jobs, gc_rows launched by "
        f"each), launches gc_rows={gc_n} merge_runs={mr_n}; part walls (s) "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}; open "
        f"to the last read: {busy_text(programs, joblog, t_last - t_open)} "
        f"[{card}]")
    return gc_n, mr_n


def http_get(url: str) -> bytes:
    """GET `url`; anything but a 200 raises."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        assert r.status == 200, (url, r.status)
        return r.read()


def http_json(url: str, body: bytes | None = None):
    """GET (or POST `body` to) `url`; the answer parsed as JSON."""
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200, (url, r.status)
        return json.loads(r.read())


_PROM_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$")


def parse_prometheus(text: str) -> int:
    """Checks every line of a Prometheus text exposition; returns the
    number of samples."""
    n = 0
    for line in text.splitlines():
        if not line.strip() or line.startswith("# TYPE "):
            continue
        assert _PROM_SAMPLE.match(line), f"bad exposition line {line!r}"
        n += 1
    return n


class RoutePoller:
    """A thread that GETs each of `routes` under `base` every `period`
    seconds until stopped: every answer must be a 200 that parses (JSON,
    or Prometheus text for /metrics). `firing` records the first time the
    named SLO of a /slo route read firing, `answers` counts the answers."""

    def __init__(self, base, routes, period=0.5, slo=None):
        self.base, self.routes, self.period, self.slo = (base, routes,
                                                         period, slo)
        self.answers = 0
        self.errors = []
        self.firing_at = None
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, name="smoke-poller")

    def _run(self):
        while not self._stop.is_set():
            for route in self.routes:
                try:
                    body = http_get(f"{self.base}/{route}")
                    if route == "metrics":
                        assert parse_prometheus(body.decode()) > 0
                    else:
                        doc = json.loads(body)
                        if (self.slo is not None and route.startswith("slo/")
                                and self.firing_at is None
                                and doc["specs"][self.slo]["firing"]):
                            self.firing_at = time.time()
                    self.answers += 1
                except Exception as e:  # noqa: BLE001 - reported by stop()
                    self.errors.append(f"{route}: {e!r}")
            self._stop.wait(self.period)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        assert not self.errors, self.errors[:5]


def sp_config(path, name, device_name, **extra):
    """Phase 24's SidePlugin config: phase 13's deployment (8 MiB write
    buffer, leveled, L0 trigger 4) with the device factory on
    `device_name`, a 10-bit bloom filter, a default Statistics with a 60 s
    histogram window, the span tracer sampling 1 op in 1000, a latency SLO
    on DB_GET_MICROS and a stall SLO, evaluated every second; `extra`
    overrides options."""
    from toplingdb_tpu_torch.utils import statistics as st

    opts = {
        "create_if_missing": True,
        "write_buffer_size": 8 << 20,
        "compaction_executor_factory": {
            "class": "device", "params": {"device_name": device_name}},
        "table_options": {"filter_policy": {
            "class": "bloom", "params": {"bits_per_key": 10}}},
        "statistics": "default",
        "histogram_window_sec": 60,
        "trace_sample_every": 1000,
        "slo_specs": [
            {"name": "get-p99", "kind": "latency",
             "histogram": st.DB_GET_MICROS, "objective": 0.99,
             "threshold_usec": 1000},
            {"name": "write-stall", "kind": "stall", "objective": 0.99}],
        "slo_eval_period_sec": 1,
    }
    opts.update(extra)
    return {"path": path, "name": name, "options": opts}


def scan_rows(db):
    """Every (key, value) of a full forward scan."""
    it = db.new_iterator()
    it.seek_to_first()
    return it.entries()


def sideplugin_part(torch, root, base, repo, card, device_name, n, mix,
                    joblogs):
    """Phase 24 (a) and (b): the SidePlugin deployment opened from its
    config, served over HTTP while it fills under the op trace, then the
    views, the trace's mix, the analyzer and the replay. Returns the
    figures printed by the phase."""
    import random

    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.env import default_env
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.tools import trace_analyzer
    from toplingdb_tpu_torch.utils import concurrency as ccy
    from toplingdb_tpu_torch.utils import config as cfgmod
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.trace import Replayer

    n_gets, n_over, n_seeks, n_mgets = mix
    value, value2 = b"v" * 20, b"w" * 20
    cfg = sp_config(os.path.join(root, "a"), "sp", device_name)
    db = repo.open_db(cfg)
    stats = db.stats
    fig = {}
    jl = JobLog(torch, db.options.compaction_executor_factory, kernels)
    joblogs.append(("a+b", jl))
    with jl:
        trace_path = os.path.join(root, "ops.trace")
        db.start_trace(trace_path)
        routes = ["metrics", "slo/sp", "health/sp", "db/sp", "levels/sp"]
        with RoutePoller(base, routes) as poller:
            fill = threaded_fill(db, n, lambda i: (db_key(i, n), value))
        groups = stats.get_ticker_count(st.WRITE_GROUP_LED)
        commits = stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS)
        assert commits == groups > 0, (commits, groups)
        assert stats.get_ticker_count(st.WRITE_GROUP_FALLBACKS) == 0
        fig["fill_traced_ops_s"] = n / fill
        log(f"[sideplugin a] opened by SidePluginRepo.open_db from its "
            f"config; fillrandom {n} keys from 4 threads under the op "
            f"trace: {fill:.3f}s, {n / fill:.0f} ops/s, {commits} native "
            f"commits of {groups} groups; {poller.answers} answers of "
            f"/metrics /slo /health /db /levels polled every 0.5 s, all 200 "
            f"and parsed")
        db.flush()
        db.wait_for_compactions()
        t0 = time.time()
        db.compact_range()
        crw = time.time() - t0
        # /levels matches the version's files.
        v = db.versions.current
        want = {f"L{lvl}": [[f.number, f.file_size, f.num_entries]
                            for f in v.files[lvl]]
                for lvl in range(v.num_levels) if v.files[lvl]}
        got = {lv: [[f["file"], f["size"], f["entries"]] for f in files]
               for lv, files in http_json(f"{base}/levels/sp").items()}
        assert got == want, (got, want)
        # /stats carries the compactions' written bytes.
        lines = http_json(f"{base}/stats/sp")["statistics"]
        cwb = [int(ln.split(":")[-1]) for ln in lines
               if ln.startswith(st.COMPACT_WRITE_BYTES + " COUNT")]
        assert cwb and cwb[0] > 0, lines[:5]
        # /metrics: the SLO gauges and the windowed quantiles.
        t0 = time.time()
        text = http_get(f"{base}/metrics").decode()
        fig["metrics_scrape_ms"] = (time.time() - t0) * 1e3
        n_samples = parse_prometheus(text)
        for want_s in ('tpulsm_slo_health{db="sp"}',
                       'tpulsm_slo_burn_rate_fast{db="sp",slo="get-p99"}',
                       'tpulsm_slo_firing{db="sp",slo="write-stall"}',
                       "tpulsm_db_get_micros_recent",
                       'tpulsm_level_files{db="sp",level="'):
            assert want_s in text, want_s
        # /traces: the sampled trees of the flushes and the compactions.
        names = {t["name"] for t in http_json(f"{base}/traces/sp")["traces"]}
        assert {"flush", "compaction"} <= names, names
        # POST /scrub: one synchronous pass, no mismatch.
        rep = http_json(f"{base}/scrub/sp", b"{}")["report"]
        assert rep["files_scanned"] > 0 and rep["corruptions"] == [], rep
        assert stats.get_ticker_count(
            st.INTEGRITY_PROTECTION_MISMATCHES) == 0
        # The open DB's options serialize back to the config it came from.
        to = cfgmod.options_to_config(db.options)
        assert to == cfgmod.options_to_config(
            cfgmod.options_from_config(cfg["options"]))
        for k, want_v in cfg["options"].items():
            if k in to:
                assert to[k] == want_v, (k, to[k], want_v)
            elif k == "compaction_executor_factory":
                assert db.options.compaction_executor_factory.device == \
                    device_name
            elif k == "table_options":
                assert db.options.table_options.filter_policy \
                    .bits_per_key == 10
            else:  # a default value: options_to_config leaves it out
                assert getattr(db.options, k) == want_v, k
        log(f"[sideplugin a] flush + wait, compact_range {crw:.3f}s on "
            f"{device_name}; /levels = the version's {sum(map(len, want.values()))} "
            f"files; /stats {st.COMPACT_WRITE_BYTES} = {cwb[0]}; /metrics "
            f"{n_samples} samples (tpulsm_slo_* gauges, _recent quantiles) "
            f"in {fig['metrics_scrape_ms']:.1f} ms; /traces holds "
            f"{sorted(names)}; POST /scrub: {rep['files_scanned']} files, "
            f"{rep['bytes_verified']} bytes, 0 corruptions; "
            f"options_to_config = the config [{card}]")
        # (b) The mix, under the trace; the same gets again without it.
        rng = random.Random(5)
        probes = [db_key(rng.randrange(n), n) for _ in range(n_gets)]
        t0 = time.time()
        for k in probes:
            assert db.get(k) is not None, k
        rr_on = time.time() - t0
        step = max(1, n // n_over)
        over = [db_key(i, n) for i in range(0, n, step)][:n_over]
        for i in range(0, len(over), 100):
            b = WriteBatch()
            for k in over[i:i + 100]:
                b.put(k, value2)
            db.write(b)
        for _ in range(n_seeks):
            it = db.new_iterator()
            it.seek(db_key(rng.randrange(n), n))
            for _ in range(10):
                it.next()
        for _ in range(n_mgets):
            ks = [db_key(rng.randrange(n), n) for _ in range(32)]
            assert all(x is not None for x in db.multi_get(ks))
        db.end_trace()
        t0 = time.time()
        for k in probes:
            assert db.get(k) is not None, k
        rr_off = time.time() - t0
        fig["readrandom_traced_ops_s"] = n_gets / rr_on
        fig["readrandom_untraced_ops_s"] = n_gets / rr_off
        eng = db.slo_engine
        t0 = time.perf_counter()
        for _ in range(200):
            eng.evaluate()
        fig["slo_evaluate_us"] = (time.perf_counter() - t0) / 200 * 1e6
        rep = trace_analyzer.analyze(default_env(), trace_path)
        want_ops = {"write_batch": n // 100 + len(over) // 100,
                    "get": n_gets, "iter_seek": n_seeks,
                    "multiget": n_mgets}
        assert rep["per_op"] == want_ops, (rep["per_op"], want_ops)
        log(f"[sideplugin b] the op trace: {rep['total_ops']} records "
            f"({os.path.getsize(trace_path)} bytes), the analyzer's counts "
            f"per op = the calls made {json.dumps(want_ops)}; readrandom "
            f"{n_gets} gets traced {fig['readrandom_traced_ops_s']:.0f} "
            f"ops/s, untraced {fig['readrandom_untraced_ops_s']:.0f} ops/s; "
            f"SLOEngine.evaluate {fig['slo_evaluate_us']:.1f} us a pass "
            f"[{card}]")
    # The replay into a second DB opened from the same config.
    cfg_r = sp_config(os.path.join(root, "r"), "sp-replay", device_name)
    db_r = repo.open_db(cfg_r)
    jl_r = JobLog(torch, db_r.options.compaction_executor_factory, kernels)
    joblogs.append(("replay", jl_r))
    with jl_r:
        t0 = time.time()
        n_ops = Replayer(db_r, trace_path).replay(fast_forward=True,
                                                  threads=1)
        replay = time.time() - t0
        assert n_ops == rep["total_ops"], (n_ops, rep["total_ops"])
        db_r.flush()
        db_r.wait_for_compactions()
        t0 = time.time()
        n_rows = 0
        ends = object()
        import itertools

        for a, b in itertools.zip_longest(scan_rows(db), scan_rows(db_r),
                                          fillvalue=ends):
            assert a == b, (a, b)
            n_rows += 1
        assert n_rows == n, (n_rows, n)
        scan = time.time() - t0
    fig["replay_ops_s"] = n_ops / replay
    log(f"[sideplugin b] Replayer(threads=1, fast_forward) into a DB opened "
        f"from the same config: {n_ops} ops in {replay:.3f}s, "
        f"{fig['replay_ops_s']:.0f} ops/s; its full scan equals the "
        f"original's, {n_rows} rows, {scan:.3f}s for both [{card}]")
    for d in (db, db_r):
        d.close()
        assert ccy.registry.check_leaks(owner=d) == []
    return fig


def stall_part(torch, root, base, repo, card, device_name, n, joblogs):
    """Phase 24 (c): the SLO under a real stall. Returns the seconds from
    the drain to the resolved read."""
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.utils import concurrency as ccy
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.config import options_from_config
    from toplingdb_tpu_torch.utils.listener import EventListener

    window = 2.0
    cfg = sp_config(os.path.join(root, "c"), "sp-stall", device_name,
                    level0_slowdown_writes_trigger=2,
                    level0_file_num_compaction_trigger=4,
                    slo_window_sec=window)
    seen = []

    class Alerts(EventListener):
        def on_slo_alert(self, db, info):
            seen.append((info.slo_name, info.state))

    opts = options_from_config(cfg["options"])
    opts.listeners = [Alerts()]
    db = DB.open(cfg["path"], opts)
    repo.attach_db("sp-stall", db, cfg)
    stats = db.stats
    jl = JobLog(torch, opts.compaction_executor_factory, kernels)
    joblogs.append(("stall", jl))
    rounds = 0
    with jl:
        with RoutePoller(base, ["slo/sp-stall"], period=0.25,
                         slo="write-stall") as poller:
            t_fill = time.time()
            # Rounds over the same keys until /slo reads firing: the
            # 8 MiB memtables reach the slowdown trigger (2 L0 files)
            # after ~2 flushes, and every write then rides the delay ramp.
            while poller.firing_at is None and rounds < 8:
                threaded_fill(db, n, lambda i: (db_key(i, n),
                                                b"%020d" % rounds))
                rounds += 1
            t_stop = time.time()
        assert poller.firing_at is not None, "the stall SLO never fired"
        assert poller.firing_at < t_stop
        db.wait_for_compactions()
        t_drain = time.time()
        resolved_at = None
        while time.time() - t_drain < 3 * window + 2.0:
            doc = http_json(f"{base}/slo/sp-stall")
            if not doc["specs"]["write-stall"]["firing"]:
                resolved_at = time.time()
                break
            time.sleep(0.1)
        assert resolved_at is not None, "not resolved within 3 windows"
        assert resolved_at - t_drain <= 3 * window, resolved_at - t_drain
        stall = [s for name, s in seen if name == "write-stall"]
        assert stall[:2] == ["firing", "resolved"] and \
            stall[-1] == "resolved", seen
        fired = stats.get_ticker_count(st.SLO_ALERTS_FIRED)
        resolved = stats.get_ticker_count(st.SLO_ALERTS_RESOLVED)
        assert fired >= 1 and resolved >= 1, (fired, resolved)
        stall_s = stats.get_ticker_count(st.STALL_MICROS) / 1e6
    log(f"[sideplugin c] {rounds} rounds of {n} keys with "
        f"level0_slowdown_writes_trigger 2: /slo read firing "
        f"{poller.firing_at - t_fill:.2f}s into the fill "
        f"({stall_s:.2f}s stalled in all); resolved "
        f"{resolved_at - t_drain:.2f}s after the writers stopped and the "
        f"jobs drained (window {window}s); on_slo_alert saw {seen}; "
        f"SLO_ALERTS_FIRED={fired} RESOLVED={resolved} [{card}]")
    repo._dbs.pop("sp-stall")
    db.close()
    assert ccy.registry.check_leaks(owner=db) == []
    return resolved_at - t_drain


def lock_cycle(edges):
    """True when the lock-order graph has a cycle."""
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    state = {}

    def visit(x):
        state[x] = 1
        for y in adj.get(x, ()):
            if state.get(y) == 1 or (y not in state and visit(y)):
                return True
        state[x] = 2
        return False

    return any(x not in state and visit(x) for x in list(adj))


def debug_part(torch, root, repo, card, device_name, n, joblogs):
    """Phase 24 (d): (a)'s deployment at n keys with the async WAL and
    the scrubber, filled with lock debug off, then on. Returns (ops/s
    off, ops/s on)."""
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.utils import concurrency as ccy

    rates = {}
    for on in (False, True):
        tag = "on" if on else "off"
        cfg = sp_config(os.path.join(root, f"d-{tag}"), f"sp-debug-{tag}",
                        device_name, enable_async_wal=True,
                        integrity_scrub_period_sec=1)
        if on:
            ccy.reset_lock_graph()
            ccy.set_debug(True)
        try:
            db = repo.open_db(cfg)
            assert (type(db._mutex).__name__ == "_DebugRLock") == on
            jl = JobLog(torch, db.options.compaction_executor_factory,
                        kernels)
            joblogs.append((f"debug-{tag}", jl))
            with jl:
                fill = threaded_fill(db, n, lambda i: (db_key(i, n),
                                                       b"d" * 20))
                db.flush()
                db.wait_for_compactions()
                db.compact_range()
                rates[on] = n / fill
                if on:
                    edges = ccy.lock_order_edges()
                    assert edges, "the debug layer recorded no edge"
                    assert not lock_cycle(edges), sorted(edges)
                    held = ccy.scan_long_holds(threshold_ms=1000)
                    assert held == [], held
            repo._dbs.pop(f"sp-debug-{tag}")
            db.close()
        finally:
            if on:
                ccy.set_debug(False)
        assert ccy.registry.check_leaks(owner=db) == []
    log(f"[sideplugin d] lock debug on (set_debug(True)) against off, "
        f"{n} keys with the async WAL, the 1 s scrubber and compact_range "
        f"on {device_name}: fill {rates[True]:.0f} against {rates[False]:.0f} "
        f"ops/s; no LockInversionError, {len(edges)} lock-order edges, no "
        f"cycle, no hold over 1 s; check_leaks empty after each close "
        f"[{card}]")
    return rates[False], rates[True]


def sideplugin_path(torch, root, card, device_name="cuda", n=SP_N,
                    mix=(SP_GETS, SP_OVERWRITE_N, SP_SEEKS, SP_MGETS),
                    n_stall=SP_STALL_N, n_debug=SP_DEBUG_N):
    """Phase 24 (see the module docstring): (a) the SidePlugin
    deployment served over HTTP, (b) the op trace, its analyzer and the
    replay, (c) the SLO under a real stall, (d) the lock-debug mode,
    (e) the jobs and launches. Returns the (gc_rows, merge_runs)
    launches."""
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.utils import concurrency as ccy
    from toplingdb_tpu_torch.utils.config import SidePluginRepo

    os.makedirs(root, exist_ok=True)
    launched = counted(kernels)
    repo = SidePluginRepo()
    port = repo.start_http(0)
    base = f"http://127.0.0.1:{port}"
    joblogs = []
    walls = {}
    with ShardPrograms(torch) as programs:
        t_open = time.time()
        t0 = time.time()
        fig = sideplugin_part(torch, root, base, repo, card, device_name, n,
                              mix, joblogs)
        walls["a+b"] = time.time() - t0
        t0 = time.time()
        resolve_s = stall_part(torch, root, base, repo, card, device_name,
                               n_stall, joblogs)
        walls["c"] = time.time() - t0
        t0 = time.time()
        off, on = debug_part(torch, root, repo, card, device_name, n_debug,
                             joblogs)
        walls["d"] = time.time() - t0
        t_last = time.time()
        gc_n, mr_n = launched()
    repo.close_all()
    assert ccy.registry.check_leaks(owner=repo) == []
    n_jobs = 0
    entry_ms = 0.0
    for tag, jl in joblogs:
        jl.check(device_name, f"sideplugin {tag}")
        n_jobs += len(jl.jobs)
        entry_ms += jl.entry_ms() if device_name != "cpu" else 0.0
    assert n_jobs, "no compaction ran on the device executor"
    if device_name != "cpu":
        assert gc_n >= 1, gc_n
    ms, busy = programs.busy(t_last - t_open)
    if ms is not None:
        ms += entry_ms
        busy = (f"{ms:.3f} ms of shard programs and per-entry device sorts "
                f"and GC masks by CUDA events, {ms / 1e3 / (t_last - t_open):.4f}"
                f" of the wall (device busy share, derived)")
    phase13 = FIGURES.get("13 fill ops/s")
    log(f"[sideplugin e] {n_jobs} device jobs on {device_name}, launches "
        f"gc_rows={gc_n} merge_runs={mr_n}; open to the last job: {busy}; "
        f"part walls (s) "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})} [{card}]")
    log(f"[sideplugin] fill ops/s trace off (phase 13) "
        f"{'not measured' if phase13 is None else f'{phase13:.0f}'}, "
        f"trace on {fig['fill_traced_ops_s']:.0f}; readrandom ops/s trace on "
        f"{fig['readrandom_traced_ops_s']:.0f}, off "
        f"{fig['readrandom_untraced_ops_s']:.0f}; replay "
        f"{fig['replay_ops_s']:.0f} ops/s; /metrics scrape "
        f"{fig['metrics_scrape_ms']:.1f} ms; SLOEngine.evaluate "
        f"{fig['slo_evaluate_us']:.1f} us a pass; stall SLO resolved "
        f"{resolve_s:.2f}s after the drain; fill with lock debug on "
        f"{on:.0f} against off {off:.0f} ops/s [{card}]")
    return gc_n, mr_n


def gc_columns(n: int, seed: int = 7):
    """A distributed GC job of n rows laid out as compaction_kernels.
    pad_columns lays out ColumnarEntries (12-digit decimal user keys over
    n / 3 keys, unique seqnos 1..n, 70% values, 20% deletions, 10%
    merges, padded to the next power of two), built with numpy, and a
    tombstone cover on 10% of the rows."""
    rng = np.random.default_rng(seed)
    p = 1
    while p < n:
        p *= 2
    draws = rng.integers(0, max(1, n // 3), n)
    digits = ((draws[:, None] // 10 ** np.arange(11, -1, -1, dtype=np.int64))
              % 10 + 48).astype(np.uint32).reshape(n, 3, 4)
    words = ((digits[:, :, 0] << 24) | (digits[:, :, 1] << 16)
             | (digits[:, :, 2] << 8) | digits[:, :, 3]) ^ np.uint32(1 << 31)
    vt = rng.choice(np.array([1] * 7 + [0] * 2 + [2], dtype=np.int64), n)
    packed = (np.arange(1, n + 1, dtype=np.uint64) << np.uint64(8)) \
        | vt.astype(np.uint64)
    inv = ~packed
    sign = np.uint64(1 << 31)
    m32 = np.uint64(0xFFFFFFFF)
    i32max = np.iinfo(np.int32).max
    job = {"n": n, "w": 3,
           "key_words": np.full((p, 3), i32max, dtype=np.int32),
           "key_len": np.full(p, i32max, dtype=np.int32),
           "inv_hi": np.full(p, i32max, dtype=np.int32),
           "inv_lo": np.full(p, i32max, dtype=np.int32),
           "vtype": np.full(p, -1, dtype=np.int32)}
    job["key_words"][:n] = words.view(np.int32)
    job["key_len"][:n] = 12
    job["inv_hi"][:n] = (((inv >> np.uint64(32)) & m32) ^ sign).astype(
        np.uint32).view(np.int32)
    job["inv_lo"][:n] = ((inv & m32) ^ sign).astype(np.uint32).view(np.int32)
    job["vtype"][:n] = vt
    job["tomb_cover"] = np.where(
        rng.random(n) < 0.1, rng.integers(1, n + 1, n), 0).astype(np.uint64)
    return job


def parallel_path(torch, env, dbdir, icmp, topts, n, card,
                  device_name="cuda", gc_rows_n=DGC_ROWS):
    """Phase 25: the mesh route and distributed GC on one card. (a) phase
    4's generator at n entries through the serial route in PARALLEL_SHARDS
    shards: single-device, with the card's own device list (one entry: a
    `single-device` mesh fallback), with the card named twice (placement,
    the UPLOAD_DEPTH x 2 window) on the serial and the pipelined routes,
    and with a wedge injected through the fault seam at shard 3; every run
    writes the single-device bytes. (b) the distributed GC step on NCCL at
    world size 1, a (jobs=1, range=1) mesh over a file store, equal bitwise
    to the same call on a gloo CPU mesh in the same process, and its
    CUDA-event time (median of 5). (c) the driver pair's defaults:
    entry()'s forward step on the card equals the "cpu" step, and
    dryrun_multichip(1) runs one rank. Returns the (gc_rows, merge)
    launches of (a)'s mesh runs and (c)'s forward step."""
    import tempfile

    import torch.distributed as dist

    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.ops import mesh_compaction as mc
    from toplingdb_tpu_torch.parallel import distributed_gc as dg

    dev = torch.device(device_name, 0) if device_name == "cuda" \
        else torch.device("cpu")
    t0 = time.time()
    metas, _rows, _ = write_runs(env, dbdir, icmp, topts, n, Alloc(9))
    log(f"[parallel] inputs: {n} entries, {len(metas)} SSTs "
        f"({time.time() - t0:.1f}s); (a) exercises the mesh route's "
        f"placement on one card (the card named twice) and measures no "
        f"multi-card scaling [{card}]")
    serial = dict(pipeline=False, num_shards=PARALLEL_SHARDS)
    base, bstats, bwall = compact(env, dbdir, icmp, topts, metas, [],
                                  device_name, Alloc(40_000), **serial)
    want = sst_bytes(dbdir, base)
    assert bstats.mesh_chips == 0

    def run(tag, alloc, **kw):
        outs, st_, wall = compact(env, dbdir, icmp, topts, metas, [],
                                  device_name, Alloc(alloc), **kw)
        assert sst_bytes(dbdir, outs) == want, f"{tag}: bytes differ"
        log(f"[parallel] {tag}: wall {wall:.3f}s, "
            f"{n * RAW_PER_ENTRY / 1e6 / wall:.2f} raw MB/s, mesh_chips="
            f"{st_.mesh_chips} mesh_shards={st_.mesh_shards} "
            f"mesh_fallbacks={st_.mesh_fallbacks}, pipelined="
            f"{st_.pipelined}, the single-device bytes [{card}]")
        remove_ssts(dbdir, outs)
        return st_

    log(f"[parallel] single device, serial route: wall {bwall:.3f}s, "
        f"{n * RAW_PER_ENTRY / 1e6 / bwall:.2f} raw MB/s [{card}]")
    st1 = run("the card's own device list (one entry)", 41_000,
              mesh_devices=[dev], **serial)
    assert (st1.mesh_fallbacks, st1.mesh_chips) == (1, 0), \
        "one device must be a single-device mesh fallback"
    kernels.gc_rows.launches = 0
    kernels.merge_runs_perm.launches = 0
    st2 = run("the card named twice, serial route", 42_000,
              mesh_devices=[dev, dev], **serial)
    assert (st2.mesh_chips, st2.mesh_shards, st2.mesh_fallbacks) == \
        (2, PARALLEL_SHARDS, 0)
    st3 = run("the card named twice, pipelined route", 43_000,
              mesh_devices=[dev, dev], pipeline_shards=PARALLEL_SHARDS)
    assert st3.pipelined and st3.mesh_chips == 2
    fired = []

    def wedge(s, _device):
        if s == 3 and not fired:
            fired.append(s)
            raise RuntimeError("injected wedge at shard 3")

    mc._FAULT_HOOK = wedge
    try:
        st4 = run("the card named twice, a wedge at shard 3", 44_000,
                  mesh_devices=[dev, dev], **serial)
    finally:
        mc._FAULT_HOOK = None
    assert fired and (st4.mesh_fallbacks, st4.mesh_chips) == (1, 1)
    gc_n = kernels.gc_rows.launches
    mr_n = kernels.merge_runs_perm.launches
    if device_name != "cpu":
        assert gc_n > 0 and mr_n > 0, "a kernel of the mesh route never ran"
    log(f"[parallel] the mesh runs launched gc_rows={gc_n} merge_runs={mr_n}")
    remove_ssts(dbdir, base)
    remove_ssts(dbdir, metas)

    # (b) distributed GC: NCCL at world size 1 against gloo on the CPU.
    t1 = time.time()
    job = gc_columns(gc_rows_n - 1000)
    snaps = [gc_rows_n // 5, gc_rows_n // 2, 4 * gc_rows_n // 5]
    store = tempfile.mkdtemp(dir=dbdir)
    backend = "nccl" if device_name == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}/store",
                            rank=0, world_size=1,
                            **({"device_id": dev} if dev.type == "cuda"
                               else {}))
    try:
        mesh = dg.make_mesh(1, 1)
        cpu_mesh = dg.make_mesh(1, 1, device="cpu", backend="gloo")
        got = dg.run_distributed_gc(mesh, [job], snaps, True)
        ref = dg.run_distributed_gc(cpu_mesh, [job], snaps, True)
        for a, b, what in zip(got, ref, ("keep", "zero_seq", "idx", "cx")):
            assert a.shape == b.shape and np.array_equal(a, b), \
                f"distributed GC {what} differs between {backend} and gloo"
        w, inputs = dg.step_inputs(mesh, [job], snaps)
        step = dg.make_distributed_gc_step(mesh, w, True)
        times = []
        for _ in range(5):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(*inputs)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t = time.perf_counter()
                step(*inputs)
                times.append((time.perf_counter() - t) * 1e3)
        kept = int(got[0].sum())
        log(f"[parallel] (b) distributed GC, {backend} world 1, a (1, 1) "
            f"mesh, p={job['key_words'].shape[0]} rows ({job['n']} real), "
            f"3 snapshots, tombstone covers: keep/zero_seq/idx/is_complex "
            f"bitwise equal to gloo on the CPU ({kept} kept); the step "
            f"{statistics.median(times):.3f} ms median of 5 "
            f"({'CUDA events' if dev.type == 'cuda' else 'host clock'}), "
            f"all {[round(t, 3) for t in times]} ms; {time.time() - t1:.1f}s "
            f"[{card}]")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # (c) the driver pair with its defaults: entry()'s forward step on the
    # card against the same step on "cpu", then dryrun_multichip(1).
    from toplingdb_tpu_torch.parallel import entry

    t2 = time.time()
    fn, args = entry.entry(device_name)
    kernels.gc_rows.launches = 0
    got = fn(*args)
    entry_n = kernels.gc_rows.launches
    cfn, cargs = entry.entry("cpu")
    for a, b, what in zip(got, cfn(*cargs), ("keep", "zero_seq", "perm")):
        assert np.array_equal(a, b), f"entry() {what} differs from cpu's"
    if device_name != "cpu":
        assert entry_n == 1, "entry() did not launch gc_rows"
    entry.dryrun_multichip(1, store_dir=dbdir, device=device_name)
    log(f"[parallel] (c) entry() on {device_name}: gc_rows launches "
        f"{entry_n}, keep / zero_seq / perm equal to cpu's; "
        f"dryrun_multichip(1) on {backend}: {time.time() - t2:.1f}s "
        f"[{card}]")
    return gc_n + entry_n, mr_n


# ---------------------------------------------------------------------------
# Phase 26: the utilities, the CompactionService and the wrapper Envs
# ---------------------------------------------------------------------------


def txn_part(root, factory, card, n, n_wp, n_undecided):
    """Phase 26 (a): a pessimistic TransactionDB filled by 4 writer threads
    in transactions of 100 keys, compact_range on the card, every key read
    back; a write_prepared TransactionDB's 2PC transactions with a
    snapshot taken while 10 are prepared, a flush and compact_range on the
    card; then 5 prepared transactions across a close and a reopen.
    Returns the open pessimistic TransactionDB and its oracle."""
    from toplingdb_tpu_torch.options import Options, ReadOptions
    from toplingdb_tpu_torch.utilities.transactions import TransactionDB

    def options():
        return Options(create_if_missing=True, write_buffer_size=8 << 20,
                       compaction_executor_factory=factory)

    def value(i):
        return b"t%019d" % i

    tdb = TransactionDB.open(os.path.join(root, "txn"), options())
    errs = []
    per_t = n // 4

    def writer(t):
        try:
            for lo in range(t * per_t, (t + 1) * per_t, 100):
                txn = tdb.begin_transaction()
                for i in range(lo, min(lo + 100, (t + 1) * per_t)):
                    txn.put(db_key(i, n), value(i))
                txn.commit()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ths = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    t0 = time.time()
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    assert not errs, errs
    fill_s = time.time() - t0
    t0 = time.time()
    tdb.db.compact_range()
    compact_s = time.time() - t0
    oracle = {db_key(i, n): value(i) for i in range(per_t * 4)}
    keys = sorted(oracle)
    rr, scan_s, n_probe, found = probe_and_scan(
        tdb.db, keys, oracle.get, per_t * 4, "txn", n_probe=20_000)
    assert found == n_probe
    log(f"[utilities a] pessimistic TransactionDB (write_committed): "
        f"{per_t * 4} keys in {per_t * 4 // 100} transactions of 100 from 4 "
        f"threads, {fill_s:.3f}s ({per_t * 4 / fill_s:.0f} keys/s); "
        f"compact_range on {factory.device} {compact_s:.3f}s; {n_probe} "
        f"gets {rr:.3f}s and a full scan {scan_s:.3f}s equal the oracle "
        f"[{card}]")

    # The write_prepared DB: 2PC transactions of 100 keys.
    wpdir = os.path.join(root, "wp")
    wp = TransactionDB.open(wpdir, options(), write_policy="write_prepared")

    def wkey(j):
        return b"wp%014d" % j

    base = wp.begin_transaction()
    for j in range(1000):                 # the 10 held transactions' keys
        base.put(wkey(j), b"pre%017d" % j)
    base.commit()
    held = []
    for t in range(10):
        txn = wp.begin_transaction()
        txn.set_name(f"held{t}")
        for j in range(t * 100, t * 100 + 100):
            txn.put(wkey(j), b"new%017d" % j)
        txn.prepare()
        held.append(txn)
    snap = wp.db.get_snapshot()
    assert len(snap.excluded_ranges) == 10
    per_w = (n_wp - 10) // 4

    def wp_writer(t):
        try:
            for x in range(10 + t * per_w, 10 + (t + 1) * per_w):
                txn = wp.begin_transaction()
                txn.set_name(f"x{x}")
                for j in range(x * 100, x * 100 + 100):
                    txn.put(wkey(j), b"new%017d" % j)
                txn.prepare()
                txn.commit()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ths = [threading.Thread(target=wp_writer, args=(t,)) for t in range(4)]
    t0 = time.time()
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    assert not errs, errs
    wp_s = time.time() - t0
    n_txn = 10 + 4 * per_w
    for txn in held:
        txn.commit()
    assert len(wp._parked_guards) == 10, len(wp._parked_guards)
    t0 = time.time()
    wp.db.flush()
    wp.db.compact_range()
    wp_compact_s = time.time() - t0
    ro = ReadOptions(snapshot=snap)
    for j in range(1000):
        assert wp.get(wkey(j), ro) == b"pre%017d" % j, j
    wkeys = [wkey(j) for j in range(n_txn * 100)]
    _, wscan, _, _ = probe_and_scan(
        wp.db, wkeys, lambda k: b"new" + k[2:].rjust(17, b"0"), len(wkeys),
        "wp", n_probe=0)
    snap.release()
    wp.begin_transaction().rollback()      # sweeps the parked guards
    assert not wp._parked_guards
    # Five prepared transactions across a close and a reopen.
    for t in range(n_undecided):
        txn = wp.begin_transaction()
        txn.set_name(f"u{t}")
        for j in range(t * 100, t * 100 + 100):
            txn.put(wkey(j), b"und%017d" % j)
        txn.prepare()
    assert wp.get(wkey(0)) == b"new%017d" % 0
    wp.close()
    t0 = time.time()
    wp = TransactionDB.open(wpdir, options(), write_policy="write_prepared")
    reopen_s = time.time() - t0
    rec = sorted(wp.get_prepared_transactions(), key=lambda x: x.name)
    assert [x.name for x in rec] == [f"u{t}" for t in range(n_undecided)]
    for j in range(n_undecided * 100):
        assert wp.get(wkey(j)) == b"new%017d" % j   # still undecided
    for x in rec[:3]:
        x.commit()
    for x in rec[3:]:
        x.rollback()
    for j in range(n_undecided * 100):
        want = b"und%017d" % j if j < 300 else b"new%017d" % j
        assert wp.get(wkey(j)) == want, j
    wp.db.compact_range()
    assert wp.get(wkey(350)) == b"new%017d" % 350
    wp.close()
    log(f"[utilities a] write_prepared TransactionDB: {n_txn} 2PC "
        f"transactions of 100 keys (prepare, commit) from 4 threads "
        f"{wp_s:.3f}s ({n_txn / wp_s:.0f} txn/s); a snapshot taken while "
        f"10 were prepared read every pre-transaction value after their "
        f"commit, a flush and compact_range on {factory.device} "
        f"({wp_compact_s:.3f}s; 10 parked guards), the live view the new "
        f"ones (scan {wscan:.3f}s); {n_undecided} prepared transactions "
        f"across close and reopen ({reopen_s:.3f}s): 3 committed, 2 rolled "
        f"back, every key checked [{card}]")
    return tdb, oracle


def backup_part(root, tdb, oracle, factory, card, n_more, n_overlay, n):
    """Phase 26 (b): a checkpoint of (a)'s live DB opened and compacted
    on the card, and two backups with a restore."""
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utilities.backup_engine import BackupEngine
    from toplingdb_tpu_torch.utilities.checkpoint import create_checkpoint

    def options():
        return Options(write_buffer_size=8 << 20,
                       compaction_executor_factory=factory)

    def scan_all(db):
        it = db.new_iterator()
        it.seek_to_first()
        return list(it.entries())

    db = tdb.db
    # An overlay in L0 over (a)'s compacted level, so the checkpoint's
    # compact_range has a job to run.
    for lo in range(0, n_overlay, 100):
        b = WriteBatch()
        for i in range(lo, min(lo + 100, n_overlay)):
            k = db_key(i * 7 % n, n)
            b.put(k, b"o%019d" % i)
            oracle[k] = b"o%019d" % i
        db.write(b)
    db.flush()
    ck = os.path.join(root, "ckpt")
    t0 = time.time()
    create_checkpoint(db, ck)
    ck_s = time.time() - t0
    src_scan = scan_all(db)
    assert src_scan == sorted(oracle.items())
    with DB.open(ck, options()) as cdb:
        t0 = time.time()
        cdb.compact_range()
        ckc_s = time.time() - t0
        assert scan_all(cdb) == src_scan
    be = BackupEngine(os.path.join(root, "backups"))
    t0 = time.time()
    b1 = be.create_backup(db)
    b1_s = time.time() - t0
    for lo in range(0, n_more, 100):
        b = WriteBatch()
        for j in range(lo, min(lo + 100, n_more)):
            k = b"bk%014d" % j
            b.put(k, b"b%019d" % j)
            oracle[k] = b"b%019d" % j
        db.write(b)
    t0 = time.time()
    b2 = be.create_backup(db)
    b2_s = time.time() - t0
    metas = {}
    for bid in (b1, b2):
        with open(os.path.join(root, "backups", "meta", f"{bid}.json")) as f:
            metas[bid] = {x["shared"] for x in json.load(f)["files"]}
    shared = len(metas[b1] & metas[b2])
    be.verify_backup(b2)
    rdir = os.path.join(root, "restored")
    t0 = time.time()
    be.restore_db_from_backup(b2, rdir)
    restore_s = time.time() - t0
    src_scan = scan_all(db)
    assert src_scan == sorted(oracle.items())
    with DB.open(rdir, options()) as rdb:
        assert scan_all(rdb) == src_scan
    log(f"[utilities b] checkpoint of the live DB (an L0 overlay of "
        f"{n_overlay} keys over its compacted level) {ck_s:.3f}s, opened "
        f"and compacted on {factory.device} {ckc_s:.3f}s, its scan equals "
        f"the source's ({len(src_scan) - n_more} keys); backups {b1_s:.3f}s and "
        f"{b2_s:.3f}s (the second after {n_more} more writes: "
        f"{len(metas[b2])} SSTs, {shared} shared with the first); restore "
        f"{restore_s:.3f}s, its scan equals the source's [{card}]")


def ingest_part(root, tdb, oracle, n, n_file, card, device):
    """Phase 26 (c): 4 external SSTs of n_file sorted keys, two
    interleaved with (a)'s key range and two past it, ingested into (a)'s
    DB, then compact_range on the card."""
    from toplingdb_tpu_torch.utilities.sst_file_writer import (
        SstFileWriter,
        ingest_external_file,
    )

    db = tdb.db
    t0 = time.time()
    paths = []
    for f in range(4):
        if f < 2:
            nums = range(2 * f, 4 * n_file + 2 * f, 4)[:n_file]
        else:
            nums = range(2 * n + (f - 2) * n_file,
                         2 * n + (f - 1) * n_file)
        path = os.path.join(root, f"ext{f}.sst")
        w = SstFileWriter()
        w.open(path)
        for x in nums:
            k = b"%016d" % x
            v = b"ing%d-%015d" % (f, x)
            w.put(k, v)
            oracle[k] = v
        w.finish()
        paths.append(path)
    write_s = time.time() - t0
    t0 = time.time()
    levels = [ingest_external_file(db, p) for p in paths]
    ingest_s = time.time() - t0
    t0 = time.time()
    db.compact_range()
    compact_s = time.time() - t0
    keys = sorted(oracle)
    rng = __import__("random").Random(5)
    n_get = min(20_000, len(keys))
    for k in rng.sample(keys, n_get):
        assert db.get(k) == oracle[k], k
    it = db.new_iterator()
    it.seek_to_first()
    got = 0
    for (k, v), wk in zip(it.entries(), keys):
        assert k == wk and v == oracle[wk], (k, wk)
        got += 1
    assert got == len(keys) and not it.valid()
    log(f"[utilities c] SstFileWriter: 4 files of {n_file} keys "
        f"{write_s:.3f}s; ingested at levels {levels} {ingest_s:.3f}s; "
        f"compact_range on {device} {compact_s:.3f}s; {n_get} gets and a "
        f"scan of {len(keys)} keys equal the oracle (ingested values win) "
        f"[{card}]")


def ttl_part(root, factory, card, n, joblog):
    """Phase 26 (d): a TtlDB whose injected clock expires half its keys;
    compact_range takes the per-entry route on the card."""
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utilities.ttl import TtlDB

    clock = [1_700_000_000.0]
    db = TtlDB.open(os.path.join(root, "ttl"), ttl=1000, options=Options(
        create_if_missing=True, write_buffer_size=8 << 20,
        compaction_executor_factory=factory), clock=lambda: clock[0])
    half = n // 2

    def fill(lo, hi):
        # One writer: TtlDB.put is a single-key write, and single-key
        # writes from several Python threads convoy on the group commit.
        for i in range(lo, hi):
            db.put(db_key(i, n), b"l%019d" % i)

    j0 = len(joblog.jobs)
    t0 = time.time()
    fill(0, half)
    clock[0] += 600
    fill(half, n)
    fill_s = time.time() - t0
    clock[0] += 600                      # the first half is 1200 s old
    t0 = time.time()
    db.compact_range()
    compact_s = time.time() - t0
    live = sorted(db_key(i, n) for i in range(half, n))
    it = db.db.new_iterator()
    it.seek_to_first()
    got = [k for k, _ in it.entries()]
    assert got == live, (len(got), len(live))
    for i in range(0, n, 97):
        v = db.get(db_key(i, n))
        assert v == (None if i < half else b"l%019d" % i), i
    jobs = joblog.jobs[j0:]
    assert jobs and all(j["route"] == "per-entry" for j in jobs), jobs
    if factory.device != "cpu":
        # One gc_rows launch a job, where no other job overlapped it.
        for j in jobs:
            if not any(o is not j and o["t0"] < j["t1"] and j["t0"] < o["t1"]
                       for o in jobs):
                assert j["gc"] == 1, j
    db.close()
    log(f"[utilities d] TtlDB: {n} keys (ttl 1000 s, the clock moved 600 s "
        f"after half of them, then 600 s more) {fill_s:.3f}s "
        f"({n / fill_s:.0f} puts/s); compact_range on {factory.device} "
        f"{compact_s:.3f}s: {len(jobs)} jobs, all per-entry, gc_rows "
        f"{sum(j['gc'] for j in jobs)} launches; {len(live)} survivors, "
        f"the oracle's, no expired key [{card}]")


def service_part(root, card, n, n_sub, device_name):
    """Phase 26 (e): a DB whose compactions run through the
    CompactionService on the card, against its twin on the device
    executor; one job through the service's CLI."""
    from toplingdb_tpu_torch.compaction import compaction_service as cs
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options

    value = b"s" * 20
    svc = cs.InProcessCompactionService()
    scans = {}
    walls = {}
    launches = {}
    for tag, factory in (
            ("service", cs.CompactionServiceExecutorFactory(
                svc, device=device_name)),
            ("device", DeviceCompactionExecutorFactory(device=device_name))):
        g0 = kernels.gc_rows.launches
        m0 = kernels.merge_runs_perm.launches
        db = DB.open(os.path.join(root, f"svc-{tag}"), Options(
            create_if_missing=True, write_buffer_size=8 << 20,
            compaction_executor_factory=factory))
        t0 = time.time()
        threaded_fill(db, n, lambda i: (db_key(i, n), value))
        db.compact_range()
        walls[tag] = time.time() - t0
        launches[tag] = (kernels.gc_rows.launches - g0,
                         kernels.merge_runs_perm.launches - m0)
        assert db._compaction_scheduler.last_error is None
        assert db._compaction_scheduler.num_local_jobs == 0
        it = db.new_iterator()
        it.seek_to_first()
        scans[tag] = list(it.entries())
        db.close()
    assert scans["service"] == scans["device"]
    assert len(scans["service"]) == n
    assert svc.jobs >= 1
    if device_name != "cpu":
        assert launches["service"][0] >= svc.jobs, launches
        assert launches["service"][1] >= 1, launches
    # One job through the CLI: a small DB with its L0 files.
    sdir = os.path.join(root, "svc-sub")
    db = DB.open(sdir, Options(
        create_if_missing=True, write_buffer_size=1 << 20,
        disable_auto_compactions=True,
        compaction_executor_factory=DeviceCompactionExecutorFactory(
            device=device_name)))
    threaded_fill(db, n_sub, lambda i: (db_key(i, n_sub), value))
    db.flush()
    nums = [f.number for f in db.versions.cf_current(0).files[0]]
    db.close()
    sub = cs.SubprocessCompactionService()
    t0 = time.time()
    res = cs.CompactionServiceResult.from_json(sub(
        sdir, os.path.join(root, "svc-sub-out"),
        cs.CompactionServiceInput(
            cf_name="default", input_files=nums, output_level=1,
            bottommost=True, snapshots=[], max_output_file_size=1 << 62,
            device=device_name).to_json()))
    sub_s = time.time() - t0
    assert res.status == "ok" and sub.returncodes == [0], (
        res.status, sub.returncodes)
    assert sum(d["num_entries"] for d in res.output_files) == n_sub
    log(f"[utilities e] CompactionService on {device_name}: {n} keys, fill "
        f"and compact_range {walls['service']:.3f}s through "
        f"{svc.jobs} in-process service jobs (launches gc_rows="
        f"{launches['service'][0]} merge_runs={launches['service'][1]}) "
        f"against {walls['device']:.3f}s on the device executor (gc_rows="
        f"{launches['device'][0]} merge_runs={launches['device'][1]}): "
        f"equal scans; one job of {len(nums)} L0 files through the CLI "
        f"(python -m toplingdb_tpu_torch.compaction.compaction_service) "
        f"rc 0 in {sub_s:.3f}s, {n_sub} entries [{card}]")
    return launches["service"]


def env_part(root, factory, card, n, n_io):
    """Phase 26 (f): a DB over EncryptedEnv and one over IOTracingEnv,
    their compactions on the card."""
    import re

    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.env import PosixEnv
    from toplingdb_tpu_torch.env.encrypted import CTRCipher, EncryptedEnv
    from toplingdb_tpu_torch.env.io_tracer import (
        IOTracer,
        IOTracingEnv,
        parse_io_trace,
    )
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.utils.status import Corruption

    def options():
        return Options(create_if_missing=True, write_buffer_size=8 << 20,
                       compaction_executor_factory=factory)

    def value(i):
        return b"e%019d" % i

    edir = os.path.join(root, "enc")
    db = DB.open(edir, options(), env=EncryptedEnv(
        PosixEnv(), CTRCipher(b"phase-26-key")))
    t0 = time.time()
    fill_s = threaded_fill(db, n, lambda i: (db_key(i, n), value(i)))
    db.flush()
    t1 = time.time()
    db.compact_range()
    compact_s = time.time() - t1
    db.close()
    enc_s = time.time() - t0
    digits = re.compile(rb"\d{16}")
    n_bytes = 0
    for f in os.listdir(edir):
        p = os.path.join(edir, f)
        if os.path.isfile(p):
            blob = open(p, "rb").read()
            n_bytes += len(blob)
            m = digits.search(blob)
            assert m is None, (f, m.group(0))
    oracle = {db_key(i, n): value(i) for i in range(n // 4 * 4)}
    db = DB.open(edir, options(), env=EncryptedEnv(
        PosixEnv(), CTRCipher(b"phase-26-key")))
    rr, scan_s, n_probe, found = probe_and_scan(
        db, sorted(oracle), oracle.get, n // 4 * 4, "enc", n_probe=ENC_GETS)
    assert found == n_probe
    db.close()
    try:
        DB.open(edir, options(), env=EncryptedEnv(PosixEnv(),
                                                  CTRCipher(b"WRONG")))
        raise AssertionError("the wrong key opened the encrypted DB")
    except Corruption:
        pass
    log(f"[utilities f] EncryptedEnv: {n} keys filled {fill_s:.3f}s "
        f"({n / fill_s:.0f} ops/s), compact_range on {factory.device} "
        f"{compact_s:.3f}s, {enc_s:.3f}s in all; {n_bytes} bytes on disk "
        f"hold no 16-digit key; reopened: {n_probe} gets {rr:.3f}s and a "
        f"scan {scan_s:.3f}s equal the oracle; the wrong key raises "
        f"Corruption [{card}]")
    trace = os.path.join(root, "io.trace")
    tracer = IOTracer(trace)
    tdir = os.path.join(root, "traced")
    db = DB.open(tdir, options(), env=IOTracingEnv(PosixEnv(), tracer))
    t0 = time.time()
    threaded_fill(db, n_io, lambda i: (db_key(i, n_io), value(i)))
    db.flush()
    db.compact_range()
    io_s = time.time() - t0
    db.close()
    tracer.close()
    per_op = parse_io_trace(trace)
    assert per_op["append"]["count"] > 0 and per_op["read"]["bytes"] > 0
    log(f"[utilities f] IOTracingEnv: {n_io} keys, fill, flush and "
        f"compact_range on {factory.device} {io_s:.3f}s, "
        f"{tracer.num_records} records; per op "
        + json.dumps({k: [v["count"], v["bytes"]]
                      for k, v in sorted(per_op.items())})
        + f" (count, bytes) [{card}]")


def utilities_path(torch, root, card, device_name="cuda", n_txn=TXN_N,
                   n_wp=WP_TXNS, n_more=BACKUP_MORE_N, n_file=INGEST_N,
                   n_ttl=TTL_N, n_svc=SVC_N, n_sub=SVC_SUB_N, n_enc=ENC_N,
                   n_io=IO_N, n_overlay=CKPT_OVERLAY_N):
    """Phase 26 (see the module docstring): (a) transactions, (b)
    checkpoint and backup, (c) ingest, (d) TTL, (e) the CompactionService,
    (f) the wrapper Envs. Returns the (gc_rows, merge_runs) launches."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.ops import kernels

    os.makedirs(root, exist_ok=True)
    factory = DeviceCompactionExecutorFactory(device=device_name)
    launched = counted(kernels)
    walls = {}
    with JobLog(torch, factory, kernels) as joblog:
        t0 = time.time()
        tdb, oracle = txn_part(root, factory, card, n_txn, n_wp, 5)
        walls["a"] = time.time() - t0
        t0 = time.time()
        backup_part(root, tdb, oracle, factory, card, n_more, n_overlay,
                    n_txn)
        walls["b"] = time.time() - t0
        t0 = time.time()
        ingest_part(root, tdb, oracle, n_txn, n_file, card, device_name)
        tdb.close()
        walls["c"] = time.time() - t0
        t0 = time.time()
        ttl_part(root, factory, card, n_ttl, joblog)
        walls["d"] = time.time() - t0
        t0 = time.time()
        env_part(root, factory, card, n_enc, n_io)
        walls["f"] = time.time() - t0
    # Every job on the device; on a card, each job no other overlapped
    # launched gc_rows (the merge only where its runs interleave, so the
    # merge is checked over the phase).
    routes = {}
    for j in joblog.jobs:
        assert j["device"] == device_name, j
        alone = not any(o is not j and o["t0"] < j["t1"]
                        and j["t0"] < o["t1"] for o in joblog.jobs)
        if device_name != "cpu" and alone:
            assert j["gc"] >= 1, j
        routes[j["route"]] = routes.get(j["route"], 0) + 1
    t0 = time.time()
    service_part(root, card, n_svc, n_sub, device_name)
    walls["e"] = time.time() - t0
    gc_n, mr_n = launched()
    if device_name != "cpu":
        assert gc_n >= len(joblog.jobs) and mr_n >= 1, (gc_n, mr_n)
    log(f"[utilities] {len(joblog.jobs)} device-executor jobs on "
        f"{device_name} (routes {json.dumps(routes)}) and the service's, "
        f"launches gc_rows={gc_n} "
        f"merge_runs={mr_n}; part walls (s) "
        f"{json.dumps({k: round(v, 1) for k, v in sorted(walls.items())})}"
        f" [{card}]")
    return gc_n, mr_n


# ---------------------------------------------------------------------------
# Phase 27: the shared SST store and the replication plane
# ---------------------------------------------------------------------------


def fill_flushed(db, n, kv, rounds=4, flush_last=True):
    """bench.py's fill of n keys (4 writers, batches of 100) in `rounds`
    equal rounds, each flushed (the last one too unless `flush_last` is
    False): at phase 27's sizes an 8 MiB memtable would never fill, and the
    flushes give L0 its trigger of 4, so the card compacts while the fill
    runs. Returns the fill's wall."""
    per = n // rounds
    t0 = time.time()
    for r in range(rounds):
        threaded_fill(db, per, lambda j, base=r * per: kv(base + j))
        if flush_last or r < rounds - 1:
            db.flush()
    return time.time() - t0


def shared_env(db):
    """The DB's SharedSstEnv (below the checksum tap of its own tables)."""
    return db.env.base if hasattr(db.env, "take_digest") else db.env


def scan_equal(db, want: list, tag: str) -> float:
    """A full forward scan equal to the sorted (key, value) list `want`,
    row for row and in length; returns its wall."""
    import itertools

    t0 = time.time()
    for got, w in itertools.zip_longest(scan_rows(db), want):
        assert got == w, (tag, got and got[0], w and w[0])
    return time.time() - t0


def store_db_part(root, spec, factory, card, n, n_gets, n_overlay):
    """Phase 27 (a) and (b): a DB on the store, filled, flushed and
    compacted on the card; every live SST in the store and verified; gets
    and a scan against the oracle; the /store view; then a reference-mode
    checkpoint, its restore opened on the store and compacted on the card.
    Returns the open DB, its oracle, the SidePlugin repo serving it, the
    checkpoint, the restored DB and the repo's HTTP port."""
    import random

    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.ops import kernels
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.storage import address_of_meta, verify_payload
    from toplingdb_tpu_torch.utilities.checkpoint import (
        Checkpoint,
        create_checkpoint,
    )
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.config import SidePluginRepo

    stats = st.Statistics()
    adir = os.path.join(root, "a")
    db = DB.open(adir, Options(create_if_missing=True,
                               write_buffer_size=8 << 20, shared_store=spec,
                               statistics=stats,
                               compaction_executor_factory=factory))
    oracle = {}

    def kv(i):
        k, v = db_key(i, n), b"%020d" % i
        oracle[k] = v
        return k, v

    g0, m0, j0 = (kernels.gc_rows.launches, kernels.merge_runs_perm.launches,
                  len(factory.jobs))
    # The last round stays in the memtable: compact_range's flush makes
    # L0's fourth file, and its jobs run on the card.
    fill = fill_flushed(db, n, kv, flush_last=False)
    t0 = time.time()
    db.compact_range()
    db.wait_for_compactions()
    cr = time.time() - t0
    jobs = len(factory.jobs) - j0
    gc_n = kernels.gc_rows.launches - g0
    mr_n = kernels.merge_runs_perm.launches - m0
    assert jobs >= 1 and db._compaction_scheduler.num_local_jobs == 0
    live = [f for _, f in db.versions.current.all_files()]
    pubs = stats.get_ticker_count(st.STORE_PUBLISHES)
    assert pubs >= len(live), (pubs, len(live))
    store = db.env.store
    t0 = time.time()
    for f in live:
        addr = address_of_meta(f)
        assert store.contains(addr), addr
        verify_payload(addr, store.fetch(addr))
    verify_s = time.time() - t0
    rng = random.Random(5)
    keys = sorted(oracle)
    t0 = time.time()
    for _ in range(n_gets):
        k = keys[rng.randrange(len(keys))]
        assert db.get(k) == oracle[k], k
    gets_s = time.time() - t0
    scan_s = scan_equal(db, sorted(oracle.items()), "store a")
    repo = SidePluginRepo()
    repo.attach_db("a", db)
    port = repo.start_http(0)
    view = http_json(f"http://127.0.0.1:{port}/store/a")
    assert view["enabled"] is True and view["store"]["objects"] >= len(live)
    log(f"[store a] fillrandom {n} keys (4 writers, batches of 100, 4 "
        f"rounds, the first 3 flushed) on shared_store={spec}: "
        f"{fill:.3f}s, {n / fill:.0f} ops/s; compact_range (its flush, "
        f"then the jobs) on {factory.device} {cr:.3f}s; {jobs} device "
        f"jobs, launches "
        f"gc_rows={gc_n} merge_runs={mr_n}; {len(live)} live SSTs, "
        f"STORE_PUBLISHES {pubs}, every "
        f"live SST's address in the store and verify_payload passed on its "
        f"bytes ({verify_s:.3f}s); {n_gets} gets {gets_s:.3f}s, scan "
        f"{scan_s:.3f}s, both equal to the oracle; /store/a: "
        f"{view['store']['objects']} objects, {view['store']['bytes']} "
        f"bytes, tickers {json.dumps(view['tickers'])} [{card}]")

    # (b) An overlay flushed into L0 over the compacted level, so the
    # restored DB's compact_range has a job; then the checkpoint.
    for lo in range(0, n_overlay, 100):
        b = WriteBatch()
        for i in range(lo, min(lo + 100, n_overlay)):
            k = db_key(i * 7 % n, n)
            oracle[k] = b"b%019d" % i
            b.put(k, oracle[k])
        db.write(b)
    ck = os.path.join(root, "ckpt")
    t0 = time.time()
    create_checkpoint(db, ck)
    ck_s = time.time() - t0
    env = shared_env(db)
    refs = env.refs_of(ck)
    names = {"%06d.sst" % f.number
             for _, f in db.versions.current.all_files()}
    ck_bytes = sum(os.path.getsize(os.path.join(ck, x))
                   for x in os.listdir(ck) if x.endswith(".sst"))
    assert ck_bytes == 0 and set(refs) == names, (ck_bytes, refs, names)
    rest = os.path.join(root, "rest")
    t0 = time.time()
    Checkpoint(ck, env).restore_to(rest)
    restore_s = time.time() - t0
    rdb = DB.open(rest, Options(write_buffer_size=8 << 20,
                                statistics=st.Statistics(),
                                compaction_executor_factory=factory),
                  env=env)
    t0 = time.time()
    rdb.compact_range()
    rcr = time.time() - t0
    want = sorted(oracle.items())
    scan_equal(db, want, "store b source")
    scan_equal(rdb, want, "store b restored")
    log(f"[store b] reference-mode checkpoint of the live DB (an L0 overlay "
        f"of {n_overlay} keys over its compacted level) {ck_s:.3f}s: 0 SST "
        f"bytes in its directory, its refs table names all {len(refs)} "
        f"tables; restore_to {restore_s:.3f}s; the restored DB opened on "
        f"the store, its compact_range on {factory.device} {rcr:.3f}s "
        f"(cold tables materialized through the cache tier), its scan "
        f"equals the source's [{card}]")
    return db, oracle, repo, port, ck, rdb


def store_job_part(root, spec, db, oracle, card, device_name, n, n_more):
    """Phase 27 (c): a store-mode dcompact job through the subprocess
    worker on `device_name` from (a)'s DB (reopened with that factory)
    after n_more keys and a flush, beside a path-mode job of the same
    size on a twin DB without the store, both compact_range calls at
    once. Returns (a)'s DB reopened."""
    import glob

    from toplingdb_tpu_torch.compaction import executor as ex
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options

    runs = {}

    def factory_for(tag):
        rec = runs.setdefault(tag, {"sst_bytes": [], "results": [],
                                    "stats": []})

        class Capturing(ex.SubprocessCompactionExecutor):
            def _spawn_local(self, job_dir, dev):
                super()._spawn_local(job_dir, dev)
                # The worker has ended: any SST it shipped is here now.
                rec["sst_bytes"].append(sum(
                    os.path.getsize(p) for p in glob.glob(
                        os.path.join(job_dir, "**", "*.sst"),
                        recursive=True)))
                with open(os.path.join(job_dir, "results.json")) as f:
                    rec["results"].append(json.load(f)["stats"])

            def execute(self, db_, compaction, snapshots, alloc):
                out = super().execute(db_, compaction, snapshots, alloc)
                rec["stats"].append(out[1])
                return out

        class Factory(ex.SubprocessCompactionExecutorFactory):
            def new_executor(self, compaction):
                return Capturing(self.device, self.job_root)

        return Factory(device=device_name,
                       job_root=os.path.join(root, f"jobs-{tag}"))

    def more(d, sink):
        for lo in range(0, n_more, 100):
            b = WriteBatch()
            for i in range(lo, min(lo + 100, n_more)):
                k = db_key(i * 11 % n, n)
                sink[k] = b"c%019d" % i
                b.put(k, sink[k])
            d.write(b)
        d.flush()

    # The path-mode twin: the same writes as (a)'s DB into a DB without
    # the store, its fill's jobs on the card in process.
    twin = DB.open(os.path.join(root, "c-path"), Options(
        create_if_missing=True, write_buffer_size=8 << 20,
        compaction_executor_factory=ex.DeviceCompactionExecutorFactory(
            device=device_name)))
    twin_oracle = {}
    fill_flushed(twin, n, lambda i: (db_key(i, n), b"%020d" % i))
    twin.wait_for_compactions()
    twin.compact_range()
    b = WriteBatch()
    for k, v in oracle.items():
        if v[:1] == b"b":
            b.put(k, v)
    twin.write(b)
    twin.flush()
    twin.close()
    db.close()
    opts = dict(create_if_missing=False, write_buffer_size=8 << 20,
                disable_auto_compactions=True)
    db = DB.open(os.path.join(root, "a"), Options(
        shared_store=spec, compaction_executor_factory=factory_for("store"),
        **opts))
    twin = DB.open(os.path.join(root, "c-path"), Options(
        compaction_executor_factory=factory_for("path"), **opts))
    more(db, oracle)
    more(twin, twin_oracle)
    walls, errs = {}, []

    def run(tag, d):
        """One job: every L0 file with the compacted level beneath them
        (compact_files), so each DB starts one worker process."""
        try:
            v = d.versions.current
            levels = {lvl for lvl, fl in enumerate(v.files) if fl}
            out = max(levels)
            assert levels <= {0, out}, v.describe()
            t0 = time.time()
            d.compact_files([f.number for _, f in v.all_files()], out)
            walls[tag] = time.time() - t0
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=run, args=a)
          for a in (("store", db), ("path", twin))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    st_s, st_p = runs["store"], runs["path"]
    assert len(st_s["stats"]) == len(st_p["stats"]) == 1, runs
    for s, r in zip(st_s["stats"], st_s["results"]):
        assert s.remote and s.sst_bytes_shipped == 0, s
        assert r["device"] == device_name, r
    assert st_s["sst_bytes"] and not any(st_s["sst_bytes"]), st_s
    assert all(s.sst_bytes_shipped > 0 for s in st_p["stats"]), st_p
    refs = shared_env(db).refs_of(os.path.join(root, "a"))
    outs = {"%06d.sst" % f.number for _, f in db.versions.current.all_files()}
    adopted = outs & set(refs)
    assert adopted, (outs, refs)
    scan_equal(db, sorted(oracle.items()), "store c")
    twin.close()

    def jobs_text(rec):
        return "; ".join(
            f"{s.input_records} rows, {r['device']} "
            f"{'pipelined' if r['pipelined'] else 'serial'}, "
            f"rpc_time_usec {s.rpc_time_usec}, work_time_usec "
            f"{s.work_time_usec}, sst_bytes_shipped {s.sst_bytes_shipped}"
            for s, r in zip(rec["stats"], rec["results"]))

    log(f"[store c] store-mode dcompact through the subprocess worker on "
        f"{device_name} after {n_more} more keys and a flush: "
        f"{jobs_text(st_s)}; job dirs held {st_s['sst_bytes']} SST bytes "
        f"when their workers ended; {len(adopted)} outputs adopted as store "
        f"references; compact_files {walls['store']:.3f}s; the scan equals "
        f"the oracle. The path-mode twin (same writes, no store), at the "
        f"same time: {jobs_text(st_p)}; compact_files {walls['path']:.3f}s "
        f"[{card}]")
    return db


def http_store_part(root, spec, db, oracle, card, factory, n_gets):
    """Phase 27 (d): a StoreServer over the store and a second DB on
    shared_store="http://..." from a reference-mode restore of a fresh
    checkpoint of (a)'s DB: cold gets over HTTP and a scan. Returns the
    server, the DB and its directory."""
    import random

    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.env import PosixEnv
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.storage import (
        LocalObjectStore,
        SharedSstEnv,
        StoreClient,
        StoreServer,
    )
    from toplingdb_tpu_torch.utilities.checkpoint import (
        Checkpoint,
        create_checkpoint,
    )
    from toplingdb_tpu_torch.utils import statistics as st

    srv = StoreServer(LocalObjectStore(spec))
    url = f"http://127.0.0.1:{srv.start()}"
    ck = os.path.join(root, "ckpt-d")
    create_checkpoint(db, ck)
    stats = st.Statistics()
    env = SharedSstEnv(PosixEnv(), StoreClient(url), stats=stats)
    ddir = os.path.join(root, "d")
    Checkpoint(ck, env).restore_to(ddir)  # queues the warm over HTTP
    ddb = DB.open(ddir, Options(shared_store=url, statistics=stats,
                                write_buffer_size=8 << 20,
                                compaction_executor_factory=factory),
                  env=env)
    rng = random.Random(7)
    keys = sorted(oracle)
    t0 = time.time()
    for _ in range(n_gets):
        k = keys[rng.randrange(len(keys))]
        assert ddb.get(k) == oracle[k], k
    gets_s = time.time() - t0
    scan_s = scan_equal(ddb, sorted(oracle.items()), "store d")
    env.tier.drain()
    misses = stats.get_ticker_count(st.STORE_MISSES)
    fetched = stats.get_ticker_count(st.STORE_BYTES_FETCHED)
    h = stats.get_histogram(st.STORE_FETCH_MICROS)
    assert misses >= 1 and fetched > 0, (misses, fetched)
    log(f"[store d] StoreServer at {url} over the store; a second DB on "
        f"shared_store={url} from a reference-mode restore: {n_gets} gets "
        f"{gets_s:.3f}s and a scan {scan_s:.3f}s equal the oracle; "
        f"STORE_MISSES {misses}, STORE_BYTES_FETCHED {fetched} (the "
        f"restore's warm and the gets, every fetch over HTTP), "
        f"STORE_FETCH_MICROS median {h.percentile(50):.0f} us over "
        f"{h.count} fetches [{card}]")
    shutil.rmtree(ck, ignore_errors=True)
    return srv, ddb, ddir


def sweep_part(root, spec, roots, card):
    """Phase 27 (e): (b)'s checkpoint and restore dropped, a mark-sweep
    over the roots still open; only unreferenced objects go, and every
    root reopens with the scan of its oracle. `roots`: (directory,
    reopen(), oracle) for each open DB, which is closed here."""
    from toplingdb_tpu_torch.storage import (
        LocalObjectStore,
        collect_live_addresses,
        mark_sweep,
    )
    from toplingdb_tpu_torch.utils import statistics as st

    store = LocalObjectStore(spec)
    before = set(store.list_addresses())
    dirs = [d for d, _, _ in roots]
    live = collect_live_addresses(dirs)
    stats = st.Statistics()
    t0 = time.time()
    rep = mark_sweep(store, dirs, statistics=stats)
    sweep_s = time.time() - t0
    swept = set(rep["swept"])
    assert not swept & live, swept & live
    assert swept == before - live - set(store.pinned()), (swept, before)
    assert all(store.contains(a) for a in live)
    walls = []
    for d, reopen, want in roots:
        db = reopen()
        try:
            walls.append(scan_equal(db, want, f"store e {d}"))
        finally:
            db.close()
    log(f"[store e] mark_sweep over {len(dirs)} roots {sweep_s:.3f}s: "
        f"{len(before)} objects, {len(live)} live, STORE_GC_SWEPT "
        f"{stats.get_ticker_count(st.STORE_GC_SWEPT)} (every unreferenced "
        f"one, no live one); each root reopened, its scan equal to its "
        f"oracle ({', '.join(f'{w:.3f}s' for w in walls)}) [{card}]")


def replication_part(root, factory, card, n, n_gets, n_promote):
    """Phase 27 (f): a primary of n keys with its compactions on the card
    and two followers tailing every 50 ms (one sharing its directory, one
    standalone through HttpTransport -> ReplicationServer): lag sampled
    every 100 ms during the fill, read-your-writes gets through
    ReplicaRouter, the followers' scans, a third follower bootstrapped
    from a checkpoint after the WAL GC, and POST /promote of the shared
    follower, which then takes writes and compacts on the card."""
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.db.write_batch import WriteBatch
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.replication import (
        FollowerDB,
        HttpTransport,
        LocalTransport,
        LogShipper,
        ReplicaRouter,
        ReplicationServer,
    )
    from toplingdb_tpu_torch.utils import statistics as st
    from toplingdb_tpu_torch.utils.config import SidePluginRepo

    from toplingdb_tpu_torch.ops import kernels

    pdir = os.path.join(root, "primary")
    db = DB.open(pdir, Options(create_if_missing=True,
                               write_buffer_size=8 << 20,
                               statistics=st.Statistics(),
                               compaction_executor_factory=factory))
    ship = LogShipper(db)
    srv = ReplicationServer(db, ship)
    url = f"http://127.0.0.1:{srv.start()}"
    fol = FollowerDB.open(pdir, Options(statistics=st.Statistics()),
                          transport=LocalTransport(ship), mode="shared")
    sfol = FollowerDB.open(os.path.join(root, "standalone"),
                           Options(statistics=st.Statistics()),
                           transport=HttpTransport(url), mode="standalone")
    # The promoted DB's options: phase 13's, its jobs on the factory's
    # device.
    repo = SidePluginRepo()
    repo.attach_db("shared", fol, {"options": {
        "write_buffer_size": 8 << 20, "compaction_executor_factory": {
            "class": "device", "params": {"device_name": factory.device}}}})
    hport = repo.start_http(0)
    for f in (fol, sfol):
        f.start_tailing(interval=0.05)
    lags = {"shared": [], "standalone": []}
    stop = threading.Event()

    def sampler():
        while not stop.wait(0.1):
            last = db.versions.last_sequence
            for tag, f in (("shared", fol), ("standalone", sfol)):
                lags[tag].append(max(0, last - f.applied_sequence()))

    th = threading.Thread(target=sampler)
    th.start()
    oracle = {}

    def kv(i):
        k, v = db_key(i, n), b"%020d" % i
        oracle[k] = v
        return k, v

    try:
        fill = fill_flushed(db, n, kv)
    finally:
        stop.set()
        th.join()
    t0 = time.time()
    target = db.versions.last_sequence
    while (fol.applied_sequence() < target
           or sfol.applied_sequence() < target):
        assert time.time() - t0 < 60, "followers never caught up"
        time.sleep(0.005)
    to_zero = time.time() - t0
    # Read-your-writes through the router: each batch's keys read with the
    # batch's token RYW_DELAY batches later.
    router = ReplicaRouter(db, [fol, sfol])
    pending, served = [], 0
    f_reads0 = db.stats.get_ticker_count(st.ROUTER_FOLLOWER_READS) \
        if db.stats is not None else 0
    t0 = time.time()
    n_batches = n_gets // 100
    for bno in range(n_batches + RYW_DELAY):
        if bno < n_batches:
            b = WriteBatch()
            ks = []
            for j in range(100):
                k = b"ryw%06d%07d" % (bno, j)
                b.put(k, b"%020d" % (bno * 100 + j))
                ks.append(k)
            pending.append((router.write(b), ks))
        if bno >= RYW_DELAY:
            token, ks = pending[bno - RYW_DELAY]
            for j, k in enumerate(ks):
                v = router.get(k, token=token)
                assert v == b"%020d" % ((bno - RYW_DELAY) * 100 + j), (k, v)
                oracle[k] = v
                served += 1
    ryw_s = time.time() - t0
    assert served == n_gets
    f_reads = (db.stats.get_ticker_count(st.ROUTER_FOLLOWER_READS)
               - f_reads0) if db.stats is not None else 0
    target = db.versions.last_sequence
    t0 = time.time()
    while (fol.applied_sequence() < target
           or sfol.applied_sequence() < target):
        assert time.time() - t0 < 60, "followers never caught up"
        time.sleep(0.005)
    for f in (fol, sfol):
        f.stop_tailing()
    want = sorted(oracle.items())
    scan_equal(db, want, "repl primary")
    scan_equal(fol, want, "repl shared follower")
    scan_equal(sfol, want, "repl standalone follower")
    # A third follower after the primary's WAL GC: bootstraps from a
    # checkpoint the ReplicationServer takes.
    db.flush()
    for i in range(1000):
        db.put(b"late%06d" % i, b"%020d" % i)
        oracle[b"late%06d" % i] = b"%020d" % i
    db.flush()
    t0 = time.time()
    tfol = FollowerDB.open(os.path.join(root, "third"),
                           Options(statistics=st.Statistics()),
                           transport=HttpTransport(url), mode="standalone")
    boot_s = time.time() - t0
    tfol.catch_up()
    assert tfol.get(b"late%06d" % 999) == b"%020d" % 999
    assert tfol.applied_sequence() == db.versions.last_sequence
    tfol.close()
    sfol.close()
    srv.stop()
    # The primary dies; POST /promote makes the shared follower a DB.
    db.close()
    t0 = time.time()
    out = http_json(f"http://127.0.0.1:{hport}/promote/shared", b"{}")
    promote_s = time.time() - t0
    pdb = repo.get_db("shared")
    assert pdb is not fol and out["promoted"] == "shared"
    pfactory = pdb.options.compaction_executor_factory
    g0 = kernels.gc_rows.launches
    t0 = time.time()
    for lo in range(0, n_promote, 100):
        b = WriteBatch()
        for i in range(lo, min(lo + 100, n_promote)):
            k = db_key(i * 13 % n, n)
            oracle[k] = b"p%019d" % i
            b.put(k, oracle[k])
        pdb.write(b)
    pdb.flush()
    pdb.compact_range()
    prom_cr = time.time() - t0
    assert pfactory.jobs and pdb._compaction_scheduler.num_local_jobs == 0
    assert pfactory.device == factory.device, pfactory.device
    if factory.device != "cpu":
        assert kernels.gc_rows.launches > g0
    scan_equal(pdb, sorted(oracle.items()), "repl promoted")
    repo.close_all()

    def lag_text(xs):
        return (f"median {statistics.median(xs) if xs else 0:.0f}, max "
                f"{max(xs) if xs else 0} over {len(xs)} samples")

    log(f"[repl f] primary fill of {n} keys (4 writers, 4 flushed rounds) "
        f"with two followers tailing every 50 ms: {fill:.3f}s, "
        f"{n / fill:.0f} ops/s; lag in sequences (primary minus applied, "
        f"every 100 ms): shared {lag_text(lags['shared'])}, standalone "
        f"(HTTP) {lag_text(lags['standalone'])}; both at 0 {to_zero:.3f}s "
        f"after the fill stopped; {served} read-your-writes gets through "
        f"ReplicaRouter (each batch's keys read with its token "
        f"{RYW_DELAY} batches later) {ryw_s:.3f}s, all their own writes, "
        f"{f_reads / max(served, 1):.3f} of them served by followers; both "
        f"followers' scans equal the primary's; a third, standalone "
        f"follower opened after the WAL GC bootstrapped from a checkpoint "
        f"of the ReplicationServer in {boot_s:.3f}s and caught up; POST "
        f"/promote {promote_s:.3f}s, the promoted DB took {n_promote} "
        f"writes, flush and compact_range on {factory.device} "
        f"{prom_cr:.3f}s ({len(pfactory.jobs)} device jobs), its scan "
        f"equals the oracle [{card}]")


def store_repl_path(torch, root, card, device_name="cuda", n_store=STORE_N,
                    n_repl=REPL_N):
    """Phase 27 (see the module docstring): (a)-(e) the shared SST store,
    (f) the replication plane. Returns the (gc_rows, merge_runs)
    launches."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.ops import kernels

    os.makedirs(root, exist_ok=True)
    spec = os.path.join(root, "store")
    factory = DeviceCompactionExecutorFactory(device=device_name)
    launched = counted(kernels)
    walls = {}
    with JobLog(torch, factory, kernels) as joblog:
        t0 = time.time()
        db, oracle, repo, _port, ck, rdb = store_db_part(
            root, spec, factory, card, n_store, STORE_GETS, STORE_OVERLAY_N)
        walls["a-b"] = time.time() - t0
        rdb.close()
        repo.stop_http()
        t0 = time.time()
        db = store_job_part(root, spec, db, oracle, card, device_name,
                            n_store, STORE_MORE_N)
        walls["c"] = time.time() - t0
        t0 = time.time()
        srv, ddb, ddir = http_store_part(root, spec, db, oracle, card,
                                         factory, STORE_HTTP_GETS)
        walls["d"] = time.time() - t0
        t0 = time.time()
        for d in (ck, os.path.join(root, "rest")):
            shutil.rmtree(d)
        want = sorted(oracle.items())
        db.close()
        ddb.close()
        url = f"http://127.0.0.1:{srv.port}"
        adir = os.path.join(root, "a")
        sweep_part(root, spec, [
            (adir, lambda: DB.open(adir, Options(
                shared_store=spec, compaction_executor_factory=factory)),
             want),
            (ddir, lambda: DB.open(ddir, Options(
                shared_store=url, compaction_executor_factory=factory)),
             want)], card)
        srv.stop()
        walls["e"] = time.time() - t0
        t0 = time.time()
        replication_part(root, factory, card, n_repl, REPL_GETS,
                         REPL_PROMOTE_N)
        walls["f"] = time.time() - t0
    for j in joblog.jobs:
        assert j["device"] == device_name, j
        alone = not any(o is not j and o["t0"] < j["t1"]
                        and j["t0"] < o["t1"] for o in joblog.jobs)
        if device_name != "cpu" and alone:
            assert j["gc"] >= 1, j
    gc_n, mr_n = launched()
    if device_name != "cpu":
        assert gc_n >= 1 and mr_n >= 1, (gc_n, mr_n)
    log(f"[store-repl] {len(joblog.jobs)} device-executor jobs on "
        f"{device_name}, launches gc_rows={gc_n} merge_runs={mr_n}; part "
        f"walls (s) {json.dumps({k: round(v, 1) for k, v in walls.items()})}"
        f" [{card}]")
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
        w_gc, w_mr = phase("19 write", write_path, torch,
                           os.path.join(dbdir, "db19"), WRITE_N, smi)
        log(f"[write] phase 19 wall {walls['19 write']:.1f}s [{smi}]")
        r_gc, r_mr = phase("20 read", read_path, torch,
                           os.path.join(dbdir, "db20"), READ_N, smi, "cuda",
                           os.path.join(dbdir, "db13"))
        log(f"[read] phase 20 wall {walls['20 read']:.1f}s [{smi}]")
        m_gc, m_mr = phase("21 manual", manual_path, torch,
                           os.path.join(dbdir, "db21"), MANUAL_N, smi)
        log(f"[manual] phase 21 wall {walls['21 manual']:.1f}s [{smi}]")
        s_gc, s_mr = phase("22 storage", storage_path, torch,
                           os.path.join(dbdir, "db22"), STORAGE_N, smi)
        log(f"[storage] phase 22 wall {walls['22 storage']:.1f}s [{smi}]")
        p_gc, p_mr = phase("23 replicas", replica_path, torch,
                           os.path.join(dbdir, "db23"), smi)
        log(f"[replicas] phase 23 wall {walls['23 replicas']:.1f}s [{smi}]")
        sp_gc, sp_mr = phase("24 sideplugin", sideplugin_path, torch,
                             os.path.join(dbdir, "db24"), smi)
        log(f"[sideplugin] phase 24 wall {walls['24 sideplugin']:.1f}s "
            f"[{smi}]")
        pa_gc, pa_mr = phase("25 parallel", parallel_path, torch, env,
                             dbdir, icmp, topts, PARALLEL_N, smi)
        log(f"[parallel] phase 25 wall {walls['25 parallel']:.1f}s [{smi}]")
        u_gc, u_mr = phase("26 utilities", utilities_path, torch,
                           os.path.join(dbdir, "db26"), smi)
        log(f"[utilities] phase 26 wall {walls['26 utilities']:.1f}s "
            f"[{smi}]")
        sr_gc, sr_mr = phase("27 store-repl", store_repl_path, torch,
                             os.path.join(dbdir, "db27"), smi)
        log(f"[store-repl] phase 27 wall {walls['27 store-repl']:.1f}s "
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
    # So do phase 19's write-path DBs, phase 20's read-path DBs, phase
    # 21's compact_files, marked-file and other jobs, and phase 22's jobs
    # after a space block, precluded, aged and over entities.
    # And phase 23's timestamp, primary, prefix and repaired DBs.
    # And phase 24's SidePlugin, replay, stalled and lock-debug DBs.
    # And phase 25's mesh runs, and phase 26's transaction, checkpoint,
    # ingest, TTL, service and wrapper-Env DBs, and phase 27's DBs on the
    # shared store, its primary and its promoted follower.
    launches["gc_rows"] += (w_gc + r_gc + m_gc + s_gc + p_gc + sp_gc + pa_gc
                            + u_gc + sr_gc)
    launches["merge_runs"] += (w_mr + r_mr + m_mr + s_mr + p_mr + sp_mr
                               + pa_mr + u_mr + sr_mr)
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
