"""DB and column-family options (copied from toplingdb_tpu/options.py with
every field, so a configuration written for toplingdb_tpu reads here).

The port's DB runs a subset of them: `unported_fields` names each field
set away from its default that the port's DB does not run, and
`DB.open` raises NotSupported for the first one instead of ignoring it.
One default differs from toplingdb_tpu's: `compaction_executor_factory`
is the device executor on the card (toplingdb_tpu's None runs the host
compaction path, which the port runs only where the caller names it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from toplingdb_tpu_torch.db.dbformat import BYTEWISE, Comparator
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.builder import TableOptions


def _device_executor_factory():
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )

    return DeviceCompactionExecutorFactory(device="cuda")


@dataclass
class Options:
    # -- DB behavior ----------------------------------------------------
    create_if_missing: bool = True
    error_if_exists: bool = False
    paranoid_checks: bool = True
    read_only: bool = False             # set by ReadOnlyDB/SecondaryDB.open
    comparator: Comparator = field(default_factory=lambda: BYTEWISE)
    merge_operator: Any = None          # MergeOperator instance or None
    compaction_filter: Any = None
    # SliceTransform (utils/slice_transform.py) or None (RocksDB's
    # ColumnFamilyOptions.prefix_extractor): enables prefix bloom filters,
    # the 'plain' table format's prefix hash index, and
    # ReadOptions.prefix_same_as_start iteration. Propagated into
    # table_options at open.
    prefix_extractor: Any = None

    # -- write path -----------------------------------------------------
    memtable_rep: str = "skiplist"       # 'skiplist' (native C++) | 'vector'
    write_buffer_size: int = 4 * 1024 * 1024
    max_write_buffer_number: int = 2
    db_write_buffer_size: int = 0       # 0 = unlimited (WriteBufferManager)
    wal_enabled: bool = True
    # Group members insert their own batches into the (lock-free native)
    # memtable in parallel (RocksDB's allow_concurrent_memtable_write,
    # db/db_impl/db_impl_write.cc:550 LaunchParallelMemTableWriters).
    allow_concurrent_memtable_write: bool = True
    # Overlap group N+1's WAL append with group N's memtable insert
    # (RocksDB's enable_pipelined_write, db_impl_write.cc:657
    # PipelinedWriteImpl). Publish order is preserved.
    enable_pipelined_write: bool = False
    # Relax write ordering: seqno allocation + WAL stay ordered, memtable
    # inserts run unordered in each writer's thread; visibility advances as
    # a low watermark and GetSnapshot drains pending writes (RocksDB's
    # unordered_write, db_impl_write.cc:267-301 WriteImplWALOnly).
    unordered_write: bool = False
    # Async WAL writer (env/env.py AsyncIORing): WAL appends/fsyncs run on
    # a dedicated writer thread behind a bounded submit ring, the leader
    # waits on its durability barrier AFTER the memtable phase (outside
    # the commit critical section), and concurrent leaders' sync=True
    # barriers coalesce into shared fsyncs. A write is still acknowledged
    # only after its barrier settles; ordering relaxation: a barrier
    # FAILURE after the memtable insert latches a HARD background error
    # (writes raise until resume()) instead of preceding the insert.
    enable_async_wal: bool = False
    # Submit-ring capacity (entries) of the async WAL writer.
    async_wal_ring_size: int = 256
    # Async read plane (env/async_reads.py AsyncReadBatcher, engaged by
    # DB.open(async_reads=True)): number of reader rings — dedicated I/O
    # threads the batched block fetches fan out across. os.pread drops
    # the GIL, so N rings genuinely overlap a cold-cache miss storm.
    async_read_rings: int = 4
    # Per-reader-ring cap on queued read tasks (separate from the append
    # capacity so a miss storm cannot starve WAL appends).
    async_read_task_capacity: int = 256

    # -- LSM shape ------------------------------------------------------
    num_levels: int = 7
    level0_file_num_compaction_trigger: int = 4
    level0_slowdown_writes_trigger: int = 20
    level0_stop_writes_trigger: int = 36
    max_bytes_for_level_base: int = 64 * 1024 * 1024
    max_bytes_for_level_multiplier: float = 10.0
    target_file_size_base: int = 8 * 1024 * 1024
    target_file_size_multiplier: int = 1
    max_compaction_bytes: int = 25 * 8 * 1024 * 1024
    compaction_style: str = "leveled"   # leveled | universal | fifo

    # universal compaction knobs (RocksDB's universal_compaction.h)
    universal_size_ratio: int = 1
    universal_min_merge_width: int = 2
    universal_max_merge_width: int = 2**31 - 1
    universal_max_size_amplification_percent: int = 200

    # fifo knobs
    fifo_max_table_files_size: int = 1024 * 1024 * 1024
    # Drop FIFO files older than this (RocksDB's CompactionOptionsFIFO.ttl;
    # 0 = off).
    fifo_ttl_seconds: int = 0
    # Rewrite any file older than this so old data keeps moving down and
    # expired-data filters re-run (RocksDB's periodic_compaction_seconds;
    # 0 = off; leveled style only — FIFO ages out via fifo_ttl_seconds).
    periodic_compaction_seconds: int = 0

    # User-defined timestamps: versions with ts below this trim point
    # collapse to the newest one at compaction (RocksDB's
    # full_history_ts_low; DB.increase_full_history_ts_low raises it).
    # Only meaningful with a ts-carrying comparator. 0 = keep full history.
    full_history_ts_low: int = 0

    # -- background work ------------------------------------------------
    max_background_jobs: int = 2
    max_subcompactions: int = 1
    disable_auto_compactions: bool = False

    # -- blob files (key-value separation, RocksDB's db/blob/) ----------
    enable_blob_files: bool = False
    min_blob_size: int = 256
    # Compaction-time blob GC: rewrite survivors out of the oldest
    # `age_cutoff` fraction of referenced blob files (RocksDB's
    # enable_blob_garbage_collection / blob_garbage_collection_age_cutoff).
    enable_blob_garbage_collection: bool = False
    blob_garbage_collection_age_cutoff: float = 0.25
    # Blob VALUE cache (RocksDB's blob_cache option + BlobSource tier,
    # db/blob/blob_source.h): a utils.cache.Cache instance, or an int
    # capacity in bytes (an LRUCache is built), or None (no caching —
    # every Get re-reads the blob file).
    blob_cache: object | None = None
    # Cap on concurrently OPEN blob file readers (RocksDB's
    # blob_file_cache.cc holds readers in a capacity-bounded cache).
    blob_file_open_limit: int = 256

    # -- wide columns ---------------------------------------------------
    # Entities carry the dedicated kTypeWideColumnEntity-style value type;
    # this gate re-enables the pre-type magic-prefix sniff for databases
    # written by older versions (plain binary values starting with
    # \x00WCE1 would otherwise present as entities on those DBs).
    legacy_wide_column_unwrap: bool = False

    # -- observability --------------------------------------------------
    # Periodic ticker snapshots for DB.get_stats_history (RocksDB's
    # stats_persist_period_sec; 0 = manual persist_stats() only).
    stats_persist_period_sec: int = 0
    # Periodic stats DUMP (RocksDB's stats_dump_period_sec): snapshots the
    # tickers into the stats-history ring AND logs a compact `stats_dump`
    # line through the event log every N seconds. Served over HTTP at
    # /stats_history/<name>?window=S. 0 = off.
    stats_dump_period_sec: int = 0
    # Request-scoped span tracing (utils/telemetry.py): sample one DB
    # operation in N as a full span tree (1 = every op, 0 = off). Rare
    # high-value ops (flush, compaction) are always traced while a tracer
    # exists. Finished traces land in a bounded ring served at
    # /traces/<name>; remote spans (dcompact workers, replication
    # followers) stitch into the same trace.
    trace_sample_every: int = 0
    # Always-sample latency backstop: an op slower than this many µs
    # leaves a (root-only) trace even when the sampler skipped it. 0 = off.
    trace_slow_usec: int = 0
    # Bound on retained finished traces (and the remote-stitch index).
    trace_ring: int = 256
    # Health plane (utils/slo.py). Windowed-histogram ring span: every
    # `*.micros` histogram keeps, besides the cumulative series, a ring
    # of per-interval histograms covering the trailing
    # histogram_window_sec seconds, exposed as `*_recent` quantiles on
    # /metrics. 0 = cumulative-only histograms (no ring).
    histogram_window_sec: float = 60.0
    # Declarative SLO specs: a list/tuple of slo.SLOSpec (or dicts with
    # the same fields) evaluated with multi-window burn-rate alerting.
    # Empty = no SLO engine.
    slo_specs: tuple = ()
    # Background SLO evaluation cadence (0 = manual db.slo_engine
    # .evaluate() only — tests and embedders drive it by hand).
    slo_eval_period_sec: float = 0.0
    # Default fast window for specs that don't set their own; the slow
    # window defaults to 5x this.
    slo_window_sec: float = 60.0
    # Sampling cadence of the seqno↔time mapping (RocksDB's
    # seqno_to_time_mapping recording period).
    seqno_time_sample_period_sec: int = 60
    # Data written within this many seconds must not receive LAST-LEVEL
    # TREATMENT (RocksDB's preclude_last_level_data_seconds, the
    # tiered/temperature seam the seqno↔time mapping exists for). Design
    # difference from RocksDB: instead of splitting outputs to the
    # penultimate level per key, a bottommost job with young inputs keeps
    # full MVCC semantics (no seqno zeroing / tombstone dropping) and the
    # last-level treatment happens on a later compaction once aged —
    # placement is unchanged.
    preclude_last_level_data_seconds: int = 0

    # Cross-DB memtable memory budget (utils.rate_limiter.WriteBufferManager;
    # RocksDB's write_buffer_manager.h:37). Shared between DB instances;
    # over budget, writers flush their memtables early.
    write_buffer_manager: Optional[object] = None

    # -- storage pressure -----------------------------------------------
    # Shared utils.rate_limiter.SstFileManager instance, or None to have
    # DB.open build a private one when any pressure knob below is set
    # (RocksDB's NewSstFileManager). Tracks live SST+WAL+blob bytes,
    # paces trash deletion, and publishes the ok/amber/red pressure level.
    sst_file_manager: Optional[object] = None
    # Hard byte budget for the DB's tracked tree (RocksDB's
    # SstFileManager::SetMaxAllowedSpaceUsage). 0 = unlimited. A flush or
    # compaction whose estimated output would breach it refuses to start;
    # an actual breach latches a retryable SOFT "no_space" background
    # error that auto-resumes once space frees.
    max_allowed_space_usage: int = 0
    # Slack compactions must leave under the budget (RocksDB's
    # SetCompactionBufferSize): a compaction may only start if
    # used + estimated_output + buffer + flush headroom fits.
    compaction_buffer_size: int = 0
    # Bytes reserved for flush+WAL so ingest can always drain even at red
    # pressure (flushes may consume this slice; compactions may not).
    # 0 = auto: 2x write_buffer_size whenever a budget is set.
    flush_headroom_bytes: int = 0
    # Free-space poller cadence (RocksDB's SetStatsDumpPeriodSec analogue
    # for the space poller). 0 = no poller thread; pressure only updates
    # when something calls SstFileManager.poll() explicitly.
    free_space_poll_period_sec: float = 0.0
    # Pressure thresholds on the free fraction (min of budget-remaining
    # fraction and filesystem-free fraction): <= red → "red",
    # <= amber → "amber". De-escalation requires clearing the threshold
    # by the hysteresis margin so the level never flaps.
    disk_amber_free_ratio: float = 0.10
    disk_red_free_ratio: float = 0.05
    disk_pressure_hysteresis: float = 0.02

    # -- caches ---------------------------------------------------------
    # Shared block cache (utils.cache.LRUCache or ClockCache, optionally
    # backed by a CompressedSecondaryCache or a utils.persistent_cache.
    # PersistentCache secondary tier; a SimCache wraps either). None = the
    # reader's per-file behavior without a shared cache.
    block_cache: Optional[object] = None

    # -- table format ---------------------------------------------------
    table_options: TableOptions = field(default_factory=TableOptions)
    compression: int = fmt.NO_COMPRESSION
    bottommost_compression: Optional[int] = None
    # Per-level codec list (RocksDB's ColumnFamilyOptions::compression_per_level,
    # include/rocksdb/options.h): levels past the end reuse the last entry;
    # empty = `compression` (or table_options.compression).
    compression_per_level: list = field(default_factory=list)
    # SST format for bottommost-level outputs (e.g. "zip": the
    # searchable-compression ZipTable — ToplingDB's ToplingZipTable
    # L2+ role, README.md:50-56). None = table_options.format everywhere.
    bottommost_format: Optional[str] = None

    # -- WAL lifecycle --------------------------------------------------
    # Keep up to N obsolete WAL files for reuse (RocksDB's
    # recycle_log_file_num, include/rocksdb/options.h:795): new WALs
    # overwrite a recycled file in place (recyclable record format stamps
    # each record with its log number, so the stale tail is inert).
    recycle_log_file_num: int = 0
    # Archive obsolete WALs under <db>/archive/ for this long instead of
    # deleting them (RocksDB's WAL_ttl_seconds / WalManager retention).
    wal_ttl_seconds: float = 0.0

    # -- distributed compaction (the dcompact boundary) -----------------
    # CompactionExecutorFactory: compactions run on the card by default;
    # DeviceCompactionExecutorFactory(device="cpu") runs the kernels'
    # plain versions, LocalCompactionExecutorFactory() the host path.
    compaction_executor_factory: Any = field(
        default_factory=_device_executor_factory)
    # Failure policy around the boundary: per-attempt retry with backoff +
    # jitter, per-job deadline, circuit-breaker thresholds, local-pin
    # degradation, and the job-lease duration (compaction/resilience.py).
    # JSON-configurable under the "dcompact" key (utils/config.py).
    dcompact: Any = None  # DcompactOptions; None = defaults, lazily built

    # -- disaggregated SST storage (storage/) ---------------------------
    # Content-addressed shared object store for SSTs, keyed by the
    # MANIFEST-recorded whole-file checksums (requires file_checksum on).
    # A filesystem path selects the local-directory backend, an http://
    # URL a StoreServer, a store-shaped object passes through; None/""/"0"
    # keeps the classic local-files path (the byte-parity oracle). This
    # field is the only switch: the port reads no TPULSM_SHARED_STORE.
    # When enabled DB.open wraps the env in SharedSstEnv: tables publish
    # on install, live thereafter as references, and re-materialize
    # through the persistent cache tier on first read.
    shared_store: Any = None

    # -- integrity plane (utils/protection.py, utils/file_checksum.py,
    # db/integrity.py) ---------------------------------------------------
    # Per-KV protection info (RocksDB's protection_bytes_per_key,
    # include/rocksdb/options.h + db/kv_checksum.h): 8/4/2/1-byte per-entry
    # checksums computed in WriteBatch, carried through the memtable, and
    # verified at every handoff (memtable insert, flush emission,
    # compaction output emission in the serial AND columnar/pipelined
    # planes, scan-plane chunk emission). 0 = off.
    protection_bytes_per_key: int = 0
    # Whole-file checksum function recorded per SST in the MANIFEST
    # (RocksDB's file_checksum_gen_factory): 'crc32c' (default) or
    # 'xxh64'; None/'off' disables. Verified by DB.verify_file_checksums,
    # checkpoint/backup/import/follower-bootstrap, and the scrubber.
    file_checksum: Optional[str] = "crc32c"
    # Background IntegrityScrubber cadence: re-read live SSTs from disk
    # and compare against MANIFEST checksums every N seconds (0 = manual
    # db.scrub() only), paced at integrity_scrub_bytes_per_sec.
    integrity_scrub_period_sec: int = 0
    integrity_scrub_bytes_per_sec: int = 32 * 1024 * 1024

    # -- observability --------------------------------------------------
    statistics: Any = None
    listeners: list = field(default_factory=list)
    info_log: Any = None

    def max_bytes_for_level(self, level: int) -> int:
        """Target size of level L (L>=1)."""
        base = self.max_bytes_for_level_base
        mult = self.max_bytes_for_level_multiplier
        size = base
        for _ in range(1, level):
            size = int(size * mult)
        return size

    def target_file_size(self, level: int) -> int:
        size = self.target_file_size_base
        for _ in range(1, max(1, level)):
            size *= self.target_file_size_multiplier
        return size

    def compression_for_level(self, level: int,
                              bottommost: bool = False) -> int:
        """Effective codec for an output level (RocksDB's
        Compaction::GetCompressionType: bottommost_compression wins at the
        last level, then compression_per_level, then the base codec)."""
        if bottommost and self.bottommost_compression is not None:
            return self.bottommost_compression
        if self.compression_per_level:
            idx = min(level, len(self.compression_per_level) - 1)
            return self.compression_per_level[idx]
        if self.compression != fmt.NO_COMPRESSION:
            return self.compression
        return self.table_options.compression

    def table_options_for_level(self, level: int, bottommost: bool = False):
        """table_options with the per-level codec and bottommost format
        applied (identity when nothing level-specific is configured)."""
        eff = self.compression_for_level(level, bottommost)
        fmt_ = self.table_options.format
        if bottommost and self.bottommost_format is not None:
            fmt_ = self.bottommost_format
        if eff == self.table_options.compression \
                and fmt_ == self.table_options.format:
            return self.table_options
        import dataclasses

        return dataclasses.replace(self.table_options, compression=eff,
                                   format=fmt_)


@dataclass
class ReadOptions:
    verify_checksums: bool = True
    snapshot: Any = None                # Snapshot object or None
    fill_cache: bool = True
    iterate_lower_bound: Optional[bytes] = None
    iterate_upper_bound: Optional[bytes] = None
    # Topling extension analogue: return existence without copying the value
    # (RocksDB's include/rocksdb/options.h:1637 just_check_key_exists).
    just_check_key_exists: bool = False
    # Fiber/io_uring MultiGet analogue (RocksDB's db_impl.cc:3026-3227 +
    # options.h:1723 async_queue_depth): memtable misses walk their SST
    # chains on parallel threads (pread releases the GIL).
    async_io: bool = False
    async_queue_depth: int = 8
    # Prefix-mode iteration (RocksDB's ReadOptions.prefix_same_as_start):
    # an iterator becomes invalid once it leaves the prefix group of its
    # Seek target (requires Options.prefix_extractor).
    prefix_same_as_start: bool = False
    # Escape hatch (RocksDB's total_order_seek): ignore prefix mode for this
    # read even when prefix_same_as_start defaults have been configured.
    total_order_seek: bool = False
    # Tailing iterator (RocksDB's ReadOptions.tailing → ForwardIterator,
    # db/forward_iterator.cc): forward-only, sees new writes after catching
    # up at end-of-data; incompatible with `snapshot`.
    tailing: bool = False
    # Iterator prefetch window in bytes (RocksDB's
    # ReadOptions.readahead_size): a fixed, immediately-armed
    # FilePrefetchBuffer window for table iteration. 0 = auto-scaling
    # (double on sequential reads, reset on seek).
    readahead_size: int = 0
    # User-defined timestamp to read AS OF (RocksDB's ReadOptions.timestamp,
    # the TOPLINGDB_WITH_TIMESTAMP feature): only versions with ts <= this
    # are visible. Requires a timestamp-carrying comparator. None = latest.
    timestamp: Optional[int] = None


@dataclass
class WriteOptions:
    sync: bool = False
    disable_wal: bool = False


@dataclass
class FlushOptions:
    wait: bool = True


# Fields the port's DB does not run, each with the reason DB.open gives
# when one is set away from its default. Everything else in Options runs.
UNPORTED = {
    "db_write_buffer_size": "a DB-wide write budget, which toplingdb_tpu "
                            "declares but does not run either (share a "
                            "WriteBufferManager through "
                            "write_buffer_manager)",
}


def unported_fields(options: Options) -> list[tuple[str, str]]:
    """(field, feature) for every field of `options` that is set away
    from its default and that the port's DB does not run, plus the
    choices of a ported field that it does not run (no compaction
    executor factory)."""
    base = Options()
    out = [(name, why) for name, why in UNPORTED.items()
           if getattr(options, name) != getattr(base, name)]
    if options.compaction_executor_factory is None:
        out.append(("compaction_executor_factory",
                    "None, toplingdb_tpu's host compaction path: name it "
                    "with LocalCompactionExecutorFactory()"))
    return out
