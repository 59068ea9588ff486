"""Statistics: tickers + histograms (copied from
toplingdb_tpu/utils/statistics.py, whole: RocksDB's
include/rocksdb/statistics.h), including the Topling local-vs-distributed compaction
split (LCOMPACTION_*/DCOMPACTION_*, statistics.h:643-651) that makes the
BASELINE.json metric directly measurable."""

from __future__ import annotations

import math
import threading

import time
from collections import defaultdict
from toplingdb_tpu_torch.utils import concurrency as ccy

# Ticker names, grouped by the reference's families
# (include/rocksdb/statistics.h Tickers enum); extensible by string.
#
# -- block cache -----------------------------------------------------
BLOCK_CACHE_HIT = "block.cache.hit"
BLOCK_CACHE_MISS = "block.cache.miss"
BLOCK_CACHE_ADD = "block.cache.add"
BLOCK_CACHE_ADD_FAILURES = "block.cache.add.failures"
BLOCK_CACHE_DATA_HIT = "block.cache.data.hit"
BLOCK_CACHE_DATA_MISS = "block.cache.data.miss"
BLOCK_CACHE_DATA_ADD = "block.cache.data.add"
BLOCK_CACHE_INDEX_HIT = "block.cache.index.hit"
BLOCK_CACHE_INDEX_MISS = "block.cache.index.miss"
BLOCK_CACHE_INDEX_ADD = "block.cache.index.add"
BLOCK_CACHE_FILTER_HIT = "block.cache.filter.hit"
BLOCK_CACHE_FILTER_MISS = "block.cache.filter.miss"
BLOCK_CACHE_FILTER_ADD = "block.cache.filter.add"
BLOCK_CACHE_BYTES_READ = "block.cache.bytes.read"
BLOCK_CACHE_BYTES_WRITE = "block.cache.bytes.write"
# -- bloom filters ---------------------------------------------------
BLOOM_USEFUL = "bloom.filter.useful"
BLOOM_CHECKED = "bloom.filter.checked"
BLOOM_FULL_POSITIVE = "bloom.filter.full.positive"
BLOOM_FULL_TRUE_POSITIVE = "bloom.filter.full.true.positive"
BLOOM_MEMTABLE_HIT = "bloom.memtable.hit"
BLOOM_MEMTABLE_MISS = "bloom.memtable.miss"
# -- reads -----------------------------------------------------------
BYTES_READ = "bytes.read"
NUMBER_KEYS_READ = "number.keys.read"
MEMTABLE_HIT = "memtable.hit"
MEMTABLE_MISS = "memtable.miss"
GET_HIT_L0 = "get.hit.l0"
GET_HIT_L1 = "get.hit.l1"
GET_HIT_L2_AND_UP = "get.hit.l2andup"
NUMBER_MULTIGET_CALLS = "number.multiget.get"
NUMBER_MULTIGET_KEYS_READ = "number.multiget.keys.read"
NUMBER_MULTIGET_BYTES_READ = "number.multiget.bytes.read"
# Async read plane (env/async_reads.py AsyncReadBatcher serving db.py
# multi_get/get behind TPULSM_ASYNC_READS): block-fetch batches submitted
# to the reader rings, requests merged away by per-file range coalescing,
# and reads the plane had to refuse (non-block tables, knob off mid-call,
# closed rings) — served synchronously instead.
READ_ASYNC_BATCHES = "read.async.batches"
READ_ASYNC_COALESCED = "read.async.coalesced"
READ_ASYNC_FALLBACKS = "read.async.fallbacks"
# -- iteration -------------------------------------------------------
NUMBER_DB_SEEK = "number.db.seek"
NUMBER_DB_NEXT = "number.db.next"
NUMBER_DB_PREV = "number.db.prev"
NUMBER_DB_SEEK_FOUND = "number.db.seek.found"
ITER_BYTES_READ = "db.iter.bytes.read"
NO_ITERATOR_CREATED = "no.iterator.created"
NO_ITERATOR_DELETED = "no.iterator.deleted"
# Chunked scan plane (ops/scan_plane.py): chunk refills served to
# DBIter, and mid-stream degradations to the per-entry path.
ITER_CHUNK_REFILLS = "db.iter.chunk.refills"
ITER_CHUNK_FALLBACKS = "db.iter.chunk.fallbacks"
# Searchable-compression zip data plane (table/zip_table.py serving
# ops/scan_plane.py): value groups bulk-decoded per scan window, raw
# bytes those decodes produced, and zip files the plane had to refuse
# (TPULSM_ZIP_PLANE=0 or native zip kernels missing).
ZIP_GROUP_DECODES = "zip.group.decodes"
ZIP_GROUP_DECODE_BYTES = "zip.group.decode.bytes"
ZIP_PLANE_FALLBACKS = "zip.plane.fallbacks"
# -- writes ----------------------------------------------------------
BYTES_WRITTEN = "bytes.written"
NUMBER_KEYS_WRITTEN = "number.keys.written"
NUMBER_KEYS_UPDATED = "number.keys.updated"
WRITE_DONE_BY_SELF = "write.self"
WRITE_DONE_BY_OTHER = "write.other"
WRITE_WITH_WAL = "write.wal"
WAL_SYNCS = "wal.synced"
WAL_BYTES = "wal.bytes"
# Group-commit write plane (db.py _lead_write_group family + the native
# fused plane): groups led by a leader, follower batches merged into them,
# groups committed through tpulsm_wb_group_commit vs the Python interiors,
# and sync barriers merged into shared fsyncs by the async WAL writer.
WRITE_GROUP_LED = "write.group.led"
WRITE_GROUP_FOLLOWERS = "write.group.followers"
WRITE_GROUP_NATIVE_COMMITS = "write.group.native.commits"
WRITE_GROUP_FALLBACKS = "write.group.fallbacks"
WRITE_GROUP_FSYNCS_COALESCED = "write.group.fsyncs.coalesced"
# -- compaction ------------------------------------------------------
COMPACT_READ_BYTES = "compact.read.bytes"
COMPACT_WRITE_BYTES = "compact.write.bytes"
COMPACTION_KEY_DROP_OBSOLETE = "compaction.key.drop.obsolete"
COMPACTION_KEY_DROP_RANGE_DEL = "compaction.key.drop.range_del"
COMPACTION_CANCELLED = "compaction.cancelled"
NUMBER_SUPERVERSION_ACQUIRES = "number.superversion_acquires"
MERGE_OPERATION_TOTAL_TIME = "merge.operation.time.nanos"
NUMBER_MERGE_FAILURES = "number.merge.failures"
# Topling split: local vs distributed (device/remote) compaction bytes.
LCOMPACTION_READ_BYTES = "lcompaction.read.bytes"
LCOMPACTION_WRITE_BYTES = "lcompaction.write.bytes"
DCOMPACTION_READ_BYTES = "dcompaction.read.bytes"
DCOMPACTION_WRITE_BYTES = "dcompaction.write.bytes"
# Compaction input-scan readahead (FilePrefetchBuffer hits vs preads).
PREFETCH_HITS = "compaction.prefetch.hits"
PREFETCH_MISSES = "compaction.prefetch.misses"
# -- dcompact resilience (compaction/resilience.py) ------------------
DCOMPACTION_ATTEMPTS = "dcompaction.attempts"            # remote tries
DCOMPACTION_RETRIES = "dcompaction.retries"              # re-tries only
DCOMPACTION_JOB_FAILURES = "dcompaction.job.failures"    # attempts exhausted
DCOMPACTION_FALLBACK_LOCAL = "dcompaction.fallback.local"
DCOMPACTION_FALLBACK_PINNED = "dcompaction.fallback.pinned"
DCOMPACTION_LOCAL_PINS = "dcompaction.local.pins"        # gate engagements
DCOMPACTION_DEADLINE_EXCEEDED = "dcompaction.deadline.exceeded"
DCOMPACTION_BREAKER_OPEN = "dcompaction.breaker.open"
DCOMPACTION_BREAKER_CLOSE = "dcompaction.breaker.close"
DCOMPACTION_BREAKER_SKIPPED = "dcompaction.breaker.skipped"
DCOMPACTION_ORPHANS_SWEPT = "dcompaction.orphans.swept"
# -- mesh compaction (ops/mesh_compaction.py): one job fanned over chips
DCOMPACTION_MESH_JOBS = "dcompaction.mesh.jobs"          # mesh-mode jobs
DCOMPACTION_MESH_SHARDS = "dcompaction.mesh.shards"      # shards dispatched
DCOMPACTION_MESH_FALLBACKS = "dcompaction.mesh.fallbacks"  # misses+demotions

# Replication plane (replication/): WAL shipping, follower apply, router.
REPLICATION_FRAMES_SHIPPED = "replication.frames.shipped"
REPLICATION_BYTES_SHIPPED = "replication.bytes.shipped"
REPLICATION_FRAMES_APPLIED = "replication.frames.applied"
REPLICATION_RECORDS_APPLIED = "replication.records.applied"
REPLICATION_FRAME_GAPS = "replication.frame.gaps"          # missing seq run
REPLICATION_FRAME_CORRUPT = "replication.frame.corrupt"    # bad CRC/frame
REPLICATION_EPOCH_RELOADS = "replication.epoch.reloads"    # MANIFEST re-read
REPLICATION_BOOTSTRAPS = "replication.bootstraps"          # checkpoint restore
ROUTER_FOLLOWER_READS = "replication.router.follower.reads"
ROUTER_PRIMARY_READS = "replication.router.primary.reads"  # fallbacks
ROUTER_STALE_SKIPS = "replication.router.stale.skips"      # applied < token
ROUTER_BREAKER_SKIPS = "replication.router.breaker.skips"
ROUTER_EPOCH_REJECTS = "replication.router.epoch.rejects"  # token epoch old
# Sharding plane (toplingdb_tpu/sharding/): key-range shard map, front-door
# router, split/merge/migration, per-tenant admission control.
SHARD_ROUTED_READS = "shard.routed.reads"
SHARD_ROUTED_WRITES = "shard.routed.writes"
SHARD_TOKEN_REJECTS = "shard.token.rejects"        # shard/epoch moved → re-route
SHARD_SPLITS = "shard.splits"
SHARD_MERGES = "shard.merges"
SHARD_MIGRATIONS = "shard.migrations"              # attempts started
SHARD_MIGRATION_FAILURES = "shard.migration.failures"
SHARD_FENCE_WAITS = "shard.fence.waits"            # writers parked at a fence
SHARD_WRITES_SHED = "shard.writes.shed"            # admission denied (Busy)
SHARD_ADMISSION_WAITS = "shard.admission.waits"    # rate-limit throttles
# Fleet plane (sharding/lease.py, sharding/fleet.py): out-of-process shard
# servers behind a lease-based shard-map coordinator.
LEASE_GRANTS = "lease.grants"                      # fresh fencing tokens
LEASE_RENEWALS = "lease.renewals"
LEASE_EXPIRIES = "lease.expiries"                  # lapsed at grant/renew time
LEASE_REJECTS = "lease.rejects"                    # fencing-token/holder mismatch
LEASE_CAS_CONFLICTS = "lease.cas.conflicts"        # map version CAS lost
FLEET_MAP_REFRESHES = "fleet.map.refreshes"        # router map re-pulls
FLEET_WRITE_REJECTS = "fleet.write.rejects"        # router map lease expired
FLEET_STALE_EPOCH_REJECTS = "fleet.stale.epoch.rejects"  # server 409s
FLEET_SELF_FENCES = "fleet.self.fences"            # server lost its lease
FLEET_PROMOTIONS = "fleet.promotions"              # follower -> primary
FLEET_RESTARTS = "fleet.restarts"                  # supervisor respawns
FLEET_HEARTBEAT_MISSES = "fleet.heartbeat.misses"  # renew attempts that failed
FLEET_MIGRATIONS_RECOVERED = "fleet.migrations.recovered"  # cross-process recover
# -- flush / WAL / files ---------------------------------------------
FLUSH_WRITE_BYTES = "flush.write.bytes"
NO_FILE_OPENS = "no.file.opens"
NO_FILE_CLOSES = "no.file.closes"
NO_FILE_ERRORS = "no.file.errors"
# -- stalls ----------------------------------------------------------
STALL_MICROS = "stall.micros"
WRITE_STALL_COUNT = "write.stall.count"
# -- transactions ----------------------------------------------------
TXN_COMMIT = "txn.commit"
TXN_ROLLBACK = "txn.rollback"
TXN_PREPARE = "txn.prepare"
TXN_LOCK_TIMEOUT = "txn.lock.timeout"
TXN_DEADLOCK = "txn.deadlock"
# -- blob files ------------------------------------------------------
BLOB_DB_CACHE_HIT = "blob.db.cache.hit"
BLOB_DB_CACHE_MISS = "blob.db.cache.miss"
BLOB_DB_CACHE_BYTES_READ = "blob.db.cache.bytes.read"
BLOB_DB_CACHE_BYTES_WRITE = "blob.db.cache.bytes.write"
BLOB_DB_BLOB_FILE_BYTES_READ = "blob.db.blob.file.bytes.read"
BLOB_DB_NUM_KEYS_READ = "blob.db.num.keys.read"
BLOB_DB_NUM_KEYS_WRITTEN = "blob.db.num.keys.written"
BLOB_DB_BYTES_READ = "blob.db.bytes.read"
BLOB_DB_BYTES_WRITTEN = "blob.db.bytes.written"
BLOB_DB_GC_NUM_FILES = "blob.db.gc.num.files"
# -- row cache / persistent tiers ------------------------------------
SECONDARY_CACHE_HITS = "secondary.cache.hits"
PERSISTENT_CACHE_HIT = "persistent.cache.hit"
PERSISTENT_CACHE_MISS = "persistent.cache.miss"
# -- disaggregated SST storage (toplingdb_tpu/storage/): the
# content-addressed shared object store behind SharedSstEnv -----------
STORE_HITS = "store.hits"                    # resident serves (cache tier)
STORE_MISSES = "store.misses"                # cold fetches from the store
STORE_PUBLISHES = "store.publishes"          # objects published on install
STORE_BYTES_FETCHED = "store.bytes.fetched"  # payload bytes pulled cold
STORE_GC_SWEPT = "store.gc.swept"            # objects removed by mark-sweep
STORE_FETCH_RETRIES = "store.fetch.retries"  # verify/transport re-fetches
# -- integrity plane (db/integrity.py, utils/protection.py) ----------
INTEGRITY_SCRUB_PASSES = "integrity.scrub.passes"
INTEGRITY_BYTES_VERIFIED = "integrity.bytes.verified"
INTEGRITY_CORRUPTIONS_DETECTED = "integrity.corruptions.detected"
INTEGRITY_PROTECTION_MISMATCHES = "integrity.protection.mismatches"
# -- health plane (utils/slo.py, utils/stats_history.py) -------------
SLO_EVALUATIONS = "slo.evaluations"                # engine passes
SLO_WINDOWS_BREACHED = "slo.windows.breached"      # fast+slow both over
SLO_ALERTS_FIRED = "slo.alerts.fired"              # firing transitions
SLO_ALERTS_RESOLVED = "slo.alerts.resolved"        # recovery transitions
STATS_DUMP_ERRORS = "stats.dump.errors"            # swallowed on_snapshot
# -- error-policy plane (utils/errors.py) ----------------------------
BG_ERROR_SWALLOWED = "bg.error.swallowed"          # policy-swallowed excs
BG_ERROR_RESUMES = "bg.error.resumes"              # latch cleared (manual+auto)
# -- storage-pressure plane (utils/rate_limiter.py SstFileManager,
# db flush/compaction preflight, sharding admission) ------------------
DISK_PRESSURE_POLLS = "disk.pressure.polls"            # poller passes
DISK_PRESSURE_POLLS_BAD = "disk.pressure.polls.bad"    # passes at amber/red
DISK_PRESSURE_TRANSITIONS = "disk.pressure.transitions"  # level changes
DISK_RECLAIM_RUNS = "disk.reclaim.runs"                # reclaim-ladder firings
DISK_TRASH_BYTES_FREED = "disk.trash.bytes.freed"      # paced deleter drains
NO_SPACE_ERRORS = "no_space.errors"                    # ENOSPC/budget latches
NO_SPACE_PREFLIGHT_BLOCKS = "no_space.preflight.blocks"  # jobs refused start
NO_SPACE_WRITES_SHED = "no_space.writes.shed"          # admission/fleet sheds

# Histogram names (reference Histograms enum families).
DB_GET_MICROS = "db.get.micros"
DB_WRITE_MICROS = "db.write.micros"
DB_SEEK_MICROS = "db.seek.micros"
DB_MULTIGET_MICROS = "db.multiget.micros"
COMPACTION_TIME_MICROS = "compaction.time.micros"
COMPACTION_PREPARE_MICROS = "compaction.prepare.micros"
COMPACTION_WAITING_MICROS = "compaction.waiting.micros"
COMPACTION_TRANSFER_MICROS = "compaction.transfer.micros"
COMPACTION_DEVICE_WAIT_MICROS = "compaction.device.wait.micros"
LCOMPACTION_TIME_MICROS = "lcompaction.time.micros"
DCOMPACTION_TIME_MICROS = "dcompaction.time.micros"
DCOMPACTION_PREPARE_MICROS = "dcompaction.prepare.micros"
DCOMPACTION_WAITING_MICROS = "dcompaction.waiting.micros"
DCOMPACTION_RPC_MICROS = "dcompaction.rpc.micros"
DCOMPACTION_ATTEMPT_MICROS = "dcompaction.attempt.micros"
FLUSH_TIME_MICROS = "flush.time.micros"
SST_READ_MICROS = "sst.read.micros"
TABLE_OPEN_IO_MICROS = "table.open.io.micros"
WAL_FILE_SYNC_MICROS = "wal.file.sync.micros"
MANIFEST_FILE_SYNC_MICROS = "manifest.file.sync.micros"
WRITE_STALL_MICROS_HIST = "write.stall.micros"
REPLICATION_LAG_MICROS = "replication.lag.micros"  # ship→apply wall lag
SCRUB_LATENCY_MICROS = "scrub.latency.micros"      # one scrubber pass
SHARD_FENCE_MICROS = "shard.fence.micros"          # write-block cutover window
SHARD_MIGRATION_MICROS = "shard.migration.micros"  # whole migration wall
STORE_FETCH_MICROS = "store.fetch.micros"          # cold-tier object fetch
NUM_FILES_IN_SINGLE_COMPACTION = "numfiles.in.singlecompaction"
BYTES_PER_READ = "bytes.per.read"
BYTES_PER_WRITE = "bytes.per.write"
WRITE_GROUP_BYTES = "write.group.bytes"  # bytes merged per commit group
NUM_SUBCOMPACTIONS_SCHEDULED = "num.subcompactions.scheduled"

# Every `tpulsm_<name>` gauge the HTTP planes may emit (config.py g(),
# replication/dcompact /metrics). tools/check_telemetry.py lints literal
# gauge emissions against this set so a typo'd metric name fails CI
# instead of silently forking a new series.
GAUGE_NAMES = frozenset({
    # per-DB gauges (config._prometheus_gauges)
    "memtable_bytes", "immutable_memtables", "level_files", "level_bytes",
    "last_sequence", "async_wal_ring_depth", "dcompaction_breaker_state",
    "trace_ring_retained", "traces_started_total",
    "write_stall_state", "write_stall_l0_files", "write_stall_micros_total",
    # per-cluster gauges (config._prometheus_cluster_gauges)
    "shard_map_version", "shard_count", "shard_epoch", "shard_fenced",
    "shard_stall_state", "shard_health",
    # SLO engine gauges (config: /metrics burn-rate block)
    "slo_burn_rate_fast", "slo_burn_rate_slow", "slo_firing", "slo_health",
    # fleet aggregator gauges (/cluster/health)
    "fleet_members", "fleet_members_unreachable",
    # dcompact worker /metrics (per-chip rows carry a chip="<i>" label)
    "dcompact_jobs_done", "dcompact_jobs_failed",
    "dcompact_chip_queue_depth", "dcompact_chip_busy",
    "dcompact_chip_wedged",
    # error-policy plane (utils/errors.py, process-wide)
    "bg_error_swallowed_total",
    # storage-pressure plane (config: per-DB SstFileManager block)
    "disk_free_bytes", "disk_tracked_bytes", "disk_trash_bytes",
    "disk_pressure_state", "disk_budget_bytes", "disk_reserved_bytes",
})


class Histogram:
    """Power-of-two bucketed histogram (lock-free-ish: GIL-atomic adds).
    Bucket b holds values in [2^(b-1), 2^b) (b=0 holds [0, 1)), so two
    histograms merge exactly by summing buckets — the property the
    windowed ring and the fleet aggregator both lean on."""

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self):
        self.buckets = [0] * 64
        self.count = 0
        self.sum = 0
        self.min = math.inf
        self.max = 0

    def add(self, v: float) -> None:
        b = max(0, min(63, int(v).bit_length())) if v >= 1 else 0
        self.buckets[b] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def average(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def observed_min(self) -> float:
        """min with the empty case guarded: an empty histogram reports
        0.0, never `inf` (which would corrupt Prometheus exposition)."""
        return 0.0 if self.count == 0 else float(self.min)

    def percentile(self, p: float) -> float:
        """In-bucket-interpolated quantile, clamped to [min, max].
        The plain power-of-two bucket upper bound was up to 2x above the
        true value; assuming a uniform spread inside the crossing bucket
        and clamping to the observed extremes keeps every quantile inside
        the data's actual range (a one-sample histogram reports the
        sample itself)."""
        if not self.count:
            return 0.0
        target = self.count * p / 100.0
        acc = 0
        for b, n in enumerate(self.buckets):
            if not n:
                continue
            if acc + n >= target:
                lo = float(1 << (b - 1)) if b else 0.0
                hi = float(1 << b)
                if hi <= lo:  # bucket 63 clamp overflow guard
                    hi = lo * 2.0
                v = lo + (hi - lo) * ((target - acc) / n)
                return min(max(v, self.observed_min), float(self.max))
            acc += n
        return float(self.max)

    def fraction_above(self, threshold: float) -> float:
        """Fraction of recorded values above `threshold`, interpolating
        inside the bucket the threshold lands in — the SLO engine's
        bad-event estimator for latency objectives."""
        if not self.count:
            return 0.0
        above = 0.0
        for b, n in enumerate(self.buckets):
            if not n:
                continue
            lo = float(1 << (b - 1)) if b else 0.0
            hi = float(1 << b)
            if hi <= lo:
                hi = lo * 2.0
            if threshold < lo:
                above += n
            elif threshold < hi:
                above += n * (hi - threshold) / (hi - lo)
        return min(1.0, above / self.count)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold `other` into self (exact: buckets sum). Returns self."""
        sb, ob = self.buckets, other.buckets
        for i in range(64):
            if ob[i]:
                sb[i] += ob[i]
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        return self

    def to_dict(self) -> dict:
        """JSON-portable form (sparse buckets) — the aggregator wire
        format; from_dict() round-trips it and merge() recombines."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": None if self.count == 0 else self.min,
            "max": self.max,
            "buckets": {str(i): n for i, n in enumerate(self.buckets) if n},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls()
        h.count = int(d.get("count", 0))
        h.sum = d.get("sum", 0)
        mn = d.get("min")
        h.min = math.inf if mn is None else mn
        h.max = d.get("max", 0)
        for i, n in (d.get("buckets") or {}).items():
            h.buckets[int(i)] = int(n)
        return h

    def to_string(self) -> str:
        return (
            f"count={self.count} avg={self.average:.1f} "
            f"p50={self.percentile(50):.0f} p99={self.percentile(99):.0f} "
            f"max={self.max:.0f}"
        )


class WindowedHistogram(Histogram):
    """Histogram with a ring of K per-interval slots AND a lifetime view.

    The hot path writes ONE place: add() lands in the ring slot covering
    the current `window_sec / intervals`-second interval (a single bucket
    add plus a countdown — the clock is only consulted every
    `_CHECK_EVERY` adds, so attribution near an interval boundary can lag
    by up to `_CHECK_EVERY - 1` samples, which a health plane does not
    care about). Slots evicted from the ring fold into a lifetime base
    histogram, and the cumulative attributes (`count`, `sum`, `min`,
    `max`, `buckets`) are derived on read as base ⊕ live slots — exact,
    because power-of-two buckets merge by summation. That keeps the
    per-add cost within noise of a plain Histogram (the bench gate
    asserts ≤2% on fill+read) while `windowed()` still answers recent
    quantiles from at most the last `window_sec` seconds — a p99
    regression after an hour of uptime shows up within one window instead
    of being diluted into the lifetime distribution. Readers rotate too
    (`windowed()` checks the clock unconditionally), so a stale slot
    never leaks into a fresh window after a quiet period."""

    __slots__ = ("window_sec", "interval_sec", "_ring", "_ring_epochs",
                 "_folded", "_slot", "_slot_epoch", "_clock", "_tick")

    _CHECK_EVERY = 16  # adds between clock reads on the hot path

    def __init__(self, window_sec: float = 60.0, intervals: int = 6,
                 clock=None):
        # Deliberately no super().__init__(): the Histogram attrs are
        # shadowed by the derived properties below.
        intervals = max(1, int(intervals))
        self.window_sec = float(window_sec)
        self.interval_sec = max(1e-9, self.window_sec / intervals)
        self._ring = [Histogram() for _ in range(intervals)]
        self._ring_epochs = [-1] * intervals
        self._folded = Histogram()
        self._clock = clock if clock is not None else time.monotonic
        e = int(self._clock() / self.interval_sec)
        i = e % intervals
        self._ring_epochs[i] = e
        self._slot = self._ring[i]
        self._slot_epoch = e
        self._tick = self._CHECK_EVERY

    # Lifetime view: folded evicted slots ⊕ live ring. Read-side cost is
    # O(intervals) (O(64 * intervals) for buckets); every reader of these
    # is a cold path (exposition, snapshots, SLO evaluation).

    @property
    def count(self) -> int:
        c = self._folded.count
        for h in self._ring:
            c += h.count
        return c

    @property
    def sum(self):
        s = self._folded.sum
        for h in self._ring:
            s += h.sum
        return s

    @property
    def min(self):
        m = self._folded.min
        for h in self._ring:
            if h.min < m:
                m = h.min
        return m

    @property
    def max(self):
        m = self._folded.max
        for h in self._ring:
            if h.max > m:
                m = h.max
        return m

    @property
    def buckets(self) -> list:
        out = list(self._folded.buckets)
        for h in self._ring:
            if h.count:
                hb = h.buckets
                for i in range(64):
                    if hb[i]:
                        out[i] += hb[i]
        return out

    def _rotate(self, epoch: int) -> None:
        ring = self._ring
        k = len(ring)
        steps = epoch - self._slot_epoch
        if steps <= 0:
            return
        # Every interval entered (or skipped over) evicts whatever slot
        # held its ring index: fold it into the lifetime base, then give
        # the index a fresh object (a reader merging the ring
        # concurrently keeps a consistent old slot).
        lo = self._slot_epoch + 1 if steps < k else epoch - k + 1
        for e in range(lo, epoch + 1):
            old = ring[e % k]
            if old.count:
                self._folded.merge(old)
            ring[e % k] = Histogram()
            self._ring_epochs[e % k] = -1
        self._ring_epochs[epoch % k] = epoch
        self._slot = ring[epoch % k]
        self._slot_epoch = epoch

    def add(self, v: float) -> None:
        t = self._tick - 1
        if t > 0:
            self._tick = t
        else:
            self._tick = self._CHECK_EVERY
            epoch = int(self._clock() / self.interval_sec)
            if epoch != self._slot_epoch:
                self._rotate(epoch)
        self._slot.add(v)

    def merge(self, other: "Histogram") -> "Histogram":
        # Merged-in data is historical, not "recent": it folds into the
        # lifetime base so the window stays honest.
        self._folded.merge(other)
        return self

    def windowed(self, seconds: float | None = None) -> Histogram:
        """Merge the live ring slots (at most the trailing `seconds`,
        default the full window) into one mergeable Histogram."""
        now_epoch = int(self._clock() / self.interval_sec)
        if now_epoch != self._slot_epoch:
            self._rotate(now_epoch)
            self._tick = self._CHECK_EVERY
        k = len(self._ring)
        span = k if seconds is None else min(
            k, max(1, math.ceil(seconds / self.interval_sec)))
        lo = now_epoch - span + 1
        out = Histogram()
        for i in range(k):
            e = self._ring_epochs[i]
            if lo <= e <= now_epoch:
                out.merge(self._ring[i])
        return out


class Statistics:
    def __init__(self, histogram_window_sec: float = 60.0,
                 histogram_window_intervals: int = 6):
        self._tickers: dict[str, int] = defaultdict(int)
        self._window_sec = float(histogram_window_sec)
        self._window_intervals = max(1, int(histogram_window_intervals))
        self._histograms: dict[str, Histogram] = defaultdict(
            self._new_histogram)
        self._lock = ccy.Lock("statistics.Statistics._lock")
        # Hot read-path histograms pre-created so record_get skips the
        # defaultdict machinery per call.
        self._h_get_micros = self._histograms[DB_GET_MICROS]
        self._h_bytes_read = self._histograms[BYTES_PER_READ]

    def _new_histogram(self) -> Histogram:
        """histogram_window_sec > 0 → windowed (cumulative + recent ring);
        0 disables the ring entirely (plain cumulative Histogram)."""
        if self._window_sec > 0:
            return WindowedHistogram(self._window_sec, self._window_intervals)
        return Histogram()

    def set_histogram_window(self, window_sec: float,
                             intervals: int = 6) -> None:
        """Re-key the windowed ring (Options.histogram_window_sec wiring).
        Only empty histograms are rebuilt — a populated cumulative series
        is never discarded mid-flight."""
        with self._lock:
            self._window_sec = float(window_sec)
            self._window_intervals = max(1, int(intervals))
            for name, h in list(self._histograms.items()):
                if h.count == 0:
                    self._histograms[name] = self._new_histogram()
            self._h_get_micros = self._histograms[DB_GET_MICROS]
            self._h_bytes_read = self._histograms[BYTES_PER_READ]

    def record_get(self, micros: float, val_len, src) -> None:
        """ONE-lock fast path for the per-Get ticker/histogram family
        (DB_GET_MICROS + NUMBER_KEYS_READ + BYTES_READ + MEMTABLE_HIT/
        MISS + GET_HIT_L*). Three separate lock acquisitions here were
        the bulk of a stats-on Get's cost. GET_HIT_* ticks only on REAL
        value hits — a tombstone-decided miss is not a level 'hit'."""
        with self._lock:
            t = self._tickers
            self._h_get_micros.add(micros)
            t[NUMBER_KEYS_READ] += 1
            if val_len is not None:
                t[BYTES_READ] += val_len
                self._h_bytes_read.add(val_len)
            if src == "mem":
                t[MEMTABLE_HIT] += 1
            else:
                t[MEMTABLE_MISS] += 1
                if val_len is not None:
                    if src == 0:
                        t[GET_HIT_L0] += 1
                    elif src == 1:
                        t[GET_HIT_L1] += 1
                    elif src is not None:
                        t[GET_HIT_L2_AND_UP] += 1

    def record_tick(self, name: str, count: int = 1) -> None:
        with self._lock:
            self._tickers[name] += count

    def record_ticks(self, pairs) -> None:
        """Batch ticker bump under ONE lock acquisition — the read hot
        path records 3-6 tickers per Get, and per-tick locking was ~40%
        of a warm native Get."""
        with self._lock:
            t = self._tickers
            for name, count in pairs:
                t[name] += count

    def get_ticker_count(self, name: str) -> int:
        with self._lock:
            return self._tickers.get(name, 0)

    def tickers(self) -> dict:
        """Consistent snapshot of every ticker (reference getTickerMap)."""
        with self._lock:
            return dict(self._tickers)

    def record_in_histogram(self, name: str, value: float) -> None:
        with self._lock:
            self._histograms[name].add(value)

    def get_histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._histograms[name]

    def record_compaction(self, stats) -> None:
        """Merge a CompactionStats from a finished job; distributed/device
        jobs go to the D* counters with the reference's per-job timing
        breakdown (compaction_job.cc:1113-1135 stat merge-back +
        compaction_executor.h:146-150 prepare/waiting/work fields)."""
        local = stats.device == "cpu" and not getattr(stats, "remote", False)
        if local:
            self.record_tick(LCOMPACTION_READ_BYTES, stats.input_bytes)
            self.record_tick(LCOMPACTION_WRITE_BYTES, stats.output_bytes)
            self.record_in_histogram(LCOMPACTION_TIME_MICROS, stats.work_time_usec)
        else:
            self.record_tick(DCOMPACTION_READ_BYTES, stats.input_bytes)
            self.record_tick(DCOMPACTION_WRITE_BYTES, stats.output_bytes)
            self.record_in_histogram(DCOMPACTION_TIME_MICROS, stats.work_time_usec)
            if stats.prepare_time_usec:
                self.record_in_histogram(DCOMPACTION_PREPARE_MICROS,
                                         stats.prepare_time_usec)
            if stats.waiting_time_usec:
                self.record_in_histogram(DCOMPACTION_WAITING_MICROS,
                                         stats.waiting_time_usec)
            if stats.rpc_time_usec:
                self.record_in_histogram(DCOMPACTION_RPC_MICROS,
                                         stats.rpc_time_usec)
        if getattr(stats, "mesh_chips", 0) > 1:
            self.record_tick(DCOMPACTION_MESH_JOBS)
            self.record_tick(DCOMPACTION_MESH_SHARDS,
                             getattr(stats, "mesh_shards", 0))
        if getattr(stats, "mesh_fallbacks", 0):
            self.record_tick(DCOMPACTION_MESH_FALLBACKS,
                             stats.mesh_fallbacks)
        self.record_tick(COMPACT_READ_BYTES, stats.input_bytes)
        self.record_tick(COMPACT_WRITE_BYTES, stats.output_bytes)
        self.record_in_histogram(COMPACTION_TIME_MICROS, stats.work_time_usec)
        if getattr(stats, "prefetch_hits", 0):
            self.record_tick(PREFETCH_HITS, stats.prefetch_hits)
        if getattr(stats, "prefetch_misses", 0):
            self.record_tick(PREFETCH_MISSES, stats.prefetch_misses)
        if stats.transfer_time_usec:
            self.record_in_histogram(COMPACTION_TRANSFER_MICROS,
                                     stats.transfer_time_usec)
        if getattr(stats, "device_wait_usec", 0):
            # Blocking device-compute + D2H waits, split out of the
            # transfer histogram by the r04 phase breakdown.
            self.record_in_histogram(COMPACTION_DEVICE_WAIT_MICROS,
                                     stats.device_wait_usec)
        if stats.dropped_obsolete or stats.dropped_tombstone:
            # CPU path: the iterator counts drops precisely.
            self.record_tick(COMPACTION_KEY_DROP_OBSOLETE,
                             stats.dropped_obsolete)
            if stats.dropped_tombstone:
                self.record_tick(COMPACTION_KEY_DROP_RANGE_DEL,
                                 stats.dropped_tombstone)
        else:
            # Device/columnar path reports only totals: attribute the
            # non-merge-collapsed remainder to obsolete drops.
            drops = max(0, stats.input_records - stats.output_records
                        - stats.merged_records)
            if drops:
                self.record_tick(COMPACTION_KEY_DROP_OBSOLETE, drops)
        if stats.input_files:
            self.record_in_histogram(NUM_FILES_IN_SINGLE_COMPACTION,
                                     stats.input_files)

    def to_prometheus(self, prefix: str = "tpulsm",
                      labels: str = "") -> str:
        """Prometheus text exposition of every ticker (counter) and
        histogram (count/sum + p50/p99 gauges) — the rockside WebView /
        Prometheus-metrics role (reference README.md:9-10)."""
        lab = "{" + labels + "}" if labels else ""
        lines = []
        with self._lock:
            tickers = sorted(self._tickers.items())
            hists = sorted(self._histograms.items())
        for k, v in tickers:
            m = f"{prefix}_{k.replace('.', '_')}"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m}{lab} {v}")
        for k, h in hists:
            m = f"{prefix}_{k.replace('.', '_')}"
            lines.append(f"# TYPE {m} summary")
            lines.append(f"{m}_count{lab} {h.count}")
            lines.append(f"{m}_sum{lab} {h.sum}")
            for q, val in ((0.5, h.percentile(50)), (0.99, h.percentile(99))):
                ql = (labels + "," if labels else "") + f'quantile="{q}"'
                lines.append(f"{m}{{{ql}}} {val}")
            if isinstance(h, WindowedHistogram):
                # Recent-window twin: quantiles over the trailing ring
                # only, so a p99 regression shows within one window.
                w = h.windowed()
                r = f"{m}_recent"
                lines.append(f"# TYPE {r} summary")
                lines.append(f"{r}_count{lab} {w.count}")
                lines.append(f"{r}_sum{lab} {w.sum}")
                for q, val in ((0.5, w.percentile(50)),
                               (0.95, w.percentile(95)),
                               (0.99, w.percentile(99))):
                    ql = (labels + "," if labels else "") + f'quantile="{q}"'
                    lines.append(f"{r}{{{ql}}} {val}")
        return "\n".join(lines) + "\n"

    def to_string(self) -> str:
        lines = []
        for k in sorted(self._tickers):
            lines.append(f"{k} COUNT : {self._tickers[k]}")
        for k in sorted(self._histograms):
            lines.append(f"{k} : {self._histograms[k].to_string()}")
        return "\n".join(lines)


class PerfContext:
    """Per-thread perf counters (reference include/rocksdb/perf_context.h —
    the same measurement families, grouped as there).
    Access via perf_context() — a thread-local instance."""

    _FIELDS = (
        # comparisons / blocks
        "user_key_comparison_count", "block_read_count", "block_read_byte",
        "block_read_time", "block_cache_hit_count", "block_cache_miss_count",
        "block_cache_index_hit_count", "block_cache_filter_hit_count",
        "block_checksum_time", "block_decompress_time",
        "raw_block_contents_count",
        # bloom
        "bloom_memtable_hit_count", "bloom_memtable_miss_count",
        "bloom_sst_hit_count", "bloom_sst_miss_count",
        # memtable / key resolution
        "get_from_memtable_count", "get_from_memtable_time",
        "seek_on_memtable_count", "seek_on_memtable_time",
        "next_on_memtable_count", "prev_on_memtable_count",
        "internal_key_skipped_count", "internal_delete_skipped_count",
        "internal_merge_count", "internal_range_del_reseek_count",
        # get path
        "get_snapshot_time", "get_from_output_files_time",
        "get_post_process_time", "get_read_bytes",
        # seek path
        "seek_child_seek_count", "seek_child_seek_time",
        "seek_internal_seek_time", "find_next_user_entry_time",
        "iter_read_bytes",
        # write path
        "write_wal_time", "write_memtable_time", "write_pre_and_post_process_time",
        "write_delay_time", "write_thread_wait_nanos",
        "wal_write_bytes",
        # file / env
        "open_table_file_nanos", "find_table_nanos",
        "new_table_iterator_nanos", "table_cache_hit_count",
        "env_read_nanos", "env_write_nanos", "env_sync_nanos",
        # txn
        "key_lock_wait_count", "key_lock_wait_time",
        # blob
        "blob_read_count", "blob_read_byte", "blob_checksum_time",
        "blob_decompress_time",
        # merge operator
        "merge_operator_time_nanos",
    )

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for f in self._FIELDS:
            setattr(self, f, 0)

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in self._FIELDS}


# PerfContext collection level (reference SetPerfLevel): 0 = disabled
# (the default, matching the reference's PerfLevel::kDisable), 1 =
# count-only, 2+ = reserved for timed fields.
perf_level = 0

_perf_tls = threading.local()


def perf_context() -> PerfContext:
    ctx = getattr(_perf_tls, "ctx", None)
    if ctx is None:
        ctx = PerfContext()
        _perf_tls.ctx = ctx
    return ctx


class IOStatsContext:
    """Per-thread IO counters (reference include/rocksdb/iostats_context.h)."""

    def __init__(self):
        self.reset()

    _FIELDS = ("bytes_written", "bytes_read", "write_nanos", "read_nanos",
               "fsync_nanos")

    def reset(self) -> None:
        self.bytes_written = 0
        self.bytes_read = 0
        self.write_nanos = 0
        self.read_nanos = 0
        self.fsync_nanos = 0

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in self._FIELDS}


_iostats_tls = threading.local()


def iostats_context() -> IOStatsContext:
    ctx = getattr(_iostats_tls, "ctx", None)
    if ctx is None:
        ctx = IOStatsContext()
        _iostats_tls.ctx = ctx
    return ctx
