"""DB: the central engine object (copied from toplingdb_tpu/db/db.py,
trimmed to the core of the engine with column families).

The role of RocksDB's DBImpl (db/db_impl/db_impl.cc): open and recover
(MANIFEST + WAL replay), the write path (group commit: WAL + memtable),
point reads through memtable → immutables → versioned SST levels, flush,
MVCC iterators, snapshots, manual compaction, the L0 write stall and
obsolete-file GC. Background compactions run in the scheduler
(compaction/scheduler.py) through Options.compaction_executor_factory: by
default the port's DeviceCompactionExecutorFactory, on the card. The
three compaction styles run (`compaction_style` "leveled", "universal",
"fifo"), and `periodic_compaction_seconds` marks aged files of a leveled
DB for a rewrite.

Integrated blob files (RocksDB's BlobDB): with `enable_blob_files`, a
flush writes values of `min_blob_size` bytes or more to a sibling blob
file and BLOB_INDEX rows into the SST; gets and scans resolve them through
`blob_source` (a BlobSource with the `blob_cache` value cache and
`blob_file_open_limit` open readers), and with
`enable_blob_garbage_collection` each compaction rewrites the survivors
of the oldest `blob_garbage_collection_age_cutoff` fraction of the blob
files it references.

Column families (RocksDB's ColumnFamilyData): `create_column_family(name)`
returns a ColumnFamilyHandle that put / delete / merge / delete_range /
get / new_iterator take as `cf=`, and a WriteBatch takes as its id
(`cf=handle.id`); a batch may span CFs and stays atomic. Every CF has its
own memtables and Version and shares the one WAL, MANIFEST, sequence and
Options. A memtable switch seals every non-empty CF, so the MANIFEST's
log number advances once all of them are flushed; compactions are picked
per CF and run on the same executor, their outputs tagged with the CF's
id and name. `drop_column_family` discards the CF (its files go with the
next obsolete-file pass, an edit of a job still in flight is dropped);
`export_column_family` (db/import_column_family_job.py) and
`create_column_family_with_import` move one CF's SSTs between DBs;
`persist_stats(to_db=True)` writes samples into the hidden CF
"__tpulsm_stats__".

The host planes are toplingdb_tpu's defaults, each switched by an
explicit DB.open argument instead of its process-wide knob:

  write plane   `write_plane=True`: each write group is validated, framed
                into one WAL record and applied to the skiplist or trie
                memtable in native calls (tpulsm_wb_group_commit). Groups
                it does not take (CF-prefixed records, range deletes,
                merge-heavy or wide-column batches, the Python reps) run
                the Python group commit, which writes the same WAL bytes.
  read chain    always on: `get` walks memtables and SST levels in one
                native call (tpulsm_getctx_get, through the `fastget`
                extension where it builds); anything the native walk
                cannot decide (merge operands, blob indexes, range
                tombstones, single deletes in SSTs) runs the Python
                GetContext chain.
  scan plane    `iter_chunk_rows=4096` (0 = off): forward iteration
                serves chunks merged natively (ops/scan_plane.py);
                backward steps and shapes it cannot take drop to the
                per-entry DBIter.

With `write_plane=True` or `iter_chunk_rows > 0`, DB.open raises
NotSupported naming the plane when the native library cannot be built or
loaded.

The integrity plane, as toplingdb_tpu runs it. With
`protection_bytes_per_key` (1, 2, 4 or 8) every record of a WriteBatch
carries a checksum from the first handoff on: the write plane computes or
verifies the vectors inside its WAL frame walk (the Python group commit
at the memtable insert), the memtable keeps them until the flush checks
every entry it writes against them, the scan plane banks the checksum of
every decoded row and checks every row it serves, and the card jobs
verify their outputs; a mismatch raises Corruption. Tables carry
whole-file checksums (`file_checksum`, taken from the bytes written),
checked by `verify_file_checksums`, `verify_checksum` (every block and
blob record) and the IntegrityScrubber (db/integrity.py; `scrub()`, and
a background pass every `integrity_scrub_period_sec`), which quarantines
a corrupt file away from compaction picks. Background errors latch with
RocksDB's ErrorHandler severities: SOFT ones (retryable flush and job IO
errors, no space) leave writes on and start an auto-recover thread; HARD
ones (a scrub's corruption, other IO errors) stop writes until
`resume()`; FATAL and UNRECOVERABLE ones (corruption found by a job, a
MANIFEST failure) need a reopen.

Observability, as toplingdb_tpu's DB wires it: `Options.statistics`
(tickers and histograms of the write, get, iterator, flush and compaction
paths; `stats_history`, `stats_persist_period_sec`,
`stats_dump_period_sec`, `histogram_window_sec`), `Options.listeners`,
the structured event log in `<db>/LOG` (rolled to `LOG.old` on open) and
the span tracer (`trace_sample_every` / `trace_slow_usec` / `trace_ring`),
the SLO engine (`slo_specs`, `slo_eval_period_sec`, `slo_window_sec`;
`db.slo_engine`) and the op trace (`start_trace` / `end_trace`: every
get, multi_get, write and iterator seek recorded before a native chain
decides it). Every lock and thread comes from utils/concurrency's named
factories; `close()` warns about a thread it owns that outlived it.
On open, job dirs of dcompact workers whose lease expired are swept from
`<db>/dcompact`.

The write modes, as toplingdb_tpu runs them. Memtable reps: "skiplist"
(native), "cspp" / "trie" / "patricia" (the native CSPP-role trie),
"vector", and "hash_skiplist" / "hash_linklist" / "prefix_hash" with an
optional ":N" prefix length. `enable_pipelined_write` and
`unordered_write` take the staged path (RocksDB's PipelinedWriteImpl and
WriteImplWALOnly): a group's sequence numbers are allocated and its WAL
record written under `_mutex`, the next leader is woken, and the group's
memtable phase runs outside the mutex; `last_sequence` advances as an
in-order watermark over completed groups, and a memtable switch, `close`
and (unordered) `get_snapshot` wait for the phases in flight.
`enable_async_wal` moves WAL appends and fsyncs onto one writer thread
(env.AsyncIORing, `async_wal_ring_size` entries), where concurrent
groups' syncs coalesce into shared fsyncs; a failed append or fsync
fails the group and latches a HARD background error with reason "wal".
`write_buffer_manager` (utils/rate_limiter.WriteBufferManager) is a
memtable budget shared between DBs: each DB charges its memtables' memory
and a write flushes when the shared sum reaches it.

The read path, as toplingdb_tpu runs it. `Options.block_cache` (a
utils.cache LRUCache or ClockCache, optionally with a secondary tier — a
CompressedSecondaryCache or a utils.persistent_cache.PersistentCache —
and a BlockCacheTracer, or a SimCache around one) serves the block
readers' data, index-partition and filter-partition blocks under a
per-open session prefix; with one the native read chain stays off, since
its own LRU would bypass the user cache's contract. `multi_get` resolves a
batch in one native call (keys it cannot decide re-resolve in Python,
pinned to the batch's snapshot), or walks the batch per file in Python:
each memtable and file is visited once for all its keys, L0 newest first
and then each level. `ReadOptions.async_io` walks each missing key's file
chain on a pool of `async_queue_depth` threads. `DB.open(async_reads=
True)` is toplingdb_tpu's TPULSM_ASYNC_READS: gets and multi_gets take the
Python walk with every candidate file's cache-missing blocks submitted up
front as one coalesced batch across `async_read_rings` reader rings
(env/async_reads.py; zip tables preload their value-group decodes), and
iterators' readahead windows become ring tasks. `get_async` and
`multi_get_async` return futures. `ReadOptions.readahead_size` pins a
fixed readahead window on every table iterator and scan-plane source.

The manual and introspection entry points, as toplingdb_tpu runs them
(RocksDB's db.h): `compact_files` runs one job of caller-chosen files in
the caller's thread through the same executor (a failed job raises and
latches the background error), `suggest_compact_range` marks files for
the picker, `promote_l0` and `delete_files_in_range` edit the MANIFEST
only; `get_property` ("tpulsm." names), `get_approximate_sizes`,
`get_live_files` with `get_sorted_wal_files` and `get_wal_files` (the
backup recipe), `key_exists`, `get_merge_operands`,
`latest_sequence_number` and `write_stall_state` read; `flush_wal`,
`pause_background_work` / `continue_background_work` and `set_options`
(the mutable subset, persisted to a new OPTIONS file) control. With
`recycle_log_file_num` obsolete WALs this DB wrote in the recyclable
format are kept in a pool and renamed and overwritten in place as new
WALs (their stale tails read as the end of the log); with
`wal_ttl_seconds` obsolete WALs move to `<db>/archive/` and leave it
once older than the TTL.

The storage-pressure plane, as toplingdb_tpu runs it. An SstFileManager
(utils/rate_limiter.py; shared through `Options.sst_file_manager`, else
built by the DB when `max_allowed_space_usage` or
`free_space_poll_period_sec` is set) tracks the live SST, WAL and blob
bytes, polls the env's free space and publishes a pressure level ("ok",
"amber", "red"; `disk_pressure()`). A flush that would breach the budget
does not start: it latches a SOFT `no_space` background error, as does an
ENOSPC from any write of a flush or a job; the auto-recover loop waits for
headroom without spending an attempt and clears the latch itself, and the
jobs rerun on the same executor. The scheduler refuses to start a job
under pressure or when its output would eat the reserved headroom. A
pressure rise runs the reclaim ladder (obsolete SSTs and blobs go through
the manager's paced trash deletion, which it unpaces). The seqno-to-time
mapping samples `(sequence, time)` every `seqno_time_sample_period_sec`
on every publishing path and persists it as `SEQNO_TIME.json` at every
flush and close; with `preclude_last_level_data_seconds` a bottommost job
over data younger than that keeps its seqnos and tombstones. Wide-column
entities: `put_entity` / `get_entity` (the dedicated value type), a plain
read presents an entity's default column, the iterator's `columns()` all
of them; `legacy_wide_column_unwrap` also unwraps values that merely
start with the entity magic.

The shared SST store (storage/): with `Options.shared_store` (a store root
path, an http:// URL of a StoreServer, or a store object) DB.open wraps
the env in a SharedSstEnv; every table a flush, a compaction, an ingest or
an import installs is published to the content-addressed store under its
checksum address, tables a checkpoint restore or a store-mode dcompact job
adopts live as references and materialize on first read, and the reclaim
ladder's red steps prune the cache tier and sweep the store.

What toplingdb_tpu runs beyond this (the SLO engine, ...) is refused at
open:
`options.unported_fields` lists it and DB.open raises NotSupported instead
of ignoring it.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import uuid
import warnings

from toplingdb_tpu_torch.db import dbformat, filename
from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.blob import BlobSource, blob_file_name
from toplingdb_tpu_torch.db.db_iter import DBIter
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.flush_job import flush_memtable_to_table
from toplingdb_tpu_torch.db.get_context import GetContext
from toplingdb_tpu_torch.db.level_iterator import LevelIterator
from toplingdb_tpu_torch.db.log import LogReader, LogWriter
from toplingdb_tpu_torch.db.memtable import MemTable, create_memtable_rep
from toplingdb_tpu_torch.db.range_del import (
    RangeDelAggregator,
    RangeTombstone,
)
from toplingdb_tpu_torch.db.snapshot import SnapshotList
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.db.version_edit import VersionEdit
from toplingdb_tpu_torch.db.version_set import VersionSet
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.env import default_env
from toplingdb_tpu_torch.env.env import AsyncIORing, AsyncWritableFile
from toplingdb_tpu_torch.ops.scan_plane import DEFAULT_CHUNK, make_scan_plane
from toplingdb_tpu_torch.options import (
    FlushOptions,
    Options,
    ReadOptions,
    WriteOptions,
    unported_fields,
)
from toplingdb_tpu_torch.table.merging_iterator import MergingIterator
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils import statistics as _st
from toplingdb_tpu_torch.utils import telemetry as _tm
from toplingdb_tpu_torch.utils.listener import EventLogger, notify
from toplingdb_tpu_torch.utils.thread_status import (
    get_thread_list,
    thread_operation,
)
from toplingdb_tpu_torch.utils.status import (
    Busy,
    Corruption,
    InvalidArgument,
    IOError_,
    NotFound,
    NoSpace,
    NotSupported,
    Severity,
    ShutdownInProgress,
    is_no_space,
)
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils.sync_point import sync_point

_DEFAULT_READ = ReadOptions()
_DEFAULT_WRITE = WriteOptions()

# Cap on bytes merged into one commit group (RocksDB's
# max_write_batch_group_size_bytes).
_MAX_WRITE_GROUP_BYTES = 1 << 20


class _Writer:
    """One queued write (RocksDB's WriteThread::Writer).

    Lifecycle: enqueued → either becomes the group leader (front of queue) or
    blocks on its event until a leader commits it (done=True), promotes it
    to lead the next group (done=False), or drafts it into a parallel
    memtable phase (parallel=True — RocksDB's
    STATE_PARALLEL_MEMTABLE_WRITER)."""

    __slots__ = ("batch", "opts", "done", "error", "event", "on_sequenced",
                 "parallel", "pg", "pg_mems")

    def __init__(self, batch: WriteBatch, opts: WriteOptions,
                 on_sequenced=None):
        self.batch = batch
        self.opts = opts
        self.done = False
        self.error: BaseException | None = None
        self.event = threading.Event()
        # Optional callable(first_seq, last_seq) fired INSIDE the commit
        # critical section, before the group's last_sequence publishes:
        # the WritePrepared policy registers its undecided seqno range
        # here, so no reader can ever observe the data unexcluded.
        self.on_sequenced = on_sequenced
        self.parallel = False          # drafted into parallel memtable phase
        self.pg = None                 # _InsertBarrier of the phase
        self.pg_mems = None            # {cf_id: MemTable} to insert into


class _InsertBarrier:
    """Completion barrier for one group's parallel memtable phase
    (RocksDB's LaunchParallelMemTableWriters /
    CompleteParallelMemTableWriter)."""

    __slots__ = ("remaining", "all_done", "error", "lock")

    def __init__(self, n: int):
        self.remaining = n
        self.all_done = threading.Event()
        self.error: BaseException | None = None
        self.lock = ccy.Lock("db._InsertBarrier.lock")

    def member_done(self, err: BaseException | None = None) -> None:
        with self.lock:
            if err is not None and self.error is None:
                self.error = err
            self.remaining -= 1
            if self.remaining == 0:
                self.all_done.set()


class ColumnFamilyHandle:
    """Opaque per-CF handle (RocksDB's include/rocksdb/db.h
    ColumnFamilyHandle)."""

    __slots__ = ("id", "name")

    def __init__(self, cf_id: int, name: str):
        self.id = cf_id
        self.name = name

    def __repr__(self):
        return f"ColumnFamilyHandle({self.id}, {self.name!r})"


class _CFData:
    """Mutable per-CF state (the memtable side of RocksDB's
    ColumnFamilyData). `sv` is the CF's published read view."""

    __slots__ = ("handle", "mem", "imm", "sv")

    def __init__(self, handle: ColumnFamilyHandle, icmp, rep_name: str,
                 protection_bytes: int = 0):
        self.handle = handle
        self.mem = MemTable(icmp, create_memtable_rep(rep_name),
                            protection_bytes=protection_bytes)
        self.imm: list[MemTable] = []
        self.sv: _SuperVersion | None = None


class _SuperVersion:
    """One CF's read view (RocksDB's SuperVersion): the active memtable,
    the immutables newest first and the Version, taken together under the
    DB mutex. A memtable switch and a flush's install publish a new one
    under the mutex, so no view shows a sealed memtable beside the L0 file
    it became, or one memtable twice."""

    __slots__ = ("mem", "imm", "version", "mems")

    def __init__(self, mem: MemTable, imm, version):
        self.mem = mem
        self.imm = tuple(imm)
        self.version = version
        self.mems = (mem,) + self.imm  # newest first


class _SeqSnapshot:
    """Sequence-pinning shim for internal reads: quacks like a Snapshot
    (.sequence, no excluded ranges) without registering in the snapshot
    list."""

    __slots__ = ("sequence",)
    excluded_ranges = ()

    def __init__(self, seq: int):
        self.sequence = seq


class _NGetState:
    """Per-thread bound state of the native point-read chain: the native
    context (it owns the out and value buffers), their mapped views, and
    a strong ref to the read view whose memtables and version the context
    embeds (compared by identity to notice a new view, and keeping those
    handles alive while this thread holds them)."""

    __slots__ = ("sv", "ctx", "fn", "out",
                 "val_ptr", "val_cap", "_lib", "mg", "mg_arena", "fast",
                 "fast_mg")

    def __del__(self):
        lib = getattr(self, "_lib", None)
        ctx = getattr(self, "ctx", None)
        if lib is not None and ctx:
            try:
                lib.tpulsm_getctx_free(ctx)
            except Exception as e:  # noqa: BLE001 - interpreter teardown
                _errors.swallow(reason="getctx-free-at-gc", exc=e)

    def remap(self, lib, vlen: int) -> None:
        # The C side grew its buffer to >= vlen; record vlen as the known
        # capacity so any LARGER future value triggers another remap (the
        # vector may reallocate again, moving the pointer).
        self.val_ptr = lib.tpulsm_getctx_val(self.ctx)
        self.val_cap = vlen

    @classmethod
    def build(cls, lib, sv: _SuperVersion, table_cache):
        import ctypes

        from toplingdb_tpu_torch import native

        handles = []
        kinds = []
        version = sv.version
        for m in sv.mems:
            h = getattr(m._rep, "_h", None)
            kind = getattr(m._rep, "_nget_mem_kind", None)
            if h is None or kind is None:
                return None  # a rep the native probe cannot walk
            handles.append(h)
            kinds.append(kind)
        vh = version.native_read_chain(table_cache)
        if vh is None and any(version.files):
            return None
        marr = (ctypes.c_void_p * len(handles))(*handles)
        ctx = lib.tpulsm_getctx_new(marr, len(handles), vh, 4096)
        if not ctx:
            return None
        for i, kind in enumerate(kinds):
            if kind:
                lib.tpulsm_getctx_set_mem_kind(ctx, i, kind)
        s = cls.__new__(cls)
        s.sv = sv
        s.ctx = ctx
        s.fn = lib.tpulsm_getctx_get
        s.out = (ctypes.c_int64 * 8).from_address(
            lib.tpulsm_getctx_out(ctx))
        s.val_ptr = lib.tpulsm_getctx_val(ctx)
        s.val_cap = 4096
        s._lib = lib
        # multi_get's ctypes scratch (status / offsets / lengths, value
        # arena), made on the first batch and kept for the next ones.
        s.mg = None
        s.mg_arena = None
        # The C-extension calls (ctypes marshaling is a large share of a
        # warm get); None keeps the ctypes call in charge.
        s.fast = native.fastget()
        s.fast_mg = native.fastmultiget()
        return s


class DB:
    """LSM engine instance. Use DB.open()."""

    def __init__(self, dbname: str, options: Options, env,
                 write_plane: bool = True,
                 iter_chunk_rows: int = DEFAULT_CHUNK,
                 async_reads: bool = False):
        self.dbname = dbname
        self.options = options
        self.env = env
        self._owns_shared_env = False  # DB.open retained a SharedSstEnv
        # The replication plane's status (a LogShipper or a FollowerDB
        # sets it; the /replication view reads it).
        self._repl_status_provider = None
        # The host planes (see the module docstring); DB.open refused a
        # plane asked for without the native library.
        from toplingdb_tpu_torch import native

        lib = native.lib()
        # A timestamp comparator's writes commit through Python, as in
        # toplingdb_tpu (its write plane refuses such a comparator).
        self._write_plane = (
            lib.tpulsm_wb_group_commit
            if write_plane and lib is not None
            and options.comparator.timestamp_size == 0 else None)
        self._write_plane_knob = bool(write_plane)  # the /db view reads it
        self.iter_chunk_rows = iter_chunk_rows
        # The async read plane (toplingdb_tpu's TPULSM_ASYNC_READS): the
        # lazy AsyncReadBatcher fanning batched block fetches across
        # Options.async_read_rings reader rings, the lazy executors of
        # get_async / multi_get_async and of ReadOptions.async_io's per-key
        # walks; close() joins them all.
        self._async_reads = bool(async_reads)
        self._read_batcher = None
        self._async_pool = None
        self._mget_pool = None
        # Test seam: set before the first async-routed read to plug a
        # ReadFaultInjector into every reader ring (fault_hook).
        self.read_fault_hook = None
        # The native point-read chain's library, None for the Python chain
        # (no library, or a user block cache: a contract of capacity and
        # stats the chain's own LRU would bypass), and each thread's
        # _NGetState.
        self._nget_lib = lib if options.block_cache is None else None
        self._nget_tl = threading.local()  # .states: {cf_id: _NGetState}
        self.icmp = InternalKeyComparator(options.comparator)
        # The integrity plane: per-entry protection, whole-file checksums
        # and the scrubber's state (utils/protection.py,
        # utils/file_checksum.py, db/integrity.py).
        from toplingdb_tpu_torch.utils.file_checksum import (
            ChecksumTapEnv,
            factory_for,
        )
        from toplingdb_tpu_torch.utils.protection import (
            check_protection_bytes,
        )

        pb = options.protection_bytes_per_key
        check_protection_bytes(pb)
        self._protection = pb
        self._file_checksum_factory = factory_for(options)
        if self._file_checksum_factory is not None:
            # Flushes and jobs write their tables through self.env: each
            # table's checksum is taken from the bytes written.
            self.env = ChecksumTapEnv(env, self._file_checksum_factory)
        self._quarantined: set[int] = set()
        self._integrity_scrubber = None
        if pb and options.table_options.protection_bytes_per_key != pb:
            # The table layer reads the width (the flush handoff check and
            # the card jobs' output verification). Copy: the caller's
            # TableOptions object must not be mutated.
            import dataclasses

            options.table_options = dataclasses.replace(
                options.table_options, protection_bytes_per_key=pb)
        if (options.prefix_extractor is not None
                and options.table_options.prefix_extractor is None):
            # The CF-level extractor feeds the table layer (prefix blooms,
            # the plain format). Copy: the caller's TableOptions object must
            # not be mutated.
            import dataclasses

            options.table_options = dataclasses.replace(
                options.table_options,
                prefix_extractor=options.prefix_extractor,
            )
        if options.bottommost_format is not None:
            from toplingdb_tpu_torch.table.factory import FORMATS

            if options.bottommost_format not in FORMATS:
                # Fail at open — a typo must not surface hours later as a
                # repeatedly failing background compaction.
                raise InvalidArgument(
                    f"bottommost_format {options.bottommost_format!r} is "
                    f"not one of {FORMATS}"
                )
        if (getattr(options.table_options, "partition_filters", False)
                and options.table_options.prefix_extractor is not None):
            raise InvalidArgument(
                "partition_filters supports whole-key filtering only "
                "(prefix probes could span filter partitions)"
            )
        if (getattr(options.table_options, "format", "block") == "plain"
                and options.table_options.prefix_extractor is None):
            raise InvalidArgument(
                "plain table format requires Options.prefix_extractor"
            )
        self.versions = VersionSet(env, dbname, self.icmp, options.num_levels)
        self.table_cache = TableCache(env, dbname, self.icmp,
                                      options.table_options,
                                      block_cache=options.block_cache)
        self.table_cache.stats = options.statistics
        self.default_cf = ColumnFamilyHandle(0, "default")
        self._cfs: dict[int, _CFData] = {
            0: _CFData(self.default_cf, self.icmp, options.memtable_rep,
                       protection_bytes=self._protection)
        }
        self.blob_source = BlobSource(
            env, dbname, blob_cache=options.blob_cache,
            open_limit=options.blob_file_open_limit,
            statistics=options.statistics)
        self.snapshots = SnapshotList()
        self._mutex = ccy.RLock("db.DB._mutex")
        self._writers: list[_Writer] = []  # FIFO write queue (leader = [0])
        self._wq_lock = ccy.Lock("db.DB._wq_lock")
        # Staged write modes (pipelined / unordered): seqno ALLOCATION runs
        # ahead of PUBLICATION. _alloc_ranges is a deque of [first, last,
        # done] entries in allocation order (indexed by _alloc_entry for
        # O(1) completion marking); last_sequence advances as an in-order
        # low watermark over the done prefix. _mt_cv (on _mutex) signals
        # completion to memtable-switch / snapshot / close waiters.
        self._mt_cv = ccy.Condition(lock=self._mutex)
        self._mt_inflight = 0
        self._seq_alloc = 0
        self._alloc_ranges: collections.deque[list] = collections.deque()
        self._alloc_entry: dict[int, list] = {}  # first -> its deque entry
        # Async WAL writer ring (Options.enable_async_wal), started by
        # DB.open just before the first WAL (_start_wal_ring).
        self._wal_ring = None
        self._wbm_charged = 0  # bytes charged to options.write_buffer_manager
        self._wal: LogWriter | None = None
        self._wal_number = 0
        self._recycle_wals: list[int] = []  # obsolete WALs kept for reuse
        # Only logs THIS process wrote in recyclable format may enter the
        # pool: a legacy-format WAL's stale records carry no log-number
        # stamp and could replay after reuse (RocksDB's alive_log_files
        # scoping).
        self._recyclable_written: set[int] = set()
        self._closed = False
        # Write-stall accounting read by write_stall_state(): the
        # cumulative counters are folded in by _account_stall; the live
        # state is derived from L0 against the triggers at query time.
        self._stall_totals = {"stalls": 0, "stall_micros": 0,
                              "last_stall_micros": 0, "last_state": "none"}
        self._compaction_scheduler = None
        self._pending_outputs: set[int] = set()  # files being written by jobs
        # The background-error latch (RocksDB's ErrorHandler): the error,
        # its Severity and the background reason it was raised for; the
        # event stops the auto-recover loop at close.
        self._bg_error: BaseException | None = None
        self._bg_error_severity = Severity.NO_ERROR
        self._bg_error_reason = ""
        self._recover_stop = threading.Event()
        self._recover_threads: list[threading.Thread] = []
        self._options_file_number = 0  # latest persisted OPTIONS file
        self._op_tracer = None  # DB::StartTrace's recorder (start_trace)
        self._file_deletions_disabled = 0  # DisableFileDeletions pin count
        self._stats_persist_seq = 0  # suffix of persisted stats keys
        self.num_flushes = 0  # L0 tables written by flushes
        # WritePrepared policy hook (RocksDB's SnapshotChecker): a callable
        # returning the seqno ranges of prepared but undecided
        # transactions, which every read must treat as invisible. Set by
        # utilities.transactions.TransactionDB under the write_prepared /
        # write_unprepared policies; None = plain visibility.
        self._undecided_provider = None
        self.identity = ""
        self._init_observability()
        self._init_storage_pressure()
        # The seqno <-> time mapping (utils/seqno_to_time.py): sampled on
        # publish, persisted as SEQNO_TIME.json at flush and close (without
        # it a reopen would treat all data as young for
        # preclude_last_level_data_seconds), loaded at open.
        from toplingdb_tpu_torch.utils.seqno_to_time import (
            SeqnoToTimeMapping,
        )

        self.seqno_to_time = SeqnoToTimeMapping()
        self._seqno_time_path = None
        self._seqno_time_dirty = False
        self._last_seqno_time_sample = 0.0

    def _init_storage_pressure(self) -> None:
        """The SstFileManager tracking this DB's live SST + WAL + blob
        bytes: the caller's (Options.sst_file_manager; it adopts this DB's
        env, root and statistics where it has none, and its owner closes
        it), else one built here when a disk budget or poller knob is set;
        None otherwise (the no-knob path pays nothing)."""
        from toplingdb_tpu_torch.utils.rate_limiter import SstFileManager

        options = self.options
        sfm = options.sst_file_manager
        self._sfm_owned = False
        self._store_gc_inflight = False  # one reclaim GC sweep at a time
        if sfm is None and (options.max_allowed_space_usage > 0
                            or options.free_space_poll_period_sec > 0):
            headroom = options.flush_headroom_bytes
            if headroom <= 0 and options.max_allowed_space_usage > 0:
                headroom = 2 * options.write_buffer_size
            sfm = SstFileManager(
                env=self.env, path=self.dbname,
                max_allowed_space_usage=options.max_allowed_space_usage,
                compaction_buffer_size=options.compaction_buffer_size,
                flush_headroom_bytes=headroom,
                free_space_poll_period_sec=(
                    options.free_space_poll_period_sec),
                amber_free_ratio=options.disk_amber_free_ratio,
                red_free_ratio=options.disk_red_free_ratio,
                pressure_hysteresis=options.disk_pressure_hysteresis,
                statistics=self.stats)
            self._sfm_owned = True
        elif sfm is not None:
            if sfm._env is None:
                sfm._env = self.env
            if sfm._path is None:
                sfm._path = self.dbname
            if sfm._stats is None:
                sfm._stats = self.stats
        self._sfm = sfm
        if sfm is not None:
            sfm.add_pressure_callback(self._on_disk_pressure_change)

    def _init_observability(self) -> None:
        """Statistics, stats history, the span tracer and the event logger
        (toplingdb_tpu's DB.__init__ wiring). The LOG file and the dump
        threads start in open(): the LOG once the directory exists, the
        threads last."""
        from toplingdb_tpu_torch.utils.stats_history import StatsHistory

        options = self.options
        self.stats = options.statistics  # may be None
        if (self.stats is not None
                and options.histogram_window_sec != self.stats._window_sec):
            # Re-key the windowed-histogram ring to the DB's knob (only
            # empty histograms are rebuilt; a shared Statistics keeps its
            # populated series).
            self.stats.set_histogram_window(options.histogram_window_sec)
        self.stats_history = StatsHistory(self.stats)
        # The SLO engine (utils/slo.py): declarative burn-rate objectives
        # over the statistics; /slo/<name> and /metrics serve its
        # verdicts. Its evaluation thread starts with the stats threads.
        self.slo_engine = None
        if self.stats is not None and options.slo_specs:
            from toplingdb_tpu_torch.utils.slo import SLOEngine

            self.slo_engine = SLOEngine(
                self.stats, options.slo_specs, db=self,
                db_name=self.dbname, listeners=options.listeners,
                default_window_sec=options.slo_window_sec or 60.0)
        self._stats_dumper = None       # stats_persist_period_sec thread
        self._stats_dump_thread = None  # stats_dump_period_sec thread
        # Request-scoped span tracer: None unless a trace_* knob turns it
        # on. The get path's 1-in-N decision is a precomputed cycle
        # (`_trace_sched` yields 1 on the Nth op, 2 for slow-watch rounds,
        # 0 otherwise).
        self.tracer = _tm.tracer_from_options(options)
        self._trace_sched = None
        tr = self.tracer
        if tr is not None:
            import itertools

            se, slow = tr.sample_every, tr.slow_usec
            pat = ([2 if slow else 0] * (se - 1) + [1]) if se else [2]
            self._trace_sched = itertools.cycle(pat).__next__
        self._log_file = None
        self.event_logger = EventLogger(None)

    def _open_log(self) -> None:
        """Open `<db>/LOG`, the previous one rolled to LOG.old (RocksDB's
        auto_roll_logger)."""
        env, dbname = self.env, self.dbname
        try:
            if env.file_exists(f"{dbname}/LOG"):
                env.rename_file(f"{dbname}/LOG", f"{dbname}/LOG.old")
            self._log_file = env.new_writable_file(f"{dbname}/LOG")
        except Exception as e:  # noqa: BLE001 - the info LOG is best-effort
            _errors.swallow(reason="info-log-roll-best-effort", exc=e,
                            stats=self.stats)
        if self._log_file is not None:
            self.event_logger = EventLogger(
                lambda line: self._log_file.append(line.encode() + b"\n"))

    def _start_stats_threads(self) -> None:
        """The periodic stats threads (the last step of open, so a failed
        open leaves none running)."""
        from toplingdb_tpu_torch.utils.stats_history import StatsDumpScheduler

        options = self.options
        if self.stats is not None and options.stats_persist_period_sec > 0:
            self._stats_dumper = StatsDumpScheduler(
                self.stats_history, options.stats_persist_period_sec)
        if self.stats is not None and options.stats_dump_period_sec > 0:
            self._stats_dump_thread = StatsDumpScheduler(
                self.stats_history, options.stats_dump_period_sec,
                on_snapshot=self._log_stats_dump)
        if self.slo_engine is not None and options.slo_eval_period_sec > 0:
            self.slo_engine.start(options.slo_eval_period_sec)

    def _log_stats_dump(self) -> None:
        """One compact stats line per dump period (RocksDB's periodic stats
        dump into the info LOG), fed from the history ring's latest delta
        sample so the dump and the history always agree."""
        sample = self.stats_history.last_sample()
        if sample is None:
            return
        ts, delta = sample
        top = sorted(delta.items(), key=lambda kv: -abs(kv[1]))[:12]
        self.event_logger.log(
            "stats_dump", sample_ts=ts,
            tickers={k: v for k, v in top},
            last_sequence=self.versions.last_sequence,
        )

    def _sweep_orphan_jobs(self) -> None:
        """A kill -9'd dcompact worker leaves its job dir (params, partial
        outputs, a stale heartbeat) behind: sweep every attempt dir whose
        lease expired before background work starts. The job's inputs are
        still live in the version, so the picker simply re-runs it."""
        from toplingdb_tpu_torch.compaction.resilience import (
            DcompactOptions,
            sweep_orphan_jobs,
        )

        options = self.options
        policy = options.dcompact or DcompactOptions()
        roots = {os.path.join(self.dbname, "dcompact")}
        job_root = getattr(options.compaction_executor_factory, "job_root",
                           None)
        if job_root:
            roots.add(job_root)
        for root in sorted(roots):
            try:
                sweep_orphan_jobs(root, policy.lease_sec,
                                  statistics=self.stats,
                                  event_logger=self.event_logger)
            except Exception as e:  # noqa: BLE001 - never blocks open
                _errors.swallow(reason="orphan-job-sweep-on-open", exc=e,
                                stats=self.stats)

    # ==================================================================
    # Open / close
    # ==================================================================

    @staticmethod
    def open(dbname: str, options: Options | None = None, env=None, *,
             write_plane: bool = True,
             iter_chunk_rows: int = DEFAULT_CHUNK,
             async_reads: bool = False) -> "DB":
        """RocksDB's DBImpl::Open: create or recover the DB at `dbname`.
        Raises NotSupported for an option set away from its default that
        the port does not run (options.unported_fields), and for a host
        plane asked for without the native library. `write_plane` is
        toplingdb_tpu's TPULSM_WRITE_PLANE (the native group commit);
        `iter_chunk_rows` its TPULSM_ITER_CHUNK (rows per scan-plane
        chunk, 0 = no scan plane); `async_reads` its TPULSM_ASYNC_READS
        (the async read plane). The defaults are toplingdb_tpu's."""
        options = options or Options()
        DB._check_open_args(options, write_plane, iter_chunk_rows,
                            async_reads)
        env, owns_shared_env = DB._shared_store_env(
            env or default_env(), options)
        # Validates; touches no file.
        db = DB(dbname, options, env, write_plane=write_plane,
                iter_chunk_rows=iter_chunk_rows, async_reads=async_reads)
        env.create_dir(dbname)
        if not options.read_only:
            db._open_log()
        current = filename.current_file_name(dbname)
        if env.file_exists(current):
            if options.error_if_exists:
                raise InvalidArgument(f"{dbname} exists (error_if_exists)")
            db._recover()
        else:
            if not options.create_if_missing:
                raise InvalidArgument(
                    f"{dbname} does not exist (create_if_missing=False)")
            db.versions.create_new()
            db._materialize_cfs()
            env.write_file(
                filename.identity_file_name(dbname), uuid.uuid4().hex.encode()
            )
        try:
            db.identity = env.read_file(
                filename.identity_file_name(dbname)).decode()
        except NotFound:
            db.identity = uuid.uuid4().hex
            env.write_file(filename.identity_file_name(dbname),
                           db.identity.encode())
        if not options.read_only:
            db._start_wal_ring(env)
        db._new_wal()
        db._load_seqno_time()
        if db.icmp.user_comparator.timestamp_size:
            # full_history_ts_low never falls across reopens (RocksDB
            # keeps it in the MANIFEST): the larger of the caller's and the
            # persisted one, so trimmed history never becomes readable.
            from toplingdb_tpu_torch.utils.config import load_latest_options

            prev = load_latest_options(dbname, env)
            if prev is not None:
                options.full_history_ts_low = max(
                    options.full_history_ts_low, prev.full_history_ts_low)
        db._persist_options()
        db._delete_obsolete_files()
        db._sweep_orphan_jobs()
        db._start_space_tracking()
        from toplingdb_tpu_torch.compaction.scheduler import (
            CompactionScheduler,
        )

        db._compaction_scheduler = CompactionScheduler(db)
        db._start_stats_threads()
        db._maybe_schedule_compaction()
        if options.integrity_scrub_period_sec > 0 and not options.read_only:
            from toplingdb_tpu_torch.db.integrity import IntegrityScrubber

            db._integrity_scrubber = IntegrityScrubber(db)
            db._integrity_scrubber.start()
        if owns_shared_env:
            env.retain()
            db._owns_shared_env = True
        return db

    @staticmethod
    def _shared_store_env(env, options: Options):
        """(env, co-owned): with Options.shared_store on (the only switch;
        no environment variable), `env` wrapped in a SharedSstEnv over the
        store the spec names, so installed tables publish to the
        content-addressed store and may live as references; a local store
        root keeps its persistent cache under <root>/cache. An env that
        already publishes SSTs (a SharedSstEnv a checkpoint restore or a
        promoted follower reopens on) is used as it is and co-owned. Each
        open retains the env, each close releases it, and the last release
        closes the tier's threads."""
        from toplingdb_tpu_torch.storage import (
            SharedSstEnv,
            open_store,
            store_spec_enabled,
        )

        if hasattr(env, "publish_sst"):
            return env, hasattr(env, "retain")
        spec = options.shared_store
        if not store_spec_enabled(spec):
            return env, False
        cache_dir = None
        if isinstance(spec, str) and not spec.startswith(
                ("http://", "https://")):
            cache_dir = os.path.join(spec, "cache")
        return SharedSstEnv(env, open_store(spec, env=env),
                            cache_dir=cache_dir,
                            stats=options.statistics), True

    @staticmethod
    def _check_open_args(options: Options, write_plane: bool,
                         iter_chunk_rows: int, async_reads: bool) -> None:
        """The open-time refusals: an option the port does not run, a bad
        plane argument, a host plane without the native library."""
        refused = unported_fields(options)
        if refused:
            raise NotSupported(
                "the port's DB does not run " + "; ".join(
                    f"Options.{name} ({why})" for name, why in refused))
        if not isinstance(iter_chunk_rows, int) or iter_chunk_rows < 0:
            raise InvalidArgument(
                f"iter_chunk_rows must be an int >= 0, got "
                f"{iter_chunk_rows!r}")
        if not isinstance(async_reads, bool):
            raise InvalidArgument(
                f"async_reads must be a bool, got {async_reads!r}")
        from toplingdb_tpu_torch import native

        planes = [name for name, on in (
            ("the native write plane (write_plane=True)", write_plane),
            ("the chunked scan plane (iter_chunk_rows > 0)",
             iter_chunk_rows > 0)) if on]
        if planes and native.lib() is None:
            raise NotSupported(
                " and ".join(planes) + " needs the port's native library, "
                "which could not be built or loaded (g++ missing?)")

    def _load_seqno_time(self) -> None:
        """Load the SEQNO_TIME.json sidecar; a new DB starts a fresh
        mapping, and so does a corrupt sidecar (a counted swallow)."""
        self._seqno_time_path = os.path.join(self.dbname, "SEQNO_TIME.json")
        if not self.env.file_exists(self._seqno_time_path):
            return
        try:
            raw = self.env.read_file(self._seqno_time_path)
            self.seqno_to_time.load(json.loads(raw.decode()))
        except Exception as e:  # noqa: BLE001 - a corrupt sidecar
            _errors.swallow(reason="seqno-time-sidecar-load", exc=e)

    def _start_space_tracking(self) -> None:
        """Seed the SstFileManager with the surviving tree (recovered SSTs,
        blobs, the fresh WAL) so the budget math starts from reality, then
        start its free-space poller."""
        if self._sfm is None:
            return
        for child in self.env.get_children(self.dbname):
            ftype, _num = filename.parse_file_name(child)
            if ftype in (filename.FileType.TABLE, filename.FileType.BLOB,
                         filename.FileType.WAL):
                self._sfm.on_add_file(f"{self.dbname}/{child}")
        self._sfm.poll()
        self._sfm.start_poller()

    def _persist_options(self) -> None:
        """Write OPTIONS-NNNNNN next to the DB (RocksDB persists its options
        on every open): utils/config.persist_options, toplingdb_tpu's
        format. Older OPTIONS files become obsolete."""
        from toplingdb_tpu_torch.utils.config import persist_options

        persist_options(self)

    def _recover(self) -> None:
        self.versions.recover()
        self._materialize_cfs()
        # Replay WALs >= versions.log_number in file-number order
        # (RocksDB's DBImpl::Recover → RecoverLogFiles).
        wal_numbers = []
        for child in self.env.get_children(self.dbname):
            ftype, num = filename.parse_file_name(child)
            if ftype == filename.FileType.WAL and num >= self.versions.log_number:
                wal_numbers.append(num)
            if ftype in (filename.FileType.WAL, filename.FileType.TABLE,
                         filename.FileType.MANIFEST, filename.FileType.BLOB):
                self.versions.mark_file_number_used(num)
        max_seq = self.versions.last_sequence
        # Records of a CF dropped after they were logged find no memtable
        # in the dict and are skipped.
        mems = {cf_id: cfd.mem for cf_id, cfd in self._cfs.items()}
        for num in sorted(wal_numbers):
            path = filename.log_file_name(self.dbname, num)
            reader = LogReader(self.env.new_sequential_file(path),
                               log_number=num)
            for rec in reader.records():
                # The WAL record's own CRC vouched for `rec`; protection
                # computed here covers the replayed entries from decode
                # through memtable and flush.
                batch = WriteBatch(
                    rec, protection_bytes_per_key=self._protection)
                batch.insert_into(mems)
                end_seq = batch.sequence() + batch.count() - 1
                max_seq = max(max_seq, end_seq)
        self.versions.last_sequence = max_seq
        any_flushed = False
        for cf_id, cfd in self._cfs.items():
            if not cfd.mem.empty():
                self._flush_memtables([cfd.mem], wal_number=None,
                                      cf_id=cf_id)
                cfd.mem = self._fresh_memtable()
                self._install_super_version(cfd)
                any_flushed = True
        if any_flushed:
            # One log_number advance once every CF is durable.
            self._install_edit(
                VersionEdit(log_number=self.versions.next_file_number)
            )

    def _materialize_cfs(self) -> None:
        """Build per-CF memtable state from the recovered VersionSet and
        publish every CF's read view over it."""
        for cf_id, st in self.versions.column_families.items():
            if cf_id not in self._cfs:
                h = ColumnFamilyHandle(cf_id, st.name)
                self._cfs[cf_id] = _CFData(h, self.icmp,
                                           self.options.memtable_rep,
                                           protection_bytes=self._protection)
        for cfd in self._cfs.values():
            self._install_super_version(cfd)

    def _fresh_memtable(self) -> MemTable:
        return MemTable(self.icmp,
                        create_memtable_rep(self.options.memtable_rep),
                        protection_bytes=self._protection)

    def _start_wal_ring(self, env) -> None:
        """With Options.enable_async_wal, the WAL's writer thread: WAL
        durability leaves the commit critical section and concurrent
        leaders' syncs coalesce into shared fsyncs. `env`'s
        `wal_writer_fault` attribute, if any, is the ring's fault hook."""
        opts = self.options
        if not (opts.enable_async_wal and opts.wal_enabled):
            return
        stats = opts.statistics
        self._wal_ring = AsyncIORing(
            capacity=opts.async_wal_ring_size,
            coalesce_cb=(
                (lambda n: stats.record_tick(
                    _st.WRITE_GROUP_FSYNCS_COALESCED, n))
                if stats is not None else None),
            fault_hook=getattr(env, "wal_writer_fault", None),
            name="tpt-wal-writer")

    def _new_wal(self) -> None:
        """A new WAL: a pooled obsolete WAL renamed and overwritten in
        place when `recycle_log_file_num` > 0 (RocksDB's WAL recycling),
        else a new file."""
        self._wal_number = self.versions.new_file_number()
        path = filename.log_file_name(self.dbname, self._wal_number)
        recycle_on = self.options.recycle_log_file_num > 0
        if recycle_on and self._recycle_wals:
            old_num = self._recycle_wals.pop(0)
            old_path = filename.log_file_name(self.dbname, old_num)
            w = self.env.reuse_writable_file(old_path, path)
            if self._sfm is not None:
                self._sfm.on_delete_file(old_path)  # renamed onto `path`
        else:
            w = self.env.new_writable_file(path)
        if self._wal_ring is not None:
            w = AsyncWritableFile(w, self._wal_ring)
        # recycle_log_file_num > 0: ALWAYS the recyclable record format, so
        # any WAL written from now on is safe to reuse later.
        self._wal = LogWriter(w, log_number=self._wal_number,
                              recycled=recycle_on)
        if recycle_on:
            self._recyclable_written.add(self._wal_number)
        if self._sfm is not None:
            self._sfm.on_add_file(path, 0)  # grows; resized at the switch

    def close(self) -> None:
        """Stop the background compactions (joining their threads), flush
        the memtables, and close the WAL, the MANIFEST and the readers.
        The read plane's executors and reader rings are joined first."""
        self._recover_stop.set()
        for t in (self._integrity_scrubber, self._stats_dumper,
                  self._stats_dump_thread, self.slo_engine):
            if t is not None:
                t.stop()
        self._stop_read_plane()
        if self._compaction_scheduler is not None:
            self._compaction_scheduler.shutdown()
        for t in self._recover_threads:
            t.join(timeout=10.0)
        if self._sfm is not None and self._sfm_owned:
            # A private manager: join its poller and trash deleters. A
            # shared one (Options.sst_file_manager) outlives this DB and is
            # closed by whoever built it.
            self._sfm.close()
        with self._mutex:
            if self._closed:
                return
            # Drain staged (pipelined / unordered) memtable phases before
            # flushing: their entries are WAL-durable but must land in the
            # memtables for the final flush to carry them.
            while self._mt_inflight > 0:
                self._mt_cv.wait(timeout=10.0)
            if any(not c.mem.empty() or c.imm for c in self._cfs.values()):
                self.flush(FlushOptions())
            if self._wal is not None:
                self._wal.sync()
                self._wal.close()
            wbm = self.options.write_buffer_manager
            if wbm is not None and self._wbm_charged:
                wbm.free(self._wbm_charged)
                self._wbm_charged = 0
            self.seqno_to_time.append(self.versions.last_sequence,
                                      int(time.time()))
            self._save_seqno_time()
            self.versions.close()
            self.table_cache.close()
            self.blob_source.close()
            if self._wal_ring is not None:
                self._wal_ring.close()
            if self._log_file is not None:
                self._log_file.close()
            self._closed = True
        # A shared-store env DB.open retained: the last release closes the
        # tier's warm ring and persistent cache.
        if self._owns_shared_env:
            self._owns_shared_env = False
            self.env.release()
        # Thread-lifecycle check: everything spawned with owner=self must
        # be gone by now. A leak here is a bug in a stop() path above.
        ccy.registry.join_all(owner=self, timeout=5.0)
        leaked = ccy.registry.check_leaks(owner=self)
        if leaked:
            warnings.warn(f"DB.close() leaked threads: {leaked}",
                          RuntimeWarning, stacklevel=2)

    def _stop_read_plane(self) -> None:
        """Join the read plane's executors and reader rings: no ring
        thread outlives close()."""
        for attr in ("_mget_pool", "_async_pool"):
            pool = getattr(self, attr)
            if pool is not None:
                pool.shutdown(wait=True)
                setattr(self, attr, None)
        if self._read_batcher is not None:
            self._read_batcher.close()
            self._read_batcher = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- default-CF views (most callers are single-CF) ------------------

    @property
    def mem(self) -> MemTable:
        return self._cfs[0].mem

    @mem.setter
    def mem(self, m: MemTable) -> None:
        self._cfs[0].mem = m

    @property
    def imm(self) -> list:
        return self._cfs[0].imm

    @imm.setter
    def imm(self, v: list) -> None:
        self._cfs[0].imm = v

    def _cf_id(self, cf) -> int:
        if cf is None:
            return 0
        if isinstance(cf, ColumnFamilyHandle):
            return cf.id
        return int(cf)

    def _cf_data(self, cf) -> _CFData:
        cfd = self._cfs.get(self._cf_id(cf))
        if cfd is None:
            raise InvalidArgument(f"unknown column family {cf!r}")
        return cfd

    # -- column family management ---------------------------------------

    def create_column_family(self, name: str) -> ColumnFamilyHandle:
        with self._mutex:
            cf_id = self.versions.create_column_family(name)
            h = ColumnFamilyHandle(cf_id, name)
            cfd = self._cfs[cf_id] = _CFData(
                h, self.icmp, self.options.memtable_rep,
                protection_bytes=self._protection)
            self._install_super_version(cfd)
            return h

    def drop_column_family(self, handle: ColumnFamilyHandle) -> None:
        """Drop the CF: its memtables go now, and its SSTs with the
        obsolete-file pass, once no live iterator or in-flight job holds a
        version of it. The calling thread's read-chain state of the CF is
        released here (another thread's goes with that thread)."""
        with self._mutex:
            self.versions.drop_column_family(handle.id)
            self._cfs.pop(handle.id, None)
            getattr(self._nget_tl, "states", {}).pop(handle.id, None)
            self._delete_obsolete_files()

    def create_column_family_with_import(
        self, name: str, source_dir: str, metadata=None,
        move_files: bool = False,
    ) -> ColumnFamilyHandle:
        """Create a CF populated from an export_column_family directory
        (RocksDB's DB::CreateColumnFamilyWithImport)."""
        from toplingdb_tpu_torch.db.import_column_family_job import (
            import_column_family,
        )

        return import_column_family(self, name, source_dir, metadata,
                                    move_files=move_files)

    def list_column_families(self) -> list[ColumnFamilyHandle]:
        with self._mutex:
            return [cfd.handle for cfd in self._cfs.values()]

    def get_column_family(self, name: str) -> ColumnFamilyHandle | None:
        for cfd in self._cfs.values():
            if cfd.handle.name == name:
                return cfd.handle
        return None

    def cf_name(self, cf_id: int) -> str:
        cfd = self._cfs.get(cf_id)
        if cfd is not None:
            return cfd.handle.name
        st = self.versions.column_families.get(cf_id)
        return st.name if st is not None else f"cf{cf_id}"

    # ==================================================================
    # Write path
    # ==================================================================

    def _validate_ts_batch(self, batch: WriteBatch) -> None:
        """Every key entering a timestamp DB must carry its suffix
        (encode_ts_key form): one raw key would break iteration for good
        (strip_ts raises on it). DeleteRange cannot carry a timestamp and
        is refused here."""
        if getattr(batch, "_ts_checked", False):
            return
        for _cf, t, key, _val in batch.entries_cf():
            if t == dbformat.ValueType.RANGE_DELETION:
                raise InvalidArgument(
                    "DeleteRange is not supported with user-defined "
                    "timestamps")
            if t == dbformat.ValueType.LOG_DATA:
                continue
            try:
                dbformat.strip_ts(key)
            except ValueError as e:
                raise InvalidArgument(
                    f"key {key!r} lacks a timestamp suffix; this DB's "
                    f"comparator requires ts= on every write") from e
        batch._ts_checked = True

    def _ts_key(self, key: bytes, ts: int | None) -> bytes:
        """The stored key: `key` with its timestamp suffix when the
        comparator carries one (RocksDB's Put(cf, key, ts, value))."""
        if self.icmp.user_comparator.timestamp_size == 0:
            if ts is not None:
                raise InvalidArgument(
                    "timestamp given but the comparator has none "
                    "(use Options(comparator=U64_TS_BYTEWISE))")
            return key
        if ts is None:
            raise InvalidArgument(
                "this DB's comparator requires a timestamp on every write")
        return dbformat.encode_ts_key(key, ts)

    def put(self, key: bytes, value: bytes, opts: WriteOptions = _DEFAULT_WRITE,
            cf=None, ts: int | None = None) -> int:
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.put(self._ts_key(key, ts), value, cf=self._cf_id(cf))
        return self.write(b, opts)

    def delete(self, key: bytes, opts: WriteOptions = _DEFAULT_WRITE,
               cf=None, ts: int | None = None) -> int:
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.delete(self._ts_key(key, ts), cf=self._cf_id(cf))
        return self.write(b, opts)

    def single_delete(self, key: bytes, opts: WriteOptions = _DEFAULT_WRITE,
                      cf=None, ts: int | None = None) -> int:
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.single_delete(self._ts_key(key, ts), cf=self._cf_id(cf))
        return self.write(b, opts)

    def merge(self, key: bytes, value: bytes,
              opts: WriteOptions = _DEFAULT_WRITE, cf=None) -> int:
        if self.icmp.user_comparator.timestamp_size:
            raise InvalidArgument(
                "Merge is not supported with user-defined timestamps")
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.merge(key, value, cf=self._cf_id(cf))
        return self.write(b, opts)

    def delete_range(self, begin: bytes, end: bytes,
                     opts: WriteOptions = _DEFAULT_WRITE, cf=None) -> int:
        if self.icmp.user_comparator.timestamp_size:
            raise InvalidArgument(
                "DeleteRange is not supported with user-defined timestamps")
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.delete_range(begin, end, cf=self._cf_id(cf))
        return self.write(b, opts)

    def latest_sequence_number(self) -> int:
        """The newest PUBLISHED sequence (RocksDB's
        GetLatestSequenceNumber)."""
        return self.versions.last_sequence

    def write(self, batch: WriteBatch,
              opts: WriteOptions = _DEFAULT_WRITE,
              on_sequenced=None) -> int:
        """Group-commit write path (RocksDB's DBImpl::WriteImpl +
        WriteThread::JoinBatchGroup): concurrent writers queue up; the
        front writer leads, merging the queue into one WAL append + one
        fsync, then applies every batch to the memtable and publishes the
        group's last sequence at once. Returns this batch's LAST sequence
        number. `on_sequenced(first, last)`, when given, runs once the
        batch's records are in the WAL and the memtable and before its
        sequence publishes (utilities/transactions.py)."""
        if batch.is_empty():
            return self.versions.last_sequence
        self._check_open()  # fail fast before any stall sleep
        if self._protection and (self._write_plane is None
                                 or batch._pb != self._protection
                                 or batch._prot is None):
            # Materialize (caller-constructed batches, records added since
            # the last compute): one native pass BEFORE the WAL append and
            # the group merge, so the memtable-insert re-verification
            # spans the whole commit path. Otherwise defer: the write plane
            # VERIFIES a current vector or COMPUTES a stale one fused into
            # its WAL frame walk (each record hashed once), and the Python
            # group commit attaches it at the insert handoff.
            batch.ensure_protection(self._protection)
        tr = self._op_tracer
        if tr is not None:
            # The op trace records every write here, before any write
            # mode or native plane decides it.
            tr.record_write(batch.data())
        tracer = self.tracer
        root = None
        if tracer is not None and tracer.sample_every \
                and next(tracer.counter) % tracer.sample_every == 0:
            # Sampled: the full span tree for this write.
            root = tracer.start("db.write", records=batch.count(),
                                bytes=batch.data_size(),
                                sync=bool(opts.sync))
        stats = self.stats
        if stats is None and tracer is None:
            return self._write_impl(batch, opts, on_sequenced)
        t0 = time.perf_counter()
        try:
            return self._write_impl(batch, opts, on_sequenced)
        finally:
            micros = (time.perf_counter() - t0) * 1e6
            if stats is not None:
                stats.record_in_histogram(_st.DB_WRITE_MICROS, micros)
            if root is not None:
                root.finish()
            elif tracer is not None and tracer.slow_usec \
                    and micros >= tracer.slow_usec:
                tracer.note_slow("db.write", micros,
                                 records=batch.count())

    @staticmethod
    def _write_token(w: _Writer) -> int:
        return w.batch.sequence() + w.batch.count() - 1

    def _write_impl(self, batch: WriteBatch, opts: WriteOptions,
                    on_sequenced=None) -> int:
        if self.icmp.user_comparator.timestamp_size:
            self._validate_ts_batch(batch)
        self._maybe_stall_writes()
        w = _Writer(batch, opts, on_sequenced)
        with self._wq_lock:
            self._writers.append(w)
            is_leader = self._writers[0] is w
        if not is_leader:
            interrupted: BaseException | None = None
            while True:
                try:
                    w.event.wait()
                    break
                except BaseException as e:  # noqa: BLE001
                    # Async interrupt (KeyboardInterrupt) mid-wait: the queue
                    # slot MUST still resolve — abandoning it would deadlock
                    # every later writer behind a never-driven leader.
                    interrupted = e
            if w.parallel:
                # Drafted into the group's parallel memtable phase: insert
                # our own batch (GIL-free native path), then wait for the
                # leader to publish.
                interrupted = self._parallel_member(w) or interrupted
                if interrupted is not None:
                    raise interrupted
                if w.error is not None:
                    raise w.error
                return self._write_token(w)
            if w.done:
                if interrupted is not None:
                    raise interrupted
                if w.error is not None:
                    raise w.error
                return self._write_token(w)
            # Woken with done=False: promoted to lead the next group.
            self._lead_write_group(w)
            if interrupted is not None:
                raise interrupted
            return self._write_token(w)
        self._lead_write_group(w)
        return self._write_token(w)

    def _parallel_member(self, w: _Writer) -> BaseException | None:
        """Follower half of a parallel memtable phase: insert own batch,
        report to the barrier, block until the leader completes the group.
        Returns an async interrupt caught mid-wait (re-raised by write())."""
        w.event.clear()
        err: BaseException | None = None
        try:
            w.batch.insert_into(w.pg_mems)
        except BaseException as e:  # noqa: BLE001
            err = e
        w.pg.member_done(err)
        interrupted: BaseException | None = None
        while True:
            try:
                w.event.wait()
                return interrupted
            except BaseException as e:  # noqa: BLE001
                interrupted = e  # leader WILL complete us; keep the slot

    def _snapshot_group(self, leader: _Writer) -> list[_Writer]:
        # Leader + queued followers with the same WAL disposition, capped in
        # bytes so a giant group can't starve later writers' latency
        # (RocksDB's WriteThread::EnterAsBatchGroupLeader).
        with self._wq_lock:
            group = [leader]
            size = leader.batch.data_size()
            for w in self._writers[1:]:
                if w.opts.disable_wal != leader.opts.disable_wal:
                    break
                size += w.batch.data_size()
                if size > _MAX_WRITE_GROUP_BYTES:
                    break
                group.append(w)
        return group

    def _lead_write_group(self, leader: _Writer) -> None:
        group = self._snapshot_group(leader)
        if self.options.unordered_write or self.options.enable_pipelined_write:
            self._lead_write_group_staged(leader, group)
            return
        err: BaseException | None = None
        try:
            self._commit_write_group(group)
        except BaseException as e:  # propagate to the whole group
            err = e
        with self._wq_lock:
            del self._writers[: len(group)]
            nxt = self._writers[0] if self._writers else None
        for w in group:
            w.done = True
            w.error = err
            w.parallel = False
            if w is not leader:
                w.event.set()
        if nxt is not None:
            nxt.event.set()  # done=False → it takes over as leader
        if err is not None:
            raise err

    def _lead_write_group_staged(self, leader: _Writer,
                                 group: list[_Writer]) -> None:
        """Pipelined / unordered write path (RocksDB's PipelinedWriteImpl,
        db_impl_write.cc:657, and WriteImplWALOnly, :267-301): the WAL
        stage runs under _mutex, then the NEXT group's leader is woken —
        its WAL append overlaps this group's memtable inserts. Publication
        advances as an in-order low watermark over completed groups."""
        err: BaseException | None = None
        first = last = 0
        mems: dict | None = None
        wal_wait = None
        plane = None
        wal_on = (self.options.wal_enabled
                  and not group[0].opts.disable_wal)
        try:
            with self._mutex:
                self._check_open()
                if (self._bg_error is not None
                        and self._bg_error_severity >= Severity.HARD_ERROR):
                    raise IOError_(
                        f"background error pending (call resume()): "
                        f"{self._bg_error!r}")
                first = max(self._seq_alloc,
                            self.versions.last_sequence) + 1
                seq = first
                for w in group:
                    w.batch.set_sequence(seq)
                    seq += w.batch.count()
                last = seq - 1
                mems = {cf_id: cfd.mem for cf_id, cfd in self._cfs.items()}
                if wal_on:
                    # The native plane frames and appends the merged record
                    # here; its insert half runs OUTSIDE _mutex below,
                    # exactly like the Python interiors it replaces.
                    with _tm.span("write.wal_frame", group=len(group),
                                  staged=True):
                        plane = self._native_group_commit(group, first,
                                                          mems, frame=True)
                        wal_wait = (plane[0] if plane is not None
                                    else self._append_group_wal(group,
                                                                first))
                self._seq_alloc = last
                entry = [first, last, False]
                self._alloc_ranges.append(entry)
                self._alloc_entry[first] = entry
                self._mt_inflight += 1
        except BaseException as e:  # noqa: BLE001
            err = e
        # Hand the queue to the next leader NOW (the overlap window).
        with self._wq_lock:
            del self._writers[: len(group)]
            nxt = self._writers[0] if self._writers else None
        if nxt is not None:
            nxt.event.set()
        if err is not None:
            for w in group:
                w.done = True
                w.error = err
                if w is not leader:
                    w.event.set()
            raise err
        # Memtable phase. The native plane applies the WHOLE group in one
        # GIL-released call; otherwise unordered mode always fans out
        # (each writer inserts its own batch, in parallel through the
        # GIL-free native inserts) and pipelined-only mode fans out when
        # allowed.
        native_used = False
        _msp = _tm.span("write.memtable_apply", group=len(group),
                        staged=True)
        if plane is not None:
            try:
                plane[1]()
                native_used = True
            except BaseException as e:  # noqa: BLE001
                err = e
                native_used = True  # nothing inserted, but don't re-run
        elif not wal_on:
            try:
                native_used = self._native_group_commit(
                    group, first, mems, frame=False) is not None
            except BaseException as e:  # noqa: BLE001
                err = e
                native_used = True  # nothing inserted, but don't re-run
        if not native_used and err is None:
            try:
                self._apply_group(group, mems, fan_out=(
                    self.options.unordered_write
                    or self.options.allow_concurrent_memtable_write))
            except BaseException as e:  # noqa: BLE001
                err = e
        _msp.finish()
        if wal_wait is not None:
            # Async WAL: the durability barrier overlapped the memtable
            # phase; settle it before completion so a failed group never
            # acknowledges.
            sync_point("DBImpl::GroupCommit:BeforeWALBarrier")
            _fsp = _tm.span("write.fsync_barrier", staged=True)
            try:
                wal_wait()
            except BaseException as e:  # noqa: BLE001
                if err is None:
                    err = e
            finally:
                _fsp.finish()
        self._tick_write_group(group, native_used and err is None)
        self._complete_staged_group(group, first, last, err)
        if err is not None:
            raise err

    def _complete_staged_group(self, group: list[_Writer], first: int,
                               last: int, err: BaseException | None) -> None:
        """Mark one staged group's memtable phase complete, advance the
        publish watermark in allocation order, and run the post-commit work
        (stats, flush trigger). The group is marked complete even on
        error — its records are durable in the WAL, and stalling the
        watermark would deadlock every later write."""
        with self._mutex:
            self._mt_inflight -= 1
            if err is None:
                for w in group:
                    if w.on_sequenced is not None:
                        s0 = w.batch.sequence()
                        w.on_sequenced(s0, s0 + w.batch.count() - 1)
            entry = self._alloc_entry.pop(first, None)
            if entry is not None:
                entry[2] = True
            ranges = self._alloc_ranges
            while ranges and ranges[0][2]:
                # In-order publish watermark: O(1) per completed group.
                self.versions.last_sequence = ranges.popleft()[1]
            if not self._closed:
                self._post_publish_work(group)
            self._mt_cv.notify_all()
        for w in group:
            w.done = True
            w.error = err
            w.parallel = False
            if w is not group[0]:
                w.event.set()

    def _maybe_sample_seqno_time(self, seq: int) -> None:
        """Record (seq, now) once the sampling period has elapsed (period 0
        = manual only), on every publishing path. Persisting happens off
        the write hot path (flush, close)."""
        period = self.options.seqno_time_sample_period_sec
        if period <= 0:
            return
        now = time.time()
        if now - self._last_seqno_time_sample >= period:
            self._last_seqno_time_sample = now
            self.seqno_to_time.append(seq, int(now))
            self._seqno_time_dirty = True

    def _save_seqno_time(self) -> None:
        """Best-effort persistence of the seqno <-> time mapping as the
        SEQNO_TIME.json sidecar (toplingdb_tpu's; RocksDB rides the
        MANIFEST and the SST properties)."""
        if self._seqno_time_path is None:
            return
        self._seqno_time_dirty = False
        try:
            self.env.write_file(
                self._seqno_time_path,
                json.dumps(self.seqno_to_time.to_list()).encode())
        except Exception as e:  # noqa: BLE001 - best effort, counted
            _errors.swallow(reason="seqno-time-sidecar-save", exc=e,
                            stats=self.stats)

    def _post_publish_work(self, group: list[_Writer]) -> None:
        """Stats, seqno-time sampling and the flush trigger after a staged
        group's publish (caller holds _mutex)."""
        self._maybe_sample_seqno_time(self.versions.last_sequence)
        if self.stats is not None:
            self.stats.record_tick(
                _st.NUMBER_KEYS_WRITTEN, sum(w.batch.count() for w in group))
            self.stats.record_tick(
                _st.BYTES_WRITTEN, sum(w.batch.data_size() for w in group))
        self._maybe_flush_on_memory()

    def _maybe_flush_on_memory(self) -> None:
        """The flush trigger of both commit paths (caller holds _mutex):
        the write buffer budget covers every CF's active memtable; a
        shared WriteBufferManager over its budget also flushes, above a
        4096-byte floor so a tiny DB does not thrash."""
        total_mem = sum(c.mem.approximate_memory_usage()
                        for c in self._cfs.values())
        wbm = self.options.write_buffer_manager
        self._sync_wbm()
        if total_mem >= self.options.write_buffer_size or (
                wbm is not None and wbm.should_flush()
                and total_mem >= 4096):
            self._switch_memtable()
            self._flush_immutables()

    def _sync_wbm(self) -> None:
        """Reconcile this DB's memtable memory with the shared
        WriteBufferManager (RocksDB's WriteBufferManager charging): called
        wherever memtable memory changes (writes AND flushes)."""
        wbm = self.options.write_buffer_manager
        if wbm is None:
            return
        total = sum(
            c.mem.approximate_memory_usage()
            + sum(m.approximate_memory_usage() for m in c.imm)
            for c in self._cfs.values()
        )
        delta = total - self._wbm_charged
        if delta > 0:
            wbm.reserve(delta)
        elif delta < 0:
            wbm.free(-delta)
        self._wbm_charged = total

    def _append_group_wal(self, group: list[_Writer], first_seq: int):
        """WAL append for one group through the Python encoder (caller
        holds _mutex): one record, the merged batch of every member.
        Returns the durability barrier of _group_wal_durability."""
        if len(group) == 1:
            rec = group[0].batch.data()
        else:
            merged = WriteBatch()
            merged.set_sequence(first_seq)
            for w in group:
                merged.append_from(w.batch)
            rec = merged.data()
        self._wal.add_record(rec)
        return self._group_wal_durability(group, len(rec))

    def _group_wal_durability(self, group: list[_Writer], rec_len: int):
        """The durability tail of both WAL encoders (the Python merge and
        the native plane): stats ticks, then the sync or flush. With the
        async WAL writer, returns a callable that waits on the ring's
        barrier: WAL durability leaves the _mutex critical section and
        overlaps the memtable phase, and concurrent leaders' sync
        barriers coalesce into shared fsyncs on the writer thread.
        Without it, settles inline (durability before insert) and
        returns None."""
        stats = self.stats
        if stats is not None:
            stats.record_tick(_st.WAL_BYTES, rec_len)
            stats.record_tick(_st.WRITE_WITH_WAL, len(group))
        if _st.perf_level:
            _st.perf_context().wal_write_bytes += rec_len
        want_sync = any(w.opts.sync for w in group)
        if self._wal_ring is not None:
            _sp = _tm.current_span()
            if _sp is not None:
                # Ring depth AT ENQUEUE: how backed up the async WAL
                # writer was when this group's barrier was submitted.
                _sp.tag(wal_ring_depth=len(self._wal_ring._q),
                        want_sync=want_sync)
            wfile = self._wal._f  # the AsyncWritableFile
            tok = wfile.sync_async() if want_sync else wfile.append_barrier()

            def wait(tok=tok, want_sync=want_sync, stats=stats):
                t0 = time.perf_counter() if (want_sync
                                             and stats is not None) else 0
                try:
                    tok.wait()
                except BaseException as e:  # noqa: BLE001
                    # The memtable phase already ran: latch a HARD error so
                    # writes stop until resume() (RocksDB's ErrorHandler
                    # on a WAL write failure).
                    self._set_background_error(e, reason="wal")
                    raise
                if want_sync and stats is not None:
                    stats.record_tick(_st.WAL_SYNCS)
                    stats.record_in_histogram(
                        _st.WAL_FILE_SYNC_MICROS,
                        (time.perf_counter() - t0) * 1e6)

            return wait
        if want_sync:
            t_sync = time.perf_counter() if stats is not None else 0
            self._wal.sync()
            if stats is not None:
                stats.record_tick(_st.WAL_SYNCS)
                stats.record_in_histogram(
                    _st.WAL_FILE_SYNC_MICROS,
                    (time.perf_counter() - t_sync) * 1e6)
        else:
            self._wal.flush()
        return None

    # -- the fused native write plane -----------------------------------

    def _native_group_commit(self, group: list[_Writer], first_seq: int,
                             mems, frame: bool):
        """The fused native write plane for one group
        (tpulsm_wb_group_commit): the frame call re-sequences the merged
        header, frames the WAL record gather-style (no Python append_from
        copy, no Python crc framing) and re-hashes carried protection in
        the same validation pass; the insert call applies every record to
        the skiplist with consecutive seqnos, GIL-free.

        frame=True (caller holds _mutex, WAL on): frames, appends and
        starts durability, returning (wal_wait_or_None, insert_fn): the
        caller runs insert_fn() as the memtable phase (outside _mutex in
        the staged modes; the insert skips re-validation because the frame
        call just proved these exact buffers) and then wal_wait(), the
        async WAL's barrier. frame=False (WAL off for this group):
        validates and inserts in ONE call and returns (None, None).
        Returns None on fallback, with nothing framed or inserted: the
        Python interiors take CF-prefixed records, range deletes,
        wide-column entities, merge-heavy groups, non-native reps and a
        group mixing current and stale protection. Raises Corruption, with
        NOTHING framed or inserted, on a protection mismatch.
        `mems` is {cf_id: active memtable}; only the default CF's is
        written here."""
        fn = self._write_plane
        if fn is None:
            return None
        mem = mems.get(0)
        gh = mem.group_handle() if mem is not None else None
        if gh is None:
            return None
        pb = self._protection
        reps = []
        prot_vecs = [] if pb else None
        total = 0
        n_stale = 0
        for w in group:
            b = w.batch
            if (not b._simple or b._has_wide
                    or (b._n_merge and b._n_merge * 2 > b._count)):
                return None  # fallback matrix: the Python path decides
            if pb:
                if b._prot is None or b._pb != pb:
                    return None
                if b._prot_n != b._count:
                    n_stale += 1
                else:
                    prot_vecs.append(b._prot)
            reps.append(b.data())
            total += b._count
        if total == 0:
            return None
        # Protection: every member current -> VERIFY the carried vectors;
        # every member stale (DB.write's deferral) -> FILL them fused with
        # the frame walk; a mixed group falls back (each member keeps its
        # own verification point).
        fill = n_stale == len(group) if pb and n_stale else False
        if pb and n_stale and not fill:
            return None
        import ctypes

        n = len(reps)
        rep_arr = (ctypes.c_char_p * n)(*reps)
        len_arr = (ctypes.c_int64 * n)(*[len(r) for r in reps])
        prot_ptr = None
        n_prots = 0
        # `keep` holds every buffer prot_ptr points into for as long as the
        # closures below can run (the insert call outlives this frame).
        keep = None
        if pb:
            if fill:
                prot_ptr = keep = (ctypes.c_uint64 * total)()
                n_prots = total
            else:
                base = getattr(prot_vecs[0], "base", None) if n == 1 \
                    else None
                if isinstance(base, ctypes.Array) and len(base) == total:
                    # _native_protect's buffer: no data_as crossing.
                    prot_ptr = keep = base
                    n_prots = total
                else:
                    import numpy as np

                    keep = (np.ascontiguousarray(prot_vecs[0],
                                                 dtype=np.uint64)
                            if n == 1 else np.concatenate(
                                [np.asarray(p, dtype=np.uint64)
                                 for p in prot_vecs]))
                    prot_ptr = keep.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint64))
                    n_prots = len(keep)
        # out[0..4]: framed bytes / new block offset / memtable byte delta
        # / delete count / merged record length; out[5..7]: the native
        # interior's timings in ns (validate / WAL frame / memtable insert)
        # for the span tracer.
        out = (ctypes.c_int64 * 8)()

        def run(mode, block_off=0, log_no=-1, wal_ptr=None, cap=0,
                _keep=keep):
            rc = fn(gh[0], gh[1], rep_arr, len_arr, n, first_seq, prot_ptr,
                    n_prots, pb, mode, block_off, log_no, wal_ptr, cap, out)
            if rc <= -5:
                raise Corruption(
                    f"write batch protection mismatch at record "
                    f"{-(rc + 5)} during group commit"
                )
            return rc

        def adopt_filled():
            # Hand the fused-computed vectors back to the batches (the
            # zero-copy shape _native_protect produces), so the memtable
            # carry and any later verify see them.
            import numpy as np

            vec = np.frombuffer(prot_ptr, dtype=np.uint64)
            off = 0
            for w in group:
                c = w.batch._count
                w.batch._prot = vec if n == 1 else vec[off:off + c]
                w.batch._prot_n = c
                off += c

        def insert(validated=True):
            rc = run(2 | (4 if validated else 8 if fill else 0))
            if rc < 0:  # only reachable from the unvalidated single call
                return None
            if out[7]:
                _tm.span_event("native.memtable_insert", out[7] // 1000,
                               records=total)
            if fill and not validated:
                adopt_filled()
            seq = first_seq
            meta = []
            for w, rep in zip(group, reps):
                meta.append((seq, rep, w.batch._prot if pb else None))
                seq += w.batch._count
            mem.note_group_applied(meta, int(out[2]), int(out[3]), rc)
            return rc

        if not frame:
            return (None, None) if insert(validated=False) is not None \
                else None
        block_off, log_no = self._wal.framing_state()
        merged_len = 12 + sum(len(r) - 12 for r in reps)
        # Tight framed bound: one 7/11B header per fragment + <=10B of
        # block-tail padding (a fragment spans at most BLOCK-hdr bytes).
        cap = merged_len + 11 * (merged_len // 32757 + 2) + 16
        wal_buf = bytearray(cap)
        wal_ptr = (ctypes.c_ubyte * cap).from_buffer(wal_buf)
        rc = run(1 | (8 if fill else 0), block_off, log_no, wal_ptr, cap)
        del wal_ptr  # release the bytearray's buffer export
        if rc < 0:
            return None  # -2/-4: the Python path decides (and names) it
        if out[5]:
            _tm.span_event("native.wal_validate", out[5] // 1000,
                           records=rc)
        if out[6]:
            _tm.span_event("native.wal_frame", out[6] // 1000,
                           bytes=int(out[0]))
        if fill:
            adopt_filled()
        self._wal.append_preframed(memoryview(wal_buf)[:int(out[0])],
                                   int(out[1]))
        return (self._group_wal_durability(group, int(out[4])), insert)

    def _tick_write_group(self, group: list[_Writer], native: bool) -> None:
        """WRITE_GROUP_* observability for one committed group."""
        stats = self.stats
        if stats is None:
            return
        stats.record_ticks((
            (_st.WRITE_GROUP_LED, 1),
            (_st.WRITE_GROUP_FOLLOWERS, len(group) - 1),
            (_st.WRITE_GROUP_NATIVE_COMMITS if native
             else _st.WRITE_GROUP_FALLBACKS, 1),
        ))
        stats.record_in_histogram(
            _st.WRITE_GROUP_BYTES,
            sum(w.batch.data_size() for w in group))

    def _commit_write_group(self, group: list[_Writer]) -> None:
        with self._mutex:
            self._check_open()
            if (self._bg_error is not None
                    and self._bg_error_severity >= Severity.HARD_ERROR):
                raise IOError_(
                    f"background error pending (call resume()): "
                    f"{self._bg_error!r}")
            first_seq = max(self._seq_alloc,
                            self.versions.last_sequence) + 1
            seq = first_seq
            for w in group:
                w.batch.set_sequence(seq)
                seq += w.batch.count()
            self._seq_alloc = seq - 1
            mems = {cf_id: cfd.mem for cf_id, cfd in self._cfs.items()}
            # The native plane frames and appends the merged WAL record
            # first (a WAL failure inserts nothing, as on the Python path),
            # then applies the whole group to the memtable in one call.
            wal_on = (self.options.wal_enabled
                      and not group[0].opts.disable_wal)
            wal_wait = None
            with _tm.span("write.wal_frame", group=len(group), wal=wal_on):
                plane = self._native_group_commit(group, first_seq, mems,
                                                  frame=wal_on)
                if plane is None and wal_on:
                    wal_wait = self._append_group_wal(group, first_seq)
            _mt0 = time.perf_counter() if _st.perf_level >= 2 else 0.0
            if plane is None:
                with _tm.span("write.memtable_apply", group=len(group),
                              native=False):
                    self._apply_group(group, mems)
            else:
                wal_wait, insert_fn = plane
                if insert_fn is not None:
                    with _tm.span("write.memtable_apply", group=len(group),
                                  native=True):
                        insert_fn()
            if _mt0:
                _st.perf_context().write_memtable_time += int(
                    (time.perf_counter() - _mt0) * 1e9)
            self._tick_write_group(group, native=plane is not None)
            if wal_wait is not None:
                # Async WAL: durability overlapped the inserts (the
                # Python encoder's and the native plane's alike).
                sync_point("DBImpl::GroupCommit:BeforeWALBarrier")
                with _tm.span("write.fsync_barrier"):
                    wal_wait()
            # on_sequenced fires only after the WAL append and the memtable
            # insert succeeded (a failed group leaks no registration), and
            # BEFORE the group's sequence publishes: the entries stay
            # invisible (seq > last_sequence) until the registration
            # exists.
            for w in group:
                if w.on_sequenced is not None:
                    s0 = w.batch.sequence()
                    w.on_sequenced(s0, s0 + w.batch.count() - 1)
            self.versions.last_sequence = seq - 1
            self._maybe_sample_seqno_time(seq - 1)
            if self.stats is not None:
                bw = sum(w.batch.data_size() for w in group)
                self.stats.record_tick(
                    _st.NUMBER_KEYS_WRITTEN,
                    sum(w.batch.count() for w in group))
                self.stats.record_tick(_st.BYTES_WRITTEN, bw)
                self.stats.record_in_histogram(_st.BYTES_PER_WRITE, bw)
                self.stats.record_tick(_st.WRITE_DONE_BY_SELF)
                if len(group) > 1:
                    self.stats.record_tick(_st.WRITE_DONE_BY_OTHER,
                                           len(group) - 1)
            self._maybe_flush_on_memory()

    def _apply_group(self, group: list[_Writer], mems,
                     fan_out: bool | None = None) -> None:
        """The group's memtable phase into `mems` ({cf_id: memtable}; the
        caller holds _mutex, or a staged group's in-flight count, so no
        memtable switch can race it). `fan_out` (default:
        allow_concurrent_memtable_write) lets each writer insert its own
        batch."""
        if fan_out is None:
            fan_out = self.options.allow_concurrent_memtable_write
        if fan_out and len(group) > 1:
            # Parallel memtable phase (RocksDB's
            # LaunchParallelMemTableWriters): followers insert their own
            # batches concurrently — the native skiplist insert is
            # lock-free and GIL-releasing, so this scales with threads.
            pg = _InsertBarrier(len(group))
            for w in group[1:]:
                w.pg = pg
                w.pg_mems = mems
                w.parallel = True
                w.event.set()
            try:
                group[0].batch.insert_into(mems)
                pg.member_done()
            except BaseException as e:  # noqa: BLE001
                pg.member_done(e)
            pg.all_done.wait()
            for w in group[1:]:
                w.parallel = False
            if pg.error is not None:
                raise pg.error
        else:
            for w in group:
                w.batch.insert_into(mems)

    def _switch_memtable(self) -> None:
        """Seal every CF's non-empty active memtable and start a new WAL
        (RocksDB's DBImpl::SwitchMemtable; switching all CFs at once lets
        the log number advance safely)."""
        # Staged groups insert into the active memtables OUTSIDE _mutex
        # (pipelined / unordered modes): sealing a memtable mid-insert could
        # let the flush miss an already-published entry. Drain them first
        # (RocksDB's WriteThread::WaitForMemTableWriters).
        while self._mt_inflight > 0:
            self._mt_cv.wait(timeout=10.0)
        # Interleaving seam: the switch closes the current WAL, so its
        # order against a staged group's async durability barrier is the
        # drain protocol above; this point lets tests pin that order.
        sync_point("DBImpl::SwitchMemtable:Start")
        if self._wal is not None:
            self._wal.sync()
            self._wal.close()
            if self._sfm is not None:
                # The sealed WAL's final size (tracked as 0 at creation).
                self._sfm.on_add_file(filename.log_file_name(
                    self.dbname, self._wal_number))
        for cfd in self._cfs.values():
            if not cfd.mem.empty():
                cfd.imm.insert(0, cfd.mem)
                cfd.mem = self._fresh_memtable()
                self._install_super_version(cfd)
        self._new_wal()

    def _install_super_version(self, cfd: _CFData) -> None:
        """Publish `cfd`'s read view from its memtables and its current
        Version. The caller holds _mutex (or is opening the DB, before
        any reader): every switch, install and catch-up publishes, so a
        read takes `cfd.sv` as it stands, without the mutex."""
        cfd.sv = _SuperVersion(
            cfd.mem, cfd.imm, self.versions.cf_current(cfd.handle.id))

    def _install_edit(self, edit: VersionEdit) -> None:
        """Log and install `edit` (VersionSet.log_and_apply) and publish
        its CF's new read view, so the view never pins the old Version's
        files. The caller holds _mutex."""
        self.versions.log_and_apply(edit)
        cfd = self._cfs.get(edit.column_family)
        if cfd is not None:
            self._install_super_version(cfd)

    def _flush_immutables(self) -> None:
        flushed = False
        for cf_id, cfd in self._cfs.items():
            if not cfd.imm:
                continue
            self._flush_memtables(list(cfd.imm), wal_number=None,
                                  cf_id=cf_id)
            flushed = True
        if flushed:
            # Advance log_number only after EVERY CF's data below the
            # current WAL is durable in SSTs: a crash mid-flush must still
            # replay the old WALs for the CFs not yet flushed.
            self._install_edit(VersionEdit(log_number=self._wal_number))
            self._delete_obsolete_files()
            self._maybe_schedule_compaction()
        self._sync_wbm()

    def _flush_memtables(self, mems: list[MemTable], wal_number: int | None,
                         cf_id: int = 0) -> None:
        sync_point("FlushJob::Start")
        if self._sfm is not None:
            # Preflight: refuse to START a flush only when even the reserved
            # flush headroom cannot absorb it (flushes may spend the
            # headroom compactions leave alone, so a red-pressure DB still
            # drains its memtables). A refusal latches SOFT no_space;
            # ingest resumes when space frees.
            est = sum(m.approximate_memory_usage() for m in mems)
            if not self._sfm.check_flush(est):
                if self.stats is not None:
                    self.stats.record_tick(_st.NO_SPACE_PREFLIGHT_BLOCKS, 1)
                err = NoSpace(
                    f"flush of ~{est} bytes would breach the disk budget")
                self._set_background_error(err, reason="no_space")
                raise err
        with thread_operation("flush", f"cf{cf_id}", self.dbname):
            # Flushes are rare and high-value: always traced while a tracer
            # exists (sampling applies to the per-op read / write roots
            # only).
            root = (self.tracer.start("flush", cf_id=cf_id,
                                      memtables=len(mems))
                    if self.tracer is not None else _tm.NOOP_SPAN)
            try:
                self._flush_memtables_traced(mems, wal_number, cf_id)
            finally:
                root.finish()

    def _flush_memtables_traced(self, mems: list[MemTable],
                                wal_number: int | None, cf_id: int) -> None:
        t0 = time.time()
        if self._seqno_time_dirty:
            # Every flush path funnels here, off the write hot path:
            # persist the pending samples so a crash does not lose them.
            self._save_seqno_time()
        fnum = self.versions.new_file_number()
        blob_num = (self.versions.new_file_number()
                    if self.options.enable_blob_files else None)
        # Guard the in-flight outputs (the blob sibling too) from
        # obsolete-file GC until the version edit lands.
        self._pending_outputs.add(fnum)
        if blob_num is not None:
            self._pending_outputs.add(blob_num)
        try:
            with _tm.span("flush.build_table", file_number=fnum):
                meta = flush_memtable_to_table(
                    self.env, self.dbname, fnum, self.icmp, mems,
                    self.options.table_options_for_level(0),
                    creation_time=int(time.time()),
                    blob_file_number=blob_num,
                    min_blob_size=self.options.min_blob_size,
                    column_family=(cf_id, self.cf_name(cf_id)),
                )
            if meta is not None:
                self._stamp_file_checksums([meta])
                self.num_flushes += 1
            edit = VersionEdit(log_number=wal_number, column_family=cf_id)
            if meta is not None:
                edit.add_file(0, meta)
            with self._mutex:
                self.versions.log_and_apply(edit)
                # The install: the flushed memtables leave the view in the
                # same step as their L0 file enters it.
                cfd = self._cfs.get(cf_id)
                if cfd is not None:
                    cfd.imm = [m for m in cfd.imm
                               if not any(m is f for f in mems)]
                    self._install_super_version(cfd)
                sync_point("FlushJob::InstallResults")
        finally:
            self._pending_outputs.discard(fnum)
            if blob_num is not None:
                self._pending_outputs.discard(blob_num)
        if meta is not None and self._sfm is not None:
            self._sfm.on_add_file(
                filename.table_file_name(self.dbname, meta.number),
                meta.file_size)
            if blob_num is not None:
                bpath = blob_file_name(self.dbname, blob_num)
                if self.env.file_exists(bpath):
                    self._sfm.on_add_file(bpath)
        if meta is not None:
            from toplingdb_tpu_torch.utils.listener import FlushJobInfo

            if self.stats is not None:
                self.stats.record_tick(_st.FLUSH_WRITE_BYTES, meta.file_size)
                self.stats.record_in_histogram(
                    _st.FLUSH_TIME_MICROS, (time.time() - t0) * 1e6)
            self.event_logger.log(
                "flush_finished", file_number=meta.number,
                file_size=meta.file_size, num_entries=meta.num_entries,
            )
            notify(self.options.listeners, "on_flush_completed", self,
                   FlushJobInfo(
                       db_name=self.dbname, file_number=meta.number,
                       file_size=meta.file_size, num_entries=meta.num_entries,
                       smallest_seqno=meta.smallest_seqno,
                       largest_seqno=meta.largest_seqno,
                   ))

    def flush(self, fopts: FlushOptions = FlushOptions()) -> None:
        """Write the active memtable (and any sealed ones) to L0 SSTs; the
        flush is synchronous, so `fopts.wait` is always honoured."""
        with self._mutex:
            self._check_open()
            if any(not c.mem.empty() for c in self._cfs.values()):
                self._switch_memtable()
            self._flush_immutables()
        if self._seqno_time_dirty:
            self._save_seqno_time()  # outside _mutex: best-effort IO

    def _stamp_file_checksums(self, metas) -> None:
        """Record whole-file checksums on freshly produced SST metadata
        before it reaches the MANIFEST (flush, compaction install, ingest,
        import). On a shared-store env each table is also published to
        the content-addressed store under its checksum address."""
        factory = self._file_checksum_factory
        if factory is None:
            return
        from toplingdb_tpu_torch.utils.file_checksum import (
            stamp_file_checksum,
        )

        publish = getattr(self.env, "publish_sst", None)
        for meta in metas:
            path = filename.table_file_name(self.dbname, meta.number)
            stamp_file_checksum(self.env, path, meta, factory)
            if publish is not None:
                # Idempotent: an address already in the store (an adopted
                # dcompact output) is a contains() probe.
                try:
                    publish(path, meta)
                except Exception as e:  # noqa: BLE001 - a store outage
                    # The install stays valid on its local bytes; a later
                    # checkpoint or dcompact job publishes it again.
                    _errors.swallow(reason="install-publish-sst", exc=e,
                                    stats=self.stats)

    # ==================================================================
    # Read path
    # ==================================================================

    # -- the op trace (RocksDB's DB::StartTrace / EndTrace) --------------

    def start_trace(self, trace_path: str, options=None) -> None:
        """Record every later get, multi_get, write and iterator seek to
        `trace_path` until end_trace (RocksDB's DB::StartTrace,
        trace_replay/trace_replay.cc), in toplingdb_tpu's trace format.
        Replay with utils.trace.Replayer, analyze with
        tools/trace_analyzer.py. `options`: a utils.trace.TraceOptions."""
        from toplingdb_tpu_torch.utils.trace import OpTracer

        self._check_open()
        if self._op_tracer is not None:
            raise InvalidArgument("a trace is already being recorded")
        self._op_tracer = OpTracer(self.env, trace_path, options)

    def end_trace(self) -> None:
        tr = self._op_tracer
        self._op_tracer = None
        if tr is not None:
            tr.close()

    def _nget_state(self, cfd, opts, sv: _SuperVersion):
        """The native chain's eligibility gate and this thread's call
        state for CF `cfd` over the read view `sv`: (lib, state), state
        None when the Python chain must run. The state is PER-THREAD (the
        context's out and value buffers are written inside a GIL-released
        call), one per CF, and keyed by the identity of the view; it holds
        a ref to it, so a new view makes the next get rebuild the state
        while the old handles live on with the old one."""
        lib = self._nget_lib
        if (lib is None or opts.just_check_key_exists
                or self._excluded_for(opts)):
            return lib, None
        if sv.mem._range_dels:
            # The ACTIVE memtable mutates under a cached state, so this
            # check runs per call; immutables are frozen and are vetted
            # once, when the state is built.
            return lib, None
        tl = self._nget_tl
        try:
            states = tl.states
        except AttributeError:
            states = tl.states = {}
        cc = states.get(cfd.handle.id)
        if cc is not None and cc.sv is sv:
            return lib, cc
        if any(m._range_dels for m in sv.imm):
            return lib, None
        cc = _NGetState.build(lib, sv, self.table_cache)
        if cc is None:
            return lib, None
        states[cfd.handle.id] = cc
        return lib, cc

    def _native_get(self, cfd, key: bytes, snap_seq: int, opts,
                    sv: _SuperVersion | None = None):
        """One-call native point lookup (RocksDB's GetImpl chain in one
        GIL-released call: DBImpl::GetImpl → Version::Get →
        BlockBasedTable::Get) over the read view `sv` (the CF's current
        one when None). Returns (handled, value, src): handled=False → run
        the Python chain (ineligible, or the native walk met something
        only the Python state machine handles). The value and the counters
        are read from context-owned memory mapped once."""
        # Inlined steady-state check (one cached-state hit per get is the
        # common case; _nget_state handles every slow or ineligible path).
        if sv is None:
            sv = cfd.sv
        cc = None
        if (opts is _DEFAULT_READ and not sv.mem._range_dels
                and self._undecided_provider is None):
            states = getattr(self._nget_tl, "states", None)
            if states is not None:
                cc = states.get(cfd.handle.id)
                if cc is not None and cc.sv is not sv:
                    cc = None
        if cc is None:
            _lib, cc = self._nget_state(cfd, opts, sv)
            if cc is None:
                return False, None, None
        fast = cc.fast
        if fast is not None:
            r = fast(cc.ctx, key, snap_seq)
            if r is False:
                return False, None, None
            rc = 0 if r is None else 1
        else:
            rc = cc.fn(cc.ctx, key, len(key), snap_seq)
            if rc == 2 or rc < 0:
                return False, None, None
        out = cc.out
        if _st.perf_level:
            pctx = _st.perf_context()
            pctx.get_from_memtable_count += out[2]
            pctx.bloom_sst_miss_count += out[3]
            pctx.bloom_sst_hit_count += out[4]
            pctx.block_cache_hit_count += out[5]
            pctx.block_read_count += out[6]
            pctx.block_read_byte += out[7]
        if self.stats is not None and (out[3] or out[5] or out[6]):
            # The chain's own block cache feeds BLOCK_CACHE_*, as in
            # toplingdb_tpu's native get.
            self.stats.record_ticks(
                (t, c) for t, c in ((_st.BLOOM_USEFUL, out[3]),
                                    (_st.BLOCK_CACHE_HIT, out[5]),
                                    (_st.BLOCK_CACHE_MISS, out[6])) if c)
        src = out[1]
        src = "mem" if src == 0 else (src - 1 if src >= 1 else None)
        if rc == 1:
            if fast is not None:
                return True, r, src  # the extension already built bytes
            vlen = out[0]
            if vlen > cc.val_cap:  # the context grew its buffer: re-map
                cc.remap(cc._lib, vlen)
            import ctypes

            return True, ctypes.string_at(cc.val_ptr, vlen), src
        return True, None, src

    def _probe_memtable(self, mem, key: bytes, snap_seq: int,
                        ctx: GetContext) -> bool:
        """One memtable source; returns False when the lookup is complete."""
        if _st.perf_level:
            _st.perf_context().get_from_memtable_count += 1
        ctx.add_tombstone_seq(mem.covering_tombstone_seq(key, snap_seq))
        for seq, t, val in mem.entries_for_key(key, snap_seq):
            if not ctx.save_value(seq, t, val):
                return False
        return True

    def _probe_file(self, reader, key: bytes, snap_seq: int,
                    ctx: GetContext, tombs, it=None,
                    preread=None) -> tuple[bool, object]:
        """One SST source. `tombs` is the file's parsed RangeTombstone
        list; `it` a reusable iterator of this reader (made on demand).
        `preread`: the async read plane's overlay (a block table's
        PrereadSpans or a zip table's value-group preload), only ever
        given for readers whose new_iterator takes it. Returns (continue?,
        iterator): continue is False when the lookup is complete."""
        ucmp = self.icmp.user_comparator
        for t in tombs:
            if ucmp.compare(t.begin, key) <= 0 and ucmp.compare(key, t.end) < 0:
                ctx.add_tombstone_seq(t.seq)
        has_filter = (getattr(reader, "_filter_data", None) is not None
                      or getattr(reader, "_filter_top", None) is not None)
        if not reader.key_may_match(key):
            if self.stats is not None:
                self.stats.record_tick(_st.BLOOM_USEFUL)
            if _st.perf_level:
                _st.perf_context().bloom_sst_miss_count += 1
            return True, it
        if has_filter and _st.perf_level:
            # Only a consulted filter counts (fail-open paths don't).
            _st.perf_context().bloom_sst_hit_count += 1
        if getattr(reader, "has_hash_index", False):
            # O(1) bucket probe (hash-indexed formats): lands on the newest
            # version; the loop below skips seqs above the snapshot.
            ordinal = reader.hash_probe(key)
            if ordinal is None:
                return True, it  # definitively absent from this file
            if it is None:
                it = reader.new_iterator()
            it.seek_ordinal(ordinal)
        else:
            if it is None:
                it = (reader.new_iterator(preread=preread)
                      if preread is not None else reader.new_iterator())
            it.seek(dbformat.make_internal_key(
                key, snap_seq, dbformat.VALUE_TYPE_FOR_SEEK
            ))
        while it.valid():
            uk, seq, t = dbformat.split_internal_key(it.key())
            if ucmp.compare(uk, key) != 0:
                break
            if seq <= snap_seq:
                if not ctx.save_value(seq, t, it.value()):
                    return False, it
            it.next()
        return True, it

    @staticmethod
    def _parsed_tombstones(reader) -> list:
        return [RangeTombstone.from_table_entry(b, e)
                for b, e in reader.range_del_entries()]

    def get(self, key: bytes, opts: ReadOptions = _DEFAULT_READ,
            cf=None) -> bytes | None:
        """Point lookup (RocksDB's DBImpl::GetImpl). Returns None if not
        found. A wide-column entity presents as its anonymous default
        column (use get_entity for every column); entities are detected by
        their dedicated value type, so a plain binary value is never
        reinterpreted, except that Options.legacy_wide_column_unwrap also
        unwraps plain values starting with the entity magic (databases
        written before the dedicated type)."""
        sched = self._trace_sched
        if sched is not None:
            m = sched()
            if m:
                return self._get_traced(key, opts, cf, m == 1)
        return self._present(*self._get_entry(key, opts, cf))

    def _get_traced(self, key: bytes, opts, cf, sampled: bool):
        """The rare half of get(): a sampled root span, or the slow-watch
        backstop when trace_slow_usec is set."""
        tracer = self.tracer
        root = tracer.start("db.get") if sampled else None
        t0 = 0.0 if sampled else time.perf_counter()
        try:
            return self._present(*self._get_entry(key, opts, cf))
        finally:
            if root is not None:
                root.finish()
            else:
                us = (time.perf_counter() - t0) * 1e6
                if us >= tracer.slow_usec:
                    tracer.note_slow("db.get", us)

    def _present(self, v: bytes | None, is_entity: bool) -> bytes | None:
        """get's presentation of a stored value: an entity's default
        column, and behind the legacy gate the magic sniff."""
        if v is None:
            return None
        if is_entity or (v[:1] == b"\x00"
                         and self.options.legacy_wide_column_unwrap):
            from toplingdb_tpu_torch.db.wide_columns import default_column_of

            return default_column_of(v)
        return v

    def _get_entry(self, key: bytes, opts: ReadOptions, cf,
                   record_trace: bool = True) -> tuple[bytes | None, bool]:
        """(stored value or None, whether it is a wide-column entity). The
        op trace records the get here, before any native chain decides
        it; multi_get's per-key fallbacks pass record_trace=False."""
        self._check_open()
        if record_trace:
            tr = self._op_tracer
            if tr is not None:
                tr.record_get(key)
        if self.icmp.user_comparator.timestamp_size:
            # The timestamp chain; the native chain stays off for such a
            # DB, as in toplingdb_tpu.
            return self._get_with_ts(key, opts, cf), False
        self._check_read_ts(opts)
        cfd = self._cf_data(cf)
        snap_seq = (
            opts.snapshot.sequence if opts.snapshot is not None
            else self.versions.last_sequence
        )
        st_on = self.stats is not None
        t0 = time.perf_counter() if st_on else 0.0
        # The native chain: memtable skiplists + SST walk in ONE
        # GIL-released call. Anything the Python state machine must see
        # (merge operands, single deletes in SSTs, blob indexes, range
        # tombstones, wide-column entities) falls through below. The async
        # read plane routes around it: it lives in the Python walk, whose
        # block fetches batch-submit through the reader rings.
        async_on = self._async_reads
        sv = cfd.sv
        if not async_on:
            handled, val, src = self._native_get(cfd, key, snap_seq, opts,
                                                 sv)
            if handled:
                if st_on:
                    self._record_get_stats(t0, val, src)
                return val, False  # the native chain hands entities back
        ctx = GetContext(key, snap_seq, self.options.merge_operator,
                         blob_resolver=self.blob_source.get,
                         excluded_ranges=self._excluded_for(opts))
        # 1. Active memtable, then immutables (newest first).
        for mem in sv.mems:
            if not self._probe_memtable(mem, key, snap_seq, ctx):
                if st_on:
                    self._record_get_stats(t0, ctx.result(), "mem")
                return ctx.result(), ctx.result_is_entity
        # 2. SST files, newest data first. Async plane: every candidate
        # file's cache-missing blocks are submitted as ONE batch before
        # the walk, so a multi-level chain overlaps its preads (deeper
        # candidates are speculative: wasted only when an upper level
        # ends the lookup first).
        version = sv.version
        preread_map = None
        if async_on:
            file_order = [f for _lvl, f in version.files_for_get(key)]
            preread_map = self._plan_async_preread(
                file_order, {f.number: [key] for f in file_order},
                {key}, snap_seq)
        hit_level = self._walk_sst_chain(version, key, snap_seq, ctx,
                                         preread_map=preread_map)
        if st_on:
            self._record_get_stats(t0, ctx.result(), hit_level)
        return ctx.result(), ctx.result_is_entity

    def _walk_sst_chain(self, version, key: bytes, snap_seq: int, ctx,
                        tombs_for=None, preread_map=None):
        """Probe the key's SST candidates newest first until the lookup
        completes (get, and multi_get's per-key walks). `preread_map`: the
        async read plane's overlays keyed by file number — the chain's
        block fetches were batch-submitted up front, so a deep walk
        consumes reads already overlapped instead of paying one serial
        pread per level. Returns the level that completed the lookup, or
        None."""
        for level, f in version.files_for_get(key):
            reader = self.table_cache.get_reader(f.number)
            tombs = (tombs_for(f) if tombs_for is not None
                     else self._parsed_tombstones(reader))
            more, _ = self._probe_file(
                reader, key, snap_seq, ctx, tombs,
                preread=(preread_map.get(f.number)
                         if preread_map is not None else None))
            if not more:
                return level
        ctx.finish()
        return None

    def _record_get_stats(self, t0: float, val, src) -> None:
        """Read-path ticker family (MEMTABLE_HIT / GET_HIT_L*, RocksDB's
        statistics.h) in one lock acquisition."""
        self.stats.record_get(
            (time.perf_counter() - t0) * 1e6,
            len(val) if val is not None else None, src)

    @staticmethod
    def _result(ctx: GetContext) -> bytes | None:
        v = ctx.result()
        if v is not None and ctx.result_is_entity:
            from toplingdb_tpu_torch.db.wide_columns import default_column_of

            return default_column_of(v)
        return v

    def key_exists(self, key: bytes,
                   opts: ReadOptions = _DEFAULT_READ) -> bool:
        return self.get(key, opts) is not None

    def put_entity(self, key: bytes, columns: dict[bytes, bytes],
                   opts: WriteOptions = _DEFAULT_WRITE, cf=None) -> None:
        """Wide-column write under the dedicated entity value type
        (RocksDB's DB::PutEntity, kTypeWideColumnEntity)."""
        from toplingdb_tpu_torch.db.wide_columns import encode_entity

        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.put_entity(self._ts_key(key, None), encode_entity(columns),
                     cf=self._cf_id(cf))
        self.write(b, opts)

    def get_entity(self, key: bytes, opts: ReadOptions = _DEFAULT_READ,
                   cf=None) -> dict[bytes, bytes] | None:
        """Wide-column read (RocksDB's DB::GetEntity); a plain value
        presents as the anonymous default column."""
        from toplingdb_tpu_torch.db.wide_columns import decode_entity

        v = self._get_raw(key, opts, cf=cf)
        return None if v is None else decode_entity(v)

    def _get_raw(self, key: bytes, opts: ReadOptions = _DEFAULT_READ,
                 cf=None) -> bytes | None:
        """Point lookup WITHOUT the default-column unwrap (get_entity needs
        the whole encoding)."""
        return self._get_entry(key, opts, cf)[0]

    def get_merge_operands(self, key: bytes,
                           opts: ReadOptions = _DEFAULT_READ,
                           cf=None) -> list[bytes]:
        """The UNMERGED chain for a key (RocksDB's DB::GetMergeOperands):
        the base value (if any) first, then merge operands oldest→newest.
        A plain key returns [value]; a missing or deleted key returns [].
        GetContext's visibility and tombstone state machine in
        collect-only mode, over the Python chain. toplingdb_tpu also
        passes the seqno ranges of undecided WritePrepared transactions;
        the port has no transactions yet, so there are none to pass."""
        self._check_open()
        self._check_read_ts(opts)
        cfd = self._cf_data(cf)
        snap_seq = (
            opts.snapshot.sequence if opts.snapshot is not None
            else self.versions.last_sequence
        )
        ctx = GetContext(key, snap_seq, None,
                         blob_resolver=self.blob_source.get,
                         collect_operands=True,
                         excluded_ranges=self._excluded_for(opts))
        sv = cfd.sv
        more = True
        for mem in sv.mems:
            if not self._probe_memtable(mem, key, snap_seq, ctx):
                more = False
                break
        if more:
            self._walk_sst_chain(sv.version, key, snap_seq, ctx)
        return ctx.merge_operand_list()

    # -- user-defined timestamps ----------------------------------------

    def _check_read_ts(self, opts: ReadOptions) -> None:
        """ReadOptions.timestamp needs a timestamp comparator, and a read
        below full_history_ts_low is InvalidArgument: that history may
        already be collapsed, so its answer would depend on which
        compactions ran."""
        if opts.timestamp is None:
            return
        if self.icmp.user_comparator.timestamp_size == 0:
            raise InvalidArgument(
                "ReadOptions.timestamp requires a timestamp-carrying "
                "comparator (U64_TS_BYTEWISE)")
        if opts.timestamp < self.options.full_history_ts_low:
            raise InvalidArgument(
                f"cannot read at ts={opts.timestamp}: history below "
                f"full_history_ts_low={self.options.full_history_ts_low} "
                f"may be collapsed")

    def _ts_lookup(self, it, key: bytes) -> tuple[bytes, int] | None:
        """Point lookup over a timestamp-aware iterator: the seek lands on
        the key's newest visible version."""
        it.seek(key)
        if it.valid() and it.key() == key:
            # Raw: the caller unwraps an entity exactly once.
            return it.raw_value(), it.timestamp()
        return None

    _TS_SLOW = object()  # the layered lookup's hand-over to the iterator

    def _ts_fast_lookup(self, key: bytes, opts: ReadOptions, cf):
        """The layered point lookup of a timestamp DB: each source (the
        memtable, the immutables, each level's overlapping files) is sought
        on its own for its newest visible version, and the candidates
        combine by (ts desc, seq desc), DBIter's order. Returns (value, ts),
        None, or _TS_SLOW when the iterator must decide (a merge operator,
        range tombstones, a merge or single delete met)."""
        if self.options.merge_operator is not None:
            return self._TS_SLOW
        if self._excluded_for(opts):
            return self._TS_SLOW  # WritePrepared visibility exclusions
        cfd = self._cf_data(cf)
        read_ts = (opts.timestamp if opts.timestamp is not None
                   else dbformat.MAX_TIMESTAMP)
        snap_seq = (
            opts.snapshot.sequence if opts.snapshot is not None
            else self.versions.last_sequence
        )
        enc_hi = dbformat.encode_ts_key(key, read_ts)  # newest visible
        enc_lo = dbformat.encode_ts_key(key, 0)        # oldest possible
        seek_ikey = dbformat.make_internal_key(
            enc_hi, snap_seq, dbformat.VALUE_TYPE_FOR_SEEK)
        esc = enc_lo[:-8]  # the escaped key and its terminator
        best = None  # (ts, seq, vtype, value)

        def probe(it) -> bool:
            """The source's newest visible version into `best`; False:
            hand over to the iterator."""
            nonlocal best
            it.seek(seek_ikey)
            while it.valid():
                uk, seq, t = dbformat.split_internal_key(it.key())
                if len(uk) != len(esc) + 8 or not uk.startswith(esc):
                    break  # past this key's versions
                if t in (dbformat.ValueType.MERGE,
                         dbformat.ValueType.SINGLE_DELETION):
                    return False
                if seq <= snap_seq:
                    cand = (dbformat.decode_ts(uk[-8:]), seq, t, it.value())
                    if best is None or cand[:2] > best[:2]:
                        best = cand
                    break  # (ts desc, seq desc): the first one wins here
                it.next()
            return True

        sv = cfd.sv
        for mem in sv.mems:
            if mem._range_dels or not probe(mem.new_iterator()):
                return self._TS_SLOW
        version = sv.version
        for level in range(version.num_levels):
            for f in version.overlapping_files(level, enc_hi, enc_lo):
                reader = self.table_cache.get_reader(f.number)
                if reader.range_del_entries() \
                        or not probe(reader.new_iterator()):
                    return self._TS_SLOW
        if best is None:
            return None
        if best[2] == dbformat.ValueType.BLOB_INDEX:
            return self.blob_source.get(best[3]), best[0]
        if best[2] != dbformat.ValueType.VALUE:
            return None
        return best[3], best[0]

    def _ts_point_lookup(self, key: bytes, opts: ReadOptions,
                         cf) -> tuple[bytes, int] | None:
        self._check_read_ts(opts)
        hit = self._ts_fast_lookup(key, opts, cf)
        if hit is not self._TS_SLOW:
            return hit
        return self._ts_lookup(self.new_iterator(opts, cf=cf), key)

    def _get_with_ts(self, key: bytes, opts: ReadOptions,
                     cf) -> bytes | None:
        """get on a timestamp DB (RocksDB's GetImpl with
        ReadOptions.timestamp)."""
        hit = self._ts_point_lookup(key, opts, cf)
        if hit is None:
            return None
        return b"" if opts.just_check_key_exists else hit[0]

    def get_with_ts(self, key: bytes, opts: ReadOptions = _DEFAULT_READ,
                    cf=None) -> tuple[bytes, int] | None:
        """(value, the version's timestamp) or None (RocksDB's
        Get(..., std::string* timestamp))."""
        self._check_open()
        return self._ts_point_lookup(key, opts, cf)

    def increase_full_history_ts_low(self, ts_low: int) -> None:
        """Raise the history trim point (RocksDB's
        DB::IncreaseFullHistoryTsLow): later compactions collapse the
        versions below it. Monotonic; needs a timestamp comparator. The
        new point is persisted (OPTIONS) before any job can trim under it,
        or rolled back."""
        if self.icmp.user_comparator.timestamp_size == 0:
            raise InvalidArgument("DB has no user-defined timestamps")
        if ts_low < self.options.full_history_ts_low:
            raise InvalidArgument(
                f"full_history_ts_low can only increase "
                f"({ts_low} < {self.options.full_history_ts_low})")
        old = self.options.full_history_ts_low
        self.options.full_history_ts_low = ts_low
        try:
            self._persist_options()
        except Exception:
            self.options.full_history_ts_low = old
            raise

    # -- multi_get and the async read plane ----------------------------

    def multi_get(self, keys: list[bytes], opts: ReadOptions = _DEFAULT_READ,
                  cf=None) -> list[bytes | None]:
        """Batched point lookups (RocksDB's DBImpl::MultiGet, and
        ToplingDB's fiber variant, db_impl.cc:3026-3227): the batch is
        grouped per source, so each memtable and file is visited once for
        all its keys. Returns one value or None per key, in order."""
        self._check_open()
        tr = self._op_tracer
        if tr is not None:
            tr.record_multiget(keys)
        self._check_read_ts(opts)
        tracer = self.tracer
        root = None
        if tracer is not None and tracer.sample_every \
                and next(tracer.counter) % tracer.sample_every == 0:
            root = tracer.start("db.multiget", keys=len(keys))
        t_mg = time.perf_counter() \
            if (self.stats is not None or tracer is not None) else 0.0
        try:
            res = self._multi_get_impl(keys, opts, cf)
        finally:
            if root is not None:
                root.finish()
            elif tracer is not None and tracer.slow_usec:
                us = (time.perf_counter() - t_mg) * 1e6
                if us >= tracer.slow_usec:
                    tracer.note_slow("db.multiget", us, keys=len(keys))
        # Entities were unwrapped per key by their typed resolution; the
        # magic sniff runs only behind the legacy gate.
        if self.options.legacy_wide_column_unwrap \
                and any(v is not None and v[:1] == b"\x00" for v in res):
            from toplingdb_tpu_torch.db.wide_columns import default_column_of

            res = [v if v is None else default_column_of(v) for v in res]
        if self.stats is not None:
            self.stats.record_tick(_st.NUMBER_MULTIGET_CALLS)
            self.stats.record_tick(_st.NUMBER_MULTIGET_KEYS_READ, len(keys))
            self.stats.record_tick(
                _st.NUMBER_MULTIGET_BYTES_READ,
                sum(len(v) for v in res if v is not None))
            self.stats.record_in_histogram(
                _st.DB_MULTIGET_MICROS, (time.perf_counter() - t_mg) * 1e6)
        return res

    def _multi_get_impl(self, keys, opts, cf):
        if self.icmp.user_comparator.timestamp_size:
            # One iterator for the whole batch, sought across the keys in
            # sorted order.
            it = self.new_iterator(opts, cf=cf)
            hits = {}
            for k in sorted(set(keys)):
                hit = self._ts_lookup(it, k)
                hits[k] = None if hit is None else hit[0]
            return [hits[k] for k in keys]
        cfd = self._cf_data(cf)
        snap_seq = (
            opts.snapshot.sequence if opts.snapshot is not None
            else self.versions.last_sequence
        )
        # The async read plane runs the Python per-file walk with its
        # block fetches fanned through the reader rings; the native
        # whole-batch call serializes its preads in-call and is bypassed.
        async_on = self._async_reads
        sv = cfd.sv
        if not async_on:
            handled, native_res = self._native_multi_get(cfd, keys, snap_seq,
                                                         opts, sv, cf)
            if handled:
                return native_res
        resolver = self.blob_source.get
        excluded = self._excluded_for(opts)
        ctxs = {
            k: GetContext(k, snap_seq, self.options.merge_operator,
                          blob_resolver=resolver, excluded_ranges=excluded)
            for k in keys
        }
        live = dict(ctxs)
        # 1. Memtables: one pass per source for ALL live keys.
        for mem in sv.mems:
            for k in list(live):
                if not self._probe_memtable(mem, k, snap_seq, live[k]):
                    del live[k]
        # 2. SSTs: keys grouped by candidate file, so each reader and
        # iterator is reused across the batch. A file's tombstones are
        # parsed once per batch, under a lock (the async_io walks share
        # the memo across threads).
        version = sv.version
        tombs_cache: dict[int, list] = {}
        cache_mu = ccy.Lock("db.DB.cache_mu")

        def tombs_for(f):
            with cache_mu:
                t = tombs_cache.get(f.number)
                if t is None:
                    t = self._parsed_tombstones(
                        self.table_cache.get_reader(f.number))
                    tombs_cache[f.number] = t
            return t

        if live and opts.async_io and len(live) > 1 and not async_on:
            # The fiber MultiGet's role: each missing key walks its own
            # file chain on a worker thread (file preads release the GIL,
            # so misses overlap their IO).
            pool = self._mget_pool
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor

                with self._mutex:
                    pool = self._mget_pool
                    if pool is None:
                        pool = self._mget_pool = ThreadPoolExecutor(
                            max_workers=max(1, opts.async_queue_depth),
                            thread_name_prefix="tpt-mget")
            list(pool.map(
                lambda k: self._walk_sst_chain(
                    version, k, snap_seq, ctxs[k], tombs_for),
                list(live),
            ))
            return [self._result(ctxs[k]) for k in keys]
        if live:
            per_file: dict[int, list[bytes]] = {}
            for k in live:
                for _level, f in version.files_for_get(k):
                    per_file.setdefault(f.number, []).append(k)
            # Files in global level order — L0 newest first, then each
            # deeper level — which keeps EVERY key's newest-first source
            # order (a key's candidates are a subsequence of this walk).
            file_order = [
                f for lvl in range(version.num_levels)
                for f in version.files[lvl] if f.number in per_file
            ]
            # Async read plane: every file's cache-missing blocks are
            # submitted as one batch before any probe, so the rings do the
            # preads while this thread decodes what completed first.
            overlays = None
            if async_on and file_order:
                overlays = self._plan_async_preread(
                    file_order, per_file, live, snap_seq)
            span_cm = (_tm.span("read.async.wait", files=len(file_order))
                       if overlays else contextlib.nullcontext())
            with span_cm:
                for f in file_order:
                    todo = [k for k in per_file[f.number] if k in live]
                    if not todo:
                        continue
                    reader = self.table_cache.get_reader(f.number)
                    tombs = tombs_for(f)
                    it = None
                    preread = (overlays.get(f.number)
                               if overlays is not None else None)
                    for k in sorted(todo):
                        ctx = live.get(k)
                        if ctx is None:
                            continue
                        more, it = self._probe_file(
                            reader, k, snap_seq, ctx, tombs, it,
                            preread=preread)
                        if not more:
                            del live[k]
        for ctx in live.values():
            ctx.finish()
        return [self._result(ctxs[k]) for k in keys]

    def _native_multi_get(self, cfd, keys, snap_seq: int, opts,
                          sv: _SuperVersion, cf=None):
        """Whole-batch native MultiGet: one GIL-released call walks every
        key's chain; only keys the native walk cannot decide (merge
        chains, blob indexes, range-tombstoned tables) re-resolve through
        the Python chain. Returns (handled, results)."""
        if not keys:
            return False, None
        lib, cc = self._nget_state(cfd, opts, sv)
        if cc is None:
            return False, None
        if cc.fast_mg is not None and isinstance(keys, list) \
                and all(type(k) is bytes for k in keys):
            # Whole batch and its result objects in the C extension.
            fm = cc.fast_mg(cc.ctx, keys, snap_seq)
            if fm is not None:
                res, ctr = fm
                self._mg_record_stats(ctr)
                return True, self._mg_resolve_fallbacks(
                    res, keys, snap_seq, opts, cf)
        import ctypes

        import numpy as np

        from toplingdb_tpu_torch import native as _nat

        n = len(keys)
        key_lens = np.fromiter((len(k) for k in keys), np.int32, n)
        key_offs = np.zeros(n, np.int64)
        np.cumsum(key_lens[:-1], out=key_offs[1:])
        keybuf = np.frombuffer(b"".join(keys), np.uint8)
        # Per-batch scratch lives on the thread's get state: a fresh 1 MiB
        # arena per 128-key batch would dominate the batch's wall.
        mg = cc.mg
        if mg is None or len(mg[0]) < n:
            cap = max(n, 256)
            mg = cc.mg = (np.zeros(cap, np.int8), np.zeros(cap, np.int64),
                          np.zeros(cap, np.int64))
        status, voffs, vlens = mg
        arena = cc.mg_arena
        if arena is None:
            arena = cc.mg_arena = np.empty(1 << 20, np.uint8)
        ctr = (ctypes.c_int64 * 6)()
        used = (ctypes.c_int64 * 1)()
        while True:
            rc = lib.tpulsm_getctx_multiget(
                cc.ctx, _nat.np_u8p(keybuf), _nat.np_i64p(key_offs),
                _nat.np_i32p(key_lens), n, snap_seq,
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                _nat.np_i64p(voffs), _nat.np_i64p(vlens),
                _nat.np_u8p(arena), len(arena), used, ctr,
            )
            if rc == -2:
                arena = cc.mg_arena = np.empty(len(arena) * 4, np.uint8)
                continue
            if rc != 0:
                return False, None
            break
        self._mg_record_stats(ctr)
        mv = memoryview(arena)
        out: list = [None] * n
        for i in range(n):
            s = status[i]
            if s == 1:
                o = voffs[i]
                out[i] = bytes(mv[o: o + vlens[i]])
            elif s == 2:
                out[i] = False  # undecidable natively: resolved below
        return True, self._mg_resolve_fallbacks(out, keys, snap_seq, opts,
                                                cf)

    def _mg_record_stats(self, ctr) -> None:
        """Batch-level perf and ticker accounting from the native
        MultiGet's six counters (the ctypes and the extension calls)."""
        if _st.perf_level:
            pctx = _st.perf_context()
            pctx.get_from_memtable_count += ctr[0]
            pctx.bloom_sst_miss_count += ctr[1]
            pctx.bloom_sst_hit_count += ctr[2]
            pctx.block_cache_hit_count += ctr[3]
            pctx.block_read_count += ctr[4]
            pctx.block_read_byte += ctr[5]
        if self.stats is not None:
            for tick, cnt in ((_st.BLOOM_USEFUL, ctr[1]),
                              (_st.BLOCK_CACHE_HIT, ctr[3]),
                              (_st.BLOCK_CACHE_MISS, ctr[4])):
                if cnt:
                    self.stats.record_tick(tick, cnt)

    def _mg_resolve_fallbacks(self, out, keys, snap_seq, opts, cf):
        """Replace the False markers (keys the native walk could not
        decide) with full per-key Python resolutions, PINNED to the
        batch's sequence: re-reading at a fresh last_sequence would mix
        sequence points within one MultiGet."""
        if not any(v is False for v in out):
            return out
        pinned_opts = opts
        if opts.snapshot is None:
            import dataclasses

            pinned_opts = dataclasses.replace(
                opts, snapshot=_SeqSnapshot(snap_seq))
        for i, v in enumerate(out):
            if v is False:
                r, is_entity = self._get_entry(keys[i], pinned_opts, cf,
                                               record_trace=False)
                if r is not None and is_entity:
                    from toplingdb_tpu_torch.db.wide_columns import (
                        default_column_of,
                    )

                    r = default_column_of(r)
                out[i] = r
        return out

    def _reader_batcher(self):
        """The DB's AsyncReadBatcher, made on the first async-routed
        read; None once the DB is closed."""
        b = self._read_batcher
        if b is None:
            from toplingdb_tpu_torch.env.async_reads import AsyncReadBatcher

            with self._mutex:
                b = self._read_batcher
                if b is None and not self._closed:
                    opts = self.options
                    b = self._read_batcher = AsyncReadBatcher(
                        rings=max(1, opts.async_read_rings),
                        task_capacity=opts.async_read_task_capacity,
                        stats=self.stats,
                        fault_hook=self.read_fault_hook,
                        name="tpt-read")
        return b

    def _plan_async_preread(self, file_order, per_file, live, snap_seq):
        """Plan and submit one batch of block fetches for a (multi_)get:
        per candidate file, seek the resident index for each live key's
        data-block handle, drop cache-resident blocks, and fan the rest
        through the reader rings in ONE submit_batch (coalescing merges
        neighbours). Returns {file_number: overlay}, the overlay a
        PrereadSpans (block tables) or a {vg: token} value-group preload
        (zip tables); files the plane cannot serve (hash-index and plain
        formats) get no entry and probe synchronously, counted by
        READ_ASYNC_FALLBACKS."""
        batcher = self._reader_batcher()
        if batcher is None:
            return None
        mk = dbformat.make_internal_key
        flat: list[tuple] = []       # (rfile, offset, length)
        flat_file: list[int] = []    # their file numbers
        zip_plans: dict[int, tuple] = {}
        planned: set[int] = set()
        fallbacks = 0
        for f in file_order:
            if f.number in planned:
                continue
            planned.add(f.number)
            todo = sorted(k for k in per_file[f.number] if k in live)
            if not todo:
                continue
            reader = self.table_cache.get_reader(f.number)
            ikeys = [mk(k, snap_seq, dbformat.VALUE_TYPE_FOR_SEEK)
                     for k in todo if reader.key_may_match(k)]
            if not ikeys:
                continue
            if hasattr(reader, "plan_block_reads") \
                    and not getattr(reader, "has_hash_index", False):
                for off, n in reader.plan_block_reads(ikeys):
                    flat.append((reader._f, off, n))
                    flat_file.append(f.number)
            elif hasattr(reader, "plan_value_groups"):
                vgs = reader.plan_value_groups(ikeys)
                if vgs:
                    zip_plans[f.number] = (reader, vgs)
            else:
                fallbacks += 1
        overlays: dict[int, object] = {}
        if flat:
            from toplingdb_tpu_torch.env.async_reads import PrereadSpans

            toks = batcher.submit_batch(flat)
            spans: dict[int, list] = {}
            for (_rf, off, n), fnum, tok in zip(flat, flat_file, toks):
                spans.setdefault(fnum, []).append((off, off + n, tok))
            for fnum, sp in spans.items():
                overlays[fnum] = PrereadSpans(
                    self.table_cache.get_reader(fnum)._f, sp)
        for fnum, (reader, vgs) in zip_plans.items():
            overlays[fnum] = {
                vg: batcher.submit_task(
                    lambda r=reader, v=vg: r._value_group(v))
                for vg in vgs
            }
        if zip_plans and self.stats is not None:
            # A value-group preload is one planned batch too.
            self.stats.record_tick(_st.READ_ASYNC_BATCHES, len(zip_plans))
        if fallbacks and self.stats is not None:
            self.stats.record_tick(_st.READ_ASYNC_FALLBACKS, fallbacks)
        return overlays

    def _submit_async(self, fn):
        """Run `fn` on the lazy async-read executor; returns a
        concurrent.futures.Future."""
        self._check_open()
        pool = self._async_pool
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._mutex:
                pool = self._async_pool
                if pool is None:
                    pool = self._async_pool = ThreadPoolExecutor(
                        max_workers=max(2, self.options.async_read_rings),
                        thread_name_prefix="tpt-get-async")
        return pool.submit(fn)

    def get_async(self, key: bytes, opts: ReadOptions = _DEFAULT_READ,
                  cf=None):
        """Future-returning point lookup: `.result()` is exactly what
        `get(key, opts, cf)` returns."""
        return self._submit_async(lambda: self.get(key, opts, cf))

    def multi_get_async(self, keys: list[bytes],
                        opts: ReadOptions = _DEFAULT_READ, cf=None):
        """Future-returning batched lookup: `.result()` is exactly what
        `multi_get(keys, opts, cf)` returns."""
        keys = list(keys)
        return self._submit_async(lambda: self.multi_get(keys, opts, cf))

    def new_iterator(self, opts: ReadOptions = _DEFAULT_READ,
                     cf=None, *, scan_plane: bool = True) -> DBIter:
        """MVCC iterator over the whole keyspace of CF `cf` (RocksDB's
        DBImpl::NewIterator → DBIter over a MergingIterator). With
        ReadOptions.tailing, a ForwardIterator over it. scan_plane=False
        keeps the iterator on the per-entry path (the tailing iterator's
        views: the chunked plane materializes the memtable at each seek,
        and a tailer seeks at every catch-up)."""
        self._check_open()
        self._check_read_ts(opts)
        if opts.tailing:
            import dataclasses

            from toplingdb_tpu_torch.db.forward_iterator import (
                ForwardIterator,
            )

            fwd = ForwardIterator(
                self, dataclasses.replace(opts, tailing=False), cf=cf)
            tr = self._op_tracer
            if tr is not None:
                from toplingdb_tpu_torch.utils.trace import TracingIterator

                return TracingIterator(fwd, tr)
            return fwd
        cfd = self._cf_data(cf)
        # Async read plane: iterator readahead windows become reader-ring
        # tasks; each child pins one ring so its windows stay ordered
        # while children overlap. The batcher is made BEFORE taking the DB
        # mutex (making it takes the mutex).
        batcher = self._reader_batcher() if self._async_reads else None
        with self._mutex:
            snap_seq = (
                opts.snapshot.sequence if opts.snapshot is not None
                else self.versions.last_sequence
            )
            version = self.versions.cf_current(cfd.handle.id)
            children = []
            rd = RangeDelAggregator(self.icmp.user_comparator)
            ra = opts.readahead_size
            for mem in [cfd.mem] + cfd.imm:
                children.append(mem.new_iterator())
                for seq, begin, end in mem.range_del_entries():
                    rd.add(RangeTombstone(seq, begin, end))
            for i, f in enumerate(version.files[0]):
                reader = self.table_cache.get_reader(f.number)
                if (ra or batcher is not None) \
                        and hasattr(reader, "new_index_iterator"):
                    children.append(reader.new_iterator(
                        readahead_size=ra,
                        aio_ring=(batcher.ring_for(i)
                                  if batcher is not None else None)))
                else:
                    children.append(reader.new_iterator())
                for b, e in reader.range_del_entries():
                    rd.add(RangeTombstone.from_table_entry(b, e))
            for level in range(1, version.num_levels):
                if version.files[level]:
                    children.append(LevelIterator(
                        self.table_cache, version.files[level], self.icmp,
                        readahead_size=ra,
                        aio_ring=(batcher.ring_for(level)
                                  if batcher is not None else None)))
                    # Only files that hold tombstones are opened here
                    # (num_range_deletions travels in the MANIFEST); data
                    # blocks are opened lazily by LevelIterator.
                    for f in version.files[level]:
                        if f.num_range_deletions == 0:
                            continue
                        reader = self.table_cache.get_reader(f.number)
                        for b, e in reader.range_del_entries():
                            rd.add(RangeTombstone.from_table_entry(b, e))
            it = DBIter(
                MergingIterator(self.icmp.compare, children), self.icmp,
                snap_seq,
                range_del_agg=None if rd.empty() else rd,
                merge_operator=self.options.merge_operator,
                lower_bound=opts.iterate_lower_bound,
                upper_bound=opts.iterate_upper_bound,
                pinned=version,
                blob_resolver=self.blob_source.get,
                prefix_extractor=self.options.prefix_extractor,
                prefix_same_as_start=(opts.prefix_same_as_start
                                      and not opts.total_order_seek),
                excluded_ranges=self._excluded_for(opts),
                read_ts=opts.timestamp,
                legacy_wce=self.options.legacy_wide_column_unwrap,
            )
            # The chunked scan plane (ops/scan_plane.py): native block
            # decode + k-way merge for forward scans; None when the
            # iterator's shape is ineligible (the per-entry path runs).
            plane = None if not scan_plane else make_scan_plane(
                mems=[cfd.mem] + list(cfd.imm),
                l0_files=list(version.files[0]),
                level_runs=[version.files[lv]
                            for lv in range(1, version.num_levels)
                            if version.files[lv]],
                table_cache=self.table_cache,
                icmp=self.icmp,
                snap_seq=snap_seq,
                rd=None if rd.empty() else rd,
                lower=opts.iterate_lower_bound,
                upper=opts.iterate_upper_bound,
                blob_resolver=self.blob_source.get,
                merge_operator=self.options.merge_operator,
                prefix_mode=(opts.prefix_same_as_start
                             and not opts.total_order_seek
                             and self.options.prefix_extractor is not None),
                excluded=self._excluded_for(opts),
                read_ts=opts.timestamp,
                stats=self.stats,
                chunk=self.iter_chunk_rows,
                readahead_size=ra,
                protection_bytes=self._protection,
                aio_rings=batcher,
            )
            if plane is not None:
                it.attach_scan_plane(plane)
            if opts.snapshot is None:
                # Refresh re-reads at the LATEST sequence; a snapshot-pinned
                # iterator cannot refresh (RocksDB's Iterator::Refresh
                # returns NotSupported for it).
                it._refresh_fn = lambda: self.new_iterator(opts, cf)
            if self.stats is not None:
                it.stats = self.stats
                self.stats.record_tick(_st.NO_ITERATOR_CREATED)
            tr = self._op_tracer
            if tr is not None:
                from toplingdb_tpu_torch.utils.trace import TracingIterator

                return TracingIterator(it, tr)
            return it

    def get_snapshot(self):
        if self.options.unordered_write:
            # Unordered writes insert out of allocation order: wait until
            # every write allocated before now is published, so the
            # snapshot covers each write that started before it (RocksDB's
            # DBImpl::GetSnapshotImpl → WaitForPendingWrites).
            with self._mutex:
                target = self._seq_alloc
                while self.versions.last_sequence < target:
                    self._mt_cv.wait(timeout=10.0)
        fn = self._undecided_provider
        return self.snapshots.new_snapshot(
            self.versions.last_sequence,
            excluded_ranges=fn() if fn is not None else (),
        )

    def _excluded_for(self, opts) -> tuple:
        """Seqno ranges invisible to this read (undecided WritePrepared
        transactions): a snapshot carries the set captured when it was
        taken; a read without one uses the live set."""
        if opts.snapshot is not None:
            return getattr(opts.snapshot, "excluded_ranges", ())
        fn = self._undecided_provider
        return fn() if fn is not None else ()

    def release_snapshot(self, snap) -> None:
        snap.release()

    # ==================================================================
    # Maintenance
    # ==================================================================

    def compact_range(self, begin: bytes | None = None,
                      end: bytes | None = None) -> None:
        """Manual compaction: flush, then push the files overlapping
        [begin, end] down level by level through the scheduler."""
        self.flush()
        if self._compaction_scheduler is not None:
            self._compaction_scheduler.compact_range(begin, end)

    def compact_files(self, file_numbers: list[int], output_level: int,
                      cf=None) -> None:
        """Compact a caller-chosen set of files into output_level (RocksDB's
        DB::CompactFiles), in the caller's thread, through the executor
        factory. The files must live at one source level and / or at
        output_level itself. A failed job raises to the caller, latches
        the DB's background error and leaves no output."""
        cfd = self._cf_data(cf)
        if not 0 <= output_level < self.options.num_levels:
            raise InvalidArgument(
                f"output_level {output_level} out of range "
                f"[0, {self.options.num_levels})"
            )
        sched = self._compaction_scheduler
        want = set(file_numbers)
        with self._mutex:
            version = self.versions.cf_current(cfd.handle.id)
            by_level: dict[int, list] = {}
            for lvl, f in version.all_files():
                if f.number in want:
                    by_level.setdefault(lvl, []).append(f)
                    want.discard(f.number)
            if want:
                raise InvalidArgument(f"files not live: {sorted(want)}")
            src_levels = [lvl for lvl in by_level if lvl != output_level]
            if len(src_levels) > 1:
                raise InvalidArgument(
                    f"input files span levels {sorted(by_level)}; at most "
                    f"one source level plus output_level {output_level}"
                )
            src = src_levels[0] if src_levels else output_level
            if src > output_level:
                raise InvalidArgument(
                    f"source level {src} is below output level {output_level}"
                )
            inputs = by_level.get(src, [])
            out_inputs = (
                by_level.get(output_level, []) if src != output_level else []
            )
            # RocksDB's CompactFiles sanitization EXPANDS the caller's set
            # rather than rejecting it (compaction_picker.cc
            # SanitizeCompactionInputFilesForAllLevels): at L0 every file
            # OLDER than the newest listed file comes along (newer unlisted
            # runs stay on top, so reads never see stale data below newer
            # data); at sorted levels the listed run is widened across
            # same-user-key boundaries; at the output level all overlapping
            # files are included to keep it non-overlapping.
            listed = {f.number for f in inputs + out_inputs}
            ucmp = self.icmp.user_comparator

            def _widen(lvl_files, lo, hi):
                # Same-user-key boundary widening: a neighbor sharing a
                # boundary user key must come along, else seqno zeroing can
                # reorder that key across the excluded file.
                while lo > 0 and ucmp.compare(
                        dbformat.extract_user_key(lvl_files[lo - 1].largest),
                        dbformat.extract_user_key(
                            lvl_files[lo].smallest)) >= 0:
                    lo -= 1
                while hi + 1 < len(lvl_files) and ucmp.compare(
                        dbformat.extract_user_key(lvl_files[hi + 1].smallest),
                        dbformat.extract_user_key(
                            lvl_files[hi].largest)) <= 0:
                    hi += 1
                return lo, hi

            if inputs and src == 0:
                # L0 is time-ordered, not key-ordered: every file OLDER than
                # the newest listed file comes along (for intra-L0 jobs too
                # — a non-contiguous subset compacted past an unlisted
                # middle file would re-sort newer data below it).
                l0 = version.files[0]  # newest-first
                first = min(i for i, f in enumerate(l0)
                            if f.number in listed)
                inputs = list(l0[first:])
            elif inputs and src >= 1:
                lvl_files = version.files[src]  # sorted by smallest key
                idxs = [i for i, f in enumerate(lvl_files)
                        if f.number in listed]
                lo, hi = _widen(lvl_files, min(idxs), max(idxs))
                inputs = list(lvl_files[lo:hi + 1])
            all_in = inputs + out_inputs
            if all_in:
                su = dbformat.extract_user_key(
                    min((f.smallest for f in all_in), key=self.icmp.sort_key))
                lu = dbformat.extract_user_key(
                    max((f.largest for f in all_in), key=self.icmp.sort_key))
                if src != output_level and output_level > 0:
                    out_files = version.files[output_level]
                    ov = {f.number for f in version.overlapping_files(
                        output_level, su, lu)}
                    oidxs = [i for i, f in enumerate(out_files)
                             if f.number in ov]
                    if oidxs:
                        lo, hi = _widen(out_files, min(oidxs), max(oidxs))
                        out_inputs = list(out_files[lo:hi + 1])
                    else:
                        out_inputs = []
                # Intermediate levels can't be represented by a two-level
                # Compaction: anything overlapping there keeps its newer
                # data ABOVE the moved output, which is unsafe — reject.
                for lvl in range(src + 1, output_level):
                    for f in version.overlapping_files(lvl, su, lu):
                        raise InvalidArgument(
                            f"file #{f.number} at intermediate L{lvl} "
                            f"overlaps the compaction range; compact it "
                            f"first or choose output_level {lvl}"
                        )
            all_in = inputs + out_inputs
            if any(f.being_compacted for f in all_in):
                raise Busy("some input files are already being compacted")
            c = Compaction(
                level=src, output_level=output_level, inputs=inputs,
                output_level_inputs=out_inputs,
                bottommost=sched.picker._is_bottommost(
                    version, output_level,
                    min((f.smallest for f in all_in),
                        key=self.icmp.sort_key),
                    max((f.largest for f in all_in),
                        key=self.icmp.sort_key),
                ) if all_in else False,
                reason="compact_files",
                max_output_file_size=self.options.target_file_size(
                    output_level),
                cf_id=cfd.handle.id,
                full_history_ts_low=self.options.full_history_ts_low,
            )
            for _, f in c.all_inputs():
                f.being_compacted = True
        try:
            sched._run_compaction(c)
        except BaseException as e:
            # Ground rule of the device executor: a failed job raises and
            # latches the background error (RocksDB's CompactFilesImpl sets
            # the BG error for a failed job); nothing re-runs it elsewhere.
            sched.last_error = e
            self._set_background_error(
                e, getattr(e, "_bg_reason", "compaction"))
            raise
        finally:
            with self._mutex:
                for _, f in c.all_inputs():
                    f.being_compacted = False
        del version
        # The install's sweep ran while the picked Version was held: sweep
        # again, so the replaced inputs leave the disk now.
        with self._mutex:
            self._delete_obsolete_files()

    def suggest_compact_range(self, begin: bytes | None = None,
                              end: bytes | None = None, cf=None) -> int:
        """Mark files overlapping [begin, end) for compaction (RocksDB's
        DB::SuggestCompactRange): the picker prioritizes marked files on
        its next pass. Returns the number of files marked."""
        cfd = self._cf_data(cf)
        ucmp = self.icmp.user_comparator
        marked = 0
        with self._mutex:
            version = self.versions.cf_current(cfd.handle.id)
            for _lvl, f in version.all_files():
                fs = dbformat.extract_user_key(f.smallest)
                fl = dbformat.extract_user_key(f.largest)
                if begin is not None and ucmp.compare(fl, begin) < 0:
                    continue
                if end is not None and ucmp.compare(fs, end) >= 0:
                    continue
                if not f.marked_for_compaction:
                    f.marked_for_compaction = True
                    marked += 1
        if marked:
            self._maybe_schedule_compaction()
        return marked

    def promote_l0(self, target_level: int = 1, cf=None) -> None:
        """Metadata-only move of ALL L0 files to target_level (RocksDB's
        DB::PromoteL0): requires pairwise non-overlapping L0 files and
        empty levels 1..target_level."""
        if not 1 <= target_level < self.options.num_levels:
            raise InvalidArgument(
                f"target_level {target_level} out of range "
                f"[1, {self.options.num_levels})"
            )
        cfd = self._cf_data(cf)
        ucmp = self.icmp.user_comparator
        with self._mutex:
            version = self.versions.cf_current(cfd.handle.id)
            l0 = list(version.files[0])
            if not l0:
                return
            for lvl in range(1, target_level + 1):
                if version.files[lvl]:
                    raise InvalidArgument(
                        f"level {lvl} is not empty; cannot promote L0 over it"
                    )
            ordered = sorted(
                l0, key=lambda f: self.icmp.sort_key(f.smallest)
            )
            for a, b in zip(ordered, ordered[1:]):
                if ucmp.compare(dbformat.extract_user_key(a.largest),
                                dbformat.extract_user_key(b.smallest)) >= 0:
                    raise InvalidArgument(
                        "L0 files overlap; compact instead of promoting"
                    )
            if any(f.being_compacted for f in l0):
                raise Busy("L0 files are being compacted")
            edit = VersionEdit(column_family=cfd.handle.id)
            for f in l0:
                edit.delete_file(0, f.number)
                edit.add_file(target_level, f)
            self._install_edit(edit)

    def wait_for_compactions(self) -> None:
        if self._compaction_scheduler is not None:
            self._compaction_scheduler.wait_idle()
        if self._bg_error is not None:
            raise IOError_(f"background error: {self._bg_error!r}")

    def _classify_bg_error(self, e: BaseException, reason: str):
        """Map (error, background reason) to a Severity, as RocksDB's
        ErrorHandler severity tables do (db/error_handler.cc): SOFT for
        retryable or no-space flush and compaction IO errors, FATAL for
        MANIFEST failures and corruption, UNRECOVERABLE for corruption
        found BY a compaction (it would be baked into new SSTs). The
        scrubber's corruption latch (reason="scrub") is HARD, not FATAL:
        the corrupt file is quarantined before the latch, so nothing wrong
        was served or propagated, and after the operator restores the file
        and a clean re-scrub, resume() is legitimate (db/integrity.py)."""
        if isinstance(e, Corruption):
            if reason == "scrub":
                return Severity.HARD_ERROR
            return (Severity.UNRECOVERABLE if reason == "compaction"
                    else Severity.FATAL_ERROR)
        if reason == "manifest":
            return Severity.FATAL_ERROR
        if reason == "no_space":
            # Space comes back (the operator frees the disk): SOFT, so the
            # auto-recover loop clears the latch.
            return Severity.SOFT_ERROR
        if getattr(e, "retryable", False) and reason in (
                "flush", "compaction"):
            return Severity.SOFT_ERROR
        return Severity.HARD_ERROR

    def _set_background_error(self, e: BaseException,
                              reason: str = "compaction") -> None:
        """RocksDB's ErrorHandler::SetBGError. Severity decides behavior:
        SOFT (retryable flush / compaction IO): foreground writes go on and
        the auto-recover loop retries; HARD: writes raise until resume();
        FATAL / UNRECOVERABLE (corruption, MANIFEST loss): resume()
        refuses, the DB must be reopened. The latch only ever escalates;
        listeners hear of every error that latched or escalated
        (`on_background_error`)."""
        if reason != "no_space" and is_no_space(e):
            # A raw ENOSPC surfacing through any background path classifies
            # SOFT and auto-recovers (RocksDB's kNoSpace subcode).
            reason = "no_space"
        if reason == "no_space":
            try:
                e.retryable = True  # the recover loop's keep-retrying gate
                e._bg_reason = "no_space"
            except Exception as attr_err:  # noqa: BLE001 - __slots__ errors
                _errors.swallow(reason="bg-error-annotate", exc=attr_err)
            if self.stats is not None:
                self.stats.record_tick(_st.NO_SPACE_ERRORS, 1)
        sev = self._classify_bg_error(e, reason)
        with self._mutex:
            if self._bg_error is not None and sev <= self._bg_error_severity:
                return
            self._bg_error = e
            self._bg_error_severity = sev
            self._bg_error_reason = reason
        # Escalations notify too, and a retryable error that replaced the
        # one a recovery thread was chasing gets a fresh thread (the old
        # one exits at its identity check).
        notify(self.options.listeners, "on_background_error", self, e)
        if sev == Severity.SOFT_ERROR or (
                getattr(e, "retryable", False)
                and sev < Severity.FATAL_ERROR):
            t = ccy.spawn("tpt-auto-recover", self._auto_recover_loop,
                          args=(e,), owner=self, start=False)
            with self._mutex:
                self._recover_threads = [
                    x for x in self._recover_threads if x.is_alive()] + [t]
            t.start()

    def _auto_recover_loop(self, target: BaseException,
                           max_attempts: int = 10,
                           base_delay: float = 0.05) -> None:
        """Retry resume() with backoff for THE error this thread was started
        for. A different error latched meanwhile, a manual resume() or the
        DB's close ends the loop untouched (RocksDB checks the recovery
        error's identity the same way). A no_space latch first waits for
        the SstFileManager's headroom, spending no attempt while it waits.
        Background work reruns on the same compaction executor; nothing
        falls back to another path."""
        no_space = getattr(target, "_bg_reason", "") == "no_space" or (
            self._bg_error is target and self._bg_error_reason == "no_space")
        attempt = 0
        backoff = 0  # grows on every pass, attempted or not
        while attempt < max_attempts:
            if self._recover_stop.wait(
                    min(base_delay * (2 ** min(backoff, 8)), 2.0)):
                return  # the DB is closing
            backoff += 1
            with self._mutex:
                if self._closed or self._bg_error is not target:
                    return
            if (no_space and self._sfm is not None
                    and not self._sfm.has_headroom()):
                # Space has not come back yet (trash still draining, the
                # disk still full): a no_space latch clears exactly when
                # the poller sees headroom, however long that takes.
                continue
            attempt += 1
            try:
                self.resume(_auto=True)
                self.wait_for_compactions()
                self.event_logger.log("auto_recovery_succeeded",
                                      attempts=attempt)
                return
            except Exception as err:  # noqa: BLE001 - still failing
                # One thread per latched error: a new error latched through
                # _set_background_error starts its own successor, so any
                # identity mismatch ends this thread's watch.
                with self._mutex:
                    latched = self._bg_error
                if latched is target and getattr(
                        target, "retryable", False):
                    continue  # still our transient error; keep retrying
                if latched is None:
                    # Our retry cleared the latch but failed with a fresh
                    # error nothing latched yet: classify it and bow out.
                    self._set_background_error(
                        err, getattr(err, "_bg_reason", "flush"))
                return
        self.event_logger.log("auto_recovery_gave_up", attempts=max_attempts)

    def resume(self, *, _auto: bool = False) -> None:
        """Clear a background error and restart background work (RocksDB's
        DB::Resume). FATAL and UNRECOVERABLE errors refuse: the DB must be
        reopened. Clearing a live latch ticks BG_ERROR_RESUMES and notifies
        `on_error_recovery_completed`."""
        with self._mutex:
            if (self._bg_error is not None
                    and self._bg_error_severity >= Severity.FATAL_ERROR):
                raise IOError_(
                    f"background error is not resumable "
                    f"({self._bg_error_severity.name}); reopen the DB: "
                    f"{self._bg_error!r}"
                )
            had = self._bg_error
            reason = self._bg_error_reason
            self._bg_error = None
            self._bg_error_severity = Severity.NO_ERROR
            self._bg_error_reason = ""
        if had is not None:
            if self.stats is not None:
                self.stats.record_tick(_st.BG_ERROR_RESUMES, 1)
            from toplingdb_tpu_torch.utils.listener import ErrorRecoveryInfo

            notify(self.options.listeners, "on_error_recovery_completed",
                   self, ErrorRecoveryInfo(db_name=self.dbname,
                                           reason=reason, auto=_auto))
        self._maybe_schedule_compaction()

    # ==================================================================
    # Storage pressure
    # ==================================================================

    def disk_pressure(self) -> str:
        """The storage-pressure level ("ok" / "amber" / "red") from the
        SstFileManager's poller; "ok" when no manager is attached."""
        return self._sfm.pressure() if self._sfm is not None else "ok"

    def _on_disk_pressure_change(self, level: str, prev: str,
                                 info: dict) -> None:
        """The SstFileManager's transition callback (outside the manager's
        locks, on the polling thread): listeners hear of it, a rise climbs
        the reclaim ladder, a return to ok restarts paused compactions."""
        from toplingdb_tpu_torch.utils.listener import DiskPressureInfo

        notify(self.options.listeners, "on_disk_pressure", self,
               DiskPressureInfo(
                   db_name=self.dbname, path=self.dbname, level=level,
                   prev_level=prev,
                   free_fraction=info.get("free_fraction", 0.0),
                   tracked_bytes=info.get("tracked_bytes", 0),
                   trash_bytes=info.get("trash_bytes", 0),
                   budget_bytes=info.get("budget_bytes", 0)))
        self.event_logger.log(
            "disk_pressure", level=level, prev=prev,
            free_fraction=round(info.get("free_fraction", 0.0), 4))
        order = {"ok": 0, "amber": 1, "red": 2}
        if order.get(level, 0) > order.get(prev, 0):
            self._run_reclaim_ladder(level)
        elif level == "ok":
            self._maybe_schedule_compaction()

    def _run_reclaim_ladder(self, level: str) -> None:
        """Free bytes in escalating cost order: (1) unpace trash deletion,
        so bytes already condemned drain at once; at red also (2) prune
        the env's clean cache tier and (3) start a mark-sweep GC of its
        shared object store. Steps 2 and 3 act on a SharedSstEnv
        (storage/shared_env.py: its `tier` drops the clean cached objects,
        which refetch on demand, and storage/gc.mark_sweep sweeps its
        `store` with a 60 s grace, rooted at this DB and every sibling
        directory holding a CURRENT); on a plain env they do nothing."""
        if self._sfm is None:
            return
        if self.stats is not None:
            self.stats.record_tick(_st.DISK_RECLAIM_RUNS, 1)
        self._sfm.accelerate_deletes()
        if level != "red":
            return
        tier = getattr(self.env, "tier", None)
        if tier is not None and hasattr(tier, "prune"):
            try:
                tier.prune()
            except Exception as e:  # noqa: BLE001 - reclaim is best effort
                _errors.swallow(reason="disk-reclaim-cache-prune", exc=e,
                                stats=self.stats)
        store = getattr(self.env, "store", None)
        if store is not None and not self._store_gc_inflight:
            self._store_gc_inflight = True

            def run_gc():
                try:
                    from toplingdb_tpu_torch.storage.gc import mark_sweep

                    # Roots: this DB plus every sibling directory holding a
                    # CURRENT (fleet shards share one store; a sweep rooted
                    # at this shard alone would reap its neighbours' live
                    # objects).
                    roots = {self.dbname}
                    parent = os.path.dirname(self.dbname)
                    try:
                        for child in self.env.get_children(parent or "."):
                            d = f"{parent}/{child}" if parent else child
                            if self.env.file_exists(
                                    filename.current_file_name(d)):
                                roots.add(d)
                    except Exception as probe_err:  # noqa: BLE001
                        _errors.swallow(reason="reclaim-gc-root-scan",
                                        exc=probe_err)
                    mark_sweep(store, sorted(roots), env=self.env,
                               grace_sec=60.0, statistics=self.stats)
                except Exception as e:  # noqa: BLE001 - best effort
                    _errors.swallow(reason="disk-reclaim-store-gc", exc=e,
                                    stats=self.stats)
                finally:
                    self._store_gc_inflight = False

            t = ccy.spawn("tpt-disk-reclaim-store-gc", run_gc, owner=self,
                          start=False)
            with self._mutex:
                self._recover_threads = [
                    x for x in self._recover_threads if x.is_alive()] + [t]
            t.start()

    # ==================================================================
    # Integrity (the at-rest half: verification passes and the scrubber)
    # ==================================================================

    def _live_versions(self) -> list:
        """Every CF's current Version; holding them pins their files
        against a concurrent obsolete-file pass."""
        with self._mutex:
            return [self.versions.cf_current(cf_id)
                    for cf_id in self.versions.column_families]

    def verify_checksum(self) -> None:
        """Full checksum scan of every live SST (RocksDB's
        DB::VerifyChecksum): every block is read FROM DISK and
        CRC-verified, bypassing cached readers; opening with
        verify_checksums=True also verifies the index, metaindex,
        properties, filter and range-del blocks, and every BLOB_INDEX
        entry's blob record is read with its record CRC. Raises Corruption
        on the first bad block or record."""
        import dataclasses

        from toplingdb_tpu_torch.table.factory import open_table

        topts = dataclasses.replace(self.options.table_options,
                                    verify_checksums=True)
        bytes_verified = 0
        for version in self._live_versions():
            for _, f in version.all_files():
                path = filename.table_file_name(self.dbname, f.number)
                reader = open_table(self.env.new_random_access_file(path),
                                    self.icmp, topts)
                try:
                    it = reader.new_iterator()
                    it.seek_to_first()
                    for ik, v in it.entries():  # decoding verifies CRCs
                        if ik[-8] == dbformat.ValueType.BLOB_INDEX:
                            self.blob_source.get(v, verify=True)
                finally:
                    reader.close()
                bytes_verified += f.file_size
        if self.stats is not None and bytes_verified:
            self.stats.record_tick(_st.INTEGRITY_BYTES_VERIFIED,
                                   bytes_verified)

    def verify_file_checksums(self) -> dict:
        """Recompute every live SST's whole-file checksum and compare it
        with the MANIFEST's (RocksDB's DB::VerifyFileChecksums); raises
        Corruption on the first mismatch. Returns {'files_verified',
        'bytes_verified', 'files_skipped'}: skipped files carry no
        recorded checksum."""
        from toplingdb_tpu_torch.utils.file_checksum import (
            verify_recorded_checksum,
        )

        verified = bytes_v = skipped = 0
        seen: set[int] = set()
        for version in self._live_versions():
            for _, f in version.all_files():
                if f.number in seen:
                    continue
                seen.add(f.number)
                path = filename.table_file_name(self.dbname, f.number)
                n = verify_recorded_checksum(self.env, path, f)
                if n:
                    verified += 1
                    bytes_v += n
                else:
                    skipped += 1
        if self.stats is not None and bytes_v:
            self.stats.record_tick(_st.INTEGRITY_BYTES_VERIFIED, bytes_v)
        return {"files_verified": verified, "bytes_verified": bytes_v,
                "files_skipped": skipped}

    def scrub(self, deep: bool = False) -> dict:
        """Run one IntegrityScrubber pass synchronously (db/integrity.py)
        and return its report. Detected corruption quarantines the file,
        fires on_corruption_detected and latches a HARD background error
        (resume() after the repair and a clean re-scrub)."""
        self._check_open()
        if self._integrity_scrubber is None:
            from toplingdb_tpu_torch.db.integrity import IntegrityScrubber

            self._integrity_scrubber = IntegrityScrubber(self)
        return self._integrity_scrubber.run_pass(deep=deep)

    def scrub_status(self) -> dict:
        """The scrubber's rolling status (passes, bytes, quarantine)."""
        if self._integrity_scrubber is None:
            return {"running": False, "passes": 0,
                    "quarantined_files": sorted(self._quarantined)}
        return self._integrity_scrubber.status()

    _STATS_CF = "__tpulsm_stats__"

    def get_stats_history(self, start_time: int = 0, end_time: int = 2 ** 62,
                          include_persisted: bool = False):
        """Time-series ticker deltas (RocksDB's DBImpl::GetStatsHistory):
        samples taken every stats_persist_period_sec, or by
        persist_stats(). With include_persisted, the samples that
        persist_stats(to_db=True) stored in the hidden stats CF are merged
        in (RocksDB's persist_stats_to_disk)."""
        out = self.stats_history.get(start_time, end_time)
        if include_persisted:
            in_memory = {ts for ts, _ in out}
            cf = self.get_column_family(self._STATS_CF)
            if cf is not None:
                it = self.new_iterator(cf=cf)
                it.seek(b"%020d" % start_time)
                while it.valid():
                    try:
                        ts = int(it.key().split(b".")[0].decode())
                        delta = {
                            k: int(v) for k, v in
                            json.loads(it.value().decode()).items()
                        }
                    except (ValueError, UnicodeDecodeError):
                        it.next()
                        continue  # a foreign or corrupt entry: skip it
                    if ts >= end_time:
                        break
                    if ts not in in_memory:  # no sample counted twice
                        out.append((ts, delta))
                    it.next()
                out.sort(key=lambda s: s[0])
        return out

    def persist_stats(self, to_db: bool = False) -> None:
        """Snapshot the tickers into the stats history; with to_db=True,
        also write the sample into the hidden stats CF (created on first
        use), keyed by its timestamp and a counter."""
        self.stats_history.snapshot()
        if not to_db:
            return
        sample = self.stats_history.last_sample()
        if sample is None:
            return
        with self._mutex:
            cf = self.get_column_family(self._STATS_CF)
            if cf is None:
                cf = self.create_column_family(self._STATS_CF)
            self._stats_persist_seq += 1
            seq = self._stats_persist_seq
        ts, delta = sample
        # Counter suffix: two persists in the same second must not collide.
        self.put(b"%020d.%06d" % (ts, seq), json.dumps(delta).encode(),
                 cf=cf)

    def _maybe_schedule_compaction(self) -> None:
        if (self._compaction_scheduler is not None
                and not self.options.disable_auto_compactions):
            self._compaction_scheduler.maybe_schedule()

    def _max_l0_files(self) -> int:
        """L0 files of the worst CF: a pileup in any CF throttles."""
        return max(
            (len(self.versions.cf_current(cf_id).files[0])
             for cf_id in self.versions.column_families), default=0,
        )

    def _maybe_stall_writes(self, timeout: float = 10.0) -> None:
        """L0 back-pressure (RocksDB's WriteController and the
        level0_slowdown/stop triggers): past the slowdown trigger writes
        are delayed; past the stop trigger they block until compaction
        drains L0. No-op when nothing can drain L0 (auto compaction
        off, or background work paused): stalling a bulk load forever
        helps no one."""
        opts = self.options
        if (opts.disable_auto_compactions
                or self._compaction_scheduler is None
                or self._compaction_scheduler._paused):
            return
        n_l0 = self._max_l0_files()
        if n_l0 >= opts.level0_stop_writes_trigger:
            t0 = time.monotonic()
            while (self._max_l0_files() >= opts.level0_stop_writes_trigger
                   and time.monotonic() - t0 < timeout
                   and not self._closed):
                self._maybe_schedule_compaction()
                time.sleep(0.01)
            stalled = time.monotonic() - t0
            self._account_stall("stopped", stalled)
            if stalled >= timeout:
                self.event_logger.log(
                    "write_stall_timeout", l0_files=self._max_l0_files(),
                    stalled_s=round(stalled, 2),
                )
        elif n_l0 >= opts.level0_slowdown_writes_trigger:
            # Proportional delay ramp toward the stop trigger.
            span = max(1, opts.level0_stop_writes_trigger
                       - opts.level0_slowdown_writes_trigger)
            frac = (n_l0 - opts.level0_slowdown_writes_trigger + 1) / span
            delay = min(0.05 * frac, 0.05)
            time.sleep(delay)
            self._account_stall("delayed", delay)

    def _account_stall(self, state: str, stalled_s: float) -> None:
        """One stall episode: the cumulative totals of
        write_stall_state(), the STALL_MICROS / WRITE_STALL_COUNT tickers
        and the write-stall histogram."""
        micros = int(stalled_s * 1e6)
        tot = self._stall_totals
        tot["stalls"] += 1
        tot["stall_micros"] += micros
        tot["last_stall_micros"] = micros
        tot["last_state"] = state
        if self.stats is not None:
            self.stats.record_tick(_st.STALL_MICROS, micros)
            self.stats.record_tick(_st.WRITE_STALL_COUNT)
            self.stats.record_in_histogram(_st.WRITE_STALL_MICROS_HIST,
                                           micros)

    def write_stall_state(self) -> dict:
        """The write-stall state: the LIVE state derived from L0 file
        counts against the slowdown / stop triggers ("none", "delayed" or
        "stopped") and the cumulative stall totals. `drainable` is False
        when nothing can reduce L0 (auto compaction off, background work
        paused); writes are then never stalled either."""
        opts = self.options
        n_l0 = self._max_l0_files()
        drainable = not (opts.disable_auto_compactions
                         or self._compaction_scheduler is None
                         or self._compaction_scheduler._paused)
        if not drainable:
            state = "none"
        elif n_l0 >= opts.level0_stop_writes_trigger:
            state = "stopped"
        elif n_l0 >= opts.level0_slowdown_writes_trigger:
            state = "delayed"
        else:
            state = "none"
        out = dict(self._stall_totals)
        out.update(
            state=state,
            l0_files=n_l0,
            drainable=drainable,
            slowdown_trigger=opts.level0_slowdown_writes_trigger,
            stop_trigger=opts.level0_stop_writes_trigger,
        )
        return out

    def disable_file_deletions(self) -> None:
        """RocksDB's DB::DisableFileDeletions (an export pins the file set
        while it links the files). Counted: each disable needs a matching
        enable."""
        with self._mutex:
            self._file_deletions_disabled += 1

    def enable_file_deletions(self, force: bool = False) -> None:
        with self._mutex:
            n = self._file_deletions_disabled
            self._file_deletions_disabled = 0 if force else max(0, n - 1)
            if n > 0 and self._file_deletions_disabled == 0:
                self._delete_obsolete_files()  # the last unpin purges

    def flush_wal(self, sync: bool = False) -> None:
        """RocksDB's DB::FlushWAL / SyncWAL."""
        with self._mutex:
            if self._wal is not None:
                if sync:
                    self._wal.sync()
                else:
                    self._wal.flush()

    def _delete_obsolete_files(self) -> None:
        """GC: remove WALs below the manifest log number (or keep them in
        the recycle pool, or archive them under `wal_ttl_seconds`), SSTs
        no CF's live versions hold, stale MANIFESTs and OPTIONS files
        (RocksDB's DBImpl::DeleteObsoleteFiles)."""
        if self._file_deletions_disabled:
            return  # an export or a backup is pinning the file set
        live, live_blobs = self.versions.live_file_sets()
        for child in self.env.get_children(self.dbname):
            ftype, num = filename.parse_file_name(child)
            keep = True
            if ftype == filename.FileType.WAL:
                keep = (num >= self.versions.log_number
                        or num == self._wal_number
                        or num in self._recycle_wals)
                if not keep and (len(self._recycle_wals)
                                 < self.options.recycle_log_file_num
                                 and num in self._recyclable_written):
                    self._recycle_wals.append(num)
                    keep = True
                if not keep and self.options.wal_ttl_seconds > 0:
                    self._archive_wal(child)
                    continue
            elif ftype == filename.FileType.TABLE:
                keep = num in live or num in self._pending_outputs
            elif ftype == filename.FileType.BLOB:
                keep = num in live_blobs or num in self._pending_outputs
            elif ftype == filename.FileType.MANIFEST:
                keep = num == self.versions.manifest_file_number
            elif ftype == filename.FileType.OPTIONS:
                keep = (num == self._options_file_number
                        or self._options_file_number == 0)
            elif ftype == filename.FileType.TEMP:
                keep = False
            if not keep:
                path = f"{self.dbname}/{child}"
                if ftype == filename.FileType.TABLE:
                    self.table_cache.evict(num)
                elif ftype == filename.FileType.BLOB:
                    self.blob_source.evict(num)
                if self._sfm is not None:
                    if ftype in (filename.FileType.TABLE,
                                 filename.FileType.BLOB):
                        # Obsolete SSTs and blobs go through the manager:
                        # paced trash deletion and live-byte accounting.
                        self._sfm.schedule_delete(path)
                        continue
                    self._sfm.on_delete_file(path)
                try:
                    self.env.delete_file(path)
                except NotFound:
                    pass

    def _archive_wal(self, child: str) -> None:
        """Move an obsolete WAL to <db>/archive/ and purge entries older
        than wal_ttl_seconds (RocksDB's WalManager::ArchiveWALFile and
        PurgeObsoleteWALFiles)."""
        arch = f"{self.dbname}/archive"
        self.env.create_dir(arch)
        try:
            self.env.rename_file(f"{self.dbname}/{child}", f"{arch}/{child}")
        except (OSError, NotFound):
            return
        if self._sfm is not None:
            # Archived WALs leave the tracked tree (the TTL purge owns
            # them).
            self._sfm.on_delete_file(f"{self.dbname}/{child}")
        now = time.time()
        try:
            names = self.env.get_children(arch)
        except NotFound:
            return
        for name in names:
            p = f"{arch}/{name}"
            try:
                if now - self.env.get_file_mtime(p) > \
                        self.options.wal_ttl_seconds:
                    self.env.delete_file(p)
            except (OSError, NotFound):
                continue

    def get_wal_files(self) -> list[tuple[int, str, bool]]:
        """(log_number, path, archived) for every retained WAL, live and
        archived, oldest first (RocksDB's WalFile metadata;
        get_sorted_wal_files keeps its names-only live-file contract for
        backup tools)."""
        out = []
        for child in self.env.get_children(self.dbname):
            ftype, num = filename.parse_file_name(child)
            if ftype == filename.FileType.WAL:
                out.append((num, f"{self.dbname}/{child}", False))
        arch = f"{self.dbname}/archive"
        try:
            for child in self.env.get_children(arch):
                ftype, num = filename.parse_file_name(child)
                if ftype == filename.FileType.WAL:
                    out.append((num, f"{arch}/{child}", True))
        except NotFound:
            pass
        return sorted(out)

    def get_sorted_wal_files(self) -> list[str]:
        """Live WAL file names, oldest first (RocksDB's
        DB::GetSortedWalFiles). While file deletions are disabled, EVERY
        on-disk WAL is returned: a concurrent flush may have advanced
        log_number, but the pinned older WALs can still carry data absent
        from a get_live_files snapshot taken earlier."""
        self._check_open()
        with self._mutex:
            pinned = self._file_deletions_disabled > 0
            nums = sorted(
                num for child in self.env.get_children(self.dbname)
                for t, num in [filename.parse_file_name(child)]
                if t == filename.FileType.WAL
                and (pinned or num >= self.versions.log_number
                     or num == self._wal_number)
            )
            return [filename.log_file_name("", n) for n in nums]

    def get_live_files(self, flush_memtable: bool = True
                       ) -> tuple[list[str], int]:
        """(relative file names, manifest_file_size): everything a
        consistent copy needs (RocksDB's DB::GetLiveFiles): SSTs, blobs,
        CURRENT, MANIFEST and OPTIONS. The live MANIFEST keeps growing, so
        the caller must TRUNCATE its copy at manifest_file_size or the copy
        references files newer than the snapshot. Hold
        disable_file_deletions() while copying."""
        self._check_open()
        if flush_memtable:
            self.flush()
        with self._mutex:
            # CURRENT versions only: files pinned solely by in-flight
            # readers are not part of a consistent copy.
            ssts: set[int] = set()
            blobs: set[int] = set()
            for cf_id in self.versions.column_families:
                for _, f in self.versions.cf_current(cf_id).all_files():
                    ssts.add(f.number)
                    blobs.update(f.blob_refs)
            # The filename helpers with dbname="" yield bare basenames.
            out = [filename.table_file_name("", n) for n in sorted(ssts)]
            out += [blob_file_name("", n) for n in sorted(blobs)]
            out.append(filename.current_file_name(""))
            out.append(filename.manifest_file_name(
                "", self.versions.manifest_file_number))
            if self._options_file_number:
                out.append(filename.options_file_name(
                    "", self._options_file_number))
            return out, self.versions.manifest_size()

    def get_approximate_sizes(self, ranges: list[tuple[bytes, bytes]],
                              cf=None) -> list[int]:
        """Approximate on-disk bytes per [begin, end) user-key range
        (RocksDB's DB::GetApproximateSizes through ApproximateOffsetOf)."""
        cfd = self._cf_data(cf)
        ucmp = self.icmp.user_comparator
        version = self.versions.cf_current(cfd.handle.id)
        out = []
        for begin, end in ranges:
            bk = dbformat.make_internal_key(
                begin, dbformat.MAX_SEQUENCE_NUMBER,
                dbformat.VALUE_TYPE_FOR_SEEK)
            ek = dbformat.make_internal_key(
                end, dbformat.MAX_SEQUENCE_NUMBER,
                dbformat.VALUE_TYPE_FOR_SEEK)
            total = 0
            for level in range(version.num_levels):
                for f in version.files[level]:
                    # Metadata-only overlap check before touching a reader.
                    if (ucmp.compare(dbformat.extract_user_key(f.largest),
                                     begin) < 0
                            or ucmp.compare(end, dbformat.extract_user_key(
                                f.smallest)) < 0):
                        continue
                    reader = self.table_cache.get_reader(f.number)
                    lo = reader.approximate_offset_of(bk)
                    hi = reader.approximate_offset_of(ek)
                    if hi > lo:
                        total += hi - lo
            out.append(total)
        return out

    def delete_files_in_range(self, begin: bytes, end: bytes, cf=None) -> int:
        """Drop whole SSTs fully contained in [begin, end) (RocksDB's
        DeleteFilesInRange, the bulk-wipe fast path; boundary files keep
        their data, which a DeleteRange and a compaction then clear). L0
        files and files being compacted are skipped. Returns the number of
        files dropped."""
        cfd = self._cf_data(cf)
        ucmp = self.icmp.user_comparator
        with self._mutex:
            version = self.versions.cf_current(cfd.handle.id)
            doomed: list[tuple[int, int]] = []
            for level in range(1, version.num_levels):  # L0 ranges overlap
                for f in version.files[level]:
                    if f.being_compacted:
                        continue
                    fs = dbformat.extract_user_key(f.smallest)
                    fl = dbformat.extract_user_key(f.largest)
                    if (ucmp.compare(begin, fs) <= 0
                            and ucmp.compare(fl, end) < 0):
                        doomed.append((level, f.number))
            if not doomed:
                return 0
            edit = VersionEdit(column_family=cfd.handle.id)
            for level, num in doomed:
                edit.delete_file(level, num)
            self._install_edit(edit)
            del version
            self._delete_obsolete_files()
            return len(doomed)

    def pause_background_work(self) -> None:
        """RocksDB's DB::PauseBackgroundWork: wait for the running jobs,
        then hold new ones until continue_background_work()."""
        if self._compaction_scheduler is not None:
            self._compaction_scheduler.pause()

    def continue_background_work(self) -> None:
        if self._compaction_scheduler is not None:
            self._compaction_scheduler.resume_background()

    # The options DB.set_options may change on an open DB (toplingdb_tpu's
    # set; RocksDB's mutable CF and DB options). Every reader reads them
    # from self.options at the time of use.
    _MUTABLE_OPTIONS = frozenset({
        "write_buffer_size", "level0_file_num_compaction_trigger",
        "level0_slowdown_writes_trigger", "level0_stop_writes_trigger",
        "disable_auto_compactions", "max_bytes_for_level_base",
        "max_bytes_for_level_multiplier", "target_file_size_base",
        "target_file_size_multiplier", "max_compaction_bytes",
        "max_subcompactions", "max_background_jobs",
        "enable_blob_garbage_collection",
        "blob_garbage_collection_age_cutoff", "min_blob_size",
        "seqno_time_sample_period_sec", "fifo_ttl_seconds",
        "periodic_compaction_seconds",
    })

    def set_options(self, changes: dict) -> None:
        """Online option changes for the mutable subset (RocksDB's
        DB::SetOptions; the SidePlugin online-config mechanism). Unknown
        or immutable names, and values of the wrong type, raise
        InvalidArgument. The new values persist to a fresh OPTIONS file
        and the old one is removed, under the DB mutex so concurrent
        callers can't interleave the roll."""
        base = Options()
        for k, v in changes.items():
            if k not in self._MUTABLE_OPTIONS:
                raise InvalidArgument(f"option {k!r} is not dynamically "
                                      f"changeable")
            want = type(getattr(base, k))
            if want is bool:
                ok = isinstance(v, bool)
            elif want is int:
                ok = isinstance(v, int) and not isinstance(v, bool)
            elif want is float:
                ok = isinstance(v, (int, float)) and not isinstance(v, bool)
            else:
                ok = isinstance(v, want)
            if not ok:
                raise InvalidArgument(
                    f"option {k!r} expects {want.__name__}, "
                    f"got {type(v).__name__}"
                )
        with self._mutex:
            for k, v in changes.items():
                setattr(self.options, k, v)
            old = self._options_file_number
            self._persist_options()
            if old:
                try:
                    self.env.delete_file(
                        filename.options_file_name(self.dbname, old))
                except NotFound:
                    pass
        self._maybe_schedule_compaction()

    def get_property(self, name: str) -> str | None:
        """RocksDB's DB::GetProperty, under toplingdb_tpu's "tpulsm."
        names; None for a name it does not answer."""
        v = self.versions.current
        if name in ("tpulsm.stats", "tpulsm.levelstats"):
            lines = [f"last_seq={self.versions.last_sequence} "
                     f"mem_entries={self.mem.num_entries} imm={len(self.imm)}"]
            for level in range(v.num_levels):
                n = len(v.files[level])
                if n:
                    lines.append(
                        f"L{level}: {n} files {v.total_bytes(level)} bytes")
            return "\n".join(lines)
        if name == "tpulsm.num-files":
            return str(v.num_files())
        if name == "tpulsm.background-errors":
            return str(int(self._bg_error is not None))
        if name == "tpulsm.bg-error-severity":
            return self._bg_error_severity.name
        if name == "tpulsm.estimate-num-keys":
            # RocksDB's rocksdb.estimate-num-keys: live table entries minus
            # deletions plus memtable entries (overcounts overwrites).
            n = sum(
                max(0, m.num_entries - 2 * m.num_deletes)
                for c in self._cfs.values() for m in [c.mem] + c.imm
            )
            for cf_id in self.versions.column_families:
                for _, f in self.versions.cf_current(cf_id).all_files():
                    n += max(0, f.num_entries - 2 * f.num_deletions)
            return str(n)
        if name == "tpulsm.cur-size-all-mem-tables":
            return str(sum(
                c.mem.approximate_memory_usage()
                + sum(m.approximate_memory_usage() for m in c.imm)
                for c in self._cfs.values()
            ))
        if name == "tpulsm.num-snapshots":
            return str(self.snapshots.num_live())
        if name == "tpulsm.estimate-live-data-size":
            return str(sum(
                f.file_size
                for cf_id in self.versions.column_families
                for _, f in self.versions.cf_current(cf_id).all_files()
            ))
        if name == "tpulsm.num-running-compactions":
            s = self._compaction_scheduler
            return str(s._running if s is not None else 0)
        if name == "tpulsm.threads":
            return json.dumps(get_thread_list())
        if name.startswith("tpulsm.num-files-at-level"):
            try:
                lvl = int(name[len("tpulsm.num-files-at-level"):])
            except ValueError:
                return None
            return str(len(v.files[lvl])) if 0 <= lvl < v.num_levels else None
        return None

    def _check_open(self) -> None:
        if self._closed:
            raise ShutdownInProgress("DB is closed")
