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
                into one WAL record and applied to the skiplist memtable
                in native calls (tpulsm_wb_group_commit). Groups it does
                not take (CF-prefixed records, range deletes,
                merge-heavy or wide-column batches, the vector rep) run
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
the span tracer (`trace_sample_every` / `trace_slow_usec` / `trace_ring`).
On open, job dirs of dcompact workers whose lease expired are swept from
`<db>/dcompact`. What toplingdb_tpu runs beyond this (the staged write
modes, the SLO engine, ...) is refused at open:
`options.unported_fields` lists it and DB.open raises NotSupported instead
of ignoring it.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

from toplingdb_tpu_torch.db import dbformat, filename
from toplingdb_tpu_torch.db.blob import BlobSource
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
from toplingdb_tpu_torch.utils.status import (
    Corruption,
    InvalidArgument,
    IOError_,
    NotFound,
    NotSupported,
    Severity,
    ShutdownInProgress,
    is_no_space,
)

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

    __slots__ = ("batch", "opts", "done", "error", "event", "parallel",
                 "pg", "pg_mems")

    def __init__(self, batch: WriteBatch, opts: WriteOptions):
        self.batch = batch
        self.opts = opts
        self.done = False
        self.error: BaseException | None = None
        self.event = threading.Event()
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
        self.lock = threading.Lock()

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
    ColumnFamilyData)."""

    __slots__ = ("handle", "mem", "imm")

    def __init__(self, handle: ColumnFamilyHandle, icmp, rep_name: str,
                 protection_bytes: int = 0):
        self.handle = handle
        self.mem = MemTable(icmp, create_memtable_rep(rep_name),
                            protection_bytes=protection_bytes)
        self.imm: list[MemTable] = []


class _NGetState:
    """Per-thread bound state of the native point-read chain: the native
    context (it owns the out and value buffers), their mapped views, and
    strong refs to the memtables and the version whose handles the context
    embeds (compared by identity to notice a memtable switch or a version
    install, and keeping those handles alive while this thread holds
    them)."""

    __slots__ = ("mem", "imm", "version", "ctx", "fn", "out",
                 "val_ptr", "val_cap", "_lib", "fast")

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
    def build(cls, lib, mem, imm, version, table_cache):
        import ctypes

        from toplingdb_tpu_torch import native

        handles = []
        kinds = []
        for m in [mem] + imm:
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
        s.mem = mem
        s.imm = list(imm)
        s.version = version
        s.ctx = ctx
        s.fn = lib.tpulsm_getctx_get
        s.out = (ctypes.c_int64 * 8).from_address(
            lib.tpulsm_getctx_out(ctx))
        s.val_ptr = lib.tpulsm_getctx_val(ctx)
        s.val_cap = 4096
        s._lib = lib
        # The C-extension call (ctypes marshaling is a large share of a
        # warm get); None keeps the ctypes call in charge.
        s.fast = native.fastget()
        return s


class DB:
    """LSM engine instance. Use DB.open()."""

    def __init__(self, dbname: str, options: Options, env,
                 write_plane: bool = True,
                 iter_chunk_rows: int = DEFAULT_CHUNK):
        self.dbname = dbname
        self.options = options
        self.env = env
        # The host planes (see the module docstring); DB.open refused a
        # plane asked for without the native library.
        from toplingdb_tpu_torch import native

        lib = native.lib()
        self._write_plane = (lib.tpulsm_wb_group_commit
                             if write_plane and lib is not None else None)
        self.iter_chunk_rows = iter_chunk_rows
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
                                      options.table_options)
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
        self._mutex = threading.RLock()
        self._writers: list[_Writer] = []  # FIFO write queue (leader = [0])
        self._wq_lock = threading.Lock()
        self._wal: LogWriter | None = None
        self._wal_number = 0
        self._closed = False
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
        self._file_deletions_disabled = 0  # DisableFileDeletions pin count
        self._stats_persist_seq = 0  # suffix of persisted stats keys
        self.num_flushes = 0  # L0 tables written by flushes
        self.identity = ""
        self._init_observability()

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
             iter_chunk_rows: int = DEFAULT_CHUNK) -> "DB":
        """RocksDB's DBImpl::Open: create or recover the DB at `dbname`.
        Raises NotSupported for an option set away from its default that
        the port does not run (options.unported_fields), and for a host
        plane asked for without the native library. `write_plane` is
        toplingdb_tpu's TPULSM_WRITE_PLANE (the native group commit);
        `iter_chunk_rows` its TPULSM_ITER_CHUNK (rows per scan-plane
        chunk, 0 = no scan plane). The defaults are toplingdb_tpu's."""
        options = options or Options()
        refused = unported_fields(options)
        if refused:
            raise NotSupported(
                "the port's DB does not run " + "; ".join(
                    f"Options.{name} ({why})" for name, why in refused))
        if not isinstance(iter_chunk_rows, int) or iter_chunk_rows < 0:
            raise InvalidArgument(
                f"iter_chunk_rows must be an int >= 0, got "
                f"{iter_chunk_rows!r}")
        from toplingdb_tpu_torch import native

        planes = [name for name, on in (
            ("the native write plane (write_plane=True)", write_plane),
            ("the chunked scan plane (iter_chunk_rows > 0)",
             iter_chunk_rows > 0)) if on]
        if planes and native.lib() is None:
            raise NotSupported(
                " and ".join(planes) + " needs the port's native library, "
                "which could not be built or loaded (g++ missing?)")
        env = env or default_env()
        # Validates; touches no file.
        db = DB(dbname, options, env, write_plane=write_plane,
                iter_chunk_rows=iter_chunk_rows)
        env.create_dir(dbname)
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
        db._new_wal()
        db._persist_options()
        db._delete_obsolete_files()
        db._sweep_orphan_jobs()
        from toplingdb_tpu_torch.compaction.scheduler import (
            CompactionScheduler,
        )

        db._compaction_scheduler = CompactionScheduler(db)
        db._start_stats_threads()
        db._maybe_schedule_compaction()
        if options.integrity_scrub_period_sec > 0:
            from toplingdb_tpu_torch.db.integrity import IntegrityScrubber

            db._integrity_scrubber = IntegrityScrubber(db)
            db._integrity_scrubber.start()
        return db

    def _persist_options(self) -> None:
        """Write OPTIONS-NNNNNN next to the DB (RocksDB persists its options
        on every open); older OPTIONS files become obsolete. The file holds
        the scalar fields as JSON."""
        num = self.versions.new_file_number()
        fields = {
            k: v for k, v in vars(self.options).items()
            if isinstance(v, (bool, int, float, str)) or v is None
        }
        self.env.write_file(filename.options_file_name(self.dbname, num),
                            json.dumps(fields, sort_keys=True).encode())
        self._options_file_number = num

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
                any_flushed = True
        if any_flushed:
            # One log_number advance once every CF is durable.
            self.versions.log_and_apply(
                VersionEdit(log_number=self.versions.next_file_number)
            )

    def _materialize_cfs(self) -> None:
        """Build per-CF memtable state from the recovered VersionSet."""
        for cf_id, st in self.versions.column_families.items():
            if cf_id not in self._cfs:
                h = ColumnFamilyHandle(cf_id, st.name)
                self._cfs[cf_id] = _CFData(h, self.icmp,
                                           self.options.memtable_rep,
                                           protection_bytes=self._protection)

    def _fresh_memtable(self) -> MemTable:
        return MemTable(self.icmp,
                        create_memtable_rep(self.options.memtable_rep),
                        protection_bytes=self._protection)

    def _new_wal(self) -> None:
        self._wal_number = self.versions.new_file_number()
        path = filename.log_file_name(self.dbname, self._wal_number)
        self._wal = LogWriter(self.env.new_writable_file(path),
                              log_number=self._wal_number)

    def close(self) -> None:
        """Stop the background compactions (joining their threads), flush
        the memtables, and close the WAL, the MANIFEST and the readers."""
        self._recover_stop.set()
        for t in (self._integrity_scrubber, self._stats_dumper,
                  self._stats_dump_thread):
            if t is not None:
                t.stop()
        if self._compaction_scheduler is not None:
            self._compaction_scheduler.shutdown()
        for t in self._recover_threads:
            t.join(timeout=10.0)
        with self._mutex:
            if self._closed:
                return
            if any(not c.mem.empty() or c.imm for c in self._cfs.values()):
                self.flush(FlushOptions())
            if self._wal is not None:
                self._wal.sync()
                self._wal.close()
            self.versions.close()
            self.table_cache.close()
            self.blob_source.close()
            if self._log_file is not None:
                self._log_file.close()
            self._closed = True

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
            self._cfs[cf_id] = _CFData(h, self.icmp,
                                       self.options.memtable_rep,
                                       protection_bytes=self._protection)
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

    def put(self, key: bytes, value: bytes, opts: WriteOptions = _DEFAULT_WRITE,
            cf=None) -> int:
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.put(key, value, cf=self._cf_id(cf))
        return self.write(b, opts)

    def delete(self, key: bytes, opts: WriteOptions = _DEFAULT_WRITE,
               cf=None) -> int:
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.delete(key, cf=self._cf_id(cf))
        return self.write(b, opts)

    def single_delete(self, key: bytes, opts: WriteOptions = _DEFAULT_WRITE,
                      cf=None) -> int:
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.single_delete(key, cf=self._cf_id(cf))
        return self.write(b, opts)

    def merge(self, key: bytes, value: bytes,
              opts: WriteOptions = _DEFAULT_WRITE, cf=None) -> int:
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.merge(key, value, cf=self._cf_id(cf))
        return self.write(b, opts)

    def delete_range(self, begin: bytes, end: bytes,
                     opts: WriteOptions = _DEFAULT_WRITE, cf=None) -> int:
        b = WriteBatch(protection_bytes_per_key=self._protection)
        b.delete_range(begin, end, cf=self._cf_id(cf))
        return self.write(b, opts)

    def write(self, batch: WriteBatch,
              opts: WriteOptions = _DEFAULT_WRITE) -> int:
        """Group-commit write path (RocksDB's DBImpl::WriteImpl +
        WriteThread::JoinBatchGroup): concurrent writers queue up; the
        front writer leads, merging the queue into one WAL append + one
        fsync, then applies every batch to the memtable and publishes the
        group's last sequence at once. Returns this batch's LAST sequence
        number."""
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
            return self._write_impl(batch, opts)
        t0 = time.perf_counter()
        try:
            return self._write_impl(batch, opts)
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

    def _write_impl(self, batch: WriteBatch, opts: WriteOptions) -> int:
        self._maybe_stall_writes()
        w = _Writer(batch, opts)
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

    def _append_group_wal(self, group: list[_Writer], first_seq: int) -> None:
        """WAL append for one group through the Python encoder (caller
        holds _mutex): one record, the merged batch of every member."""
        if len(group) == 1:
            rec = group[0].batch.data()
        else:
            merged = WriteBatch()
            merged.set_sequence(first_seq)
            for w in group:
                merged.append_from(w.batch)
            rec = merged.data()
        self._wal.add_record(rec)
        self._group_wal_durability(group, len(rec))

    def _group_wal_durability(self, group: list[_Writer],
                              rec_len: int) -> None:
        """The durability tail of both WAL encoders (the Python merge and
        the native plane): stats ticks, then the sync or flush."""
        stats = self.stats
        if stats is not None:
            stats.record_tick(_st.WAL_BYTES, rec_len)
            stats.record_tick(_st.WRITE_WITH_WAL, len(group))
        if _st.perf_level:
            _st.perf_context().wal_write_bytes += rec_len
        if any(w.opts.sync for w in group):
            t_sync = time.perf_counter() if stats is not None else 0
            self._wal.sync()
            if stats is not None:
                stats.record_tick(_st.WAL_SYNCS)
                stats.record_in_histogram(
                    _st.WAL_FILE_SYNC_MICROS,
                    (time.perf_counter() - t_sync) * 1e6)
        else:
            self._wal.flush()

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
        settles durability, then returns the memtable phase as a zero-arg
        callable (the insert skips re-validation: the frame call just
        proved these exact buffers). frame=False (WAL off for this group):
        validates and inserts in ONE call and returns True.
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
            return True if insert(validated=False) is not None else None
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
        self._group_wal_durability(group, int(out[4]))
        return insert

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
            first_seq = self.versions.last_sequence + 1
            seq = first_seq
            for w in group:
                w.batch.set_sequence(seq)
                seq += w.batch.count()
            mems = {cf_id: cfd.mem for cf_id, cfd in self._cfs.items()}
            # The native plane frames and appends the merged WAL record
            # first (a WAL failure inserts nothing, as on the Python path),
            # then applies the whole group to the memtable in one call.
            wal_on = (self.options.wal_enabled
                      and not group[0].opts.disable_wal)
            with _tm.span("write.wal_frame", group=len(group), wal=wal_on):
                plane = self._native_group_commit(group, first_seq, mems,
                                                  frame=wal_on)
                if plane is None and wal_on:
                    self._append_group_wal(group, first_seq)
            _mt0 = time.perf_counter() if _st.perf_level >= 2 else 0.0
            if plane is None:
                with _tm.span("write.memtable_apply", group=len(group),
                              native=False):
                    self._apply_group(group, mems)
            elif plane is not True:
                with _tm.span("write.memtable_apply", group=len(group),
                              native=True):
                    plane()
            if _mt0:
                _st.perf_context().write_memtable_time += int(
                    (time.perf_counter() - _mt0) * 1e9)
            self._tick_write_group(group, native=plane is not None)
            self.versions.last_sequence = seq - 1
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
            # The write buffer budget covers every CF's active memtable.
            total_mem = sum(c.mem.approximate_memory_usage()
                            for c in self._cfs.values())
            if total_mem >= self.options.write_buffer_size:
                self._switch_memtable()
                self._flush_immutables()

    def _apply_group(self, group: list[_Writer], mems) -> None:
        """The group's memtable phase into `mems` ({cf_id: memtable}; the
        caller holds _mutex, so no memtable switch can race it)."""
        if self.options.allow_concurrent_memtable_write and len(group) > 1:
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
        if self._wal is not None:
            self._wal.sync()
            self._wal.close()
        for cfd in self._cfs.values():
            if not cfd.mem.empty():
                cfd.imm.insert(0, cfd.mem)
                cfd.mem = self._fresh_memtable()
        self._new_wal()

    def _flush_immutables(self) -> None:
        flushed = False
        for cf_id, cfd in self._cfs.items():
            if not cfd.imm:
                continue
            self._flush_memtables(list(cfd.imm), wal_number=None,
                                  cf_id=cf_id)
            cfd.imm = []
            flushed = True
        if flushed:
            # Advance log_number only after EVERY CF's data below the
            # current WAL is durable in SSTs: a crash mid-flush must still
            # replay the old WALs for the CFs not yet flushed.
            self.versions.log_and_apply(
                VersionEdit(log_number=self._wal_number))
            self._delete_obsolete_files()
            self._maybe_schedule_compaction()

    def _flush_memtables(self, mems: list[MemTable], wal_number: int | None,
                         cf_id: int = 0) -> None:
        # Flushes are rare and high-value: always traced while a tracer
        # exists (sampling applies to the per-op read / write roots only).
        root = (self.tracer.start("flush", cf_id=cf_id, memtables=len(mems))
                if self.tracer is not None else _tm.NOOP_SPAN)
        try:
            self._flush_memtables_traced(mems, wal_number, cf_id)
        finally:
            root.finish()

    def _flush_memtables_traced(self, mems: list[MemTable],
                                wal_number: int | None, cf_id: int) -> None:
        t0 = time.time()
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
            self.versions.log_and_apply(edit)
        finally:
            self._pending_outputs.discard(fnum)
            if blob_num is not None:
                self._pending_outputs.discard(blob_num)
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

    def _stamp_file_checksums(self, metas) -> None:
        """Record whole-file checksums on freshly produced SST metadata
        before it reaches the MANIFEST (flush and compaction install)."""
        factory = self._file_checksum_factory
        if factory is None:
            return
        from toplingdb_tpu_torch.utils.file_checksum import (
            stamp_file_checksum,
        )

        for meta in metas:
            stamp_file_checksum(
                self.env, filename.table_file_name(self.dbname, meta.number),
                meta, factory)

    # ==================================================================
    # Read path
    # ==================================================================

    def _nget_state(self, cfd, opts):
        """The native chain's eligibility gate and this thread's call
        state for CF `cfd`: (lib, state), state None when the Python chain
        must run. The state is PER-THREAD (the context's out and value
        buffers are written inside a GIL-released call), one per CF, and
        keyed by the identity of (active memtable, immutables, version); it
        holds refs to them, so a flush or a compaction that installs a new
        version makes the next get rebuild it while the old handles live on
        with the old state."""
        lib = self._nget_lib
        if lib is None or opts.just_check_key_exists:
            return lib, None
        mem = cfd.mem
        if mem._range_dels:
            # The ACTIVE memtable mutates under a cached state, so this
            # check runs per call; immutables are frozen and are vetted
            # once, when the state is built.
            return lib, None
        imm = cfd.imm
        version = self.versions.cf_current(cfd.handle.id)
        tl = self._nget_tl
        try:
            states = tl.states
        except AttributeError:
            states = tl.states = {}
        cc = states.get(cfd.handle.id)
        if cc is not None and cc.mem is mem and cc.version is version \
                and cc.imm == imm:
            return lib, cc
        if any(m._range_dels for m in imm):
            return lib, None
        cc = _NGetState.build(lib, mem, imm, version, self.table_cache)
        if cc is None:
            return lib, None
        states[cfd.handle.id] = cc
        return lib, cc

    def _native_get(self, cfd, key: bytes, snap_seq: int, opts):
        """One-call native point lookup (RocksDB's GetImpl chain in one
        GIL-released call: DBImpl::GetImpl → Version::Get →
        BlockBasedTable::Get). Returns (handled, value, src): handled=False
        → run the Python chain (ineligible, or the native walk met
        something only the Python state machine handles). The value and
        the counters are read from context-owned memory mapped once."""
        # Inlined steady-state check (one cached-state hit per get is the
        # common case; _nget_state handles every slow or ineligible path).
        mem = cfd.mem
        cc = None
        if opts is _DEFAULT_READ and not mem._range_dels:
            states = getattr(self._nget_tl, "states", None)
            if states is not None:
                cc = states.get(cfd.handle.id)
                if cc is not None and (
                        cc.mem is not mem
                        or cc.version is not self.versions.cf_current(
                            cfd.handle.id)
                        or cc.imm != cfd.imm):
                    cc = None
        if cc is None:
            _lib, cc = self._nget_state(cfd, opts)
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
                    ctx: GetContext) -> bool:
        """One SST source; returns False when the lookup is complete."""
        ucmp = self.icmp.user_comparator
        for b, e in reader.range_del_entries():
            t = RangeTombstone.from_table_entry(b, e)
            if ucmp.compare(t.begin, key) <= 0 and ucmp.compare(key, t.end) < 0:
                ctx.add_tombstone_seq(t.seq)
        has_filter = (getattr(reader, "_filter_data", None) is not None
                      or getattr(reader, "_filter_top", None) is not None)
        if not reader.key_may_match(key):
            if self.stats is not None:
                self.stats.record_tick(_st.BLOOM_USEFUL)
            if _st.perf_level:
                _st.perf_context().bloom_sst_miss_count += 1
            return True
        if has_filter and _st.perf_level:
            # Only a consulted filter counts (fail-open paths don't).
            _st.perf_context().bloom_sst_hit_count += 1
        it = reader.new_iterator()
        if getattr(reader, "has_hash_index", False):
            # O(1) bucket probe (hash-indexed formats): lands on the newest
            # version; the loop below skips seqs above the snapshot.
            ordinal = reader.hash_probe(key)
            if ordinal is None:
                return True  # definitively absent from this file
            it.seek_ordinal(ordinal)
        else:
            it.seek(dbformat.make_internal_key(
                key, snap_seq, dbformat.VALUE_TYPE_FOR_SEEK
            ))
        while it.valid():
            uk, seq, t = dbformat.split_internal_key(it.key())
            if ucmp.compare(uk, key) != 0:
                break
            if seq <= snap_seq:
                if not ctx.save_value(seq, t, it.value()):
                    return False
            it.next()
        return True

    def get(self, key: bytes, opts: ReadOptions = _DEFAULT_READ,
            cf=None) -> bytes | None:
        """Point lookup (RocksDB's DBImpl::GetImpl). Returns None if not
        found. A wide-column entity presents as its anonymous default
        column."""
        sched = self._trace_sched
        if sched is not None:
            m = sched()
            if m:
                return self._get_traced(key, opts, cf, m == 1)
        return self._get_impl(key, opts, cf)

    def _get_traced(self, key: bytes, opts, cf, sampled: bool):
        """The rare half of get(): a sampled root span, or the slow-watch
        backstop when trace_slow_usec is set."""
        tracer = self.tracer
        root = tracer.start("db.get") if sampled else None
        t0 = 0.0 if sampled else time.perf_counter()
        try:
            return self._get_impl(key, opts, cf)
        finally:
            if root is not None:
                root.finish()
            else:
                us = (time.perf_counter() - t0) * 1e6
                if us >= tracer.slow_usec:
                    tracer.note_slow("db.get", us)

    def _get_impl(self, key: bytes, opts: ReadOptions, cf) -> bytes | None:
        self._check_open()
        self._check_read_options(opts)
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
        # tombstones, wide-column entities) falls through below.
        handled, val, src = self._native_get(cfd, key, snap_seq, opts)
        if handled:
            if st_on:
                self._record_get_stats(t0, val, src)
            return val
        ctx = GetContext(key, snap_seq, self.options.merge_operator,
                         blob_resolver=self.blob_source.get)
        # 1. Active memtable, then immutables (newest first).
        for mem in [cfd.mem] + cfd.imm:
            if not self._probe_memtable(mem, key, snap_seq, ctx):
                if st_on:
                    self._record_get_stats(t0, ctx.result(), "mem")
                return self._result(ctx)
        # 2. SST files, newest data first.
        version = self.versions.cf_current(cfd.handle.id)
        hit_level = None
        for level, f in version.files_for_get(key):
            reader = self.table_cache.get_reader(f.number)
            if not self._probe_file(reader, key, snap_seq, ctx):
                hit_level = level
                break
        else:
            ctx.finish()
        if st_on:
            self._record_get_stats(t0, ctx.result(), hit_level)
        return self._result(ctx)

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

    def _check_read_options(self, opts: ReadOptions) -> None:
        for name in ("tailing", "prefix_same_as_start", "async_io"):
            if getattr(opts, name):
                raise NotSupported(
                    f"ReadOptions.{name} is not ported yet")
        if opts.timestamp is not None:
            raise NotSupported("ReadOptions.timestamp is not ported yet")
        if opts.readahead_size:
            raise NotSupported(
                "ReadOptions.readahead_size is not ported yet")

    def new_iterator(self, opts: ReadOptions = _DEFAULT_READ,
                     cf=None) -> DBIter:
        """MVCC iterator over the whole keyspace of CF `cf` (RocksDB's
        DBImpl::NewIterator → DBIter over a MergingIterator)."""
        self._check_open()
        self._check_read_options(opts)
        cfd = self._cf_data(cf)
        with self._mutex:
            snap_seq = (
                opts.snapshot.sequence if opts.snapshot is not None
                else self.versions.last_sequence
            )
            version = self.versions.cf_current(cfd.handle.id)
            children = []
            rd = RangeDelAggregator(self.icmp.user_comparator)
            for mem in [cfd.mem] + cfd.imm:
                children.append(mem.new_iterator())
                for seq, begin, end in mem.range_del_entries():
                    rd.add(RangeTombstone(seq, begin, end))
            for f in version.files[0]:
                reader = self.table_cache.get_reader(f.number)
                children.append(reader.new_iterator())
                for b, e in reader.range_del_entries():
                    rd.add(RangeTombstone.from_table_entry(b, e))
            for level in range(1, version.num_levels):
                if version.files[level]:
                    children.append(LevelIterator(
                        self.table_cache, version.files[level], self.icmp))
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
            )
            # The chunked scan plane (ops/scan_plane.py): native block
            # decode + k-way merge for forward scans; None when the
            # iterator's shape is ineligible (the per-entry path runs).
            plane = make_scan_plane(
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
                stats=self.stats,
                chunk=self.iter_chunk_rows,
                protection_bytes=self._protection,
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
            return it

    def get_snapshot(self):
        return self.snapshots.new_snapshot(self.versions.last_sequence)

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
            t = threading.Thread(target=self._auto_recover_loop, args=(e,),
                                 daemon=True, name="tpt-auto-recover")
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
        error's identity the same way). Background work reruns on the same
        compaction executor; nothing falls back to another path."""
        attempt = 0
        backoff = 0
        while attempt < max_attempts:
            if self._recover_stop.wait(
                    min(base_delay * (2 ** min(backoff, 8)), 2.0)):
                return  # the DB is closing
            backoff += 1
            with self._mutex:
                if self._closed or self._bg_error is not target:
                    return
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
        off): stalling a bulk load forever helps no one."""
        opts = self.options
        if opts.disable_auto_compactions or self._compaction_scheduler is None:
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
            self._account_stall(stalled)
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
            self._account_stall(delay)

    def _account_stall(self, stalled_s: float) -> None:
        """One stall episode: the STALL_MICROS / WRITE_STALL_COUNT tickers
        and the write-stall histogram."""
        if self.stats is not None:
            micros = int(stalled_s * 1e6)
            self.stats.record_tick(_st.STALL_MICROS, micros)
            self.stats.record_tick(_st.WRITE_STALL_COUNT)
            self.stats.record_in_histogram(_st.WRITE_STALL_MICROS_HIST,
                                           micros)

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

    def _delete_obsolete_files(self) -> None:
        """GC: remove WALs below the manifest log number, SSTs no CF's
        live versions hold, stale MANIFESTs and OPTIONS files (RocksDB's
        DBImpl::DeleteObsoleteFiles)."""
        if self._file_deletions_disabled:
            return  # an export is pinning the file set
        live, live_blobs = self.versions.live_file_sets()
        for child in self.env.get_children(self.dbname):
            ftype, num = filename.parse_file_name(child)
            keep = True
            if ftype == filename.FileType.WAL:
                keep = (num >= self.versions.log_number
                        or num == self._wal_number)
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
                if ftype == filename.FileType.TABLE:
                    self.table_cache.evict(num)
                elif ftype == filename.FileType.BLOB:
                    self.blob_source.evict(num)
                try:
                    self.env.delete_file(f"{self.dbname}/{child}")
                except NotFound:
                    pass

    def _check_open(self) -> None:
        if self._closed:
            raise ShutdownInProgress("DB is closed")
