"""Background compaction scheduling (copied from
toplingdb_tpu/compaction/scheduler.py, with the leveled, universal and
FIFO styles and the periodic trigger; the preclude-last-level policy and
the storage-pressure preflight come with later slices; the local-pin gate
is not ported, since no job falls back).

The role of RocksDB's MaybeScheduleFlushOrCompaction → BGWorkCompaction
chain (db/db_impl/db_impl_compaction_flush.cc): after every flush and
compaction the scores are re-evaluated and jobs run on a bounded pool of
background threads (named "tpt-compaction-bg"). Every job routes through
Options.compaction_executor_factory: the device executor (the default, on
the card) or, where the caller names LocalCompactionExecutorFactory, the
host compaction path. A failed device job raises; none falls back.
Column families are picked by descending top score (a fixed order would
starve the later CFs under load on an earlier one), and a manual
compaction runs over every CF in id order. A FIFO compaction only drops
files: a version edit and the obsolete-file sweep, with no executor. A
manual compaction of a universal DB is one job of every run into the last
level.

Every finished job reports as toplingdb_tpu's does: the compaction
tickers and histograms (`Statistics.record_compaction`), a
`compaction_finished` or `trivial_move` event-log line,
`on_compaction_completed` to the listeners, and a "compaction" root span
tagged with the job's mode while the DB has a tracer.
"""

from __future__ import annotations

import threading
import time
import traceback

from toplingdb_tpu_torch.compaction.compaction_job import (
    emit_phase_spans,
    make_version_edit,
    run_compaction_to_tables,
)
from toplingdb_tpu_torch.compaction.picker import Compaction, create_picker
from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.version_edit import VersionEdit
from toplingdb_tpu_torch.utils import telemetry as _tm
from toplingdb_tpu_torch.utils.listener import CompactionJobInfo, notify

THREAD_PREFIX = "tpt-"


class CompactionScheduler:
    def __init__(self, db):
        self.db = db
        self.picker = create_picker(db.options, db.icmp)
        # Age policies read creation_time from the table properties.
        self.picker.creation_time_fn = self._file_creation_time
        self._pending = 0
        self._running = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._shutdown = False
        self._manual_active = False
        self._threads: list[threading.Thread] = []
        self.last_error: BaseException | None = None
        self.num_trivial_moves = 0
        self.num_completed = 0
        # Jobs that ran the host compaction path (the factory's
        # should_run_local: LocalCompactionExecutorFactory).
        self.num_local_jobs = 0

    # ------------------------------------------------------------------

    def maybe_schedule(self) -> None:
        if self.db.options.disable_auto_compactions:
            return
        with self._lock:
            if self._shutdown or self._manual_active:
                return
            if self._running + self._pending >= self.db.options.max_background_jobs:
                return
            self._pending += 1
            self._threads = [t for t in self._threads if t.is_alive()]
            t = threading.Thread(target=self._bg_work, daemon=True,
                                 name=THREAD_PREFIX + "compaction-bg")
            self._threads.append(t)
        t.start()

    def _bg_work(self) -> None:
        # Keep running jobs in THIS thread until no work remains: _running
        # stays nonzero for the whole drain, so wait_idle() can never observe
        # a false idle gap between one job finishing and its follow-up being
        # scheduled.
        with self._lock:
            self._pending -= 1
            self._running += 1
        try:
            while True:
                with self._lock:
                    if self._shutdown or self._manual_active:
                        break
                if not self._run_one():
                    break
        except BaseException as e:
            # Surface to the DB's error handler: writes fail until resume()
            # (RocksDB's ErrorHandler, db/error_handler.h).
            self.last_error = e
            self.db._set_background_error(
                e, getattr(e, "_bg_reason", "compaction"))
            traceback.print_exc()
        finally:
            with self._lock:
                self._running -= 1
                self._cv.notify_all()

    def wait_idle(self) -> None:
        """Block until no compaction is running or pending."""
        with self._lock:
            while self._running or self._pending:
                self._cv.wait(timeout=0.1)

    def shutdown(self) -> None:
        """Stop scheduling, wait for running jobs, and join every
        background thread this scheduler started."""
        with self._lock:
            self._shutdown = True
        self.wait_idle()
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join()

    # ------------------------------------------------------------------

    def _file_creation_time(self, f):
        """Creation time from the table properties, memoized on the meta so
        the age sweeps never re-open files (a sweep across a big DB would
        otherwise thrash the table cache on every cycle)."""
        ct = getattr(f, "_creation_time_cache", None)
        if ct is not None:
            return ct or None  # 0: unreadable or absent before
        try:
            ct = self.db.table_cache.get_reader(f.number).properties \
                .creation_time
        except Exception as e:  # noqa: BLE001 - logged, file left alone
            self.db.event_logger.log(
                "creation_time_unreadable", file_number=f.number,
                error=repr(e),
            )
            ct = 0
        f._creation_time_cache = ct
        return ct or None

    def _apply_periodic_marking(self) -> None:
        """RocksDB's periodic_compaction_seconds: files past the age are
        marked so the picker rewrites them (the rewrite refreshes
        creation_time; 'bottommost marked' outputs suppress re-marks).
        Leveled style only: the universal and FIFO pickers do not read
        marked_for_compaction (FIFO ages out by fifo_ttl_seconds)."""
        db = self.db
        per = db.options.periodic_compaction_seconds
        if not per or db.options.compaction_style != "leveled":
            return
        cutoff = int(time.time()) - per
        with db._mutex:
            for cf_id in list(db.versions.column_families):
                v = db.versions.cf_current(cf_id)
                for lvl in range(v.num_levels):
                    for f in v.files[lvl]:
                        if f.marked_for_compaction or f.being_compacted:
                            continue
                        ct = self._file_creation_time(f)
                        if ct and ct <= cutoff:
                            f.marked_for_compaction = True

    def _pick(self):
        """(the next job over every CF, by descending top score, its input
        files marked busy; the Version it was picked from), or (None,
        None)."""
        db = self.db
        with db._mutex:
            scored = []
            for cf_id in db.versions.column_families:
                version = db.versions.cf_current(cf_id)
                scores = self.picker.compaction_score(version)
                top = scores[0][0] if scores else 0.0
                scored.append((top, cf_id, version))
            scored.sort(key=lambda s: -s[0])
            for top, cf_id, version in scored:
                if top < 1.0:
                    break
                c = self.picker.pick_compaction(version)
                if c is not None:
                    c.cf_id = cf_id
                    for _, f in c.all_inputs():
                        f.being_compacted = True
                    return c, version
        return None, None

    def _run_one(self) -> bool:
        db = self.db
        self._apply_periodic_marking()
        # The job holds the Version it was picked from, so its inputs stay
        # on disk while it reads them, even if its CF is dropped (RocksDB's
        # Compaction::input_version_).
        c, version = self._pick()
        if c is None:
            return False
        try:
            self._run_compaction(c)
        finally:
            with db._mutex:
                for _, f in c.all_inputs():
                    f.being_compacted = False
        del version
        # The job's own sweep ran while its Version was held: sweep again,
        # or what the job made obsolete (a FIFO drop's files) stays on
        # disk until the next flush or job.
        with db._mutex:
            db._delete_obsolete_files()
        with self._lock:
            self.num_completed += 1
        return True

    def _run_compaction(self, c: Compaction) -> None:
        db = self.db
        if not c.output_level_inputs and not c.inputs:
            return
        if c.reason.startswith("fifo"):
            # Deletion only.
            edit = make_version_edit(c, [])
            with db._mutex:
                db.versions.log_and_apply(edit)
                db._delete_obsolete_files()
            return

        def _bottom_move_ok(f) -> bool:
            # A bottommost rewrite exists to GC tombstones / fold merges;
            # a file with neither loses nothing by moving.
            if f.num_deletions or f.num_range_deletions:
                return False
            props = db.table_cache.get_reader(f.number).properties
            return props.num_merge_operands == 0

        if (len(c.inputs) == 1 and not c.output_level_inputs
                and c.level > 0 and c.output_level > c.level
                and db.options.compaction_filter is None
                and (not c.bottommost or _bottom_move_ok(c.inputs[0]))
                and not (db.options.enable_blob_garbage_collection
                         and c.inputs[0].blob_refs)):
            # Trivial move (RocksDB's Compaction::IsTrivialMove): nothing
            # overlaps below — just relocate the file's metadata, no
            # rewrite, no IO.
            meta = c.inputs[0]
            edit = VersionEdit(column_family=c.cf_id)
            edit.delete_file(c.level, meta.number)
            edit.add_file(c.output_level, meta)
            with db._mutex:
                db.versions.log_and_apply(edit)
            with self._lock:
                self.num_trivial_moves += 1
            db.event_logger.log(
                "trivial_move", file_number=meta.number,
                from_level=c.level, to_level=c.output_level,
            )
            notify(db.options.listeners, "on_compaction_completed", db,
                   CompactionJobInfo(
                       db_name=db.dbname, input_level=c.level,
                       output_level=c.output_level,
                       input_files=[meta.number], output_files=[meta.number],
                       input_records=meta.num_entries,
                       output_records=meta.num_entries,
                       elapsed_micros=0, device="move",
                       reason="trivial move",
                   ))
            return
        # Compactions are always traced while a tracer exists.
        root = (db.tracer.start(
            "compaction", level=c.level, output_level=c.output_level,
            reason=c.reason, cf_id=c.cf_id)
            if db.tracer is not None else _tm.NOOP_SPAN)
        try:
            self._run_compaction_traced(c, root)
        finally:
            root.finish()

    def _run_compaction_traced(self, c: Compaction, root) -> None:
        db = self.db
        snapshots = db.snapshots.sequences()
        pending: list[int] = []

        def alloc() -> int:
            # Protect in-flight outputs from obsolete-file GC until the
            # version edit lands (RocksDB's pending_outputs_).
            n = db.versions.new_file_number()
            with db._mutex:
                db._pending_outputs.add(n)
            pending.append(n)
            return n

        try:
            factory = db.options.compaction_executor_factory
            if factory.should_run_local(c):
                outputs, stats = self._run_local(c, snapshots, alloc)
            else:
                from toplingdb_tpu_torch.compaction.resilience import (
                    execute_resilient,
                )

                outputs, stats = execute_resilient(
                    db, factory, c, snapshots, alloc)
            root.tag(mode=self._compaction_mode(stats),
                     input_records=stats.input_records,
                     output_records=stats.output_records)
            emit_phase_spans(stats)
            if db.options.statistics is not None:
                db.options.statistics.record_compaction(stats)
            if c.reason == "bottommost marked":
                # The rewrite already dropped everything droppable; keeping a
                # collector re-mark would rewrite the same file forever while
                # snapshots pin its remaining tombstones.
                for m in outputs:
                    m.marked_for_compaction = False
            # Whole-file checksums ride into the MANIFEST with the install.
            db._stamp_file_checksums(outputs)
            edit = make_version_edit(c, outputs)
            with db._mutex:
                db.versions.log_and_apply(edit)
                db._delete_obsolete_files()
            db.event_logger.log(
                "compaction_finished", input_level=c.level,
                output_level=c.output_level, device=stats.device,
                input_records=stats.input_records,
                output_records=stats.output_records,
                input_bytes=stats.input_bytes, output_bytes=stats.output_bytes,
                micros=stats.work_time_usec, reason=c.reason,
            )
            notify(db.options.listeners, "on_compaction_completed", db,
                   CompactionJobInfo(
                       db_name=db.dbname, input_level=c.level,
                       output_level=c.output_level,
                       input_files=[f.number for _, f in c.all_inputs()],
                       output_files=[m.number for m in outputs],
                       input_records=stats.input_records,
                       output_records=stats.output_records,
                       elapsed_micros=stats.work_time_usec,
                       device=stats.device, reason=c.reason,
                   ))
        finally:
            with db._mutex:
                db._pending_outputs.difference_update(pending)

    @staticmethod
    def _compaction_mode(stats) -> str:
        """serial / columnar / device / pipelined / remote: the root span's
        `mode` tag."""
        if stats.remote:
            return "remote"
        if stats.pipelined:
            return "pipelined"
        if stats.device != "cpu":
            return "device"
        if stats.host_compute_usec or stats.encode_write_usec:
            return "columnar"
        return "serial"

    def _run_local(self, c: Compaction, snapshots, alloc):
        from toplingdb_tpu_torch.db.blob import maybe_new_blob_gc

        db = self.db
        with self._lock:
            self.num_local_jobs += 1
        return run_compaction_to_tables(
            db.env, db.dbname, db.icmp, c, db.table_cache,
            db.options.table_options_for_level(c.output_level, c.bottommost),
            snapshots,
            merge_operator=db.options.merge_operator,
            compaction_filter=db.options.compaction_filter,
            new_file_number=alloc,
            blob_resolver=db.blob_source.get,
            blob_gc=maybe_new_blob_gc(db, c, alloc),
            column_family=(c.cf_id, db.cf_name(c.cf_id)),
            max_subcompactions=db.options.max_subcompactions,
        )

    # ------------------------------------------------------------------

    def compact_range(self, begin: bytes | None, end: bytes | None) -> None:
        """Manual compaction: push overlapping files down level by level
        (RocksDB's DBImpl::CompactRange). Pauses auto scheduling while
        running so picks cannot race."""
        with self._lock:
            self._manual_active = True
        try:
            self.wait_idle()
            self._compact_range_impl(begin, end)
        finally:
            with self._lock:
                self._manual_active = False
        # The per-level loop's frame pinned the previous Version (weak-ref
        # lifetime) during the last install; sweep again now it's released.
        with self.db._mutex:
            self.db._delete_obsolete_files()
        self.maybe_schedule()

    def _compact_range_impl(self, begin: bytes | None,
                            end: bytes | None) -> None:
        for cf_id in sorted(self.db.versions.column_families):
            self._compact_range_cf(begin, end, cf_id)

    def _compact_range_cf(self, begin: bytes | None, end: bytes | None,
                          cf_id: int) -> None:
        db = self.db
        if cf_id not in db.versions.column_families:
            return  # dropped concurrently
        if db.options.compaction_style == "universal":
            self._manual_universal(cf_id)
            return
        version = db.versions.cf_current(cf_id)
        for level in range(0, version.num_levels - 1):
            with db._mutex:
                version = db.versions.cf_current(cf_id)
                if level == 0:
                    inputs = [f for f in version.files[0]
                              if not f.quarantined]
                else:
                    inputs = [
                        f for f in version.overlapping_files(level, begin, end)
                        if not f.quarantined
                    ]
                if not inputs:
                    continue
                smallest = min((f.smallest for f in inputs), key=db.icmp.sort_key)
                largest = max((f.largest for f in inputs), key=db.icmp.sort_key)
                su = dbformat.extract_user_key(smallest)
                lu = dbformat.extract_user_key(largest)
                outputs = version.overlapping_files(level + 1, su, lu)
                c = Compaction(
                    level=level, output_level=level + 1, inputs=inputs,
                    output_level_inputs=outputs,
                    bottommost=self.picker._is_bottommost(
                        version, level + 1, smallest, largest
                    ),
                    reason="manual",
                    max_output_file_size=db.options.target_file_size(level + 1),
                    cf_id=cf_id,
                    full_history_ts_low=db.options.full_history_ts_low,
                )
                for _, f in c.all_inputs():
                    f.being_compacted = True
            try:
                self._run_compaction(c)
            finally:
                with db._mutex:
                    for _, f in c.all_inputs():
                        f.being_compacted = False

    def _manual_universal(self, cf_id: int) -> None:
        """compact_range of a universal DB: every run of L0 and the last
        level's run merged into the last level, in one job."""
        db = self.db
        with db._mutex:
            version = db.versions.cf_current(cf_id)
            runs = [f for f in version.files[0] if not f.quarantined]
            last = version.num_levels - 1
            base = [f for f in version.files[last] if not f.quarantined]
            if not runs and not base:
                return
            c = Compaction(
                level=0, output_level=last, inputs=runs,
                output_level_inputs=base, bottommost=True,
                reason="manual universal", max_output_file_size=2**62,
                cf_id=cf_id,
                full_history_ts_low=db.options.full_history_ts_low,
            )
            for _, f in c.all_inputs():
                f.being_compacted = True
        try:
            self._run_compaction(c)
        finally:
            with db._mutex:
                for _, f in c.all_inputs():
                    f.being_compacted = False
