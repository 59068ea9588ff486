"""CompactionJob: execute one picked compaction (copied from
toplingdb_tpu/compaction/compaction_job.py).

The job is split into stages shared by the CPU path here and the device
path (ops/device_compaction.py), so both write byte-identical outputs:

  collect_inputs()              open input files, gather range tombstones
  CompactionIterator / device   the data plane (survivor stream)
  build_outputs()               output-file cutting + table building

`run_compaction_to_tables` is the CPU path (RocksDB's CompactionJob::
RunLocal → ProcessKeyValueCompaction): a heap merge through the
CompactionIterator, split into subcompactions on threads when asked.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass

from toplingdb_tpu_torch.compaction.compaction_iterator import (
    CompactionIterator,
)
from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db import dbformat, filename
from toplingdb_tpu_torch.db.blob import decode_blob_index
from toplingdb_tpu_torch.db.level_iterator import LevelIterator
from toplingdb_tpu_torch.db.range_del import (
    RangeDelAggregator,
    RangeTombstone,
    fragment_tombstones,
)
from toplingdb_tpu_torch.db.version_edit import FileMetaData, VersionEdit
from toplingdb_tpu_torch.table.merging_iterator import MergingIterator
from toplingdb_tpu_torch.table.factory import new_table_builder, open_table
from toplingdb_tpu_torch.utils import protection
from toplingdb_tpu_torch.utils.status import Corruption, NotFound
from toplingdb_tpu_torch.utils import concurrency as ccy


@dataclass
class CompactionStats:
    """Per-job stats (reference CompactionJobStats / CompactionResults
    timing fields, compaction_executor.h:120-158)."""

    input_records: int = 0
    output_records: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    output_files: int = 0
    input_files: int = 0
    dropped_obsolete: int = 0
    dropped_tombstone: int = 0
    merged_records: int = 0
    work_time_usec: int = 0
    rpc_time_usec: int = 0      # transport time for remote jobs (curl role)
    prepare_time_usec: int = 0  # params serde + job-dir/open setup (worker)
    waiting_time_usec: int = 0  # queue wait before the job ran (worker)
    transfer_time_usec: int = 0  # host<->device upload+download (device jobs)
    # Phase breakdown of work_time (the CompactionResults timing split,
    # extended with device-plane phases). Phases can OVERLAP under the streamed shard
    # path (device wait happens inside the encode loop), so they need not sum
    # to work_time_usec.
    input_scan_usec: int = 0    # SST read + block decode into columnar bufs
    host_compute_usec: int = 0  # host-twin sort+GC (accelerator-less mode)
    device_wait_usec: int = 0   # blocking waits on device compute + D2H
    resolve_usec: int = 0       # host complex-group (merge/SD) resolution
    encode_write_usec: int = 0  # SST block build + frame + file write
    finish_usec: int = 0        # trailer decode, zero-seq patch, output metas
    pipeline_stall_usec: int = 0  # writer starved waiting on compute chunks
    prefetch_hits: int = 0      # input-scan reads served from readahead
    prefetch_misses: int = 0    # input-scan reads that went to the file
    device: str = "cpu"
    remote: bool = False        # ran in a worker process (dcompact)
    pipelined: bool = False     # ran the 3-stage pipeline (ops/pipeline.py)
    # Mesh plane (ops/mesh_compaction.py): >1 chips means the job's
    # key-range shards fanned out over a device mesh; fallbacks counts
    # eligibility misses while the knob was on PLUS mid-job chip
    # demotions (a wedged chip's shards re-ran on the survivors).
    mesh_chips: int = 0
    mesh_shards: int = 0
    mesh_fallbacks: int = 0
    # SST payload bytes that crossed the job transport (storage/: 0 when
    # the worker resolved inputs from the shared store and published its
    # outputs back — the job shipped only metadata).
    sst_bytes_shipped: int = 0

    def phase_dict(self) -> dict:
        """Non-zero timing phases, seconds — for bench/dcompact reporting.
        Includes an `other_s` residual (clamped at 0) so the phases sum to
        at least work_time_s: wall the named
        timers missed is reported, not hidden. Under the pipelined and
        streamed-shard paths the stages run concurrently, so the named
        phases OVER-count wall time; that over-count is reported
        explicitly as `pipeline_overlap_s` = sum(phases) - wall — the
        wall-clock the pipeline saved versus running the phases back to
        back."""
        out = {}
        accounted = 0
        for f in ("input_scan_usec", "host_compute_usec",
                  "transfer_time_usec", "device_wait_usec", "resolve_usec",
                  "encode_write_usec", "finish_usec", "pipeline_stall_usec",
                  "work_time_usec"):
            v = getattr(self, f)
            if v:
                out[f.replace("_usec", "_s")] = round(v / 1e6, 3)
                if f != "work_time_usec":
                    accounted += v
        resid = self.work_time_usec - accounted
        if self.work_time_usec:
            out["other_s"] = round(max(0, resid) / 1e6, 3)
            if resid < 0:
                out["pipeline_overlap_s"] = round(-resid / 1e6, 3)
        return out


# Stats phase field → telemetry span name: every route reports its
# interior through CompactionStats, so one synthesis point gives each a
# stage waterfall (a dcompact worker emits them under its own root).
_PHASE_SPANS = (
    ("waiting_time_usec", "compaction.queue_wait"),
    ("prepare_time_usec", "compaction.prepare"),
    ("input_scan_usec", "compaction.input_scan"),
    ("host_compute_usec", "compaction.compute"),
    ("transfer_time_usec", "compaction.transfer"),
    ("device_wait_usec", "compaction.device_wait"),
    ("resolve_usec", "compaction.resolve"),
    ("encode_write_usec", "compaction.encode_write"),
    ("rpc_time_usec", "compaction.rpc"),
)


def emit_phase_spans(stats) -> None:
    """Pre-finished child spans from a CompactionStats phase breakdown,
    attached under the calling thread's active span (no-op untraced)."""
    from toplingdb_tpu_torch.utils import telemetry

    for field, name in _PHASE_SPANS:
        v = getattr(stats, field, 0)
        if v:
            telemetry.span_event(name, v)


def surviving_tombstone_fragments(rd: RangeDelAggregator,
                                  snapshots: list[int], bottommost: bool,
                                  ucmp):
    """Tombstones that must be written to outputs. At the bottommost level a
    fragment is droppable only in snapshot stripe 0 (same rule as point
    DELETIONs); newer-than-a-snapshot tombstones must be kept or they would
    resurrect older kept entries."""
    if rd.empty():
        return []
    snaps = sorted(snapshots)
    frags = fragment_tombstones(rd.tombstones(), ucmp)
    if bottommost:
        return [f for f in frags if bisect.bisect_left(snaps, f.seq) > 0]
    return frags


def _delete_quietly(env, path: str) -> None:
    try:
        env.delete_file(path)
    except (NotFound, OSError):
        pass  # best-effort cleanup; the job's own error propagates


def verify_output_table(env, path: str, icmp, table_options,
                        expected: dict, expected_entries: int) -> None:
    """Per-entry protection check of one output SST (RocksDB's
    paranoid_file_checks with per-entry checksums): re-read the file from
    disk, checksums verified, and match every entry against the multiset
    `expected` (truncated protect_entry checksum → count) of the entries
    meant for it. Raises Corruption when a writer altered a key or a
    value, or when the entry counts differ."""
    import dataclasses

    pb = table_options.protection_bytes_per_key
    topts = dataclasses.replace(table_options, verify_checksums=True)
    reader = open_table(env.new_random_access_file(path), icmp, topts)
    try:
        remaining = dict(expected)
        n = 0
        it = reader.new_iterator()
        it.seek_to_first()
        for ikey, val in it.entries():
            uk, _seq, t = dbformat.split_internal_key(ikey)
            cs = protection.truncate(protection.protect_entry(t, uk, val),
                                     pb)
            left = remaining.get(cs, 0)
            if left <= 0:
                raise Corruption(
                    f"compaction output {path}: entry {uk!r} (type {t}) "
                    "does not match any emitted survivor — output bytes "
                    "corrupted by the write plane")
            remaining[cs] = left - 1
            n += 1
        if n != expected_entries:
            raise Corruption(
                f"compaction output {path}: {n} entries on disk, "
                f"{expected_entries} emitted")
    finally:
        reader.close()


def build_outputs(env, dbname: str, icmp, compaction: Compaction,
                  entries_iter, surviving_tombstones, new_file_number,
                  table_options, stats: CompactionStats,
                  creation_time: int,
                  column_family: tuple[int, str] = (0, "default"),
                  ) -> list[FileMetaData]:
    """Cut the survivor stream into output tables (RocksDB's
    CompactionOutputs / SubcompactionState::AddToOutput): outputs are cut
    only at user-key boundaries once a file reaches max_output_file_size,
    and while range tombstones survive there is one output. With
    protection_bytes_per_key set, each entry's checksum is banked as it is
    added and every finished file is re-read and verified against its bank
    (verify_output_table). On any failure every partial or finished output
    of the job is deleted before the error propagates."""
    pb = table_options.protection_bytes_per_key
    outputs: list[FileMetaData] = []
    builder = None
    wfile = None
    fnum = None
    blob_refs: set[int] = set()
    emitted: dict[int, int] = {}  # checksum → count, the open output's
    emitted_n = 0

    def open_output():
        nonlocal builder, wfile, fnum, emitted, emitted_n
        fnum = new_file_number()
        wfile = env.new_writable_file(filename.table_file_name(dbname, fnum))
        builder = new_table_builder(wfile, icmp, table_options,
                                    creation_time=creation_time,
                                    column_family_id=column_family[0],
                                    column_family_name=column_family[1])
        blob_refs.clear()
        emitted = {}
        emitted_n = 0

    def close_output(pending_tombstones):
        nonlocal builder, wfile
        if builder is None:
            return
        for frag in pending_tombstones:
            b, e = frag.to_table_entry()
            builder.add_tombstone(b, e)
        if builder.num_entries == 0:
            wfile.close()
            env.delete_file(filename.table_file_name(dbname, fnum))
            builder = None
            wfile = None
            return
        props = builder.finish()
        wfile.sync()
        wfile.close()
        if pb:
            verify_output_table(env, filename.table_file_name(dbname, fnum),
                                icmp, table_options, emitted, emitted_n)
        meta = FileMetaData(
            number=fnum,
            file_size=env.get_file_size(
                filename.table_file_name(dbname, fnum)),
            smallest=builder.smallest_key,
            largest=builder.largest_key,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno,
            num_entries=props.num_entries,
            num_deletions=props.num_deletions,
            num_range_deletions=props.num_range_deletions,
            blob_refs=sorted(blob_refs),
            marked_for_compaction=builder.need_compaction,
        )
        outputs.append(meta)
        stats.output_bytes += meta.file_size
        stats.output_files += 1
        builder = None
        wfile = None

    last_user_key = None
    try:
        for ikey, value in entries_iter:
            if builder is None:
                open_output()
            uk = dbformat.extract_user_key(ikey)
            if (builder.file_size() >= compaction.max_output_file_size
                    and last_user_key is not None
                    and not surviving_tombstones
                    and icmp.user_comparator.compare(uk, last_user_key) != 0):
                # Cut outputs only at user-key boundaries (all versions of a
                # key stay in one file). While range tombstones survive a
                # single output is produced: add_tombstone widens the file
                # bounds to the tombstone span, and splitting would make
                # sibling outputs overlap.
                close_output([])
                open_output()
            if pb:
                cs = protection.truncate(
                    protection.protect_entry(ikey[-8], uk, value), pb)
                emitted[cs] = emitted.get(cs, 0) + 1
                emitted_n += 1
            builder.add(ikey, value)
            if ikey[-8] == dbformat.ValueType.BLOB_INDEX:
                blob_refs.add(decode_blob_index(value)[0])
            stats.output_records += 1
            last_user_key = uk
        if surviving_tombstones and builder is None:
            open_output()
        close_output(surviving_tombstones)
    except BaseException:
        # Failed job: no partial or completed output may survive.
        if wfile is not None:
            try:
                wfile.close()
            except OSError:
                pass  # best-effort cleanup; the job's own error propagates
        for m in outputs:
            _delete_quietly(env, filename.table_file_name(dbname, m.number))
        # fnum may name an output whose builder never constructed (the
        # constructor raised): the file exists, so delete it regardless.
        if fnum is not None:
            _delete_quietly(env, filename.table_file_name(dbname, fnum))
        raise
    return outputs


def collect_inputs(compaction: Compaction, table_cache, icmp):
    """Open all input files; returns (children_iterators, range_del_agg)
    (RocksDB's VersionSet::MakeInputIterator)."""
    children = []
    rd = RangeDelAggregator(icmp.user_comparator)

    def add_tombs(f):
        r = table_cache.get_reader(f.number)
        for b, e in r.range_del_entries():
            rd.add(RangeTombstone.from_table_entry(b, e))
        return r

    if compaction.level == 0:
        for f in compaction.inputs:
            r = add_tombs(f)
            children.append(r.new_iterator())
    else:
        files = sorted(compaction.inputs, key=lambda f: icmp.sort_key(f.smallest))
        children.append(LevelIterator(table_cache, files, icmp))
        for f in files:
            add_tombs(f)
    if compaction.output_level_inputs:
        files = sorted(
            compaction.output_level_inputs, key=lambda f: icmp.sort_key(f.smallest)
        )
        children.append(LevelIterator(table_cache, files, icmp))
        for f in files:
            add_tombs(f)
    return children, rd


def gen_subcompaction_boundaries(compaction: Compaction, icmp,
                                 max_subcompactions: int) -> list[bytes]:
    """User-key boundaries splitting the compaction into ranges (RocksDB's
    CompactionJob::GenSubcompactionBoundaries; anchors come from input-file
    bounds instead of TableReader::Anchors: cheap, even-ish partitions at
    user-key granularity)."""
    import functools

    ucmp = icmp.user_comparator
    anchors = set()
    for _, f in compaction.all_inputs():
        anchors.add(dbformat.extract_user_key(f.smallest))
        anchors.add(dbformat.extract_user_key(f.largest))
    ordered = sorted(anchors, key=functools.cmp_to_key(ucmp.compare))
    inner = ordered[1:-1]
    k = min(max_subcompactions, len(inner) + 1)
    if k <= 1:
        return []
    bounds: list[bytes] = []
    for i in range(1, k):
        b = inner[(i * len(inner)) // k]
        if not bounds or ucmp.compare(b, bounds[-1]) > 0:
            bounds.append(b)
    return bounds


class _BoundedMerger:
    """View of a positioned iterator that ends at user key `hi` (exclusive);
    the subcompaction's input window."""

    def __init__(self, it, icmp, hi: bytes | None):
        self._it = it
        self._ucmp = icmp.user_comparator
        self._hi = hi

    def valid(self):
        if not self._it.valid():
            return False
        if self._hi is None:
            return True
        uk = dbformat.extract_user_key(self._it.key())
        return self._ucmp.compare(uk, self._hi) < 0

    def key(self):
        return self._it.key()

    def value(self):
        return self._it.value()

    def next(self):
        self._it.next()


def _clip_fragments(frags, lo: bytes | None, hi: bytes | None, ucmp):
    """Restrict tombstone fragments to [lo, hi) so sibling subcompactions
    don't write overlapping tombstone spans."""
    out = []
    for f in frags:
        if lo is not None and ucmp.compare(f.end, lo) <= 0:
            continue
        if hi is not None and ucmp.compare(f.begin, hi) >= 0:
            continue
        nb = f.begin if lo is None or ucmp.compare(f.begin, lo) >= 0 else lo
        ne = f.end if hi is None or ucmp.compare(f.end, hi) <= 0 else hi
        out.append(type(f)(f.seq, nb, ne))
    return out


def run_compaction_to_tables(
    env, dbname: str, icmp, compaction: Compaction, table_cache,
    table_options, snapshots: list[int], merge_operator=None,
    compaction_filter=None, new_file_number=None, creation_time=None,
    blob_resolver=None, blob_gc=None, column_family: tuple[int, str] = (0, "default"),
    max_subcompactions: int = 1,
) -> tuple[list[FileMetaData], CompactionStats]:
    """The CPU data plane: heap merge → CompactionIterator GC → outputs.
    `blob_gc` is an optional BlobGarbageCollector rewriting survivors out of
    aged blob files (blob GC during compaction). With
    max_subcompactions > 1 the key range is partitioned at user-key anchors
    and ranges run on parallel threads (RocksDB's subcompaction fan-out;
    the native block codec releases the GIL, so threads scale the
    encode/decode work)."""
    t0 = time.time()
    stats = CompactionStats()
    stats.input_bytes = compaction.total_input_bytes()
    stats.input_files = len(compaction.all_inputs())
    gc_active = blob_gc is not None and blob_gc.active
    bounds = (
        gen_subcompaction_boundaries(compaction, icmp, max_subcompactions)
        if max_subcompactions > 1 and not gc_active else []
    )
    outputs = _run_subcompactions(
        env, dbname, icmp, compaction, table_cache, table_options,
        snapshots, merge_operator, compaction_filter, new_file_number,
        creation_time, blob_resolver, column_family, bounds, stats,
        blob_gc=blob_gc if gc_active else None,
    )
    if blob_gc is not None and not gc_active:
        blob_gc.finish()  # no-op close for an inactive collector
    stats.work_time_usec = int((time.time() - t0) * 1e6)
    return outputs, stats


def _run_subcompactions(env, dbname, icmp, compaction, table_cache,
                        table_options, snapshots, merge_operator,
                        compaction_filter, new_file_number, creation_time,
                        blob_resolver, column_family, bounds: list[bytes],
                        stats: CompactionStats,
                        blob_gc=None) -> list[FileMetaData]:
    """One worker per key range (a single unbounded range when bounds is
    empty — the degenerate case IS the single-threaded path, so the sub=1
    and sub>1 pipelines cannot diverge); each range runs the full
    merge→GC→build pipeline over its window and the results concatenate in
    range order. Tombstones are fragmented ONCE and clipped per range.
    `blob_gc` (single-range only) rewrites survivors out of aged blob
    files."""
    from toplingdb_tpu_torch.utils import telemetry

    ucmp = icmp.user_comparator
    ranges = [
        (bounds[i - 1] if i > 0 else None,
         bounds[i] if i < len(bounds) else None)
        for i in range(len(bounds) + 1)
    ]
    assert blob_gc is None or len(ranges) == 1
    ctime = creation_time if creation_time is not None else int(time.time())
    # Fragment once (quadratic in tombstone count — not per thread); the
    # readers' tombstone meta is cached, so per-thread aggregators for the
    # point-key GC stay cheap.
    rd0 = RangeDelAggregator(ucmp)
    for _, f in compaction.all_inputs():
        r = table_cache.get_reader(f.number)
        for b, e in r.range_del_entries():
            rd0.add(RangeTombstone.from_table_entry(b, e))
    all_frags = surviving_tombstone_fragments(
        rd0, snapshots, compaction.bottommost, ucmp
    )
    results: list = [None] * len(ranges)
    errors: list[BaseException] = []
    # Serial-plane telemetry: the streamed merge→GC→build stage per key
    # range, parented cross-thread under the compaction root.
    trace_handle = telemetry.current_handle()

    def work(idx: int, lo: bytes | None, hi: bytes | None) -> None:
        _tsp = telemetry.span_under(trace_handle,
                                    "compaction.subcompaction", range=idx)
        try:
            st = CompactionStats()
            children, rd = collect_inputs(compaction, table_cache, icmp)
            merger = MergingIterator(icmp.compare, children)
            if lo is None:
                merger.seek_to_first()
            else:
                merger.seek(dbformat.make_internal_key(
                    lo, dbformat.MAX_SEQUENCE_NUMBER,
                    dbformat.VALUE_TYPE_FOR_SEEK,
                ))
            ci = CompactionIterator(
                _BoundedMerger(merger, icmp, hi), icmp, snapshots,
                bottommost_level=compaction.bottommost,
                merge_operator=merge_operator,
                compaction_filter=compaction_filter,
                compaction_filter_level=compaction.output_level,
                range_del_agg=None if rd.empty() else rd,
                blob_resolver=blob_resolver,
                full_history_ts_low=getattr(
                    compaction, "full_history_ts_low", 0
                ),
            )
            frags = _clip_fragments(all_frags, lo, hi, ucmp)
            stream = ci.entries()
            if blob_gc is not None:
                stream = blob_gc.rewrite(stream)
            outs = build_outputs(
                env, dbname, icmp, compaction, stream, frags,
                new_file_number, table_options, st, ctime,
                column_family=column_family,
            )
            st.input_records = ci.num_input_records
            st.dropped_obsolete = ci.num_dropped_obsolete
            st.dropped_tombstone = ci.num_dropped_tombstone
            st.merged_records = ci.num_merged
            for ch in children:
                pc = getattr(ch, "prefetch_counts", None)
                if pc is not None:
                    h, m = pc()
                    st.prefetch_hits += h
                    st.prefetch_misses += m
            results[idx] = (outs, st)
        except BaseException as e:  # noqa: BLE001 — surfaced by the driver
            errors.append(e)
        finally:
            _tsp.finish()

    if len(ranges) == 1:
        work(0, None, None)
    else:
        threads = [
            ccy.spawn(f"tpt-subcompaction-{i}", work, args=(i, lo, hi),
                      start=False)
            for i, (lo, hi) in enumerate(ranges)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        if blob_gc is not None:
            blob_gc.abort()
        raise errors[0]
    if blob_gc is not None:
        blob_gc.finish()
    outputs: list[FileMetaData] = []
    for outs, st in results:
        outputs.extend(outs)
        stats.input_records += st.input_records
        stats.output_records += st.output_records
        stats.output_bytes += st.output_bytes
        stats.output_files += st.output_files
        stats.dropped_obsolete += st.dropped_obsolete
        stats.dropped_tombstone += st.dropped_tombstone
        stats.merged_records += st.merged_records
        stats.prefetch_hits += st.prefetch_hits
        stats.prefetch_misses += st.prefetch_misses
    return outputs


def make_version_edit(compaction: Compaction, outputs: list[FileMetaData]) -> VersionEdit:
    edit = VersionEdit(column_family=compaction.cf_id)
    for level, f in compaction.all_inputs():
        edit.delete_file(level, f.number)
    for meta in outputs:
        edit.add_file(compaction.output_level, meta)
    return edit
