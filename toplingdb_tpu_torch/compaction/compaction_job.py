"""Per-job compaction stats, their phase spans, the tombstones a job
writes, and the per-entry output cutter (copied from
toplingdb_tpu/compaction/compaction_job.py, trimmed to `CompactionStats`,
`emit_phase_spans`, `surviving_tombstone_fragments`, `verify_output_table`
and `build_outputs`; the CPU CompactionJob comes with the DB engine in a
later slice)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db import dbformat, filename
from toplingdb_tpu_torch.db.blob import decode_blob_index
from toplingdb_tpu_torch.db.range_del import (
    RangeDelAggregator,
    fragment_tombstones,
)
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.table.factory import new_table_builder, open_table
from toplingdb_tpu_torch.utils import protection
from toplingdb_tpu_torch.utils.status import Corruption, NotFound


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
