"""Per-job compaction stats and the tombstones a job writes (copied from
toplingdb_tpu/compaction/compaction_job.py, trimmed to `CompactionStats` and
`surviving_tombstone_fragments`; the per-entry CompactionJob comes with a
later slice)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from toplingdb_tpu_torch.db.range_del import (
    RangeDelAggregator,
    fragment_tombstones,
)


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
