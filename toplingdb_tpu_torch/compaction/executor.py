"""The compaction executor boundary (copied from
toplingdb_tpu/compaction/executor.py, trimmed to the in-process device
executor and the serialized dcompact job boundary).

  CompactionExecutorFactory.should_run_local / new_executor — decide
  routing per job;
  CompactionExecutor.execute(db, compaction, snapshots, alloc) — run the
  data plane and return (outputs, stats).

DeviceCompactionExecutor runs the job through run_device_compaction on the
card ("cuda") or on the kernels' plain versions ("cpu"); it is the default
of Options.compaction_executor_factory, on "cuda". Unlike toplingdb_tpu's
factory, the port's never falls back to the CPU path: a failed device job
raises and surfaces as the DB's background error. The host compaction
path (run_compaction_to_tables) runs only where the caller names it with
LocalCompactionExecutorFactory. The subprocess executor comes with a later
slice.

`CompactionParams`, `CompactionResults`, `encode_file_meta`,
`decode_file_meta` and `table_options_from_params` are the dcompact job
dir's params.json and results.json, in toplingdb_tpu's format, so a job
written by either package is read by the other's worker.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

from toplingdb_tpu_torch.compaction.compaction_job import CompactionStats
from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db.version_edit import FileMetaData


class CompactionExecutor:
    def execute(self, db, compaction: Compaction, snapshots: list[int],
                new_file_number) -> tuple[list[FileMetaData], CompactionStats]:
        raise NotImplementedError


class CompactionExecutorFactory:
    """RocksDB's CompactionExecutorFactory (compaction_executor.h)."""

    def should_run_local(self, compaction: Compaction) -> bool:
        return False

    def new_executor(self, compaction: Compaction) -> CompactionExecutor:
        raise NotImplementedError


class LocalCompactionExecutorFactory(CompactionExecutorFactory):
    """Every job on the host compaction path (run_compaction_to_tables,
    per entry): what toplingdb_tpu's DB runs with no factory. The port
    runs it only where the caller asks for it by this factory."""

    def should_run_local(self, compaction: Compaction) -> bool:
        return True


# ---------------------------------------------------------------------------
# In-process device executor
# ---------------------------------------------------------------------------


class DeviceCompactionExecutor(CompactionExecutor):
    def __init__(self, factory: "DeviceCompactionExecutorFactory"):
        self.factory = factory
        self.device = factory.device

    def execute(self, db, compaction, snapshots, new_file_number):
        from toplingdb_tpu_torch.db.blob import maybe_new_blob_gc
        from toplingdb_tpu_torch.ops.device_compaction import (
            run_device_compaction,
        )

        t0 = time.time()
        outputs, stats = run_device_compaction(
            db.env, db.dbname, db.icmp, compaction, db.table_cache,
            db.options.table_options_for_level(
                compaction.output_level, compaction.bottommost),
            snapshots,
            merge_operator=db.options.merge_operator,
            compaction_filter=db.options.compaction_filter,
            new_file_number=new_file_number,
            device_name=self.device,
            blob_resolver=db.blob_source.get,
            blob_gc=maybe_new_blob_gc(db, compaction, new_file_number),
            column_family=(compaction.cf_id, db.cf_name(compaction.cf_id)),
        )
        self.factory.record_job(compaction, stats, time.time() - t0)
        return outputs, stats


class DeviceCompactionExecutorFactory(CompactionExecutorFactory):
    """Every job on the device data plane, with run_device_compaction's
    own choices of route.

    device: "cuda" (the card; a job raises without one) or "cpu" (the
    kernels' plain PyTorch versions). A failed job raises; nothing re-runs
    it elsewhere. `jobs` logs every job the factory's executors ran: its
    level pair, input files and rows, whether it ran pipelined, and its
    wall."""

    def __init__(self, device: str = "cuda"):
        if device not in ("cuda", "cpu"):
            raise ValueError(
                f"device {device!r}: the port's executor runs 'cuda' or "
                f"'cpu'")
        self.device = device
        self.jobs: list[dict] = []
        self._lock = threading.Lock()

    def new_executor(self, compaction: Compaction) -> CompactionExecutor:
        return DeviceCompactionExecutor(self)

    def record_job(self, compaction: Compaction, stats: CompactionStats,
                   wall_s: float) -> None:
        with self._lock:
            self.jobs.append(dict(
                level=compaction.level, output_level=compaction.output_level,
                input_files=compaction.num_input_files(),
                rows=stats.input_records, pipelined=stats.pipelined,
                wall_s=wall_s))


@dataclasses.dataclass
class CompactionParams:
    """Everything a worker needs to run one compaction job (the reference's
    CompactionParams, field for field, so job dirs cross between the two
    packages unchanged). Plugin objects travel as registry names."""

    job_id: int
    attempt: int
    dbname: str                      # source DB dir (shared storage)
    output_dir: str                  # where the worker writes SSTs
    input_files: list[str]           # absolute SST paths
    output_level: int
    bottommost: bool
    max_output_file_size: int
    snapshots: list[int]
    comparator: str                  # registry name
    merge_operator: str | None       # registry name
    compaction_filter: str | None    # registry name
    compression: int
    block_size: int
    creation_time: int
    table_format: str = "block"
    # SliceTransform serialized name (utils/slice_transform.py) or None —
    # required when table_format == 'plain' (prefix hash index) and feeds
    # prefix blooms for the other formats.
    prefix_extractor: str | None = None
    # Job-lease duration: the worker heartbeats job_dir/heartbeat at
    # ~lease_sec/3; a heartbeat older than lease_sec marks the job
    # orphaned (compaction/resilience.py). 0 disables heartbeating.
    lease_sec: float = 30.0
    smallest_seqno_guard: int = 0
    device: str = "cuda"
    cf_id: int = 0
    cf_name: str = "default"
    collectors: list = dataclasses.field(default_factory=list)
    # Propagated trace context (utils/telemetry.py inject()): the worker
    # adopts it, records its spans locally, and returns them in
    # results.json so the DB stitches one end-to-end trace. None = the
    # submitting op was untraced.
    trace: dict | None = None
    # Disaggregated-storage mode (the reference's storage/): when set, the
    # worker resolves inputs by content address from the shared store
    # (input_addrs pairs with input_files) and publishes outputs back —
    # ZERO SST bytes cross the job transport. None = classic path mode.
    store_spec: str | None = None
    input_addrs: list | None = None
    checksum_func: str | None = None  # output stamping func in store mode

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @staticmethod
    def from_json(s: str) -> "CompactionParams":
        return CompactionParams(**json.loads(s))


def table_options_from_params(params: CompactionParams):
    """The output table options a job's params name, as the reference's
    worker builds them: block size, compression, format, the prefix
    extractor by its registry name and the collector factories from
    their serialized form (other fields keep their defaults)."""
    from toplingdb_tpu_torch.table.builder import TableOptions
    from toplingdb_tpu_torch.utils.slice_transform import (
        slice_transform_from_name,
    )
    from toplingdb_tpu_torch.utils.table_properties_collector import (
        create_collector_factory,
    )

    return TableOptions(
        block_size=params.block_size, compression=params.compression,
        format=params.table_format,
        prefix_extractor=(slice_transform_from_name(params.prefix_extractor)
                          if params.prefix_extractor else None),
        properties_collector_factories=[
            create_collector_factory(d) for d in params.collectors],
    )


@dataclasses.dataclass
class CompactionResults:
    """Worker → DB results (the reference's CompactionResults)."""

    status: str                      # "ok" | error text
    output_files: list[dict]         # serialized FileMetaData (paths relative)
    stats: dict
    curl_time_usec: int = 0          # kept for parity with reference fields
    work_time_usec: int = 0
    # Worker-side finished span dicts (telemetry plane): the DB side
    # attaches them to the originating trace (attach_remote).
    spans: list = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @staticmethod
    def from_json(s: str) -> "CompactionResults":
        return CompactionResults(**json.loads(s))


def encode_file_meta(meta: FileMetaData, path: str) -> dict:
    return {
        "path": path,
        "file_size": meta.file_size,
        "smallest": meta.smallest.hex(),
        "largest": meta.largest.hex(),
        "smallest_seqno": meta.smallest_seqno,
        "largest_seqno": meta.largest_seqno,
        "num_entries": meta.num_entries,
        "num_deletions": meta.num_deletions,
        "num_range_deletions": meta.num_range_deletions,
        "blob_refs": list(meta.blob_refs),
        "marked_for_compaction": meta.marked_for_compaction,
    }


def decode_file_meta(d: dict, number: int) -> FileMetaData:
    return FileMetaData(
        number=number,
        file_size=d["file_size"],
        smallest=bytes.fromhex(d["smallest"]),
        largest=bytes.fromhex(d["largest"]),
        smallest_seqno=d["smallest_seqno"],
        largest_seqno=d["largest_seqno"],
        num_entries=d["num_entries"],
        num_deletions=d["num_deletions"],
        num_range_deletions=d["num_range_deletions"],
        blob_refs=list(d.get("blob_refs", [])),
        marked_for_compaction=d.get("marked_for_compaction", False),
        # Store-mode outputs arrive pre-stamped (the worker checksummed
        # them for their content address) — the install path's
        # stamp_file_checksum sees the digest and skips the re-read.
        file_checksum=bytes.fromhex(d["file_checksum"])
        if d.get("file_checksum") else b"",
        file_checksum_func_name=d.get("file_checksum_func_name", ""),
    )
