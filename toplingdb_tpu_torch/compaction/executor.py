"""The serialized dcompact job boundary (copied from
toplingdb_tpu/compaction/executor.py, trimmed to the job boundary:
`CompactionParams`, `CompactionResults`, `encode_file_meta`,
`decode_file_meta`, and `table_options_from_params`, the worker's table
options). A job dir's params.json and results.json carry these
as JSON, in the reference's format, so a job written by either package is
read by the other's worker. The executors that submit jobs read the DB's
options and come with the DB engine.
"""

from __future__ import annotations

import dataclasses
import json

from toplingdb_tpu_torch.db.version_edit import FileMetaData


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
