"""The compaction executor boundary (copied from
toplingdb_tpu/compaction/executor.py: the in-process device executor, the
serialized dcompact job boundary and the subprocess transport).

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
LocalCompactionExecutorFactory.

SubprocessCompactionExecutor ships a job through a job dir: params.json
(CompactionParams) and lease.json are written to
`<db>/dcompact/job-NNNNN/att-NN`, a worker process
(`python -m toplingdb_tpu_torch.compaction.worker`) runs it and writes its
outputs and results.json, and the outputs are renamed into the DB dir
under fresh file numbers (RocksDB's CompactionJob::RunRemote). Its
factory's default device is "cuda": the worker owns the card. "cpu-jax"
(the kernels' plain versions) and "cpu" (the per-entry
CompactionIterator) run only where the caller names them. The HTTP
transport (compaction/dcompact_service.py) reuses the executor with a
POST in place of the spawn.

Store mode (ToplingDB's dcompact over shared storage): when the DB runs on
a SharedSstEnv (Options.shared_store) whose store a worker can reopen (a
root path or an http:// URL) and every input carries a checksum address,
the job names the store (`store_spec`) and the inputs' addresses
(`input_addrs`); the worker fetches the inputs from the store, runs the
job on its device, publishes and pins each output, and answers with its
address (`store_addr`), which the DB adopts as a reference. The job dir
then carries no SST bytes (`sst_bytes_shipped` 0).

`CompactionParams`, `CompactionResults`, `encode_file_meta`,
`decode_file_meta` and `table_options_from_params` are the dcompact job
dir's params.json and results.json, in toplingdb_tpu's format, so a job
written by either package is read by the other's worker.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
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

    def job_url(self, job_id: int, attempt: int) -> str:
        return ""


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
            host_sort=self.factory.host_sort,
            host_merge=self.factory.host_merge,
            mesh_devices=self.factory.mesh_devices,
        )
        self.factory.record_job(compaction, stats, time.time() - t0)
        return outputs, stats


class DeviceCompactionExecutorFactory(CompactionExecutorFactory):
    """Every job on the device data plane, with run_device_compaction's
    own choices of route.

    device: "cuda" (the card; a job raises without one) or "cpu" (the
    kernels' plain PyTorch versions). host_sort / host_merge /
    mesh_devices: run_device_compaction's route arguments (the host twins;
    the mesh route over a device list). A failed job raises; nothing
    re-runs it elsewhere. `jobs` logs every job the factory's executors
    ran: its column family id, level pair, reason, input files and rows,
    whether it ran pipelined, its mesh devices and fallbacks, and its
    wall."""

    def __init__(self, device: str = "cuda", host_sort: bool = False,
                 host_merge: bool = True, mesh_devices=None):
        if device not in ("cuda", "cpu"):
            raise ValueError(
                f"device {device!r}: the port's executor runs 'cuda' or "
                f"'cpu'")
        self.device = device
        self.host_sort = host_sort
        self.host_merge = host_merge
        self.mesh_devices = (None if mesh_devices is None
                             else list(mesh_devices))
        self.jobs: list[dict] = []
        self._lock = threading.Lock()

    def new_executor(self, compaction: Compaction) -> CompactionExecutor:
        return DeviceCompactionExecutor(self)

    def record_job(self, compaction: Compaction, stats: CompactionStats,
                   wall_s: float) -> None:
        with self._lock:
            self.jobs.append(dict(
                cf_id=compaction.cf_id,
                level=compaction.level, output_level=compaction.output_level,
                reason=compaction.reason,
                input_files=compaction.num_input_files(),
                rows=stats.input_records, pipelined=stats.pipelined,
                mesh_chips=stats.mesh_chips,
                mesh_fallbacks=stats.mesh_fallbacks, wall_s=wall_s))


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
    # Disaggregated-storage mode (storage/): when set, the worker
    # resolves inputs by content address from the shared store
    # (input_addrs pairs with input_files) and publishes outputs back —
    # ZERO SST bytes cross the job transport. None = classic path mode.
    store_spec: str | None = None
    input_addrs: list | None = None
    checksum_func: str | None = None  # output stamping func in store mode
    # The port's route arguments of run_device_compaction (the reference
    # reads them from its process env: TPULSM_HOST_SORT, TPULSM_HOST_MERGE,
    # TPULSM_MESH_COMPACT). Written only when they differ from these
    # defaults, so the reference's worker reads a default job's params.
    host_sort: bool = False
    host_merge: bool = True
    mesh_devices: list | None = None  # device names, e.g. ["cuda:0", ...]

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for name, default in _ROUTE_DEFAULTS.items():
            if d[name] == default:
                del d[name]
        return json.dumps(d, indent=1)

    @staticmethod
    def from_json(s: str) -> "CompactionParams":
        return CompactionParams(**json.loads(s))


_ROUTE_DEFAULTS = {"host_sort": False, "host_merge": True,
                   "mesh_devices": None}


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


# ---------------------------------------------------------------------------
# Subprocess transport (the dcompact worker in its own process)
# ---------------------------------------------------------------------------


def _store_spec_of(env) -> str | None:
    """The store spec a worker process can reopen: the HTTP URL of a
    StoreClient or the root path of a LocalObjectStore. None when the env
    has no store or its backend has no process-portable name."""
    store = getattr(env, "store", None)
    if store is None:
        return None
    url = getattr(store, "url", None)
    if isinstance(url, str) and url:
        return url
    root = getattr(store, "root", None)
    return root if isinstance(root, str) and root else None


def _store_mode(db, compaction) -> tuple[str | None, list | None]:
    """(store_spec, input_addrs) of a store-mode job: the DB runs on a
    SharedSstEnv whose store a worker can reopen, and EVERY input carries
    a checksum address. One unstamped input (file_checksum off) sends the
    whole job down the path mode, as toplingdb_tpu does: a choice of
    transport, the job runs on the same device either way."""
    if not hasattr(db.env, "publish_sst"):
        return None, None
    from toplingdb_tpu_torch.storage.object_store import address_of_meta

    addrs = [address_of_meta(f) for _, f in compaction.all_inputs()]
    spec = _store_spec_of(db.env)
    if spec is None or any(a is None for a in addrs):
        return None, None
    return spec, addrs

# The device names a remote job may carry: the worker maps them
# (compaction/worker.py).
REMOTE_DEVICES = ("cuda", "cpu-jax", "cpu")

# Job ids come from a PROCESS-WIDE counter: the factory builds one executor
# per compaction, and concurrent jobs with per-executor counters would
# collide on the same job dir.
_job_counter = itertools.count(1)


def _check_remote_device(device: str) -> None:
    if device not in REMOTE_DEVICES:
        raise ValueError(
            f"device {device!r}: a dcompact worker runs one of "
            f"{REMOTE_DEVICES}")


class SubprocessCompactionExecutor(CompactionExecutor):
    """Ship the job to a worker process through a shared job dir: the
    transport shape of dcompact (HTTP + NFS in ToplingDB; a local spawn and
    a shared filesystem here; the hop is pluggable through `spawn`)."""

    def __init__(self, device: str = "cuda", job_root: str | None = None,
                 spawn=None, policy=None, fault_injector=None):
        _check_remote_device(device)
        self.device = device
        self.job_root = job_root
        self._local_spawn = spawn is None
        self.spawn = spawn or self._spawn_local
        self._job_seq = 0
        # Set by the retry driver (compaction/resilience.py) before each
        # execute(); attempt N gets its own att-NN dir so a failed
        # attempt's partial outputs never collide with the retry's.
        self.attempt = 0
        self.policy = policy          # DcompactOptions or None (defaults)
        self.fault_injector = fault_injector
        self.url = ""                 # transport identity (HTTP sets it)
        self._plan = None             # active injected-fault plan

    def _spawn_local(self, job_dir: str, device: str) -> None:
        # The child's environment is a copy: nothing here writes the
        # parent's os.environ.
        env = dict(os.environ)
        if self._plan == "kill":
            # The worker crashes hard mid-job (os._exit after heartbeats
            # and a partial output): deterministically a kill -9.
            env["TPULSM_TEST_WORKER_CRASH"] = "mid_job"
        timeout = (self.policy.attempt_timeout
                   if self.policy is not None else 3600.0)
        r = subprocess.run(
            [sys.executable, "-m", "toplingdb_tpu_torch.compaction.worker",
             "--job-dir", job_dir],
            capture_output=True, env=env, timeout=timeout,
        )
        if r.returncode != 0:
            from toplingdb_tpu_torch.utils.status import IOError_

            raise IOError_(
                f"compaction worker failed rc={r.returncode}: "
                f"{r.stderr.decode(errors='replace')[-2000:]}"
            )

    def execute(self, db, compaction, snapshots, new_file_number):
        self._job_seq = next(_job_counter)
        job_root = self.job_root or os.path.join(db.dbname, "dcompact")
        job_dir = os.path.join(
            job_root, f"job-{self._job_seq:05d}", f"att-{self.attempt:02d}"
        )
        os.makedirs(os.path.join(job_dir, "out"), exist_ok=True)
        try:
            return self._execute_in(db, compaction, snapshots,
                                    new_file_number, job_dir)
        except BaseException:
            # Sweep THIS attempt's partial state (params, lease, partial
            # outputs) so a retry or the on-open orphan sweep never sees
            # half-written SSTs as live job state.
            self._cleanup(job_dir)
            raise

    def _params(self, db, compaction, snapshots, job_dir,
                lease_sec: float) -> CompactionParams:
        from toplingdb_tpu_torch.db import filename
        from toplingdb_tpu_torch.utils import telemetry
        from toplingdb_tpu_torch.utils.table_properties_collector import (
            serialize_collector_factory,
        )

        opts = db.options
        store_spec, input_addrs = _store_mode(db, compaction)
        return CompactionParams(
            job_id=self._job_seq,
            attempt=self.attempt,
            dbname=db.dbname,
            output_dir=os.path.join(job_dir, "out"),
            input_files=[
                filename.table_file_name(db.dbname, f.number)
                for _, f in compaction.all_inputs()
            ],
            output_level=compaction.output_level,
            bottommost=compaction.bottommost,
            max_output_file_size=compaction.max_output_file_size,
            snapshots=list(snapshots),
            comparator=opts.comparator.name(),
            merge_operator=(
                opts.merge_operator.name() if opts.merge_operator else None
            ),
            compaction_filter=(
                opts.compaction_filter.name() if opts.compaction_filter
                else None
            ),
            compression=opts.compression_for_level(
                compaction.output_level, compaction.bottommost),
            block_size=opts.table_options.block_size,
            creation_time=int(time.time()),
            device=self.device,
            table_format=getattr(opts.table_options, "format", "block"),
            prefix_extractor=(
                opts.table_options.prefix_extractor.name()
                if getattr(opts.table_options, "prefix_extractor", None)
                else None
            ),
            cf_id=compaction.cf_id,
            cf_name=db.cf_name(compaction.cf_id),
            collectors=[
                serialize_collector_factory(f)
                for f in opts.table_options.properties_collector_factories
            ],
            lease_sec=lease_sec,
            trace=telemetry.inject(),
            store_spec=store_spec,
            input_addrs=input_addrs,
            checksum_func=(opts.file_checksum or "crc32c")
            if store_spec else None,
        )

    def _execute_in(self, db, compaction, snapshots, new_file_number,
                    job_dir):
        from toplingdb_tpu_torch.compaction.resilience import write_lease
        from toplingdb_tpu_torch.db import filename
        from toplingdb_tpu_torch.utils import telemetry
        from toplingdb_tpu_torch.utils.status import IOError_

        opts = db.options
        if opts.compaction_filter is not None:
            # An unregistered filter cannot travel the serialized
            # boundary: fail before the worker starts.
            from toplingdb_tpu_torch.utils.compaction_filter import (
                create_compaction_filter,
            )

            create_compaction_filter(opts.compaction_filter.name())
        policy = self.policy or getattr(opts, "dcompact", None)
        lease_sec = policy.lease_sec if policy is not None else 30.0
        params = self._params(db, compaction, snapshots, job_dir, lease_sec)
        with open(os.path.join(job_dir, "params.json"), "w") as f:
            f.write(params.to_json())
        write_lease(job_dir, self._job_seq, self.attempt, lease_sec)
        inj = self.fault_injector
        self._plan = inj.plan(self._job_seq, self.attempt) if inj else None
        t0 = time.time()
        if inj is not None:
            inj.before_spawn(self._plan)
        if self._plan == "kill" and not self._local_spawn:
            # A transport without a worker process of its own cannot kill
            # one: leave the observable state of one (a partial output),
            # then fail the attempt.
            with open(os.path.join(job_dir, "out", "partial.sst"), "wb") as f:
                f.write(b"\x00" * 64)
            raise IOError_("injected: worker killed mid-job")
        self.spawn(job_dir, self.device)
        if inj is not None:
            inj.after_spawn(self._plan, job_dir)
        rpc_usec = int((time.time() - t0) * 1e6)
        try:
            with open(os.path.join(job_dir, "results.json")) as f:
                results = CompactionResults.from_json(f.read())
        except (OSError, ValueError, TypeError) as e:
            # Missing, truncated or garbage results.json: a worker crash
            # between compute and a complete write, a transport failure.
            raise IOError_(f"dcompact results unreadable: {e!r}") from e
        if results.status != "ok":
            raise IOError_(f"worker error: {results.status}")
        if results.spans:
            # Stitch the worker's spans into the compaction trace active
            # on this thread (no-op when the job ran untraced).
            telemetry.attach_current(results.spans)
        # Rename the outputs into the DB dir under fresh file numbers
        # (RocksDB's RunRemote rename loop). Store-mode outputs are
        # adopted instead: their bytes live in the shared store under
        # their content address, and only the reference lands here.
        outputs = []
        shipped = 0
        for d in results.output_files:
            num = new_file_number()
            dst = filename.table_file_name(db.dbname, num)
            addr = d.get("store_addr")
            if addr:
                db.env.adopt(dst, addr)
                try:
                    db.env.store.unpin(addr)  # the ref shields it from GC
                except Exception as e:  # noqa: BLE001 - the pin's TTL ends
                    from toplingdb_tpu_torch.utils import errors as _errors

                    _errors.swallow(reason="dcompact-adopt-unpin", exc=e)
            else:
                os.replace(os.path.join(params.output_dir, d["path"]), dst)
                shipped += int(d["file_size"])
            outputs.append(decode_file_meta(d, num))
        stats = CompactionStats(**results.stats)
        stats.sst_bytes_shipped = shipped
        stats.device = self.device
        stats.remote = True
        stats.work_time_usec = results.work_time_usec
        # Transport time, the counterpart of ToplingDB's curl_time_usec.
        stats.rpc_time_usec = rpc_usec - results.work_time_usec
        self._cleanup(job_dir)
        return outputs, stats

    @staticmethod
    def _rmdir_if_empty(path: str) -> None:
        try:
            if os.path.isdir(path) and not os.listdir(path):
                os.rmdir(path)
        except OSError:
            pass

    @classmethod
    def _cleanup(cls, job_dir: str) -> None:
        """Remove the whole attempt dir (outputs were renamed into the DB
        dir, or the attempt failed) and the job skeleton once empty: a
        finished job leaves no residue for the on-open orphan sweep."""
        shutil.rmtree(job_dir, ignore_errors=True)
        cls._rmdir_if_empty(os.path.dirname(job_dir))


class SubprocessCompactionExecutorFactory(CompactionExecutorFactory):
    """Every job through a worker process on `device` ("cuda" by default;
    "cpu-jax" or "cpu" by name). A failed attempt is retried by the
    scheduler's retry driver; a job whose attempts all fail raises."""

    def __init__(self, device: str = "cuda", job_root: str | None = None,
                 policy=None, fault_injector=None):
        _check_remote_device(device)
        self.device = device
        self.job_root = job_root
        self.policy = policy                  # DcompactOptions or None
        self.fault_injector = fault_injector  # DcompactFaultInjector

    def new_executor(self, compaction: Compaction) -> CompactionExecutor:
        return SubprocessCompactionExecutor(
            self.device, self.job_root, policy=self.policy,
            fault_injector=self.fault_injector)

    def job_url(self, job_id: int, attempt: int) -> str:
        return (f"file://{self.job_root or 'dcompact'}/job-{job_id:05d}/"
                f"att-{attempt:02d}")
