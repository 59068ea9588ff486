"""The CompactionService path (copied from
toplingdb_tpu/compaction/compaction_service.py): RocksDB's upstream remote
compaction (include/rocksdb/options.h compaction_service: a plugin
receives one serialized job; the worker side calls DB::OpenAndCompact,
include/rocksdb/db.h, db/compaction/compaction_service_job.cc), beside
ToplingDB's dcompact (compaction/executor.py and compaction/worker.py).

  open_and_compact(dbname, output_dir, input_json)  the worker side: opens
      the source DB READ-ONLY (MANIFEST recovery only, no WAL ownership),
      resolves the job's input files in the live Version, runs the job,
      writes its outputs to output_dir and returns the serialized result.
      The job's `device` picks where it runs, as the dcompact worker maps
      it: "cuda" (the default), "tpu" and "device" are the card
      (run_device_compaction(device_name="cuda"), raising without one),
      "cpu-jax" the same data plane on the kernels' plain versions, "cpu"
      the host compaction path (run_compaction_to_tables, the one the
      reference runs); any other name fails the job.
  CompactionServiceExecutorFactory  the DB side: the service behind the
      executor seam the scheduler routes through (compaction/executor.py).
      It has no fallback: a failed service job raises, becomes the
      scheduler's last_error and the DB's background error, and leaves
      no output under the job root. The transport is a callable:
      in-process, a subprocess per job (the `main` CLI), or anything
      HTTP-shaped.

Options (comparator, merge operator, table format) are NOT shipped in the
job: the worker loads them from the DB's persisted OPTIONS file, as
RocksDB's worker gets them from the options file named in
CompactionServiceInput.
"""

from __future__ import annotations

import dataclasses
import json
import itertools
import os
import subprocess
import sys
import time

from toplingdb_tpu_torch.compaction.compaction_job import (
    CompactionStats,
    run_compaction_to_tables,
)
from toplingdb_tpu_torch.compaction.executor import (
    CompactionExecutor,
    CompactionExecutorFactory,
    decode_file_meta,
    encode_file_meta,
)
from toplingdb_tpu_torch.compaction.picker import Compaction
from toplingdb_tpu_torch.db import filename
from toplingdb_tpu_torch.utils.status import Corruption, InvalidArgument
from toplingdb_tpu_torch.utils import errors as _errors


@dataclasses.dataclass
class CompactionServiceInput:
    """One job, serialized DB→worker (RocksDB's CompactionServiceInput,
    options.h / compaction_service_job.cc). `device`: where the worker
    runs it (see the module docstring)."""

    cf_name: str
    input_files: list[int]           # file NUMBERS, resolved via the Version
    output_level: int
    bottommost: bool
    snapshots: list[int]
    max_output_file_size: int
    creation_time: int = 0
    device: str = "cuda"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "CompactionServiceInput":
        return CompactionServiceInput(**json.loads(s))


@dataclasses.dataclass
class CompactionServiceResult:
    """Worker→DB result (RocksDB's CompactionServiceResult)."""

    status: str                      # "ok" | error text
    output_files: list[dict]         # encode_file_meta dicts, paths relative
    stats: dict = dataclasses.field(default_factory=dict)
    bytes_read: int = 0
    bytes_written: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "CompactionServiceResult":
        return CompactionServiceResult(**json.loads(s))


def open_and_compact(dbname: str, output_dir: str, input_json: str,
                     env=None) -> str:
    """Worker entry point (RocksDB's DB::OpenAndCompact): one read-only
    open, one compaction on the job's device, outputs under output_dir
    named like table files. Never touches the source DB dir. Returns
    CompactionServiceResult JSON (errors reported in .status rather than
    raised, matching the RPC shape)."""
    from toplingdb_tpu_torch.db.db_readonly import ReadOnlyDB
    from toplingdb_tpu_torch.env import default_env
    from toplingdb_tpu_torch.utils.config import load_latest_options

    env = env or default_env()
    try:
        inp = CompactionServiceInput.from_json(input_json)
        device_name = _device_name(inp.device)
        # None (no OPTIONS file persisted) legitimately means defaults; a
        # CORRUPT/unreadable OPTIONS file must fail the job in-band rather
        # than silently compact with the wrong comparator/merge operator.
        options = load_latest_options(dbname, env=env)
        db = ReadOnlyDB.open(dbname, options, env=env)
        try:
            cfd = None
            for c in db._cfs.values():
                if c.handle.name == inp.cf_name:
                    cfd = c
                    break
            if cfd is None:
                raise InvalidArgument(f"no column family {inp.cf_name!r}")
            version = db.versions.cf_current(cfd.handle.id)
            by_number = {
                f.number: f for level_files in version.files
                for f in level_files
            }
            metas = []
            for num in inp.input_files:
                f = by_number.get(num)
                if f is None:
                    raise Corruption(
                        f"input file {num} not in the current version "
                        f"(compaction already superseded?)"
                    )
                metas.append(f)
            compaction = Compaction(
                level=0,  # per-file iterators: correct for any input mix
                output_level=inp.output_level,
                inputs=metas,
                bottommost=inp.bottommost,
                max_output_file_size=inp.max_output_file_size,
            )
            env.create_dir(output_dir)
            counter = [0]

            def alloc():
                counter[0] += 1
                return counter[0]

            from toplingdb_tpu_torch.db.blob import BlobSource

            blob_source = BlobSource(env, dbname)
            topts = db.options.table_options
            if device_name is None:
                outputs, stats = run_compaction_to_tables(
                    env, output_dir, db.icmp, compaction, db.table_cache,
                    topts, list(inp.snapshots),
                    merge_operator=db.options.merge_operator,
                    compaction_filter=db.options.compaction_filter,
                    new_file_number=alloc,
                    creation_time=inp.creation_time or None,
                    blob_resolver=blob_source.get,
                    column_family=(cfd.handle.id, cfd.handle.name),
                )
            else:
                from toplingdb_tpu_torch.ops.device_compaction import (
                    run_device_compaction,
                )

                outputs, stats = run_device_compaction(
                    env, output_dir, db.icmp, compaction, db.table_cache,
                    topts, list(inp.snapshots),
                    merge_operator=db.options.merge_operator,
                    compaction_filter=db.options.compaction_filter,
                    new_file_number=alloc,
                    creation_time=inp.creation_time or None,
                    device_name=device_name,
                    blob_resolver=blob_source.get,
                    column_family=(cfd.handle.id, cfd.handle.name),
                )
            files = [
                encode_file_meta(
                    m, os.path.basename(
                        filename.table_file_name(output_dir, m.number)
                    )
                )
                for m in outputs
            ]
            return CompactionServiceResult(
                status="ok", output_files=files,
                stats=dataclasses.asdict(stats),
                bytes_read=stats.input_bytes,
                bytes_written=stats.output_bytes,
            ).to_json()
        finally:
            db.close()
    except Exception as e:  # RPC shape: errors travel in-band
        return CompactionServiceResult(
            status=f"{type(e).__name__}: {e}", output_files=[],
        ).to_json()


def _device_name(device: str) -> str | None:
    """The job's device name → run_device_compaction's device_name (None:
    the host path), as the dcompact worker maps it; ValueError for any
    other name."""
    from toplingdb_tpu_torch.compaction.worker import _DEVICE_NAMES

    if device == "cpu":
        return None
    if device not in _DEVICE_NAMES:
        raise ValueError(f"unknown device {device!r}: expected one of "
                         f"{sorted(_DEVICE_NAMES) + ['cpu']}")
    return _DEVICE_NAMES[device]


class InProcessCompactionService:
    """Transport: run the worker half in this process (RocksDB's
    compaction_service_test.cc MyTestCompactionService shape)."""

    def __init__(self, env=None):
        self._env = env
        self.jobs = 0

    def __call__(self, dbname: str, output_dir: str, input_json: str) -> str:
        self.jobs += 1
        return open_and_compact(dbname, output_dir, input_json,
                                env=self._env)


class SubprocessCompactionService:
    """Transport: a fresh worker process per job (full isolation, RocksDB's
    remote worker binary, minus the network): `python -m
    toplingdb_tpu_torch.compaction.compaction_service DBNAME OUTPUT_DIR`
    with the job on stdin. `returncodes` logs each process's exit code."""

    def __init__(self):
        self.returncodes: list[int] = []

    def __call__(self, dbname: str, output_dir: str, input_json: str) -> str:
        import toplingdb_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(toplingdb_tpu_torch.__file__)
        ))
        p = subprocess.run(
            [sys.executable, "-m",
             "toplingdb_tpu_torch.compaction.compaction_service",
             dbname, output_dir],
            input=input_json, capture_output=True, text=True, cwd=pkg_root,
        )
        self.returncodes.append(p.returncode)
        if p.returncode != 0 or not p.stdout.strip():
            return CompactionServiceResult(
                status=f"worker process failed: {p.stderr[-500:]}",
                output_files=[],
            ).to_json()
        return p.stdout.strip().splitlines()[-1]


class CompactionServiceExecutor(CompactionExecutor):
    """DB-side half: serialize → service → install (the role of RocksDB's
    ProcessKeyValueCompactionWithCompactionService, compaction_job.cc).
    A failed job raises; its outputs are removed first."""

    def __init__(self, service, job_root: str | None = None,
                 device: str = "cuda"):
        self._service = service
        self._job_root = job_root
        self._device = device
        self._output_dir = None
        self._env = None

    _job_seq = itertools.count(1)

    def execute(self, db, compaction, snapshots, new_file_number):
        env = self._env = db.env
        root = self._job_root or os.path.join(db.dbname, "service_jobs")
        env.create_dir(root)
        # pid + process-global atomic counter (itertools.count next() is a
        # single bytecode under the GIL): unique under concurrent scheduler
        # fan-out AND across worker processes sharing the job root.
        seq = next(CompactionServiceExecutor._job_seq)
        out_dir = self._output_dir = os.path.join(
            root, f"job-{os.getpid()}-{seq:06d}",
        )
        # The worker reconstructs options from the persisted OPTIONS file,
        # which can only carry REGISTERED plugin objects — an unregistered
        # comparator/merge-operator/compaction-filter would silently compact
        # with defaults. Raise here instead: the job fails, nothing runs
        # it elsewhere.
        from toplingdb_tpu_torch.utils.config import options_to_config

        cfg = options_to_config(db.options)
        opts = db.options
        if opts.comparator.name() != "tpulsm.BytewiseComparator" and \
                "comparator" not in cfg:
            raise InvalidArgument(
                "unregistered comparator cannot travel the service boundary"
            )
        if opts.merge_operator is not None and "merge_operator" not in cfg:
            raise InvalidArgument(
                "unregistered merge operator cannot travel the service "
                "boundary"
            )
        if getattr(opts, "compaction_filter", None) is not None and \
                "compaction_filter" not in cfg:
            raise InvalidArgument(
                "unregistered compaction filter cannot travel the service "
                "boundary"
            )
        inp = CompactionServiceInput(
            cf_name=db.cf_name(compaction.cf_id),
            input_files=[f.number for _, f in compaction.all_inputs()],
            output_level=compaction.output_level,
            bottommost=compaction.bottommost,
            snapshots=list(snapshots),
            max_output_file_size=compaction.max_output_file_size,
            creation_time=int(time.time()),
            device=self._device,
        )
        t0 = time.time()
        try:
            res = CompactionServiceResult.from_json(
                self._service(db.dbname, out_dir, inp.to_json())
            )
            if res.status != "ok":
                raise Corruption(f"compaction service failed: {res.status}")
            outputs = []
            stats = CompactionStats(device="service")
            for k, v in (res.stats or {}).items():
                if hasattr(stats, k) and isinstance(v, (int, float)):
                    setattr(stats, k, v)
            # Install: move each output under a DB-allocated file number
            # (RocksDB's RunRemote RenameFile loop, compaction_job.cc).
            for d in res.output_files:
                num = new_file_number()
                src = os.path.join(out_dir, d["path"])
                dst = filename.table_file_name(db.dbname, num)
                env.rename_file(src, dst)
                outputs.append(decode_file_meta(d, num))
        except BaseException:
            # Un-installed worker outputs must not stay under the DB dir:
            # the job raises with its output dir emptied and removed.
            self.clean_files()
            raise
        stats.rpc_time_usec = int((time.time() - t0) * 1e6)
        stats.device = "service"
        self.clean_files()  # emptied job dir
        return outputs, stats

    def clean_files(self):
        if self._output_dir is not None and self._env is not None:
            try:
                for child in self._env.get_children(self._output_dir):
                    self._env.delete_file(
                        os.path.join(self._output_dir, child)
                    )
            except Exception as e:
                _errors.swallow(reason="remote-output-cleanup", exc=e)
            try:
                os.rmdir(self._output_dir)  # best-effort for posix envs
            except OSError:
                pass


class CompactionServiceExecutorFactory(CompactionExecutorFactory):
    """RocksDB's ColumnFamilyOptions.compaction_service, routed through the
    executor seam. `device` is every job's CompactionServiceInput.device
    ("cuda" by default; see the module docstring). There is no fallback
    (the reference's `allow_fallback`): a failed job raises."""

    def __init__(self, service=None, job_root: str | None = None,
                 device: str = "cuda"):
        _device_name(device)  # an unknown name raises here
        self._service = service or InProcessCompactionService()
        self._job_root = job_root
        self.device = device

    def should_run_local(self, compaction: Compaction) -> bool:
        return False

    def new_executor(self, compaction: Compaction) -> CompactionExecutor:
        return CompactionServiceExecutor(self._service, self._job_root,
                                         self.device)

    def job_url(self, job_id: int, attempt: int) -> str:
        return f"service://job-{job_id:05d}/att-{attempt:02d}"


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m toplingdb_tpu_torch.compaction.compaction_service "
              "<dbname> <output_dir>  (input JSON on stdin)", file=sys.stderr)
        return 2
    print(open_and_compact(argv[0], argv[1], sys.stdin.read()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
