"""Compaction worker process: the dcompact worker (the counterpart of
toplingdb_tpu/compaction/worker.py).

Runs one serialized compaction job from a job dir (params.json → SST
outputs + results.json). This is the process that owns the card in a
disaggregated deployment: it reads the input SSTs from shared storage, runs
the device data plane and writes the outputs back. A job dir written by
either package runs on either package's worker.

The job's `device` field picks the route:
  "cuda", "tpu", "device"  the device data plane on the card
                           (`run_device_compaction(device_name="cuda")`);
                           without a card the job fails, it never falls
                           back to the CPU
  "cpu-jax"                the same data plane through the kernels' plain
                           versions on the host (`device_name="cpu"`)
  "cpu"                    the per-entry CompactionIterator over the
                           host-sorted inputs
A non-bytewise comparator takes the per-entry branch (with the device
stream for the device names, which refuses it, as the reference's does).
Every table format, a prefix extractor and property collectors travel in
the job (`table_format`, `prefix_extractor`, `collectors`;
`executor.table_options_from_params`), and so do the data plane's route
arguments (`host_sort`, `host_merge`, `mesh_devices`; `run_job`'s
`mesh_devices` overrides the job's, for the service's chip grant). Any
other device name fails with ValueError before any file is written.

Store mode (`store_spec`, `input_addrs`; storage/): the inputs resolve from
the shared store by content address into a scratch directory of this
process (materialized on first open, each fetch verified against its
address), the job runs on its device as above, and each output is
checksum-stamped, published to the store, pinned until the DB adopts it
and answered as `store_addr`: the job dir carries only params and
results. A store_spec that names no backend (neither a directory path nor
an http(s):// URL) fails with NotSupported before any file is written.
With TPULSM_TEST_WORKER_CRASH=mid_job in its environment
(the fault injector's "kill" plan sets it in the child's environment only)
the worker dies mid-job as kill -9 would, exit code 137.

Usage: python -m toplingdb_tpu_torch.compaction.worker --job-dir DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import traceback

# The job's device name → run_device_compaction's device_name.
_DEVICE_NAMES = {"cuda": "cuda", "tpu": "cuda", "device": "cuda",
                 "cpu-jax": "cpu"}


def run_job(job_dir: str, mesh_devices=None) -> int:
    """Run the job of `job_dir`. `mesh_devices` (a list of device names)
    overrides the params' own: the worker service passes its chip grant
    here."""
    from toplingdb_tpu_torch.compaction.executor import CompactionParams

    t_enter = time.time()
    pjson = os.path.join(job_dir, "params.json")
    try:
        # Queue wait: params were written when the job was submitted.
        waiting_usec = max(0, int((t_enter - os.path.getmtime(pjson)) * 1e6))
    except OSError:
        waiting_usec = 0
    with open(pjson) as f:
        params = CompactionParams.from_json(f.read())
    if mesh_devices is not None:
        params.mesh_devices = list(mesh_devices)
    # Job lease: heartbeat the job dir while the job runs, so the
    # submitting side can tell a live job from an orphan.
    heartbeat = None
    lease_sec = float(params.lease_sec or 0.0)
    if lease_sec > 0:
        from toplingdb_tpu_torch.compaction.resilience import HeartbeatWriter

        heartbeat = HeartbeatWriter(job_dir, lease_sec).start()
    # Cross-process tracing: adopt the submitter's context when it sampled
    # this job, record this worker's spans, and append them to
    # results.json for the submitter to stitch.
    from toplingdb_tpu_torch.utils import telemetry

    ctx = params.trace
    root = None
    if ctx and ctx.get("sampled"):
        tracer = telemetry.Tracer(sample_every=1, proc="dcompact-worker")
        root = tracer.start_from(ctx, "dcompact.worker",
                                 job_id=params.job_id,
                                 attempt=params.attempt,
                                 device=params.device)
    try:
        return _run_job_inner(job_dir, params, t_enter, waiting_usec)
    finally:
        if root is not None:
            tracer_ = root._tracer
            root.finish()
            _append_result_spans(job_dir,
                                 tracer_.export_trace(root.trace_id))
        if heartbeat is not None:
            heartbeat.stop()


def _run_job_inner(job_dir: str, params, t_enter: float,
                   waiting_usec: int) -> int:
    if params.device not in _DEVICE_NAMES and params.device != "cpu":
        raise ValueError(f"unknown device {params.device!r}: expected one "
                         f"of {sorted(_DEVICE_NAMES) + ['cpu']}")
    store_mode = _StoreJobMode.maybe(params)
    try:
        return _run_job_body(job_dir, params, t_enter, waiting_usec,
                             store_mode)
    finally:
        if store_mode is not None:
            store_mode.cleanup()


def _run_job_body(job_dir: str, params, t_enter: float,
                  waiting_usec: int, store_mode) -> int:
    from toplingdb_tpu_torch.compaction.compaction_job import (
        CompactionStats,
        build_outputs,
        emit_phase_spans,
        surviving_tombstone_fragments,
    )
    from toplingdb_tpu_torch.compaction.executor import (
        CompactionResults,
        table_options_from_params,
    )
    from toplingdb_tpu_torch.compaction.picker import Compaction
    from toplingdb_tpu_torch.db import dbformat
    from toplingdb_tpu_torch.db.blob import BlobSource
    from toplingdb_tpu_torch.db.range_del import (
        RangeDelAggregator,
        RangeTombstone,
    )
    from toplingdb_tpu_torch.db.version_edit import FileMetaData
    from toplingdb_tpu_torch.env import PosixEnv
    from toplingdb_tpu_torch.table.factory import open_table
    from toplingdb_tpu_torch.utils import telemetry
    from toplingdb_tpu_torch.utils.compaction_filter import (
        create_compaction_filter,
    )

    if os.environ.get("TPULSM_TEST_WORKER_CRASH") == "mid_job":
        # Chaos hook (resilience.DcompactFaultInjector's "kill" plan, set
        # in this process's environment by the spawning side): die the
        # way kill -9 does — a partial output on disk, heartbeats
        # stopped, no results.json, no cleanup.
        with open(os.path.join(params.output_dir, "partial.sst"),
                  "wb") as f:
            f.write(b"\x00" * 4096)
        os._exit(137)
    env = PosixEnv()
    if store_mode is not None:
        # The inputs resolve from the shared store into this process's
        # scratch dir, and the outputs are written there and published
        # back: the job dir (the transport) carries no SST bytes.
        env = store_mode.attach(env)
    comparators = {c.name(): c for c in (dbformat.BYTEWISE,
                                         dbformat.REVERSE_BYTEWISE,
                                         dbformat.U64_TS_BYTEWISE)}
    if params.comparator not in comparators:
        raise ValueError(f"unknown comparator {params.comparator!r}")
    # The u64-timestamp comparator's order (key asc, ts desc) is baked into
    # the stored bytes, so the device sort and GC mask are right for it
    # (device_gc_entries keeps its bottommost tombstones, as
    # CompactionIterator does). CompactionParams carries no history trim
    # point (the reference's format has none), so a worker job keeps every
    # version below full_history_ts_low: safe, since reads below it are
    # refused.
    ucmp = comparators[params.comparator]
    icmp = dbformat.InternalKeyComparator(ucmp)
    merge_op = (_merge_operator_by_name(params.merge_operator)
                if params.merge_operator else None)
    cfilter = (create_compaction_filter(params.compaction_filter)
               if params.compaction_filter else None)
    topts = table_options_from_params(params)
    column_family = (params.cf_id, params.cf_name)

    blob_source = BlobSource(env, params.dbname)
    counter = [0]

    def alloc():
        counter[0] += 1
        return counter[0]

    device_name = _DEVICE_NAMES.get(params.device)   # None: "cpu"
    if device_name is not None and ucmp is dbformat.BYTEWISE:
        # The device data plane: the pipelined / columnar routes of
        # run_device_compaction, with the per-phase stats in results.json.
        from toplingdb_tpu_torch.ops.device_compaction import (
            run_device_compaction,
        )

        readers = {}
        metas = []
        for i, path in enumerate(params.input_files, 1):
            r = open_table(env.new_random_access_file(path), icmp, topts)
            readers[i] = r
            # Real key bounds and entry counts: the planes shard by them.
            it = r.new_iterator()
            it.seek_to_first()
            smallest = it.key() if it.valid() else b""
            it.seek_to_last()
            largest = it.key() if it.valid() else smallest
            metas.append(FileMetaData(
                number=i, file_size=env.get_file_size(path),
                smallest=smallest, largest=largest,
                num_entries=r.properties.num_entries,
                num_deletions=r.properties.num_deletions,
            ))
        fake_compaction = Compaction(
            level=0, output_level=params.output_level, inputs=metas,
            bottommost=params.bottommost,
            max_output_file_size=params.max_output_file_size,
        )
        outputs, stats = run_device_compaction(
            env, params.output_dir, icmp, fake_compaction,
            _PathTableCache(readers), topts, params.snapshots,
            merge_operator=merge_op, compaction_filter=cfilter,
            new_file_number=alloc, creation_time=params.creation_time,
            device_name=device_name, blob_resolver=blob_source.get,
            column_family=column_family, host_sort=params.host_sort,
            host_merge=params.host_merge, mesh_devices=params.mesh_devices,
        )
        stats.input_files = len(params.input_files)
        stats.input_bytes = sum(
            env.get_file_size(p) for p in params.input_files)
        stats.prepare_time_usec = max(
            0, int((time.time() - t_enter) * 1e6) - stats.work_time_usec)
        stats.waiting_time_usec = waiting_usec
        emit_phase_spans(stats)  # the worker's interior, under its root
        results = CompactionResults(
            status="ok",
            output_files=_encode_outputs(outputs, env, params,
                                         store_mode),
            stats=dataclasses.asdict(stats),
            work_time_usec=stats.work_time_usec,
        )
        with open(os.path.join(job_dir, "results.json"), "w") as f:
            f.write(results.to_json())
        return 0

    # The per-entry branch ("cpu", and other comparators): read the inputs
    # raw, unsorted for the device stream, host-sorted for the iterator.
    entries = []
    rd = RangeDelAggregator(ucmp)
    with telemetry.span("compaction.input_scan",
                        files=len(params.input_files)):
        for path in params.input_files:
            r = open_table(env.new_random_access_file(path), icmp, topts)
            it = r.new_iterator()
            it.seek_to_first()
            for k, v in it.entries():
                entries.append((k, v))
            for b, e in r.range_del_entries():
                rd.add(RangeTombstone.from_table_entry(b, e))

    stats = CompactionStats(device=params.device)
    stats.input_records = len(entries)
    stats.input_files = len(params.input_files)
    stats.input_bytes = sum(env.get_file_size(p) for p in params.input_files)
    # Setup + input scan before the merge / GC work starts.
    stats.prepare_time_usec = int((time.time() - t_enter) * 1e6)
    stats.waiting_time_usec = waiting_usec

    fake_compaction = Compaction(
        level=0, output_level=params.output_level, inputs=[],
        bottommost=params.bottommost,
        max_output_file_size=params.max_output_file_size,
    )

    if device_name is not None:
        from toplingdb_tpu_torch.ops.device_compaction import (
            device_gc_entries,
        )

        stream = device_gc_entries(
            entries, icmp, params.snapshots, params.bottommost,
            merge_operator=merge_op, compaction_filter=cfilter,
            compaction_filter_level=params.output_level,
            rd=None if rd.empty() else rd,
            blob_resolver=blob_source.get, device_name=device_name,
        )
    else:
        from toplingdb_tpu_torch.compaction.compaction_iterator import (
            CompactionIterator,
        )

        entries.sort(key=lambda kv: icmp.sort_key(kv[0]))
        stream = CompactionIterator(
            _ListIter(entries), icmp, params.snapshots,
            bottommost_level=params.bottommost, merge_operator=merge_op,
            compaction_filter=cfilter,
            compaction_filter_level=params.output_level,
            range_del_agg=None if rd.empty() else rd,
            blob_resolver=blob_source.get,
        ).entries()

    tombs = surviving_tombstone_fragments(
        rd, params.snapshots, params.bottommost, ucmp)
    with telemetry.span("compaction.encode_write"):
        outputs = build_outputs(
            env, params.output_dir, icmp, fake_compaction, stream, tombs,
            alloc, topts, stats, params.creation_time,
            column_family=column_family,
        )
    results = CompactionResults(
        status="ok",
        output_files=_encode_outputs(outputs, env, params, store_mode),
        stats=dataclasses.asdict(stats),
        # Disjoint from prepare: waiting + prepare + work partition the
        # worker's wall clock.
        work_time_usec=max(
            0, int((time.time() - t_enter) * 1e6) - stats.prepare_time_usec),
    )
    with open(os.path.join(job_dir, "results.json"), "w") as f:
        f.write(results.to_json())
    return 0


class _StoreJobMode:
    """A store-mode job's context (storage/): resolve the inputs from the
    shared store by content address, publish the outputs back, pin them
    until the DB side adopts them. Every SST byte lives in a scratch dir
    of this process, removed when the job ends, never in the job dir."""

    @staticmethod
    def maybe(params):
        """The job's store context, or None for a path-mode job. Refuses,
        before any file is written, a store_spec no backend opens and a
        job without an address for every input."""
        if not params.store_spec:
            return None
        from toplingdb_tpu_torch.storage import check_store_spec
        from toplingdb_tpu_torch.utils.status import InvalidArgument

        check_store_spec(params.store_spec)
        addrs = params.input_addrs or []
        if len(addrs) != len(params.input_files) or not all(addrs):
            raise InvalidArgument(
                f"store_spec job with {len(params.input_files)} inputs "
                f"and input_addrs {params.input_addrs!r}: every input "
                f"needs its store address")
        return _StoreJobMode(params)

    def __init__(self, params):
        import tempfile

        self.params = params
        self.holder = f"dcompact-job-{params.job_id}"
        self.scratch = tempfile.mkdtemp(
            prefix=f"dcompact-store-{params.job_id}-")
        self.env = None
        self.store = None

    def attach(self, base_env):
        from toplingdb_tpu_torch.storage import SharedSstEnv, open_store

        self.store = open_store(self.params.store_spec)
        self.env = SharedSstEnv(base_env, self.store)
        out_dir = os.path.join(self.scratch, "out")
        os.makedirs(out_dir, exist_ok=True)
        local_inputs = []
        for path, addr in zip(self.params.input_files,
                              self.params.input_addrs):
            lp = os.path.join(self.scratch, os.path.basename(path))
            self.env.adopt(lp, addr)  # materializes on first open
            local_inputs.append(lp)
        self.params.input_files = local_inputs
        self.params.output_dir = out_dir
        return self.env

    def publish_output(self, env, path: str, meta) -> dict:
        """Checksum-stamp and publish one output; returns the keys the DB
        side needs to adopt it (its address and its digest)."""
        from toplingdb_tpu_torch.storage.object_store import address_of_meta
        from toplingdb_tpu_torch.utils.file_checksum import (
            FileChecksumGenFactory,
            stamp_file_checksum,
        )

        factory = FileChecksumGenFactory(
            self.params.checksum_func or "crc32c")
        stamp_file_checksum(env, path, meta, factory)
        addr = address_of_meta(meta)
        self.store.publish_file(path, addr, src_env=env.base)
        # Pinned until the DB side's adopt makes a refs-table entry (the
        # GC's mark phase sees that); the TTL bounds a crashed primary.
        self.store.pin(addr, self.holder)
        return {"store_addr": addr,
                "file_checksum": meta.file_checksum.hex(),
                "file_checksum_func_name": meta.file_checksum_func_name}

    def cleanup(self):
        import shutil

        shutil.rmtree(self.scratch, ignore_errors=True)
        if self.env is not None:
            self.env.close()


def _encode_outputs(outputs, env, params, store_mode) -> list[dict]:
    from toplingdb_tpu_torch.compaction.executor import encode_file_meta

    docs = []
    for m in outputs:
        name = f"{m.number:06d}.sst"
        d = encode_file_meta(m, name)
        if store_mode is not None:
            d.update(store_mode.publish_output(
                env, os.path.join(params.output_dir, name), m))
        docs.append(d)
    return docs


def _append_result_spans(job_dir: str, spans: list) -> None:
    """Re-open results.json and attach the worker's finished spans (the
    results were written by the job body before the tracer could close its
    root). A failed job has no results.json to annotate yet."""
    import json

    path = os.path.join(job_dir, "results.json")
    try:
        with open(path) as f:
            results = json.load(f)
        results["spans"] = spans
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
    except (OSError, ValueError):
        pass


def _merge_operator_by_name(name: str):
    from toplingdb_tpu_torch.utils.merge_operator import (
        create_merge_operator,
    )

    return create_merge_operator(name)


class _PathTableCache:
    """TableCache-shaped view over the job's already-open input readers
    (the worker addresses inputs by path, not by live version state)."""

    def __init__(self, readers: dict):
        self._readers = readers

    def get_reader(self, number: int):
        return self._readers[number]


class _ListIter:
    def __init__(self, items):
        self._items = items
        self._i = 0

    def valid(self):
        return self._i < len(self._items)

    def key(self):
        return self._items[self._i][0]

    def value(self):
        return self._items[self._i][1]

    def next(self):
        self._i += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run one dcompact job from a job dir.")
    ap.add_argument("--job-dir", required=True)
    args = ap.parse_args(argv)
    try:
        return run_job(args.job_dir)
    except Exception as e:  # noqa: BLE001 - reported through results.json
        traceback.print_exc()
        try:
            from toplingdb_tpu_torch.compaction.executor import (
                CompactionResults,
            )

            with open(os.path.join(args.job_dir, "results.json"), "w") as f:
                f.write(CompactionResults(
                    status=f"{type(e).__name__}: {e}", output_files=[],
                    stats={},
                ).to_json())
        except OSError:
            pass
        return 1


if __name__ == "__main__":
    sys.exit(main())
