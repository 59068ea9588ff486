"""Shard → device planning shared by the mesh route
(ops/mesh_compaction.py) and the scaling probe (parallel/scaling_probe.py)
(the counterpart of toplingdb_tpu/parallel/mesh_plan.py).

One compaction job's uniform key-range shards (device_compaction's
`_prepare_uniform_shards` output) are placed round-robin over a list of
devices; each shard's uploads land on its device, which runs the same
per-shard program as the single-device plane, so the bytes are identical.
Eligibility is decided here: one fallback matrix for the route, the probe
and the tests.

The device list, its cap and the row floor are arguments (the reference
reads TPULSM_MESH_DEVICES and TPULSM_MESH_MIN_ROWS); the reference's
configure_virtual_devices / pin_cpu_backend have no counterpart: the
port's device list is whatever the caller passes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

# Probe exit codes: 0 = measured, EXIT_SKIP = the environment cannot run
# the probe (no backend, too few devices), EXIT_FAILURE = the measurement
# itself broke.
EXIT_OK = 0
EXIT_FAILURE = 1
EXIT_SKIP = 3

# Below this many total rows a fan-out loses to its dispatch overhead; the
# job stays on one device.
DEFAULT_MESH_MIN_ROWS = 1 << 18

# In-flight uploads per device: 2 = a double buffer (shard s+D's copies
# stream while shard s computes on the same device).
UPLOAD_DEPTH = 2


def mesh_devices(limit: int | None = None) -> list[torch.device]:
    """The CUDA devices a plan may use, `limit` of them at most (None:
    every visible card)."""
    devs = [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]
    if limit is not None and limit > 0:
        devs = devs[:max(1, limit)]
    return devs


@dataclass
class MeshPlan:
    """One job's shard → device placement. `assignments[s]` is the index
    into `devices` of the device that runs shard s; round-robin keeps each
    device's queue at most ceil(S/D) deep and makes shards s and s+D the
    double-buffer pair. Two entries may name the same device."""

    devices: list
    assignments: list[int]
    total_rows: int
    depth: int = UPLOAD_DEPTH

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def window(self) -> int:
        """How many shards may be dispatched ahead of the consumer."""
        return self.depth * len(self.devices)


def check_eligibility(shards, any_complex: bool, devices,
                      min_rows: int | None = None):
    """The fallback matrix: (reason, total_rows), reason None when a mesh
    plan is allowed. Reasons: no-uniform-shards, single-shard,
    complex-groups, below-row-floor, single-device. `min_rows` None:
    DEFAULT_MESH_MIN_ROWS."""
    if min_rows is None:
        min_rows = DEFAULT_MESH_MIN_ROWS
    if not shards:
        return "no-uniform-shards", 0
    total = sum(int(c[3]) for chunks, _ranges in shards for c in chunks)
    if len(shards) < 2:
        return "single-shard", total
    if any_complex:
        # MERGE / SINGLE_DELETION groups fold on the host in stream order.
        return "complex-groups", total
    if total < min_rows:
        return "below-row-floor", total
    if len(devices) < 2:
        return "single-device", total
    return None, total


def plan_shards(shards, any_complex: bool = False, devices=None,
                min_rows: int | None = None):
    """(MeshPlan, None) when the job is mesh-eligible, (None, reason)
    otherwise. `devices` None: mesh_devices()."""
    if devices is None:
        devices = mesh_devices()
    reason, total = check_eligibility(shards, any_complex, devices,
                                      min_rows)
    if reason is not None:
        return None, reason
    assignments = [s % len(devices) for s in range(len(shards))]
    return MeshPlan(list(devices), assignments, total), None


# ---------------------------------------------------------------------------
# The probe's measurement loops
# ---------------------------------------------------------------------------


def make_weak_scaling_job(n: int, seed: int = 7) -> dict:
    """A padded GC job of n rows (12-byte user keys, unique seqnos) for
    the distributed GC step."""
    from toplingdb_tpu_torch.db.dbformat import ValueType, make_internal_key
    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops.columnar import ColumnarEntries

    rng = np.random.default_rng(seed)
    draws = rng.integers(0, n, n)
    entries = [
        (make_internal_key(b"%012d" % draws[i], i + 1, ValueType.VALUE),
         b"v")
        for i in range(n)
    ]
    return ck.pad_columns(ColumnarEntries.from_entries(entries, 12))


def weak_scaling_rows(mesh_for, rows_per_device: int, max_devices: int,
                      repeats: int = 3) -> list[dict]:
    """Run run_distributed_gc over (jobs=1, range=R) meshes for R = 1, 2,
    4 .. max_devices with a FIXED row count per device; best-of-`repeats`
    wall per R. `mesh_for(R)` returns this rank's mesh of R ranges, or None
    when this rank sits out R; every rank calls it for every R. Rows are
    returned on the ranks that took part."""
    import torch.distributed as dist

    from toplingdb_tpu_torch.parallel.distributed_gc import (
        run_distributed_gc,
    )

    rows_list = []
    counts = [1 << i for i in range(max_devices.bit_length())
              if (1 << i) <= max_devices]
    for r in counts:
        mesh = mesh_for(r)
        dist.barrier()
        if mesh is None:
            continue
        n = rows_per_device * r
        job = make_weak_scaling_job(n)
        run_distributed_gc(mesh, [job], [], True)  # the groups' first use
        best = None
        for _ in range(repeats):
            mesh.barrier()
            t0 = time.time()
            run_distributed_gc(mesh, [job], [], True)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        rows_list.append({"range_devices": r, "rows": n,
                          "rows_per_device": rows_per_device,
                          "best_s": best, "rows_per_s": n / best})
    return rows_list


def _make_uniform_shards(n_shards: int, rows_per_shard: int,
                         key_len: int = 20, seed: int = 11):
    """`_prepare_uniform_shards`-shaped input: n_shards range shards of
    presorted uniform internal keys (key_len includes the 8-byte trailer)
    over disjoint user-key ranges."""
    from toplingdb_tpu_torch.ops import compaction_kernels as ck

    rng = np.random.default_rng(seed)
    shards = []
    row_base = 0
    uk_len = key_len - 8
    for s in range(n_shards):
        uk = np.sort(rng.integers(0, rows_per_shard * 4, rows_per_shard))
        recs = []
        # Internal-key order: a duplicate user key's seqnos descend.
        j = rows_per_shard
        for k in uk:
            packed = ((row_base + j) << 8) | 1
            j -= 1
            recs.append((b"%02d" % s) + (b"%0*d" % (uk_len - 2, int(k)))
                        + packed.to_bytes(8, "little"))
        buf = np.frombuffer(b"".join(recs), np.uint8)
        chunk = ck.prepare_uniform_chunk(buf, rows_per_shard, key_len)
        shards.append(([chunk], [(row_base, row_base + rows_per_shard)]))
        row_base += rows_per_shard
    return shards


def mesh_compact_rows(rows_per_shard: int, devices: list, repeats: int = 3,
                      n_shards: int | None = None,
                      key_len: int = 20) -> list[dict]:
    """The same uniform shards through the mesh shard runner at one device
    and over `devices`: wall and MB/s per configuration (strong scaling of
    one fanned-out job). Devices may repeat (placement on one card)."""
    from toplingdb_tpu_torch.ops import mesh_compaction as mc

    if n_shards is None:
        n_shards = max(2, len(devices)) * UPLOAD_DEPTH
    shards = _make_uniform_shards(n_shards, rows_per_shard, key_len=key_len)
    total = n_shards * rows_per_shard
    out = []
    configs = [[devices[0]]] + ([list(devices)] if len(devices) > 1
                                else [])
    for devs in configs:
        plan, _reason = plan_shards(shards, devices=devs, min_rows=1)
        best = None
        for _ in range(repeats):
            t0 = time.time()
            run = mc.MeshShardRun(plan, shards, None, [], True,
                                  device=devs[0])
            for s in range(len(shards)):
                run.finish(s)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        out.append({"devices": len(devs), "rows": total, "shards": n_shards,
                    "best_s": best, "rows_per_s": total / best,
                    "MBps": total * key_len / best / 1e6})
    return out
