"""The mesh route: one job's uniform key-range shards fanned out over a
list of devices (the counterpart of toplingdb_tpu/ops/mesh_compaction.py).

The single-device plane (ops/device_compaction.py) already splits a big
job into presorted uniform shards and runs one program per shard; a
shard's program runs where its uploads are. The mesh route is placement,
not a new kernel: each shard's `upload_uniform_shard` buffers go to a
device picked round-robin from the plan, so S shards run on D devices
while the host consumes the finishes in shard order into the same
writers. The bytes equal the single-device plane's by construction (the
same per-shard program on the same per-shard inputs, stitched in the same
order).

Dispatch is double-buffered per device (mesh_plan.UPLOAD_DEPTH uploads in
flight each). The device list is an argument (`mesh_devices=`; the
reference reads TPULSM_MESH_COMPACT): None keeps the single-device plane,
and an ineligible job (complex groups, non-uniform shards, below the row
floor, one shard or one device) falls back to it, counted on
`CompactionStats.mesh_fallbacks`. A device that fails mid-job is wedged,
by its index in the plan (two entries may name the same card): its shards
re-dispatch onto the surviving entries, or onto the job's own device when
none survives, never onto the host; when that device fails too, the job
raises. The demotion is counted on `mesh_fallbacks` and emitted as a
`compaction.mesh.fallback` span event beside the per-device
`compaction.mesh.shard` spans.

The pipelined route places one `mesh_devices` list differently, on
purpose and as the reference does (its ops/pipeline.py `_device_compute`):
its shards arrive one scan at a time, so there is no whole job for
`check_eligibility`'s row floor and shape checks (`pipeline_devices` asks
only for two devices and two shards, and the pipeline checks each shard as
it lands), and its first device failure demotes every remaining shard to
the job's own device (`_demote` in ops/pipeline.py) instead of wedging one
entry. Either way the bytes are the single-device bytes.
"""

from __future__ import annotations

import time

import torch

from toplingdb_tpu_torch.parallel import mesh_plan
from toplingdb_tpu_torch.utils import telemetry
from toplingdb_tpu_torch.utils.status import NotSupported

# Test seam: callable(shard_idx, device) invoked before each dispatch;
# raising simulates a device failure at that point. Set by tests only.
_FAULT_HOOK = None


def maybe_plan(shards, any_complex: bool = False, stats=None, trace=None,
               mesh_devices=None, min_rows: int | None = None):
    """A MeshPlan over `mesh_devices` when the job is eligible, else None.
    With a device list given, an ineligible job is a fallback: counted on
    `stats.mesh_fallbacks` and emitted as a `compaction.mesh.fallback`
    event naming the reason."""
    if mesh_devices is None:
        return None
    plan, reason = mesh_plan.plan_shards(shards, any_complex,
                                         list(mesh_devices), min_rows)
    if plan is None:
        if stats is not None:
            stats.mesh_fallbacks = getattr(stats, "mesh_fallbacks", 0) + 1
        telemetry.span_event_under(trace, "compaction.mesh.fallback", 0,
                                   reason=reason)
        return None
    if stats is not None:
        stats.mesh_chips = plan.n_devices
        stats.mesh_shards = len(shards)
    return plan


class MeshShardRun:
    """Windowed round-robin dispatch of one job's shards over a plan's
    devices. `finish(s)` must be called for s = 0..n_shards-1 in order (the
    writers consume survivor orders in shard order); each finish tops the
    window back up, keeping every device double-buffered.

    plan=None is the serial twin: every shard uploads up front to
    `device`, the single-device plane's dispatch."""

    def __init__(self, plan, shards, cover, snapshots, bottommost,
                 stats=None, trace=None, device="cuda"):
        from toplingdb_tpu_torch.ops import compaction_kernels as ck

        self._ck = ck
        self._plan = plan
        self._shards = shards
        self._cover = cover
        self._snapshots = snapshots
        self._bottommost = bottommost
        self._stats = stats
        self._trace = trace
        self._device = torch.device(device)
        self._wedged: set[int] = set()
        self._pend: dict[int, tuple] = {}
        self._next = 0
        self._window = plan.window if plan is not None else len(shards)
        self._fill()

    # -- placement ---------------------------------------------------------

    def _device_for(self, s: int):
        """(plan index, device) of shard s: the plan's round-robin
        assignment, re-mapped onto the surviving entries once any is
        wedged; (None, the job's device) when none survives."""
        if self._plan is None:
            return None, self._device
        if not self._wedged:
            i = self._plan.assignments[s]
            return i, self._plan.devices[i]
        healthy = [i for i in range(self._plan.n_devices)
                   if i not in self._wedged]
        if not healthy:
            return None, self._device
        i = healthy[s % len(healthy)]
        return i, self._plan.devices[i]

    def _wedge(self, idx: int, exc) -> None:
        if idx in self._wedged:
            return
        self._wedged.add(idx)
        if self._stats is not None:
            self._stats.mesh_fallbacks = getattr(
                self._stats, "mesh_fallbacks", 0) + 1
            self._stats.mesh_chips = max(
                1, self._plan.n_devices - len(self._wedged))
        telemetry.span_event_under(
            self._trace, "compaction.mesh.fallback", 0,
            reason="chip-wedged", chip=f"{idx}:{self._plan.devices[idx]}",
            error=type(exc).__name__)

    # -- dispatch ----------------------------------------------------------

    def _covers_for(self, ranges):
        if self._cover is None:
            return None
        return [self._cover[lo:hi] for lo, hi in ranges]

    def _start_on(self, s: int, device):
        chunks, ranges = self._shards[s]
        if _FAULT_HOOK is not None:
            _FAULT_HOOK(s, device)
        h = self._ck.upload_uniform_shard(chunks, self._covers_for(ranges),
                                          device=device)
        return self._ck.fused_uniform_shard_start(
            h, self._snapshots, self._bottommost)

    def _dispatch(self, s: int) -> None:
        while True:
            idx, device = self._device_for(s)
            try:
                pending = self._start_on(s, device)
            except NotSupported:
                raise  # a job-shape refusal: the caller's route decides
            except Exception as e:
                if idx is None:
                    raise  # the job's own device failed: a real error
                self._wedge(idx, e)
                continue  # the next surviving entry, or the job's device
            self._pend[s] = (pending, idx, device, time.time())
            return

    def _fill(self) -> None:
        n = len(self._shards)
        while self._next < n and len(self._pend) < self._window:
            self._dispatch(self._next)
            self._next += 1

    # -- consume -----------------------------------------------------------

    def finish(self, s: int):
        """Block on shard s's result (order, zero_flags, cx_flags,
        has_complex); re-dispatches the shard elsewhere if its device
        fails under the wait, then refills the window."""
        pending, idx, device, t_disp = self._pend.pop(s)
        while True:
            try:
                out = self._ck.fused_uniform_shard_finish(pending)
                break
            except Exception as e:
                if idx is None:
                    raise
                self._wedge(idx, e)
                self._dispatch(s)  # the same program elsewhere, same bytes
                pending, idx, device, t_disp = self._pend.pop(s)
        if self._plan is not None:
            chunks, _ranges = self._shards[s]
            telemetry.span_event_under(
                self._trace, "compaction.mesh.shard",
                (time.time() - t_disp) * 1e6, shard=s,
                chip=f"{idx}:{device}" if idx is not None else "default",
                rows=sum(int(c[3]) for c in chunks))
        self._fill()
        return out


def dispatch_shards(shards, cover, snapshots, bottommost, stats=None,
                    any_complex: bool = False, trace=None, device="cuda",
                    mesh_devices=None):
    """The seam device_compaction calls: plan over `mesh_devices` (None:
    no mesh), then return (finish(s), mesh_active). A job without a plan
    gets the serial dispatch, every shard uploaded up front to `device`."""
    plan = maybe_plan(shards, any_complex=any_complex, stats=stats,
                      trace=trace, mesh_devices=mesh_devices)
    run = MeshShardRun(plan, shards, cover, snapshots, bottommost,
                       stats=stats, trace=trace, device=device)
    return run.finish, plan is not None


def pipeline_devices(n_shards: int, stats=None, mesh_devices=None):
    """Devices for the pipelined plane's compute stage: `mesh_devices`
    when there are at least two of them and two shards (the pipeline
    checks each shard's shape itself as its scan lands), else None (the
    single-buffer path)."""
    if mesh_devices is None or n_shards < 2 or len(mesh_devices) < 2:
        return None
    devices = list(mesh_devices)
    if stats is not None:
        stats.mesh_chips = len(devices)
        stats.mesh_shards = n_shards
    return devices
