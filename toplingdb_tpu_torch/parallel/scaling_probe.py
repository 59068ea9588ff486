"""Multi-device probe CLI, a thin wrapper over parallel/mesh_plan.py (the
counterpart of toplingdb_tpu/parallel/scaling_probe.py). Two modes, each
printing one JSON line:

  weak (default)  weak scaling of the distributed GC step:
                  run_distributed_gc over (jobs=1, range=R) meshes for
                  R = 1, 2, 4 .. devices with a fixed row count per rank.
                  On "cpu" the ranks are gloo processes; on "cuda" one
                  NCCL rank per card.
  mesh            the mesh route: the same uniform key-range shards
                  through the mesh shard runner (ops/mesh_compaction.py)
                  on one device and on `devices` entries (on "cpu" the
                  entries are the host, placement only).

On the CPU the ranks share one host, so the numbers describe partitioning
and collective overhead, not device throughput.

Exit codes: 0 measured; 3 SKIP (the environment cannot run the probe:
more devices asked for than there are cards, or ranks than CPU cores); 1
the measurement itself failed.

Usage: python -m toplingdb_tpu_torch.parallel.scaling_probe
           [--mode weak|mesh] [--devices N] [--rows-per-device R]
           [--repeats K] [--device cuda|cpu]

The probe runs on the cards unless --device cpu asks for gloo ranks on the
host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from toplingdb_tpu_torch.parallel import mesh_plan


def _weak_rank(rank, world, rows_per_device, repeats, device, out_path):
    from toplingdb_tpu_torch.parallel import distributed_gc as dg

    def mesh_for(r):
        return dg.make_mesh(1, r, list(range(r)),
                            device=None if device == "cuda" else "cpu")

    rows = mesh_plan.weak_scaling_rows(mesh_for, rows_per_device, world,
                                       repeats)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(rows, f)


def _weak(args) -> list[dict]:
    from toplingdb_tpu_torch.parallel import distributed_gc as dg

    backend = "nccl" if args.device == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rows.json")
        if args.devices == 1:
            # One rank: in this process (no spawn).
            dg._rank_entry(0, _weak_rank, 1, os.path.join(d, "store"),
                           backend, 120.0,
                           (args.rows_per_device, args.repeats,
                            args.device, out))
        else:
            dg.spawn_ranks(_weak_rank, args.devices, d,
                           args=(args.rows_per_device, args.repeats,
                                 args.device, out),
                           backend=backend, timeout=600.0)
        with open(out) as f:
            return json.load(f)


def _available(device: str) -> int:
    if device == "cuda":
        import torch

        return torch.cuda.device_count()
    return os.cpu_count() or 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("weak", "mesh"), default="weak")
    ap.add_argument("--rows-per-device", type=int, default=1 << 16)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    have = _available(args.device)
    if args.devices < 1 or (args.devices > have
                            and not (args.mode == "mesh"
                                     and args.device == "cpu")):
        print(json.dumps({"skip": f"{have} {args.device} devices < "
                                  f"{args.devices} requested"}))
        return mesh_plan.EXIT_SKIP
    try:
        if args.mode == "mesh":
            import torch

            devices = ([torch.device("cpu")] * args.devices
                       if args.device == "cpu" else
                       mesh_plan.mesh_devices(args.devices))
            rows = mesh_plan.mesh_compact_rows(
                args.rows_per_device, devices, args.repeats)
            print(json.dumps({"mesh_compact": rows}))
        else:
            print(json.dumps({"weak_scaling": _weak(args)}))
    except Exception as e:  # noqa: BLE001 - the measurement broke
        print(json.dumps({"error": repr(e)[:300]}))
        return mesh_plan.EXIT_FAILURE
    return mesh_plan.EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
