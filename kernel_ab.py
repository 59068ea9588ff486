"""Times the merge and gc_rows kernels of two checkouts of this repository
on one card, in turns.

    python3 kernel_ab.py PARENT
    python3 kernel_ab.py --tree TREE

PARENT is an earlier commit unpacked with `git archive` into a git-ignored
directory such as `_archive/parent`. The first form runs the second for
PARENT, this checkout, this checkout and PARENT, each in its own process on
the same card, and prints the four results as one JSON line {"ab": [...]}.
The second form does one checkout and prints one JSON line.

For each kernel at both routes' shapes (chip_smoke.SHAPES, with
chip_smoke.py's inputs), checked bitwise against its plain version:
- ms: chip_smoke.py's time_ms (CUDA events around one wrapper call, L2
  flushed, median of 25), the method of the kernels JSON line; the
  host's enqueue of the call lies inside it;
- device_ms: the same with the card kept busy for about half a
  millisecond (torch.cuda._sleep) between the flush and the start event,
  so that the events enclose the device work and not the enqueue;
- host_us: the host time of one wrapper call (its Python, ctypes and
  launch work, the card idle), median of 200;
- launch_us: the device time of each kernel launch of one call, by
  torch.profiler, the L2 flushed before the call;
beside the timing floor of ms and device_ms (a one-element add), then the
main-path shard program of chip_smoke.shard_phase: CUDA-event ms (enqueue
included) and profiled device time.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def device_ms(torch, fn, flush, iters=25):
    """time_ms with a ~0.5 ms spin on the card after the flush."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, iters=200):
    """Median host time of one fn() call in us, the card idle at each."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def launch_us(torch, fn, flush, pattern):
    """Device time in us of each kernel launch whose name holds `pattern`
    in one fn() call, by torch.profiler, the L2 flushed before it (up to
    three tries: a trace now and then comes back without the call's
    device events)."""
    from torch.profiler import ProfilerActivity, profile

    us = []
    for _ in range(3):
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = [round(e.time_range.elapsed_us(), 1) for e in prof.events()
              if pattern in e.name and str(e.device_type).endswith("CUDA")]
        if us:
            break
    return us


def one_tree(tree: str) -> int:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from toplingdb_tpu_torch.ops import kernels

    assert kernels.__file__.startswith(tree + os.sep), kernels.__file__
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kernels.build()
    rng = np.random.default_rng(7)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    out = {"tree": tree, "card": cs.card_line()}

    def timed(name, fn, pattern=None):
        out[name] = dict(ms=cs.time_ms(torch, fn, flush),
                         device_ms=device_ms(torch, fn, flush))
        if pattern:
            out[name].update(host_us=host_us(torch, fn),
                             launch_us=launch_us(torch, fn, flush, pattern))
        cs.log(f"{name}: {out[name]}")

    one = torch.zeros(1, device=device)
    timed("timing_floor", lambda: one.add_(1))

    for p, per_run in cs.SHAPES:
        args = cs.gc_rows_inputs(torch, rng, p, 3, False, device)
        for g, w in zip(kernels.gc_rows(*args), kernels.gc_rows_plain(*args)):
            assert torch.equal(g, w), "gc_rows disagrees with its plain version"
        timed(f"gc_rows_p{p}", lambda: kernels.gc_rows(*args), "gc_rows")
        cols, starts = cs.merge_inputs(torch, rng, p, per_run, device)
        assert torch.equal(kernels.merge_runs_perm(cols, starts, 3),
                           kernels.merge_runs_perm_plain(cols, starts, 3)), \
            "merge_runs disagrees with its plain version"
        timed(f"merge_runs_p{p}",
              lambda: kernels.merge_runs_perm(cols, starts, 3), "merge")
        del args, cols, starts
    del flush
    ms, dev_us = cs.shard_phase(torch, device)
    out["shard_program"] = dict(ms=ms, device_us=dev_us)
    print(json.dumps(out), flush=True)
    return 0


def ab(parent: str) -> int:
    rows = []
    for tree in (parent, REPO, REPO, parent):
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree],
            capture_output=True, text=True, timeout=600)
        sys.stdout.write(run.stdout)
        sys.stderr.write(run.stderr[-4000:])
        if run.returncode != 0:
            return run.returncode
        rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
    print(json.dumps({"ab": rows}), flush=True)
    return 0


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--tree":
        return one_tree(argv[1])
    if len(argv) == 1:
        return ab(argv[0])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
