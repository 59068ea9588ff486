"""Runs the DB read phases of chip_smoke.py (13: bench.py's DB deployment
with its readrandom probes; 20: multireadrandom and per-key readrandom on
phase 13's compacted DB) from two checkouts in turns on the card, each run
in a fresh process that builds that checkout's kernels and native planes,
so that two commits' get figures are compared within one machine.

Usage: python3 chip_phase_ab.py A_DIR B_DIR [--order ABBA]

Each run prints its phases' own lines, tagged with the run's letter and
checkout; the exit code is non-zero when any run failed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def child(tree: str) -> None:
    """One run of phases 13 and 20 of `tree`'s chip_smoke.py."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from toplingdb_tpu_torch import native
    from toplingdb_tpu_torch.ops import kernels

    assert torch.cuda.is_available(), "no CUDA device"
    kernels.build()
    assert native.lib() is not None, "the native host library did not build"
    native.fastget()
    smi = cs.card_line()
    d = os.path.join(tree, "_smoke_ab")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        cs.db_path(torch, os.path.join(d, "db13"), cs.DB_N, cs.DB_WAL_N)
        cs.read_path(torch, os.path.join(d, "db20"), cs.READ_N, smi, "cuda",
                     os.path.join(d, "db13"))
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    rc = 0
    for i, letter in enumerate(args.order):
        tree = trees[letter]
        print(f"=== run {i + 1}: {letter} {tree}", flush=True)
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, tree,
             "--child", tree], capture_output=True, text=True, timeout=900)
        for line in p.stdout.splitlines():
            if line.startswith(("[db]", "[read a]", "[read]")):
                print(f"{letter}{i + 1} {line}", flush=True)
        if p.returncode:
            print(f"{letter}{i + 1} failed rc={p.returncode}: "
                  f"{p.stderr[-2000:]}", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    _ns = sys.argv[1:]
    if "--child" in _ns:
        child(_ns[_ns.index("--child") + 1])
        sys.exit(0)
    sys.exit(main())
