"""Driver entry points (the counterpart of the reference's
__graft_entry__.py `entry` and `dryrun_multichip`).

entry()              → (fn, example_args): the single-device forward step
                       of the compaction data plane (device_sort's sort
                       into internal-key order and the MVCC GC mask, whose
                       gc_rows launches the CUDA kernel on the card).
dryrun_multichip(n)  → spawns n ranks joined by torch.distributed (NCCL on
                       "cuda", one card a rank; gloo on "cpu"), builds a
                       (jobs, range) mesh with the framework's two parallel
                       axes, runs the distributed GC step on tiny jobs
                       (plain, merge-bearing, tombstone-bearing) and
                       cross-checks every job against the single-device
                       gc_mask. With n >= 4 it also runs an (n, 1) mesh,
                       one job per rank.

Both run on the card unless the caller asks for "cpu"; without a card,
"cuda" raises. The reference's TPU-tunnel probe (utils/backend_probe.py),
whose only job is to fall back to the CPU, has no counterpart.

Usage: python -m toplingdb_tpu_torch.parallel.entry [--devices N]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

SNAPSHOTS = [10, 40]


def _require(device: str):
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but there is no "
                           f"CUDA device (pass device='cpu')")
    return dev


def entry(device: str = "cuda"):
    from toplingdb_tpu_torch.ops import compaction_kernels as ck

    dev = _require(device)

    w = 4          # 16-byte key budget
    p = 1024       # padded entries
    rng = np.random.default_rng(0)
    key_words = rng.integers(-2**31, 2**31 - 1, size=(p, w), dtype=np.int32)
    key_len = np.full(p, 16, dtype=np.int32)
    inv_hi = rng.integers(-2**31, 2**31 - 1, size=p, dtype=np.int32)
    inv_lo = rng.integers(-2**31, 2**31 - 1, size=p, dtype=np.int32)
    vtype = np.ones(p, dtype=np.int32)
    snap_hi, snap_lo = ck._split_snapshots([])

    def compaction_forward(key_words, key_len, inv_hi, inv_lo, vtype,
                           snap_hi, snap_lo):
        s, perm = ck.device_sort(
            {"n": p, "w": w, "key_words": key_words, "key_len": key_len,
             "inv_hi": inv_hi, "inv_lo": inv_lo, "vtype": vtype}, dev)
        keep, zero_seq, _host_resolve, _group_id = ck._gc_mask(
            s["key_words"], s["key_len"], s["inv_hi"], s["inv_lo"],
            s["vtype"], ck._to_device(snap_hi, dev),
            ck._to_device(snap_lo, dev), None, None, True)
        return keep.cpu().numpy(), zero_seq.cpu().numpy(), perm

    return compaction_forward, (key_words, key_len, inv_hi, inv_lo, vtype,
                                snap_hi, snap_lo)


def tiny_job(seed, with_merge=False, with_tombstone=False):
    """One job's (entries, tomb_cover): 64 entries over 24 keys, with
    MERGE / SINGLE_DELETION groups and a range tombstone [k005, k015) at
    seq 50 when asked (its per-row cover stripe-clamped as the
    single-device paths compute it)."""
    from toplingdb_tpu_torch.db.dbformat import ValueType, make_internal_key

    r = np.random.default_rng(seed)
    entries = []
    for seq in range(1, 65):
        k = b"k%03d" % int(r.integers(0, 24))
        roll = r.random()
        if with_merge and roll < 0.15:
            t = ValueType.MERGE
        elif with_merge and roll < 0.22:
            t = ValueType.SINGLE_DELETION
        elif roll < 0.8:
            t = ValueType.VALUE
        else:
            t = ValueType.DELETION
        entries.append((make_internal_key(k, seq, t), b"v%02d" % seq))
    cover = None
    if with_tombstone:
        t_seq, lo, hi = 50, b"k005", b"k015"
        snaps = np.array(SNAPSHOTS, dtype=np.uint64)
        cover = np.zeros(len(entries), dtype=np.uint64)
        for i, (ik, _v) in enumerate(entries):
            uk, seq = ik[:-8], int.from_bytes(ik[-8:], "little") >> 8
            j = int(np.searchsorted(snaps, seq, side="left"))
            upper = int(snaps[j]) if j < len(snaps) else (1 << 56) - 1
            if lo <= uk < hi and seq < t_seq <= upper:
                cover[i] = t_seq
    return entries, cover


def _padded(entries, cover) -> dict:
    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops.columnar import ColumnarEntries

    d = ck.pad_columns(ColumnarEntries.from_entries(entries,
                                                    max_key_bytes=8))
    if cover is not None:
        d["tomb_cover"] = cover
    return d


def check_against_single_device(jobs_entries, covers, results) -> None:
    """Both sides reduce to the same survivor set: the single-device
    keeps plus every row of a complex group, against the distributed
    keeps plus the per-row complex flags broadcast to their group."""
    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops.columnar import ColumnarEntries

    keep, _zero_seq, sidx, is_cx = results
    for j, ents in enumerate(jobs_entries):
        col = ColumnarEntries.from_entries(ents, max_key_bytes=8)
        scols, perm = ck.device_sort(ck.pad_columns(col), device="cpu")
        cv = covers[j]
        tc = cv[perm] if cv is not None else None
        k1, _, hr, _ = ck.gc_mask(scols, SNAPSHOTS, tc, True)
        want = sorted(perm[k1 | hr].tolist())
        real = sidx[j] >= 0
        srows = sidx[j][real]
        uks = np.array([ents[i][0][:-8] for i in srows])
        newg = np.ones(len(srows), dtype=bool)
        if len(srows) > 1:
            newg[1:] = uks[1:] != uks[:-1]
        gid = np.cumsum(newg) - 1
        gcx = np.zeros(gid[-1] + 1 if len(gid) else 0, dtype=bool)
        np.maximum.at(gcx, gid, is_cx[j][real])
        eff = keep[j][real] | gcx[gid]
        got = sorted(int(i) for i in srows[eff])
        assert got == want, (f"job {j}: multichip {len(got)} != 1chip "
                             f"{len(want)}")


def mesh_specs(n_devices: int):
    """The dryrun's meshes: (jobs, range, [(with_merge, with_tombstone)]
    per job)."""
    range_dim = max(n_devices // 2, 1)
    jobs_dim = n_devices // range_dim
    out = [(jobs_dim, range_dim, [(False, False)] * (jobs_dim - 1)
            + [(True, False), (False, True)])]
    if n_devices >= 4:
        out.append((n_devices, 1, [(False, False)] * (n_devices - 2)
                    + [(True, False), (False, True), (True, True)]))
    return out


def _dryrun_rank(rank: int, world: int, device: str | None) -> None:
    from toplingdb_tpu_torch.parallel import distributed_gc as dg

    for jobs_dim, range_dim, specs in mesh_specs(world):
        mesh = dg.make_mesh(jobs_dim, range_dim, device=device)
        made = [tiny_job(i + 1, m, t) for i, (m, t) in enumerate(specs)]
        results = dg.run_distributed_gc(
            mesh, [_padded(e, c) for e, c in made], SNAPSHOTS, True)
        if rank == 0:
            check_against_single_device([e for e, _ in made],
                                        [c for _, c in made], results)
            kinds = ["merge" if m else ("tombstone" if t else "plain")
                     for m, t in specs]
            print(f"dryrun_multichip OK: mesh jobs={jobs_dim} x "
                  f"range={range_dim}, {len(specs)} jobs validated against "
                  f"the single-device gc_mask (kinds: {', '.join(kinds)})",
                  flush=True)


def dryrun_multichip(n_devices: int, store_dir: str | None = None,
                     device: str = "cuda", timeout: float = 120.0) -> None:
    """Spawn n ranks (NCCL on "cuda", one card a rank; gloo on "cpu") and
    run the dryrun; raises when there are fewer cards than ranks, when a
    rank fails or when a job disagrees with the single-device GC."""
    import torch

    from toplingdb_tpu_torch.parallel import distributed_gc as dg

    dev = _require(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        # NCCL refuses two ranks on one card.
        raise RuntimeError(f"{n_devices} NCCL ranks need {n_devices} cards, "
                           f"have {torch.cuda.device_count()}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        dg.spawn_ranks(_dryrun_rank, n_devices, d,
                       args=(None if dev.type == "cuda" else "cpu",),
                       backend=backend, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: every card on cuda, 4 on cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    fn, ex = entry(args.device)
    out = fn(*ex)
    print(f"entry() ran on {args.device}:", [tuple(o.shape) for o in out],
          flush=True)
    n = args.devices
    if n is None:
        import torch

        n = torch.cuda.device_count() if args.device == "cuda" else 4
    dryrun_multichip(n, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
