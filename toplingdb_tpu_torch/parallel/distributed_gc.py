"""Distributed compaction GC: a sample sort + GC mask over a (jobs, range)
mesh of torch.distributed process groups (the counterpart of
toplingdb_tpu/parallel/distributed_gc.py, whose step is one shard_map
program; here it is PyTorch code and collectives, gloo on the CPU, NCCL
on CUDA).

One compaction's key range is sharded over the 'range' axis (the
subcompaction analogue), independent jobs over the 'jobs' axis (the
dcompact analogue). Every rank holds one (job block, range block) of the
padded sort columns and runs, per job:

  1. the local sort of its rows' sort columns (LSD stable torch.sort
     passes over int64-packed column pairs)
  2. regular-sample splitters, all_gather over the range group
  3. the capacity-padded bucket exchange, all_to_all_single over the
     range group; rows past a bucket's capacity are counted as overflow,
     summed over the range group, and any overflow raises TryAgain
  4. the local sort of the received buckets
  5. the halo: each shard's last real key and stripe to the next range
     rank (an all_gather over the range group)
  6. the GC mask (snapshot stripes, first-in-stripe, range-tombstone
     cover), with per-row complex flags (MERGE / SINGLE_DELETION groups
     are resolved by the host, which sees the global order)

Entries travel as fixed-width int32 sort columns (key words + length +
inverted seqno words) with (vtype, original index, cover words) as
payload; values never leave the host. The outputs, (keep, zero_seq,
sorted idx, is_complex) per job, equal the reference's bitwise.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from toplingdb_tpu_torch.utils.status import TryAgain

_SIGN = 0x80000000
_M32 = 0xFFFFFFFF
INT32MAX = np.iinfo(np.int32).max
_DELETION, _VALUE, _MERGE, _SINGLE_DELETION = 0, 1, 2, 7


class RangeMesh:
    """This rank's place in a (jobs, range) mesh: the mesh's ranks in
    row-major order (job row j holds ranks[j*R:(j+1)*R]), this rank's job
    row and range index, the process group of its job row (the 'range'
    collectives) and the group of the whole mesh."""

    def __init__(self, jobs: int, range_: int, ranks: list[int], rank: int,
                 range_group, mesh_group, device: torch.device):
        self.shape = {"jobs": jobs, "range": range_}
        self.ranks = ranks
        self.rank = rank
        pos = ranks.index(rank)
        self.job_index, self.range_index = divmod(pos, range_)
        self.range_group = range_group
        self.mesh_group = mesh_group
        self.device = device

    def barrier(self) -> None:
        dist.barrier(group=self.mesh_group)


def make_mesh(jobs: int, range_: int, ranks: list[int] | None = None,
              device=None, backend: str | None = None) -> RangeMesh | None:
    """The (jobs, range) mesh over `ranks` (default: the first jobs*range
    ranks of the world). Every rank of the world must call this with the
    same arguments (process groups are made collectively); ranks outside
    the mesh get None. `device`: where this rank's tensors live (None:
    "cuda:<local card>" under NCCL, else the CPU). `backend`: the groups'
    backend (None: the world's; "gloo" beside an NCCL world gives a CPU
    mesh in the same processes)."""
    n = jobs * range_
    ranks = list(range(n)) if ranks is None else list(ranks)
    if len(ranks) != n or ranks != sorted(set(ranks)):
        # Sorted: a group's ranks are numbered in global rank order, and
        # the range index must be the group rank the collectives use.
        raise ValueError(f"a ({jobs}, {range_}) mesh needs {n} distinct "
                         f"ranks in ascending order, got {ranks}")
    rows = [dist.new_group(ranks[j * range_:(j + 1) * range_],
                           backend=backend) for j in range(jobs)]
    mesh_group = dist.new_group(ranks, backend=backend)
    rank = dist.get_rank()
    if rank not in ranks:
        return None
    if device is None:
        if (backend or dist.get_backend()) == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
    mesh = RangeMesh(jobs, range_, ranks, rank, None, mesh_group,
                     torch.device(device))
    mesh.range_group = rows[mesh.job_index]
    return mesh


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the trailing column dim."""
    c = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    lt = torch.zeros(shape, dtype=torch.bool, device=a.device)
    eq = torch.ones(shape, dtype=torch.bool, device=a.device)
    for i in range(c):
        ai = a[..., i]
        bi = b[..., i]
        lt = lt | (eq & (ai < bi))
        eq = eq & (ai == bi)
    return lt


def _local_sort(cols: torch.Tensor, payload: torch.Tensor):
    """cols [P, C] int32 sort columns, payload [P, K] carried along: rows
    in lexicographic column order (compaction_kernels._sort_perm: LSD
    stable passes over int64-packed column pairs)."""
    from toplingdb_tpu_torch.ops.compaction_kernels import _sort_perm

    perm = _sort_perm([cols[:, i] for i in range(cols.shape[1])])
    return cols[perm], payload[perm]


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def _seq_words(inv_hi_i32, inv_lo_i32):
    """(seq_hi, seq_lo) u32 words in int64 from the inverted trailer
    words."""
    packed_hi = ~(_u32(inv_hi_i32) ^ _SIGN) & _M32
    packed_lo = ~(_u32(inv_lo_i32) ^ _SIGN) & _M32
    return packed_hi >> 8, ((packed_hi << 24) & _M32) | (packed_lo >> 8)


def _stripe(seq_hi, seq_lo, snap_hi, snap_lo) -> torch.Tensor:
    lt = (snap_hi[None, :] < seq_hi[:, None]) | (
        (snap_hi[None, :] == seq_hi[:, None])
        & (snap_lo[None, :] < seq_lo[:, None]))
    return lt.sum(dim=1).to(torch.int32)


def _tomb_covered(seq_hi, seq_lo, tomb_hi, tomb_lo, snap_hi, snap_lo,
                  stripe):
    """Same-stripe range-tombstone shadowing (the reference's
    compaction_kernels._tomb_covered)."""
    has_tomb = (tomb_hi | tomb_lo) != 0
    tomb_newer = (tomb_hi > seq_hi) | ((tomb_hi == seq_hi)
                                       & (tomb_lo > seq_lo))
    return has_tomb & tomb_newer & (
        _stripe(tomb_hi, tomb_lo, snap_hi, snap_lo) == stripe)


def _gc_mask_local(cols, vtype, tomb_hi_i32, tomb_lo_i32, prev_last_cols,
                   prev_last_stripe, prev_valid: bool, snap_hi, snap_lo,
                   bottommost: bool):
    """The survivor mask of one locally sorted shard; the halo (the
    previous shard's last key and stripe) stitches group and stripe
    continuity across shards."""
    n = cols.shape[0]
    w = cols.shape[1] - 3  # key words + len + inv_hi + inv_lo
    key_cols = cols[:, :w + 1]  # words + len identify the user key
    prev_rows = torch.roll(key_cols, 1, dims=0)
    prev_rows[0] = prev_last_cols[:w + 1]
    same_key = torch.all(key_cols == prev_rows, dim=1)
    if n and not prev_valid:
        same_key[0] = False
    new_key = ~same_key

    seq_hi, seq_lo = _seq_words(cols[:, w + 1], cols[:, w + 2])
    stripe = _stripe(seq_hi, seq_lo, snap_hi, snap_lo)
    prev_stripe = torch.roll(stripe, 1)
    prev_stripe[0] = prev_last_stripe
    first_in_stripe = new_key | (stripe != prev_stripe)
    covered = _tomb_covered(seq_hi, seq_lo, _u32(tomb_hi_i32),
                            _u32(tomb_lo_i32), snap_hi, snap_lo, stripe)
    is_pad = vtype < 0
    keep = first_in_stripe & ~covered & ~is_pad
    if bottommost:
        keep = keep & ~((stripe == 0) & (vtype == _DELETION))
        zero_seq = keep & (stripe == 0) & (vtype == _VALUE)
    else:
        zero_seq = torch.zeros_like(keep)
    # Complex rows flag per row; the group-level broadcast happens on the
    # host, which sees the global sorted order.
    is_complex = ((vtype == _MERGE) | (vtype == _SINGLE_DELETION)) & ~is_pad
    return keep, zero_seq, stripe, is_complex


def make_distributed_gc_step(mesh: RangeMesh, num_key_words: int,
                             bottommost: bool, capacity_factor: float = 2.0):
    """The step over this rank's block of `mesh`. Inputs (this rank's job
    block and range block):
      cols   [j, p, C] int32, C = num_key_words + 3 sort columns
      vtype  [j, p]    int32 value types (-1 = padding)
      idx    [j, p]    int32 original entry indices (-1 = padding)
      tomb_hi/lo [j, p] int32 max covering tombstone seqno words
      snap_hi/lo [S]   int64 padded snapshot words (replicated)
    Returns keep, zero_seq [j, L] bool; sorted idx [j, L]; is_complex
    [j, L] bool; overflow [j] int32 summed over the range group, with
    L = R * cap on a range axis of R > 1 ranks, else p."""
    r = mesh.shape["range"]
    ri = mesh.range_index
    c = num_key_words + 3
    group = mesh.range_group

    def one_job(cols1, vtype1, idx1, th1, tl1, p_local):
        cap = int(capacity_factor * p_local / r) if r > 1 else p_local
        cap = max(cap, 1)
        payload = torch.stack([vtype1, idx1, th1, tl1], dim=1)
        cols_s, pay_s = _local_sort(cols1, payload)
        if r == 1:
            return cols_s, pay_s, 0
        dev = cols1.device
        # Splitters: r regular samples per shard, all_gather, the global
        # r-quantiles of the sorted samples.
        stride = max(p_local // r, 1)
        samples = cols_s[::stride][:r]
        if samples.shape[0] < r:
            samples = torch.cat([samples, torch.full(
                (r - samples.shape[0], c), INT32MAX, dtype=torch.int32,
                device=dev)])
        gathered = [torch.empty_like(samples) for _ in range(r)]
        dist.all_gather(gathered, samples.contiguous(), group=group)
        all_samples = torch.cat(gathered)
        srt, _ = _local_sort(all_samples, torch.zeros(
            (r * r, 1), dtype=torch.int32, device=dev))
        splitters = srt[r::r][:r - 1]
        # Bucket of each row: the splitters at or below it.
        ge = ~_lex_less(cols_s[:, None, :], splitters[None, :, :])
        bucket = ge.sum(dim=1)
        # Pad rows take no capacity: they go to the spill slot and are
        # rebuilt as padding on the receive side.
        is_pad_row = pay_s[:, 0] < 0
        onehot = torch.nn.functional.one_hot(bucket, r) * (
            ~is_pad_row)[:, None]
        pos = torch.cumsum(onehot, dim=0) - onehot
        slot = (pos * onehot).sum(dim=1)
        overflow = int(((slot >= cap) & ~is_pad_row).sum())
        slot = torch.where(is_pad_row, torch.full_like(slot, cap),
                           torch.clamp(slot, max=cap))
        send_cols = torch.full((r, cap + 1, c), INT32MAX, dtype=torch.int32,
                               device=dev)
        # Pad-slot cover words are ZERO: an all-ones word would read as a
        # huge covering tombstone.
        send_pay = torch.full((r, cap + 1, 4), -1, dtype=torch.int32,
                              device=dev)
        send_pay[:, :, 2:] = 0
        send_cols[bucket, slot] = cols_s
        send_pay[bucket, slot] = pay_s
        send_cols = send_cols[:, :cap].reshape(r * cap, c).contiguous()
        send_pay = send_pay[:, :cap].reshape(r * cap, 4).contiguous()
        recv_cols = torch.empty_like(send_cols)
        recv_pay = torch.empty_like(send_pay)
        dist.all_to_all_single(recv_cols, send_cols, group=group)
        dist.all_to_all_single(recv_pay, send_pay, group=group)
        cols_s, pay_s = _local_sort(recv_cols, recv_pay)
        return cols_s, pay_s, overflow

    def last_row(cols1, pay1, snap_hi, snap_lo):
        """The shard's last REAL row (pad rows sort to the tail) and its
        stripe: the halo for the next range rank."""
        n_real = int((pay1[:, 0] >= 0).sum())
        if n_real > 0:
            last = cols1[n_real - 1]
        else:
            last = torch.full((c,), INT32MAX, dtype=torch.int32,
                              device=cols1.device)
        seq_hi, seq_lo = _seq_words(last[c - 2:c - 1], last[c - 1:c])
        return last, _stripe(seq_hi, seq_lo, snap_hi, snap_lo)[0]

    def step(cols, vtype, idx, tomb_hi, tomb_lo, snap_hi, snap_lo):
        j, p_local = vtype.shape
        sorted_ = [one_job(cols[i], vtype[i], idx[i], tomb_hi[i],
                           tomb_lo[i], p_local) for i in range(j)]
        overflow = torch.tensor([o for _c, _p, o in sorted_],
                                dtype=torch.int32, device=cols.device)
        lasts = [last_row(cs, ps, snap_hi, snap_lo) for cs, ps, _o in sorted_]
        last_cols = torch.stack([lc for lc, _s in lasts]).contiguous()
        last_stripe = torch.stack([ls for _l, ls in lasts]).to(
            torch.int32).contiguous()
        if r > 1:
            gc_ = [torch.empty_like(last_cols) for _ in range(r)]
            gs_ = [torch.empty_like(last_stripe) for _ in range(r)]
            dist.all_gather(gc_, last_cols, group=group)
            dist.all_gather(gs_, last_stripe, group=group)
            prev_cols, prev_stripe = gc_[(ri - 1) % r], gs_[(ri - 1) % r]
            prev_valid = ri > 0
            dist.all_reduce(overflow, group=group)
        else:
            prev_cols = torch.full_like(last_cols, INT32MAX)
            prev_stripe = torch.zeros_like(last_stripe)
            prev_valid = False
        outs = []
        for i, (cs, ps, _o) in enumerate(sorted_):
            keep, zero_seq, _stripe_, is_cx = _gc_mask_local(
                cs, ps[:, 0], ps[:, 2], ps[:, 3], prev_cols[i],
                prev_stripe[i], prev_valid, snap_hi, snap_lo, bottommost)
            outs.append((keep, zero_seq, ps[:, 1], is_cx))
        stack = [torch.stack([o[k] for o in outs]) for k in range(4)]
        return (*stack, overflow)

    return step


def run_distributed_gc(mesh: RangeMesh, jobs: list, snapshots: list[int],
                       bottommost: bool, capacity_factor: float = 2.0):
    """The host side of the step, called by every rank of `mesh` with the same
    arguments: jobs = padded column dicts (compaction_kernels.pad_columns),
    all of one padded length and word count, optionally with "tomb_cover"
    (per-row uint64 max covering tombstone seqno). The jobs list is padded
    to the jobs axis. Returns per-job (keep, zero_seq, sorted_idx,
    is_complex) numpy arrays in global sorted order on every rank; raises
    TryAgain when a bucket overflowed (retry on one device)."""
    w, inputs = step_inputs(mesh, jobs, snapshots)
    step = make_distributed_gc_step(mesh, w, bottommost, capacity_factor)
    return gather_outputs(mesh, len(jobs), step(*inputs))


def step_inputs(mesh: RangeMesh, jobs: list, snapshots: list[int]):
    """(num_key_words, the step's inputs for this rank's block, on its
    device): the jobs' padded columns stacked and padded to the mesh."""
    from toplingdb_tpu_torch.ops.compaction_kernels import (
        _split_cover,
        _split_snapshots,
    )

    jdim = mesh.shape["jobs"]
    rdim = mesh.shape["range"]
    w = jobs[0]["w"]
    p = jobs[0]["key_words"].shape[0]
    p = max(p, rdim)  # at least one row per shard
    if p % rdim:
        raise ValueError(f"padded length {p} is not a multiple of the "
                         f"range axis {rdim}")
    nj = len(jobs)
    jpad = -(-nj // jdim) * jdim
    cols = np.full((jpad, p, w + 3), INT32MAX, dtype=np.int32)
    vtype = np.full((jpad, p), -1, dtype=np.int32)
    idx = np.full((jpad, p), -1, dtype=np.int32)
    tomb_hi = np.zeros((jpad, p), dtype=np.int32)
    tomb_lo = np.zeros((jpad, p), dtype=np.int32)
    for i, job in enumerate(jobs):
        n = job["key_words"].shape[0]
        cols[i, :n, :w] = job["key_words"]
        cols[i, :n, w] = job["key_len"]
        cols[i, :n, w + 1] = job["inv_hi"]
        cols[i, :n, w + 2] = job["inv_lo"]
        vtype[i, :n] = job["vtype"]
        n_real = job["n"]
        idx[i, :n_real] = np.arange(n_real, dtype=np.int32)
        cv = job.get("tomb_cover")
        if cv is not None and len(cv):
            hi_w, lo_w = _split_cover(np.asarray(cv, dtype=np.uint64), p)
            tomb_hi[i] = hi_w.view(np.int32)
            tomb_lo[i] = lo_w.view(np.int32)
    snap_hi, snap_lo = _split_snapshots(snapshots)

    jl, pl = jpad // jdim, p // rdim
    js = slice(mesh.job_index * jl, (mesh.job_index + 1) * jl)
    ps = slice(mesh.range_index * pl, (mesh.range_index + 1) * pl)
    dev = mesh.device

    def block(a):
        return torch.from_numpy(np.ascontiguousarray(a[js, ps])).to(dev)

    return w, (block(cols), block(vtype), block(idx), block(tomb_hi),
               block(tomb_lo),
               torch.from_numpy(snap_hi.astype(np.int64)).to(dev),
               torch.from_numpy(snap_lo.astype(np.int64)).to(dev))


def gather_outputs(mesh: RangeMesh, nj: int, outputs):
    """The step's outputs of every rank, assembled per job in global
    sorted order; raises TryAgain when any bucket overflowed."""
    keep, zero_seq, sidx, is_cx, overflow = outputs
    jdim = mesh.shape["jobs"]
    rdim = mesh.shape["range"]
    worst = overflow.max().reshape(1).to(torch.int64)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=mesh.mesh_group)
    if int(worst.item()) > 0:
        raise TryAgain("bucket overflow in distributed sort; retry 1-chip")
    # Gather every rank's block: [jl, L] each, in mesh rank order.
    local = torch.stack([keep.to(torch.int32), zero_seq.to(torch.int32),
                         sidx.to(torch.int32), is_cx.to(torch.int32)])
    parts = [torch.empty_like(local) for _ in mesh.ranks]
    dist.all_gather(parts, local.contiguous(), group=mesh.mesh_group)
    parts = [t.cpu().numpy() for t in parts]
    rows = [np.concatenate(parts[j * rdim:(j + 1) * rdim], axis=2)
            for j in range(jdim)]
    full = np.concatenate(rows, axis=1)  # [4, jpad, R * L]
    return (full[0, :nj].astype(bool), full[1, :nj].astype(bool),
            full[2, :nj], full[3, :nj].astype(bool))


# ---------------------------------------------------------------------------
# Rank processes
# ---------------------------------------------------------------------------


def _rank_entry(rank, fn, world, store, backend, timeout_s, args):
    extra = {}
    if backend == "nccl":
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        extra["device_id"] = card  # one card a rank, named, not guessed
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **extra)
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, store_dir: str, args=(), backend="gloo",
                timeout: float = 120.0) -> None:
    """Run fn(rank, world, *args) in `world` spawned processes joined by a
    torch.distributed group over a file store in `store_dir` (no TCP
    port). Raises when a rank fails or when the ranks outlive `timeout`
    (they are terminated first). `fn` must be importable by module path."""
    import torch.multiprocessing as mp

    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store-{os.getpid()}-{time.time_ns()}")
    ctx = mp.start_processes(
        _rank_entry, args=(fn, world, store, backend, timeout, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)


def run_cases(rank: int, world: int, cases: list, out_path: str) -> None:
    """A rank's body for a batch of meshes: each case is a dict of
    jobs / range (the mesh shape), ranks (None: the first jobs * range),
    gc_jobs, snapshots, bottommost and capacity_factor. Every rank builds
    every mesh; rank 0 pickles, per case, the four output arrays or the
    name and message of the error raised, to `out_path`."""
    import pickle

    results = []
    for case in cases:
        mesh = make_mesh(case["jobs"], case["range"], case.get("ranks"))
        out = None
        if mesh is not None:
            try:
                out = run_distributed_gc(
                    mesh, case["gc_jobs"], case["snapshots"],
                    case["bottommost"], case.get("capacity_factor", 2.0))
            except TryAgain as e:
                out = ("TryAgain", str(e))
        dist.barrier()
        results.append(out)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
