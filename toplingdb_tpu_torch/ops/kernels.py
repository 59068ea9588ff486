"""The port's hand-written Hopper kernels, their wrappers and their plain
PyTorch versions (the counterpart of toplingdb_tpu/ops/pallas_kernels.py).

- `gc_rows`: the per-row MVCC GC core (replaces the Pallas `_gc_rows_kernel`),
  CUDA source `csrc/gc_rows.cu`.
- `merge_runs_perm`: the stable merge permutation of presorted runs
  (replaces the Pallas `_bitonic_merge_kernel`; its plain version is a torch
  port of the XLA `_merge_runs_perm`), CUDA source `csrc/merge_runs.cu`.
- `shared_prefix_lengths`: shared-prefix lengths between consecutive sorted
  keys (replaces the Pallas `_prefix_kernel`), CUDA source
  `csrc/shared_prefix.cu`.

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back. Each wrapper
counts its kernel launches in a plain integer attribute, `<wrapper>.launches`.

The CUDA sources build with nvcc at first use (one nvcc per source, started
together) into `toplingdb_tpu_torch/_build/`, and bind through ctypes with a
plain C interface; nothing here imports a CUDA toolchain or touches the card
when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = {"gc_rows": "gc_rows.cu", "merge_runs": "merge_runs.cu",
           "shared_prefix": "shared_prefix.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Most snapshot words the gc_rows kernel stages in shared memory; matches
# the reference's MAX_SNAPSHOTS.
MAX_SNAPSHOTS = 1024

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_u32_mask = 0xFFFFFFFF


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _so_path(name)
    src = os.path.join(CSRC, SOURCES[name])
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all stale ones), one nvcc
    process per source, all started together. Returns {name: seconds}.
    Raises RuntimeError with the compiler's output when a build fails."""
    import time

    names = [n for n in (names or SOURCES) if _stale(n)]
    if not names:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.time()
    for n in names:
        tmp = f"{_so_path(n)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    secs, errors = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        secs[n] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"{SOURCES[n]}:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, _so_path(n))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return secs


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(_so_path(name))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        if name == "gc_rows":
            lib.tpt_gc_rows.restype = i32
            lib.tpt_gc_rows.argtypes = [vp] * 8 + [i32, i64] + [vp] * 5
        elif name == "shared_prefix":
            lib.tpt_shared_prefix.restype = i32
            lib.tpt_shared_prefix.argtypes = [vp, vp, i32, i64, vp, vp]
        else:
            lib.tpt_merge_round.restype = i32
            lib.tpt_merge_round.argtypes = [vp] * 6 + [i32, i64, vp, i32,
                                                       i32, vp]
        _libs[name] = lib
        return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(t: torch.Tensor, name: str, dtype, device, n=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or (n is not None and t.shape[0] != n):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → their unsigned values, in int64."""
    return x.to(torch.int64) & _u32_mask


# ---------------------------------------------------------------------------
# gc_rows
# ---------------------------------------------------------------------------


def _stripe_plain(hi, lo, snap_hi, snap_lo):
    nh = snap_hi[None, :]
    nl = snap_lo[None, :]
    lt = (nh < hi[:, None]) | ((nh == hi[:, None]) & (nl < lo[:, None]))
    return lt.sum(dim=1, dtype=torch.int32)


def gc_rows_plain(seq_hi, seq_lo, new_key, tomb_hi, tomb_lo, vtype,
                  snap_hi, snap_lo):
    """Plain PyTorch version of `gc_rows` (the torch twin of the lax branch
    of toplingdb_tpu/ops/compaction_kernels.py::_gc_mask_impl): stripe by a
    [n, S] broadcast compare, previous row by a wrapping roll."""
    sh, sl = _u32(seq_hi), _u32(seq_lo)
    nh, nl = _u32(snap_hi), _u32(snap_lo)
    stripe = _stripe_plain(sh, sl, nh, nl)
    fis = new_key | (stripe != torch.roll(stripe, 1))
    if tomb_hi is None:
        covered = torch.zeros_like(new_key)
    else:
        th, tl = _u32(tomb_hi), _u32(tomb_lo)
        has_tomb = (th | tl) != 0
        tomb_newer = (th > sh) | ((th == sh) & (tl > sl))
        covered = has_tomb & tomb_newer & (
            _stripe_plain(th, tl, nh, nl) == stripe)
    cx = (vtype == 2) | (vtype == 7)
    return stripe, fis, covered, cx


def gc_rows(seq_hi, seq_lo, new_key, tomb_hi, tomb_lo, vtype, snap_hi,
            snap_lo):
    """Per sorted row: (stripe int32, first_in_stripe bool, covered bool,
    complex bool).

    seq_hi/seq_lo/tomb_hi/tomb_lo/snap_hi/snap_lo are int32 tensors holding
    u32 bit patterns; tomb_hi/tomb_lo may both be None (no range
    tombstones). new_key is bool, vtype int32. snap_* is the SORTED
    snapshot list padded with the 2^56 sentinel (at most MAX_SNAPSHOTS
    words). Row 0's previous row is the last row."""
    device = seq_hi.device
    if device.type == "cpu":
        return gc_rows_plain(seq_hi, seq_lo, new_key, tomb_hi, tomb_lo,
                             vtype, snap_hi, snap_lo)
    if device.type != "cuda":
        raise NotImplementedError(f"gc_rows has no kernel for {device}")
    n = seq_hi.shape[0]
    s = snap_hi.shape[0]
    if s > MAX_SNAPSHOTS:
        raise ValueError(f"{s} snapshot words exceed {MAX_SNAPSHOTS}")
    if (tomb_hi is None) != (tomb_lo is None):
        raise ValueError("tomb_hi and tomb_lo must both be given or None")
    for t, name, dt, ln in ((seq_hi, "seq_hi", torch.int32, n),
                            (seq_lo, "seq_lo", torch.int32, n),
                            (new_key, "new_key", torch.bool, n),
                            (vtype, "vtype", torch.int32, n),
                            (snap_hi, "snap_hi", torch.int32, s),
                            (snap_lo, "snap_lo", torch.int32, s)):
        _check(t, name, dt, device, ln)
    if tomb_hi is not None:
        _check(tomb_hi, "tomb_hi", torch.int32, device, n)
        _check(tomb_lo, "tomb_lo", torch.int32, device, n)
    stripe = torch.empty(n, dtype=torch.int32, device=device)
    fis = torch.empty(n, dtype=torch.bool, device=device)
    covered = torch.empty(n, dtype=torch.bool, device=device)
    cx = torch.empty(n, dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        rc = _lib("gc_rows").tpt_gc_rows(
            _ptr(seq_hi), _ptr(seq_lo), _ptr(new_key), _ptr(tomb_hi),
            _ptr(tomb_lo), _ptr(vtype), _ptr(snap_hi), _ptr(snap_lo), s, n,
            _ptr(stripe), _ptr(fis), _ptr(covered), _ptr(cx),
            _stream(device))
    if rc != 0:
        raise RuntimeError(f"gc_rows kernel launch failed: cuda error {rc}")
    gc_rows.launches += 1
    return stripe, fis, covered, cx


gc_rows.launches = 0


# ---------------------------------------------------------------------------
# Segmented merge of presorted runs
# ---------------------------------------------------------------------------


def _rows_less(cols, ai, bi):
    """Lexicographic a < b over priority-ordered int32 columns, folded from
    the least-significant column up."""
    lt = torch.zeros(ai.shape, dtype=torch.bool, device=ai.device)
    for c in reversed(cols):
        a = c[ai]
        b = c[bi]
        lt = (a < b) | ((a == b) & lt)
    return lt


def _partner_bound(cols, probe_idx, lo0, hi0, strict, steps):
    """Vectorized binary search: each probe row's insertion point in its
    partner run [lo0, hi0) — lower bound when strict, upper bound
    otherwise."""
    lo, hi = lo0, hi0
    top = cols[0].shape[0] - 1
    for _ in range(steps):
        mid = (lo + hi) >> 1
        midc = mid.clamp(0, top)
        if strict:
            right = _rows_less(cols, midc, probe_idx)
        else:
            right = ~_rows_less(cols, probe_idx, midc)
        open_ = lo < hi
        lo = torch.where(open_ & right, mid + 1, lo)
        hi = torch.where(open_ & ~right, mid, hi)
    return lo


def merge_runs_perm_plain(cols: torch.Tensor, run_starts: torch.Tensor,
                          n_rounds: int) -> torch.Tensor:
    """Plain PyTorch version of `merge_runs_perm`: a torch port of
    toplingdb_tpu/ops/compaction_kernels.py::_merge_runs_perm (pairwise
    rank merges by vectorized binary search, log2(R) rounds)."""
    p = cols.shape[1]
    cols = tuple(cols[c] for c in range(cols.shape[0]))
    steps = max(1, p.bit_length())
    iota = torch.arange(p, dtype=torch.int64, device=cols[0].device)
    perm = iota
    starts = run_starts.to(torch.int64)
    for _ in range(n_rounds):
        c = tuple(col[perm] for col in cols)
        last = starts.shape[0] - 2
        r = torch.searchsorted(starts, iota, right=True) - 1
        pc = (r ^ 1).clamp(0, last)
        lo_p = starts[pc]
        hi_p = starts[pc + 1]
        even = (r & 1) == 0
        lb = _partner_bound(c, iota, lo_p, hi_p, True, steps)
        ub = _partner_bound(c, iota, lo_p, hi_p, False, steps)
        bound = torch.where(even, lb, ub)
        base = starts[(r & ~1).clamp(0, last)]
        new_pos = base + (iota - starts[r]) + (bound - lo_p)
        inv_round = torch.empty_like(iota).scatter_(0, new_pos, iota)
        perm = perm[inv_round]
        starts = starts[::2].contiguous()
    return perm.to(torch.int32)


def merge_runs_perm(cols: torch.Tensor, run_starts: torch.Tensor,
                    n_rounds: int) -> torch.Tensor:
    """Permutation (new row -> old row, int32) realizing the stable merge of
    the R presorted runs bounded by run_starts ([R+1] int32, R = 2^n_rounds,
    nondecreasing from 0 to p, empty runs allowed). cols: [C, p] int32,
    priority-ordered key columns compared as signed int32 (u32 words in
    sign-flipped order). Ties keep the earlier run's rows first. On CUDA
    each round is one kernel launch (n_rounds per call)."""
    device = cols.device
    if device.type == "cpu":
        return merge_runs_perm_plain(cols, run_starts, n_rounds)
    if device.type != "cuda":
        raise NotImplementedError(f"merge_runs_perm has no kernel for {device}")
    if cols.dim() != 2 or cols.dtype != torch.int32 or not cols.is_contiguous():
        raise ValueError("cols must be a contiguous [C, p] int32 tensor")
    n_runs = run_starts.shape[0] - 1
    if n_runs != 1 << n_rounds:
        raise ValueError(f"{n_runs} runs do not make {n_rounds} rounds")
    _check(run_starts, "run_starts", torch.int32, device, n_runs + 1)
    n_cols, p = cols.shape
    if n_rounds == 0:
        return torch.arange(p, dtype=torch.int32, device=device)
    lib = _lib("merge_runs")
    perm = torch.empty(p, dtype=torch.int32, device=device)
    # Rounds before the last write the rows they move, keys + origin rows,
    # into one of two [C+1, p] buffers that the next round streams, and one
    # flag per run: 1 while the run still lies unmoved in `cols`. One
    # workspace holds the buffers, then their flags; the rounds take raw
    # addresses in it, so the loop makes no tensor views.
    n_bufs = min(2, n_rounds - 1)
    buf_words = (n_cols + 1) * p
    base = 0
    if n_bufs:
        work = torch.empty(n_bufs * (buf_words + n_runs), dtype=torch.int32,
                           device=device)
        base = work.data_ptr()
    buf = lambda b: base + 4 * b * buf_words
    flag = lambda b: base + 4 * (n_bufs * buf_words + b * n_runs)
    cols_ptr, starts_ptr = cols.data_ptr(), run_starts.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        for r in range(n_rounds):
            last = r == n_rounds - 1
            src = buf((r - 1) % 2) if r else None
            f_in = flag((r - 1) % 2) if r else None
            dst = None if last else buf(r % 2)
            dst_org = perm.data_ptr() if last else dst + 4 * n_cols * p
            f_out = None if last else flag(r % 2)
            rc = lib.tpt_merge_round(cols_ptr, src, dst, dst_org, f_in, f_out,
                                     n_cols, p, starts_ptr, n_runs, 1 << r,
                                     stream)
            if rc != 0:
                raise RuntimeError(
                    f"merge_runs kernel launch failed: cuda error {rc}")
            merge_runs_perm.launches += 1
    return perm


merge_runs_perm.launches = 0


# ---------------------------------------------------------------------------
# Shared-prefix lengths
# ---------------------------------------------------------------------------

# Lanes of the Pallas kernel: a row equal to its predecessor reports this.
KEY_LANES = 128


def shared_prefix_lengths_plain(keys: torch.Tensor,
                                key_lens: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Plain PyTorch version of `shared_prefix_lengths`: the torch twin of
    the Pallas `_prefix_kernel` (first differing lane by a where/min over
    the lanes) plus its host wrapper's clamp."""
    n, k = keys.shape
    out = torch.zeros(n, dtype=torch.int32, device=keys.device)
    if n > 1:
        lane = torch.arange(k, dtype=torch.uint8, device=keys.device)
        first = torch.where(keys[1:] != keys[:-1], lane,
                            torch.tensor(KEY_LANES, dtype=torch.uint8,
                                         device=keys.device))
        out[1:] = first.amin(dim=1).to(torch.int32)
    if key_lens is not None and n:
        cap = torch.minimum(key_lens, torch.roll(key_lens, 1))
        cap[0] = 0
        out = torch.minimum(out, cap.to(torch.int32))
    return out


def shared_prefix_lengths(keys: torch.Tensor,
                          key_lens: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """out[i] (int32) = index of the first byte where row i of the [N, K]
    uint8 key matrix (1 <= K <= 128) differs from row i-1; out[0] = 0 and a
    row equal to its predecessor gives 128 (KEY_LANES), as in the Pallas
    entry. With key_lens (int32 [N]) the result is clamped to
    min(key_lens[i], key_lens[i-1])."""
    if keys.dim() != 2 or keys.dtype != torch.uint8:
        raise ValueError("keys must be a [N, K] uint8 tensor")
    n, k = keys.shape
    if not 1 <= k <= KEY_LANES:
        raise ValueError(f"key width {k} is outside 1..{KEY_LANES}")
    device = keys.device
    if device.type == "cpu":
        return shared_prefix_lengths_plain(keys, key_lens)
    if device.type != "cuda":
        raise NotImplementedError(
            f"shared_prefix_lengths has no kernel for {device}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if key_lens is not None:
        _check(key_lens, "key_lens", torch.int32, device, n)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out
    with torch.cuda.device(device):
        rc = _lib("shared_prefix").tpt_shared_prefix(
            _ptr(keys), _ptr(key_lens), k, n, _ptr(out), _stream(device))
    if rc != 0:
        raise RuntimeError(
            f"shared_prefix kernel launch failed: cuda error {rc}")
    shared_prefix_lengths.launches += 1
    return out


shared_prefix_lengths.launches = 0
