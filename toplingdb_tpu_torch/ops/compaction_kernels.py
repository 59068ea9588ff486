"""Device half of the compaction data plane, in PyTorch (the counterpart of
toplingdb_tpu/ops/compaction_kernels.py: the uniform-shard programs and the
whole-job program over variable-length keys).

One key-range shard of a compaction runs as one device program over two
bulk uploads (front-coded or plain user-key bytes, plus one packed u32 per
row: (seq - chunk_min_seq) << 8 | vtype) and, when the job has range
tombstones, two u32 planes of each row's max covering tombstone seqno:

  1. decode the [p, uk_len] key matrix and rebuild each row's 64-bit
     (seq << 8 | type) trailer from its 24-bit delta;
  2. order the rows: the segmented merge of the presorted runs (kernel
     `merge_runs_perm`) on CUDA, a full LSD sort on the CPU, nothing when
     the shard is one presorted run;
  3. the MVCC GC mask, whose per-row core is the `gc_rows` kernel;
  4. compact the survivors to the front, stably;
  5. pack the survivor order into three byte planes for the download
     (22-bit local row ids, bit 23 = zero-seq flag, bit 22 = complex-group
     flag) plus [count, has_complex] — or, on the block-assembly route
     (ops/block_assembly.py), build the output's data blocks from steps
     1-4 (`_uniform_shard_core`).

Jobs whose keys are not of one length run `fused_encode_sort_gc` instead:
one program over the job's raw internal-key bytes and lengths that encodes
each row (trailer unpack, big-endian user-key words), orders the rows by a
full LSD sort, runs the same GC mask (`gc_rows`) and compacts the
survivors; the order, zero-seq and complex flags come back whole.

The per-entry route (ops/device_compaction.device_gc_entries) takes a
job's entries as columns: `pad_columns`, `device_sort` (the same LSD sort,
ties kept in original order) and `gc_mask`, which returns the sorted rows'
keep / zero-seq / complex flags and their user-key group ids.

The host twins at the end of the module (`host_fused_full` and its parts)
are the accelerator-less route in numpy and the native library: the k-way
merge of the presorted runs with the GC mask inline
(`tpulsm_merge_gc_runs`), or a native sort or np.lexsort followed by a
numpy GC mask. Their outputs equal the device programs'.

Every reference u32 word is carried in int64 and masked to 32 bits after
`~`, `<<` and `+`; the kernels take int32 tensors holding the bit patterns.
All functions take an explicit device; nothing is global.
"""

from __future__ import annotations

import numpy as np
import torch

from toplingdb_tpu_torch.ops import kernels
from toplingdb_tpu_torch.utils.status import NotSupported

_SIGN = 0x80000000
_M32 = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1
# Snapshot words are padded to a power-of-two bucket (>= 64), as in the
# reference; above MAX_SNAPSHOTS the job is refused.
MAX_SNAPSHOTS = kernels.MAX_SNAPSHOTS
_MIN_SNAP_BUCKET = 64

# Per-shard row budget for the 3-byte packed-order download: local row ids
# must fit 22 bits (bit 23 carries the zero-seq flag, bit 22 the
# complex-group flag).
MAX_SHARD_ROWS = 1 << 22

# ValueType codes the GC mask tests (gc_rows tests MERGE and
# SINGLE_DELETION itself).
_DELETION, _VALUE = 0, 1


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _split_snapshots(snapshots: list[int]) -> tuple[np.ndarray, np.ndarray]:
    """Sorted snapshot seqnos padded to the next pow2 bucket (>=64) with the
    2^56 sentinel, split into (hi, lo) uint32 word arrays."""
    pad_snap = 1 << 56
    bucket = _MIN_SNAP_BUCKET
    while bucket < len(snapshots):
        bucket *= 2
    snaps = sorted(snapshots) + [pad_snap] * (bucket - len(snapshots))
    snap_hi = np.array([x >> 32 for x in snaps], dtype=np.uint32)
    snap_lo = np.array([x & _M32 for x in snaps], dtype=np.uint32)
    return snap_hi, snap_lo


def _i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values carried in int64 → int32 tensor of the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → their u32 values in int64."""
    return x.to(torch.int64) & _M32


# ---------------------------------------------------------------------------
# Ordering
# ---------------------------------------------------------------------------


def _sort_perm(cols: list[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation over priority-ordered int32
    columns (the reference's lax.sort over num_keys operands). Pairs of
    columns pack into one int64 key — (hi << 32) + (lo + 2^31) orders like
    the pair — and LSD passes of torch.sort(stable=True) run from the
    least-significant key up."""
    keys = []
    for k in range(0, len(cols), 2):
        hi = cols[k].to(torch.int64)
        if k + 1 < len(cols):
            keys.append((hi << 32) + (cols[k + 1].to(torch.int64) + 2**31))
        else:
            keys.append(hi)
    perm = torch.arange(cols[0].shape[0], dtype=torch.int64,
                        device=cols[0].device)
    for key in reversed(keys):
        idx = torch.sort(key[perm], stable=True).indices
        perm = perm[idx]
    return perm


# ---------------------------------------------------------------------------
# GC mask
# ---------------------------------------------------------------------------


def _gc_mask(key_words, key_len, inv_hi, inv_lo, vtype, snap_hi, snap_lo,
             tomb_hi, tomb_lo, bottommost: bool,
             keep_tombstones: bool = False):
    """GC mask over SORTED columns (the reference's _gc_mask_impl).
    key_words [p, w] / key_len / inv_hi / inv_lo / vtype int32; snap_* and
    tomb_* int32 u32 bit patterns (tomb_* None = no tombstones).
    keep_tombstones: a bottommost job keeps its DELETION rows (a timestamp
    DB's tombstone still shadows the key's older versions, which are other
    groups). Returns
    (keep, zero_seq, host_resolve) bool tensors and the int64 group_id
    (user-key group of each row), all of padded length."""
    n = key_words.shape[0]
    same_words = (key_words == torch.roll(key_words, 1, 0)).all(dim=1)
    same_len = key_len == torch.roll(key_len, 1)
    same_key = same_words & same_len
    same_key[0] = False
    new_key = ~same_key
    group_id = torch.cumsum(new_key, 0) - 1

    # Seqno recovery: packed = ~inv (64-bit), seq = packed >> 8.
    packed_hi = (~(_u32(inv_hi) ^ _SIGN)) & _M32
    packed_lo = (~(_u32(inv_lo) ^ _SIGN)) & _M32
    seq_hi = packed_hi >> 8
    seq_lo = ((packed_hi << 24) | (packed_lo >> 8)) & _M32

    stripe, first_in_stripe, covered, is_complex = kernels.gc_rows(
        _i32(seq_hi), _i32(seq_lo), new_key, tomb_hi, tomb_lo, vtype,
        snap_hi, snap_lo,
    )
    first_in_stripe = first_in_stripe | new_key
    group_complex = torch.zeros(n, dtype=torch.int32, device=key_words.device)
    group_complex = group_complex.scatter_reduce(
        0, group_id, is_complex.to(torch.int32), "amax", include_self=False)
    host_resolve = group_complex[group_id] > 0

    is_pad = vtype < 0
    keep = first_in_stripe & ~covered & ~is_pad
    if bottommost:
        if not keep_tombstones:
            keep = keep & ~((stripe == 0) & (vtype == _DELETION))
        zero_seq = keep & (stripe == 0) & (vtype == _VALUE)
    else:
        zero_seq = torch.zeros_like(keep)
    keep = keep & ~host_resolve
    return keep, zero_seq, host_resolve & ~is_pad, group_id


# ---------------------------------------------------------------------------
# Uniform-shard program
# ---------------------------------------------------------------------------


def _decode_front_coded(plens: torch.Tensor, sfx: torch.Tensor,
                        uk_len: int) -> torch.Tensor:
    """Rebuild the [p, uk_len] u8 key matrix from front-coded uploads.
    Column j of row i comes from the LAST row i' <= i with plen[i'] <= j
    (the reference takes a cummax over source rows); chunk starts have plen
    0, so inheritance never crosses a chunk boundary.

    The running "last owner" is found with one flat prefix sum instead of a
    cummax down the rows: torch's CUDA cummax along a long outer dimension
    runs one sequential loop per column. Column by column (column-major),
    each position that owns its byte (plen <= j) gets the next rank; every
    position reads the row of the owner holding its own rank. Row 0 of
    every column owns its byte, so no lookup reaches an earlier column."""
    p = plens.shape[0]
    device = plens.device
    pl = plens.to(torch.int64)
    sfx_len = uk_len - pl
    sfx_off = torch.cumsum(sfx_len, 0) - sfx_len
    col = torch.arange(uk_len, dtype=torch.int64, device=device)[:, None]
    own = (pl[None, :] <= col).reshape(-1)
    rank = torch.cumsum(own, 0) - 1
    rows = torch.arange(p, dtype=torch.int64, device=device).repeat(uk_len)
    spill = uk_len * p  # one extra slot takes every non-owner's write
    owner_row = torch.empty(spill + 1, dtype=torch.int64, device=device)
    owner_row.scatter_(0, torch.where(own, rank, spill), rows)
    src = owner_row[rank].reshape(uk_len, p)
    pos = sfx_off[src] + (col - pl[src])
    return sfx[pos.clamp(0, sfx.shape[0] - 1)].T.contiguous()


def _stable_partition(mask: torch.Tensor) -> torch.Tensor:
    """The reference's argsort(~mask, stable=True): rows with mask set
    first, then the rest, each in row order (int64 permutation)."""
    p = mask.shape[0]
    m = mask.to(torch.int64)
    count = m.sum()
    dest = torch.where(mask, torch.cumsum(m, 0) - 1,
                       torch.cumsum(1 - m, 0) - 1 + count)
    return torch.empty_like(dest).scatter_(
        0, dest, torch.arange(p, dtype=torch.int64, device=mask.device))


def _uniform_shard_core(kb, pkb, starts, min_his, min_los, tomb_hi, tomb_lo,
                        snap_hi, snap_lo, total: int, num_key_words: int,
                        uk_len: int, bottommost: bool, run_starts=None,
                        merge_mode: str = "sort"):
    """[p, uk_len] u8 key matrix in → order + GC. tomb_hi/tomb_lo: per
    ORIGINAL row max covering tombstone seqno words (int32 bit patterns),
    or both None. Returns a dict of per-SORTED-row tensors (perm: sorted
    row → local row, take: the survivors-first stable partition, out,
    zero_seq, host_resolve) plus per-ORIGINAL-row packed trailer words
    (packed_hi, packed_lo: u32 values in int64), vtype_orig and valid, for
    the packed-download and block-assembly tails."""
    p = pkb.shape[0]
    device = pkb.device
    span = num_key_words * 4
    iota = torch.arange(p, dtype=torch.int64, device=device)
    valid = iota < total

    kbp = kb.to(torch.int64)
    if span > uk_len:
        kbp = torch.nn.functional.pad(kbp, (0, span - uk_len))
    kbp = kbp.reshape(p, num_key_words, 4)
    words = ((kbp[:, :, 0] << 24) | (kbp[:, :, 1] << 16)
             | (kbp[:, :, 2] << 8) | kbp[:, :, 3])
    # i32(words ^ SIGN) == words - 2^31 for u32 words.
    key_words = torch.where(valid[:, None], words - 2**31,
                            _INT32_MAX).to(torch.int32)

    # Full 64-bit packed trailers: per-row chunk id by searchsorted over the
    # chunk starts, then that chunk's 64-bit min seqno plus the 24-bit delta.
    cid = torch.searchsorted(starts, iota.to(torch.int32), right=True) - 1
    pk = _u32(pkb)
    rel = pk >> 8
    mlo = _u32(min_los)[cid]
    seq_lo = (mlo + rel) & _M32
    carry = (seq_lo < mlo).to(torch.int64)
    seq_hi = (_u32(min_his)[cid] + carry) & _M32
    vt0 = pk & 0xFF
    packed_hi = ((seq_hi << 8) | (seq_lo >> 24)) & _M32
    packed_lo = ((seq_lo << 8) | vt0) & _M32
    # i32(~packed ^ SIGN) == 2^31 - 1 - packed for u32 packed words.
    inv_hi = torch.where(valid, _INT32_MAX - packed_hi,
                         _INT32_MAX).to(torch.int32)
    inv_lo = torch.where(valid, _INT32_MAX - packed_lo,
                         _INT32_MAX).to(torch.int32)
    vtype = torch.where(valid, vt0, -1).to(torch.int32)
    key_len = torch.where(valid, uk_len, _INT32_MAX).to(torch.int32)

    if merge_mode == "skip":
        # One presorted run (+ trailing pads): already in output order.
        perm = iota
        kw, kl, ih, il, vt = key_words, key_len, inv_hi, inv_lo, vtype
    else:
        cols = [key_words[:, j] for j in range(num_key_words)] + [
            key_len, inv_hi, inv_lo]
        if merge_mode == "merge":
            n_runs = run_starts.shape[0] - 1
            n_rounds = max(0, n_runs.bit_length() - 1)
            perm = kernels.merge_runs_perm(
                torch.stack(cols), run_starts, n_rounds).to(torch.int64)
        elif merge_mode == "sort":
            perm = _sort_perm(cols)
        else:
            raise ValueError(f"unknown merge mode {merge_mode!r}")
        kw = key_words[perm]
        kl = key_len[perm]
        ih = inv_hi[perm]
        il = inv_lo[perm]
        vt = vtype[perm]
    th = tl = None
    if tomb_hi is not None:
        th = tomb_hi[perm]
        tl = tomb_lo[perm]
    keep, zero_seq, host_resolve, _ = _gc_mask(
        kw, kl, ih, il, vt, snap_hi, snap_lo, th, tl, bottommost)
    out = keep | host_resolve
    return {
        "perm": perm, "take": _stable_partition(out), "out": out,
        "zero_seq": zero_seq, "host_resolve": host_resolve,
        "packed_hi": packed_hi, "packed_lo": packed_lo,
        "vtype_orig": vt0, "valid": valid,
    }


def _uniform_shard_tail(kb, pkb, starts, min_his, min_los, tomb_hi, tomb_lo,
                        snap_hi, snap_lo, total, num_key_words, uk_len,
                        bottommost, run_starts=None, merge_mode="sort"):
    """Packed-download tail: (packed_bytes u8[3p], meta int32[2])."""
    core = _uniform_shard_core(
        kb, pkb, starts, min_his, min_los, tomb_hi, tomb_lo, snap_hi,
        snap_lo, total, num_key_words, uk_len, bottommost,
        run_starts=run_starts, merge_mode=merge_mode,
    )
    take = core["take"]
    po = (core["perm"][take]
          | (core["zero_seq"][take].to(torch.int64) << 23)
          | (core["host_resolve"][take].to(torch.int64) << 22))
    packed_bytes = torch.cat([
        (po & 0xFF).to(torch.uint8),
        ((po >> 8) & 0xFF).to(torch.uint8),
        ((po >> 16) & 0xFF).to(torch.uint8),
    ])
    meta = torch.stack([core["out"].sum(),
                        core["host_resolve"].any().to(torch.int64)]).to(
        torch.int32)
    return packed_bytes, meta


# ---------------------------------------------------------------------------
# Whole-job program over raw variable-length key bytes
# ---------------------------------------------------------------------------


def _encode_from_bytes(key_buf, key_offs, key_lens, valid,
                       num_key_words: int):
    """Encode from raw internal-key bytes (u8 key_buf, int64 offsets and
    lengths, bool valid, all on one device): the trailer unpack and the
    big-endian packing of the user key into num_key_words u32 words, bytes
    past the user key zeroed, invalid rows masked to the int32max sentinel.
    Returns (key_words [p, w], key_len, inv_hi, inv_lo, vtype), int32."""
    device = key_buf.device
    top = key_buf.shape[0] - 1
    lane8 = torch.arange(8, dtype=torch.int64, device=device)
    tr_idx = (key_offs + key_lens - 8)[:, None] + lane8[None, :]
    tr = key_buf[tr_idx.clamp(0, top)].to(torch.int64)
    packed_lo = tr[:, 0] | (tr[:, 1] << 8) | (tr[:, 2] << 16) | (tr[:, 3] << 24)
    packed_hi = tr[:, 4] | (tr[:, 5] << 8) | (tr[:, 6] << 16) | (tr[:, 7] << 24)
    vtype = torch.where(valid, packed_lo & 0xFF, -1).to(torch.int32)
    # i32(~packed ^ SIGN) == 2^31 - 1 - packed for u32 packed words.
    inv_hi = torch.where(valid, _INT32_MAX - packed_hi,
                         _INT32_MAX).to(torch.int32)
    inv_lo = torch.where(valid, _INT32_MAX - packed_lo,
                         _INT32_MAX).to(torch.int32)

    uk_len = key_lens - 8
    lane4 = torch.arange(4, dtype=torch.int64, device=device)
    words = []
    for j in range(num_key_words):  # one [p, 4] gather per word
        pos = 4 * j + lane4
        b = key_buf[(key_offs[:, None] + pos[None, :]).clamp(0, top)]
        b = b.to(torch.int64) * (pos[None, :] < uk_len[:, None])
        words.append((b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8)
                     | b[:, 3])
    # i32(words ^ SIGN) == words - 2^31 for u32 words.
    key_words = torch.where(valid[:, None], torch.stack(words, 1) - 2**31,
                            _INT32_MAX).to(torch.int32)
    key_len = torch.where(valid, uk_len, _INT32_MAX).to(torch.int32)
    return key_words, key_len, inv_hi, inv_lo, vtype


def _sort_gc_compact_tail(key_words, key_len, inv_hi, inv_lo, vtype,
                          snap_hi, snap_lo, bottommost: bool,
                          tomb_hi_orig=None, tomb_lo_orig=None):
    """Sort → GC mask → survivors compacted to the front in sorted order
    (the reference's _sort_gc_compact_tail). Rows of complex groups are
    included in the output, flagged in cx_flags. tomb_*_orig: per-ORIGINAL
    row max covering tombstone seqno words (int32 bit patterns), or both
    None. Returns (order int32, zero_flags, cx_flags, count, has_complex),
    each of padded length except the two scalars."""
    w = key_words.shape[1]
    perm = _sort_perm([key_words[:, j] for j in range(w)]
                      + [key_len, inv_hi, inv_lo])
    th = tl = None
    if tomb_hi_orig is not None:
        th = tomb_hi_orig[perm]
        tl = tomb_lo_orig[perm]
    keep, zero_seq, host_resolve, _ = _gc_mask(
        key_words[perm], key_len[perm], inv_hi[perm], inv_lo[perm],
        vtype[perm], snap_hi, snap_lo, th, tl, bottommost)
    out = keep | host_resolve
    take = _stable_partition(out)
    return (perm[take].to(torch.int32), zero_seq[take], host_resolve[take],
            out.sum(), host_resolve.any())


def _fused_encode_sort_gc_impl(key_buf, key_lens, valid, tomb_hi, tomb_lo,
                               snap_hi, snap_lo, num_key_words: int,
                               bottommost: bool):
    """Columnar encode + sort + GC mask over raw internal-key bytes and
    lengths (entries densely packed, so the offsets are an exclusive cumsum
    of the lengths). tomb_hi/tomb_lo: each original row's max covering
    tombstone seqno words, or both None. Returns _sort_gc_compact_tail's
    tuple."""
    lens = key_lens.to(torch.int64)
    offs = torch.cumsum(lens, 0) - lens
    return _sort_gc_compact_tail(
        *_encode_from_bytes(key_buf, offs, lens, valid, num_key_words),
        snap_hi, snap_lo, bottommost, tomb_hi, tomb_lo)


def fused_encode_sort_gc_start(key_buf: np.ndarray, key_offs: np.ndarray,
                               key_lens: np.ndarray, max_key_bytes: int,
                               snapshots: list[int], bottommost: bool,
                               cover: np.ndarray | None = None,
                               device="cuda"):
    """Upload one job's raw flat key bytes (rows and bytes padded to powers
    of two, as the reference pads them), enqueue the whole-job program and
    the download of its result into pinned memory behind an event. `cover`:
    optional per-original-row uint64 max covering tombstone seqno (0 =
    uncovered). Decode with fused_encode_sort_gc_finish. Raises
    NotSupported for a key buffer that is not densely packed or more than
    MAX_SNAPSHOTS snapshots."""
    if len(snapshots) > MAX_SNAPSHOTS:
        raise NotSupported(
            f"device GC supports <= {MAX_SNAPSHOTS} live snapshots")
    device = torch.device(device)
    n = len(key_offs)
    # The device derives offsets as an exclusive cumsum of the lengths; that
    # requires the dense end-to-end layout ColumnarKV scans produce.
    if n and (int(key_offs[0]) != 0
              or int(key_offs[-1]) + int(key_lens[-1]) != len(key_buf)
              or not np.array_equal(
                  key_offs[1:], (np.cumsum(key_lens) - key_lens)[1:])):
        raise NotSupported("fused encode requires densely packed key buffers")
    p = _next_pow2(max(1, n))
    w = (max_key_bytes + 3) // 4
    lens = np.zeros(p, dtype=np.int32)  # pad rows: zero-length (masked)
    valid = np.zeros(p, dtype=bool)
    lens[:n] = key_lens
    valid[:n] = True
    snap_hi, snap_lo = _split_snapshots(snapshots)
    tomb_hi = tomb_lo = None
    if cover is not None and np.any(cover):
        tc = np.zeros(p, dtype=np.uint64)
        tc[:n] = cover
        tomb_hi = _to_device((tc >> np.uint64(32)).astype(np.uint32), device)
        tomb_lo = _to_device((tc & np.uint64(_M32)).astype(np.uint32), device)
    kb = np.zeros(_next_pow2(max(8, len(key_buf))), dtype=np.uint8)
    kb[: len(key_buf)] = key_buf
    order, zero_flags, cx_flags, count, has_complex = \
        _fused_encode_sort_gc_impl(
            _to_device(kb, device), _to_device(lens, device),
            _to_device(valid, device), tomb_hi, tomb_lo,
            _to_device(snap_hi, device), _to_device(snap_lo, device), w,
            bool(bottommost))
    meta = torch.stack([count, has_complex.to(torch.int64)]).to(torch.int32)
    out = (order, zero_flags, cx_flags, meta)
    if device.type != "cuda":
        return out, None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in out)
    for h, t in zip(host, out):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host, done


def fused_encode_sort_gc_finish(pending):
    """Block on the whole-job program: (order[count] int32 original rows,
    zero_flags[count] bool, cx_flags[count] bool, has_complex)."""
    (order, zero_flags, cx_flags, meta), done = pending
    if done is not None:
        done.synchronize()
    c, has_complex = (int(x) for x in meta.numpy())
    return (order.numpy()[:c], zero_flags.numpy()[:c], cx_flags.numpy()[:c],
            bool(has_complex))


def fused_encode_sort_gc(key_buf, key_offs, key_lens, max_key_bytes,
                         snapshots, bottommost, cover=None, device="cuda"):
    """Raw flat key bytes in, survivor order out, in one call (the
    reference's fused_encode_sort_gc): fused_encode_sort_gc_start, then
    fused_encode_sort_gc_finish."""
    return fused_encode_sort_gc_finish(fused_encode_sort_gc_start(
        key_buf, key_offs, key_lens, max_key_bytes, snapshots, bottommost,
        cover, device=device))


# ---------------------------------------------------------------------------
# Per-entry route: sort and GC mask over padded columns
# ---------------------------------------------------------------------------


def _split_cover(cover: np.ndarray, p: int):
    """uint64 per-row max-covering-tombstone seqnos → (hi, lo) u32 word
    arrays padded to p rows."""
    tc = np.zeros(p, dtype=np.uint64)
    tc[: len(cover)] = cover
    return ((tc >> np.uint64(32)).astype(np.uint32),
            (tc & np.uint64(_M32)).astype(np.uint32))


def pad_columns(col) -> dict:
    """Pad a ColumnarEntries to the next power of two. Sentinel rows sort
    last (int32 max keys) and carry vtype=-1."""
    n = col.n
    p = _next_pow2(max(1, n))
    w = col.key_words.shape[1]
    out = {
        "n": n, "w": w,
        "key_words": np.full((p, w), _INT32_MAX, dtype=np.int32),
        "key_len": np.full(p, _INT32_MAX, dtype=np.int32),
        "inv_hi": np.full(p, _INT32_MAX, dtype=np.int32),
        "inv_lo": np.full(p, _INT32_MAX, dtype=np.int32),
        "vtype": np.full(p, -1, dtype=np.int32),
    }
    out["key_words"][:n] = col.key_words
    out["key_len"][:n] = col.key_len
    out["inv_hi"][:n] = col.inv_hi
    out["inv_lo"][:n] = col.inv_lo
    out["vtype"][:n] = col.vtype
    return out


def device_sort(padded: dict, device="cuda"):
    """Upload padded columns to `device` and sort them into internal-key
    order there (the reference's one stable multi-operand lax.sort: ties
    keep their original order). Returns a dict of SORTED on-device columns
    (padding rows last) plus the permutation of original indices as
    np.ndarray[:n]."""
    device = torch.device(device)
    kw = _to_device(padded["key_words"], device)
    kl = _to_device(padded["key_len"], device)
    ih = _to_device(padded["inv_hi"], device)
    il = _to_device(padded["inv_lo"], device)
    vt = _to_device(padded["vtype"], device)
    perm = _sort_perm([kw[:, j] for j in range(padded["w"])] + [kl, ih, il])
    sorted_cols = {
        "n": padded["n"], "w": padded["w"], "key_words": kw[perm],
        "key_len": kl[perm], "inv_hi": ih[perm], "inv_lo": il[perm],
        "vtype": vt[perm],
    }
    return sorted_cols, perm[: padded["n"]].to(torch.int32).cpu().numpy()


def gc_mask(sorted_cols: dict, snapshots: list[int],
            tomb_cover: np.ndarray | None, bottommost: bool,
            keep_tombstones: bool = False):
    """Host wrapper over sorted on-device columns from device_sort().
    tomb_cover: [n] uint64 max covering tombstone seq per sorted entry
    (None = no tombstones); keep_tombstones: see _gc_mask. Returns (keep, zero_seq, host_resolve, group_id)
    as numpy arrays trimmed to n."""
    if len(snapshots) > MAX_SNAPSHOTS:
        # Truncating would merge stripes and corrupt MVCC.
        raise NotSupported(
            f"device GC supports <= {MAX_SNAPSHOTS} live snapshots, "
            f"got {len(snapshots)}")
    device = sorted_cols["key_words"].device
    p = sorted_cols["key_words"].shape[0]
    n = sorted_cols["n"]
    snap_hi, snap_lo = _split_snapshots(snapshots)
    tomb_hi = tomb_lo = None
    if tomb_cover is not None:
        th, tl = _split_cover(tomb_cover, p)
        tomb_hi, tomb_lo = _to_device(th, device), _to_device(tl, device)
    keep, zero_seq, host_resolve, group_id = _gc_mask(
        sorted_cols["key_words"], sorted_cols["key_len"],
        sorted_cols["inv_hi"], sorted_cols["inv_lo"], sorted_cols["vtype"],
        _to_device(snap_hi, device), _to_device(snap_lo, device),
        tomb_hi, tomb_lo, bool(bottommost), keep_tombstones)
    out = torch.stack([keep[:n], zero_seq[:n], host_resolve[:n]]).cpu()
    keep, zero_seq, host_resolve = out.numpy()
    return (keep, zero_seq, host_resolve,
            group_id[:n].to(torch.int32).cpu().numpy())


def prepare_uniform_chunk(key_buf: np.ndarray, n: int, key_len: int):
    """Host half of the uniform upload: strip the 8-byte trailers from one
    dense uniform-length key slice; no device traffic. Returns
    (uk_bytes, pk32, min_seq, n, uk_len). Raises NotSupported when the
    chunk's seqno span exceeds 24 bits (the uint32 packing budget)."""
    import sys as _sys

    kb2 = key_buf[: n * key_len].reshape(n, key_len)
    tr = np.ascontiguousarray(kb2[:, -8:]).view(np.uint64).reshape(n)
    if _sys.byteorder == "big":
        tr = tr.byteswap()
    seq = tr >> np.uint64(8)
    min_seq = int(seq.min()) if n else 0
    rel = seq - np.uint64(min_seq)
    if n and int(rel.max()) >= 1 << 24:
        raise NotSupported("chunk seqno span exceeds the 24-bit delta budget")
    pk32 = ((rel << np.uint64(8)) | (tr & np.uint64(0xFF))).astype(np.uint32)
    uk_len = key_len - 8
    uk = np.ascontiguousarray(kb2[:, :uk_len]).reshape(-1)
    return (uk, pk32, min_seq, n, uk_len)


# Front-coded uploads: on for uniform keys up to this many bytes. The
# decode materializes [p, uk_len] int64 intermediates (cummax source rows +
# gather positions), so the total element count is capped too.
_FC_MAX_UK_LEN = 32
_FC_MAX_ELEMS = 64 << 20


def _want_front_code(uk_len: int, total_rows: int) -> bool:
    return (0 < uk_len <= _FC_MAX_UK_LEN
            and _next_pow2(max(1, total_rows)) * uk_len <= _FC_MAX_ELEMS)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host numpy array → device tensor; pinned and non-blocking on CUDA.
    u32 arrays travel as int32 bit patterns."""
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload_uniform_shard(chunks, covers=None, front_code=None,
                         device="cuda"):
    """Pack one shard's prepared chunks (prepare_uniform_chunk outputs, in
    row order) into device buffers, pad rows to the next power of two, and
    start the host→device copies. `covers`: optional per-chunk uint64
    max-covering-tombstone arrays (None = tombstone-free), uploaded as two
    u32 planes. `front_code` (None = auto): upload per-row shared-prefix
    lengths + suffix bytes instead of full key bytes; the device rebuilds
    the exact key matrix. Returns a handle dict."""
    device = torch.device(device)
    uk_len = chunks[0][4]
    ns = tuple(int(c[3]) for c in chunks)
    total = sum(ns)
    if total > MAX_SHARD_ROWS:
        raise NotSupported(
            f"shard rows {total} exceed the 24-bit packed-order budget")
    if front_code is None:
        front_code = _want_front_code(uk_len, total)
    if uk_len > 255:
        front_code = False  # plens is uint8; a longer prefix would wrap
    p = _next_pow2(max(1, total))
    pkb = np.zeros(p, dtype=np.uint32)
    has_tombs = covers is not None and any(
        c is not None and np.any(c) for c in covers)
    if has_tombs:
        tomb_hi = np.zeros(p, dtype=np.uint32)
        tomb_lo = np.zeros(p, dtype=np.uint32)
    if front_code:
        plens = np.zeros(p, dtype=np.uint8)
        sfx_parts = []
    else:
        ukb = np.zeros(p * uk_len, dtype=np.uint8)
    pos = 0
    for ci, (uk, pk32, _mn, n, _l) in enumerate(chunks):
        if front_code and n:
            kb2 = uk.reshape(n, uk_len)
            eq = kb2[1:] == kb2[:-1]
            pl = np.zeros(n, dtype=np.int32)
            if n > 1:
                all_eq = eq.all(axis=1)
                pl[1:] = np.where(all_eq, uk_len, np.argmin(eq, axis=1))
            plens[pos:pos + n] = pl.astype(np.uint8)
            sfx_parts.append(kb2[np.arange(uk_len)[None, :] >= pl[:, None]])
        elif not front_code:
            ukb[pos * uk_len:(pos + n) * uk_len] = uk
        pkb[pos:pos + n] = pk32
        if has_tombs and covers[ci] is not None:
            cv = covers[ci]
            tomb_hi[pos:pos + n] = (cv >> np.uint64(32)).astype(np.uint32)
            tomb_lo[pos:pos + n] = (cv & np.uint64(_M32)).astype(np.uint32)
        pos += n
    mins = np.array([c[2] for c in chunks], dtype=np.uint64)
    # Chunk starts + per-chunk min seqnos, pow2-padded (sentinel 2^31-1).
    nc = _next_pow2(max(1, len(ns)))
    starts = np.full(nc, 2**31 - 1, dtype=np.int32)
    starts[: len(ns)] = np.cumsum([0] + list(ns[:-1]), dtype=np.int64)
    min_his = np.zeros(nc, dtype=np.uint32)
    min_los = np.zeros(nc, dtype=np.uint32)
    min_his[: len(ns)] = (mins >> np.uint64(32)).astype(np.uint32)
    min_los[: len(ns)] = (mins & np.uint64(_M32)).astype(np.uint32)
    # Segmented-merge run boundaries: each chunk is one presorted run, the
    # padding rows form a final sorted run, and empty runs pad the count to
    # a power of two (the merge does log2(R) pairwise rounds).
    n_chunks = len(ns)
    real_runs = n_chunks + (1 if p > total else 0)
    rr = _next_pow2(max(1, real_runs))
    run_starts = np.full(rr + 1, p, dtype=np.int32)
    run_starts[:n_chunks] = np.cumsum([0] + list(ns[:-1]), dtype=np.int64)
    run_starts[n_chunks] = total
    h = {
        "device": device, "total": total, "uk_len": uk_len,
        "n_chunks": n_chunks,
        "pkb": _to_device(pkb, device),
        "starts": _to_device(starts, device),
        "min_his": _to_device(min_his, device),
        "min_los": _to_device(min_los, device),
        "run_starts": _to_device(run_starts, device),
        "tomb_hi": _to_device(tomb_hi, device) if has_tombs else None,
        "tomb_lo": _to_device(tomb_lo, device) if has_tombs else None,
    }
    if front_code:
        sfx = (np.concatenate(sfx_parts) if sfx_parts
               else np.zeros(0, dtype=np.uint8))
        # Pad-row columns all "contribute themselves" (plen 0), so the
        # decode's clipped gather needs only a pow2 bucket, not real bytes.
        sb = np.zeros(_next_pow2(max(8, len(sfx))), dtype=np.uint8)
        sb[: len(sfx)] = sfx
        h["plens"] = _to_device(plens, device)
        h["sfx"] = _to_device(sb, device)
    else:
        h["ukb"] = _to_device(ukb, device)
    return h


def shard_merge_mode(handle) -> str:
    """The reorder strategy for one uploaded shard: "skip" when the shard
    is a single presorted chunk, the segmented merge kernel on CUDA, and the
    full LSD sort on the CPU (a sequential sort beats the merge's
    gather-heavy rounds there), as the reference picks per backend."""
    if handle["n_chunks"] == 1:
        return "skip"
    return "merge" if handle["device"].type == "cuda" else "sort"


def shard_key_matrix(handle) -> torch.Tensor:
    """The shard's [p, uk_len] u8 user-key matrix on its device: decoded
    from the front-coded upload, or the plain upload reshaped."""
    p = handle["pkb"].shape[0]
    if "plens" in handle:
        return _decode_front_coded(handle["plens"], handle["sfx"],
                                   handle["uk_len"])
    return handle["ukb"].reshape(p, handle["uk_len"])


def fused_uniform_shard_start(handle, snapshots: list[int], bottommost: bool,
                              merge_mode: str | None = None):
    """Enqueue one shard's device program over an upload_uniform_shard
    handle, and the download of its result. `merge_mode` (None = auto,
    shard_merge_mode) forces "sort", "merge" or "skip". Decode with
    fused_uniform_shard_finish."""
    if len(snapshots) > MAX_SNAPSHOTS:
        raise NotSupported(
            f"device GC supports <= {MAX_SNAPSHOTS} live snapshots")
    h = handle
    device = h["device"]
    uk_len = h["uk_len"]
    w = (max(uk_len, 4) + 3) // 4
    if merge_mode is None:
        merge_mode = shard_merge_mode(h)
    snap_hi, snap_lo = _split_snapshots(snapshots)
    snap_hi = _to_device(snap_hi, device)
    snap_lo = _to_device(snap_lo, device)
    packed_bytes, meta = _uniform_shard_tail(
        shard_key_matrix(h), h["pkb"], h["starts"], h["min_his"],
        h["min_los"], h["tomb_hi"], h["tomb_lo"], snap_hi, snap_lo,
        h["total"], w, uk_len, bool(bottommost),
        run_starts=h["run_starts"], merge_mode=merge_mode,
    )
    if device.type != "cuda":
        return packed_bytes, meta, None
    host_bytes = torch.empty(packed_bytes.shape, dtype=torch.uint8,
                             pin_memory=True)
    host_meta = torch.empty(meta.shape, dtype=torch.int32, pin_memory=True)
    host_bytes.copy_(packed_bytes, non_blocking=True)
    host_meta.copy_(meta, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host_bytes, host_meta, done


def fused_uniform_shard_finish(pending):
    """Block on one shard's result: (order[count] int32 LOCAL shard rows,
    zero_flags[count] bool, cx_flags[count] bool, has_complex)."""
    packed_bytes, meta, done = pending
    if done is not None:
        done.synchronize()
    m = meta.numpy()
    c = int(m[0])
    has_complex = bool(m[1])
    arr = packed_bytes.numpy()
    p = arr.size // 3
    a = arr.reshape(3, p)
    po = (
        a[0, :c].astype(np.uint32)
        | (a[1, :c].astype(np.uint32) << 8)
        | (a[2, :c].astype(np.uint32) << 16)
    )
    order = (po & np.uint32(MAX_SHARD_ROWS - 1)).astype(np.int32)
    zero_flags = (po >> np.uint32(23)).astype(bool)
    cx_flags = ((po >> np.uint32(22)) & np.uint32(1)).astype(bool)
    return order, zero_flags, cx_flags, has_complex


# ---------------------------------------------------------------------------
# The host twins (the reference's accelerator-less route, selected there by
# TPULSM_HOST_SORT=1; here by run_device_compaction(host_sort=True)): the
# native k-way run merge with an inline GC mask per shard, or the two-pass
# twin (a native sort or np.lexsort, then a numpy GC mask). Their outputs
# equal the device programs' (bitwise). A missing native library raises:
# the numpy sort runs only where a native routine refuses the shape.
# ---------------------------------------------------------------------------

_MERGE, _SINGLE_DELETION = 2, 7


def _host_lib():
    from toplingdb_tpu_torch import native

    lib = native.lib()
    if lib is None:
        raise NotSupported("the host twins need the native library, which "
                           "could not be built or loaded")
    return native, lib


def _valid_run_starts(run_starts, n: int):
    """int64 run boundaries, or None when they are missing or malformed
    (malformed ones would leave rows unmerged or index past the entries
    in C)."""
    if run_starts is None or len(run_starts) < 2:
        return None
    rs = np.ascontiguousarray(run_starts, dtype=np.int64)
    if int(rs[0]) != 0 or int(rs[-1]) != n or not np.all(np.diff(rs) >= 0):
        return None
    return rs


def host_encode_sort(key_buf: np.ndarray, key_offs: np.ndarray,
                     key_lens: np.ndarray, max_key_bytes: int):
    """The numpy half-twin: columnar encode + np.lexsort into internal-key
    order. Returns (s, words, uk_len, seq, vtype) with s = the sorted →
    original permutation and the UNSORTED per-entry columns."""
    n = len(key_offs)
    offs = key_offs.astype(np.int64)
    lens = key_lens.astype(np.int64)

    seq, vtype = _trailer_seq_vtype(key_buf, key_offs, key_lens)
    packed = (seq << np.uint64(8)) | vtype.astype(np.uint64)
    inv = ~packed  # descending seq under an ascending sort

    # Big-endian user-key words, zero-masked past each key's length.
    w = (max_key_bytes + 3) // 4
    span = w * 4
    uk_len = lens - 8
    idx = offs[:, None] + np.arange(span)[None, :]
    np.clip(idx, 0, max(len(key_buf) - 1, 0), out=idx)
    kb = key_buf[idx].astype(np.uint32)
    kb *= np.arange(span)[None, :] < uk_len[:, None]
    kbw = kb.reshape(n, w, 4)
    words = ((kbw[:, :, 0] << 24) | (kbw[:, :, 1] << 16)
             | (kbw[:, :, 2] << 8) | kbw[:, :, 3])

    # lexsort's LAST column is primary: (key words..., key_len, inv), the
    # device's operand order; stable, so equal internal keys keep their
    # input order.
    s = np.lexsort((inv, uk_len) + tuple(
        words[:, j] for j in range(w - 1, -1, -1)))
    return s, words, uk_len, seq, vtype


def host_sort_order(key_buf: np.ndarray, key_offs: np.ndarray,
                    key_lens: np.ndarray, run_starts=None,
                    host_merge: bool = True):
    """(order, new_key, packed) from the native byte-span comparator, the
    device sort's order; `packed` = per-ORIGINAL-row (seq << 8 | type).
    With `run_starts` ([R+1] boundaries of PRESORTED input runs) and
    `host_merge`, the multi-threaded k-way run merge replaces the full
    sort where it takes the shape (user keys of at most 8 bytes). None
    when the native sort refuses the job."""
    import ctypes

    native, lib = _host_lib()
    n = len(key_offs)
    offs = np.ascontiguousarray(key_offs, dtype=np.int64)
    lens = np.ascontiguousarray(key_lens, dtype=np.int64)
    kb = np.ascontiguousarray(key_buf)
    order = np.empty(n, dtype=np.int32)
    new_key = np.empty(n, dtype=np.uint8)
    packed = np.empty(n, dtype=np.uint64)
    u64p = packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    rs = _valid_run_starts(run_starts, n) if host_merge and n else None
    rc = -1
    if rs is not None:
        rc = lib.tpulsm_merge_runs(
            native.np_u8p(kb), native.np_i64p(offs), native.np_i64p(lens),
            n, native.np_i64p(rs), len(rs) - 1,
            native.np_i32p(order), native.np_u8p(new_key), u64p)
    if rc != 0:
        rc = lib.tpulsm_sort_entries(
            native.np_u8p(kb), native.np_i64p(offs), native.np_i64p(lens),
            n, native.np_i32p(order), native.np_u8p(new_key), u64p)
    if rc != 0:
        return None
    return order, new_key.astype(bool), packed


def host_merge_gc(key_buf, key_offs, key_lens, snapshots, bottommost,
                  cover, run_starts, host_merge: bool = True,
                  threads: int = 0):
    """ONE native pass: the k-way merge of presorted runs with the GC mask
    inline. Returns host_fused_full's 6-tuple, or None where the routine
    does not apply (host_merge=False, missing or malformed run boundaries,
    user keys over 8 bytes); the two-pass twin runs then. `threads`
    (1-16) pins the merge's thread count, 0 leaves it to the routine."""
    import ctypes

    native, lib = _host_lib()
    if not host_merge:
        return None
    n = len(key_offs)
    rs = _valid_run_starts(run_starts, n)
    if rs is None:
        return None
    offs = np.ascontiguousarray(key_offs, dtype=np.int64)
    lens = np.ascontiguousarray(key_lens, dtype=np.int64)
    kb = np.ascontiguousarray(key_buf)
    order = np.empty(n, dtype=np.int32)
    zero = np.empty(n, dtype=np.uint8)
    cx = np.empty(n, dtype=np.uint8)
    packed = np.empty(n, dtype=np.uint64)
    hc = np.zeros(1, dtype=np.int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    snaps = np.asarray(sorted(snapshots), dtype=np.uint64)
    cov = (np.ascontiguousarray(cover, dtype=np.uint64)
           if cover is not None else None)
    n_out = lib.tpulsm_merge_gc_runs(
        native.np_u8p(kb), native.np_i64p(offs), native.np_i64p(lens), n,
        native.np_i64p(rs), len(rs) - 1,
        snaps.ctypes.data_as(u64p) if len(snaps) else None, len(snaps),
        cov.ctypes.data_as(u64p) if cov is not None else None,
        1 if bottommost else 0,
        native.np_i32p(order), native.np_u8p(zero), native.np_u8p(cx),
        packed.ctypes.data_as(u64p), native.np_i32p(hc), int(threads),
    )
    if n_out < 0:
        return None
    seq = packed >> np.uint64(8)
    vtype = (packed & np.uint64(0xFF)).astype(np.int32)
    return (order[:n_out], zero[:n_out].astype(bool),
            cx[:n_out].astype(bool), bool(hc[0]), seq, vtype)


def host_gc_mask(new_key, sseq, svt, snapshots, cover, bottommost):
    """The numpy twin of the GC mask over SORTED columns; `new_key` marks
    user-key group starts, `cover` is the per-sorted-row stripe-clamped max
    covering tombstone seqno (or None). Returns (keep, zero_seq,
    host_resolve, group_id), like gc_mask."""
    n = len(sseq)
    snaps = np.asarray(sorted(snapshots), dtype=np.uint64)
    stripe = np.searchsorted(snaps, sseq, side="left").astype(np.int64)
    first_in_stripe = new_key.copy()
    if n > 1:
        first_in_stripe[1:] |= stripe[1:] != stripe[:-1]

    is_complex = (svt == _MERGE) | (svt == _SINGLE_DELETION)
    group_id = np.cumsum(new_key) - 1
    starts = np.flatnonzero(new_key)
    group_complex = (np.bitwise_or.reduceat(is_complex, starts)
                     if n else np.zeros(0, dtype=bool))
    host_resolve = group_complex[group_id] if n else is_complex

    covered = np.zeros(n, dtype=bool)
    if cover is not None:
        c = np.asarray(cover, dtype=np.uint64)
        covered = (c != 0) & (c > sseq)  # cover is stripe-clamped already

    keep = first_in_stripe & ~covered
    if bottommost:
        keep &= ~((stripe == 0) & (svt == _DELETION))
    zero_seq = (keep & bool(bottommost) & (stripe == 0)
                & (svt == _VALUE))
    keep &= ~host_resolve
    return keep, zero_seq, host_resolve, group_id


def host_fused_full(key_buf: np.ndarray, key_offs: np.ndarray,
                    key_lens: np.ndarray, max_key_bytes: int,
                    snapshots: list[int], bottommost: bool,
                    cover: np.ndarray | None = None, run_starts=None,
                    host_merge: bool = True, threads: int = 0):
    """The host twin of the fused shard program: the native merge with
    its inline GC, else the two-pass twin (host_sort_with_boundaries +
    host_gc_mask). `cover`: optional per-ORIGINAL-row uint64 max covering
    tombstone seqno. Returns (order, zero_flags, cx_flags, has_complex,
    seq, vtype) with seq / vtype per ORIGINAL row; `order` includes the
    complex groups' rows, flagged by cx_flags."""
    if len(snapshots) > MAX_SNAPSHOTS:
        raise NotSupported(
            f"device GC supports <= {MAX_SNAPSHOTS} live snapshots")
    n = len(key_offs)
    if n == 0:
        e = np.empty(0, np.uint64)
        return (np.empty(0, np.int32), np.empty(0, bool),
                np.empty(0, bool), False, e, e.astype(np.int32))
    fused = host_merge_gc(key_buf, key_offs, key_lens, snapshots,
                          bottommost, cover, run_starts,
                          host_merge=host_merge, threads=threads)
    if fused is not None:
        return fused
    s, new_key, seq, vtype = host_sort_with_boundaries(
        key_buf, key_offs, key_lens, max_key_bytes, run_starts=run_starts,
        host_merge=host_merge)
    keep, zero_seq, host_resolve, _ = host_gc_mask(
        new_key, seq[s], vtype[s], snapshots,
        None if cover is None else cover[s], bottommost)
    out = keep | host_resolve
    order = s[out].astype(np.int32)
    return (order, zero_seq[out], host_resolve[out],
            bool(host_resolve.any()), seq, vtype)


def host_sort_with_boundaries(key_buf, key_offs, key_lens, max_key_bytes,
                              run_starts=None, host_merge: bool = True):
    """The two-pass twin's front half: (s, new_key, seq, vtype) from the
    native comparator, or from the lexsort twin where it refuses."""
    nat = host_sort_order(key_buf, key_offs, key_lens,
                          run_starts=run_starts, host_merge=host_merge)
    if nat is not None:
        s, new_key, packed = nat
        seq = packed >> np.uint64(8)
        vtype = (packed & np.uint64(0xFF)).astype(np.int32)
    else:
        s, words, uk_len, seq, vtype = host_encode_sort(
            key_buf, key_offs, key_lens, max_key_bytes)
        new_key = _new_key_from_words(words[s], uk_len[s])
    return s, new_key, seq, vtype


def _trailer_seq_vtype(key_buf, key_offs, key_lens):
    """(seq, vtype) of each row from its 8 little-endian trailer bytes."""
    offs = key_offs.astype(np.int64)
    lens = key_lens.astype(np.int64)
    tr_idx = (offs + lens - 8)[:, None] + np.arange(8)[None, :]
    tr = key_buf[tr_idx].astype(np.uint64)
    packed = np.zeros(len(offs), dtype=np.uint64)
    for i in range(8):
        packed |= tr[:, i] << np.uint64(8 * i)
    return packed >> np.uint64(8), (packed & np.uint64(0xFF)).astype(np.int32)


def _new_key_from_words(skw, slen):
    """User-key group starts of sorted rows from their key words."""
    n = len(slen)
    same_key = np.zeros(n, dtype=bool)
    if n > 1:
        same_key[1:] = np.all(skw[1:] == skw[:-1], axis=1) & (
            slen[1:] == slen[:-1])
    return ~same_key
