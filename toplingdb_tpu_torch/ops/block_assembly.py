"""On-device SST block assembly, in PyTorch (the counterpart of
toplingdb_tpu/ops/block_assembly.py).

After the shard program's merge and GC, one device program builds the
finished, uncompressed data-block payloads of the output SST: shared-prefix
lengths between consecutive survivors (kernel `shared_prefix_lengths`),
greedy block cuts, per-entry byte offsets, and one scatter of every record
and restart array into a single output buffer. The host only frames the
blocks (type byte and masked crc32c) and writes the index, the filter, the
meta blocks and the footer, so its per-job cost is O(blocks), not
O(entries).

Byte parity with the native block builder: the greedy cut rule
`used + 4*num_restarts + 4 >= block_size` is reproduced with a
residue-class searchsorted (the cut after block start j is the first i
where a prefix-sum expression crosses the budget; restart overhead folds
into per-residue prefix sums because restarts sit at i = j (mod R)),
followed by pointer doubling over the next-cut graph to mark the actual
block starts.

Scope, decided on the host before any device work (`assembly_supported`):
one shard, uniform key length 0 < K < 128, values < 128 B (single-byte
varints), NO_COMPRESSION, whole-key or no filter, a single output file, no
blob index and no complex groups. A survivor bitmap (1 bit per row) comes
back with the blocks, so the host builds the bloom without the order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.db.dbformat import ValueType
from toplingdb_tpu_torch.ops import compaction_kernels as ck
from toplingdb_tpu_torch.ops import kernels
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.utils import crc32c
from toplingdb_tpu_torch.utils.status import NotSupported

_M32 = 0xFFFFFFFF
# Download sections: about this many payload bytes, cut at block ends.
_SECTION_BYTES = 8 << 20


def assemble_blocks(kb, pkb, starts, min_his, min_los, vlens, vflat,
                    tomb_hi, tomb_lo, snap_hi, snap_lo, total: int,
                    num_key_words: int, uk_len: int, bottommost: bool,
                    R: int, B: int, max_rec: int, ubp: int, nbp: int,
                    run_starts=None, merge_mode: str = "sort"):
    """Merge + GC + full block assembly for one uploaded shard (the
    reference's _assemble_blocks_impl over the [p, uk_len] key matrix kb).

    Returns (out u8[ubp], meta i32[10], bcounts i32[nbp], bpayload
    i32[nbp], bfirst i32[nbp], blast i32[nbp], surv_bitmap u8[ceil(p/8)]):
      out      concatenated block payloads (no trailers)
      meta     [nb, m, total_payload, has_complex, num_deletions,
                raw_value, smin_hi, smin_lo, smax_hi, smax_lo]
      bcounts  entries per block
      bpayload payload bytes per block
      bfirst/blast  original LOCAL row of each block's first/last entry,
                    bit 30 = that entry's seq was zeroed
    """
    core = ck._uniform_shard_core(
        kb, pkb, starts, min_his, min_los, tomb_hi, tomb_lo, snap_hi,
        snap_lo, total, num_key_words, uk_len, bottommost,
        run_starts=run_starts, merge_mode=merge_mode,
    )
    device = pkb.device
    i64 = torch.int64
    p = pkb.shape[0]
    iota = torch.arange(p, dtype=i64, device=device)
    K = uk_len + 8

    # --- survivor-ordered arrays (first m rows valid) ---
    take = core["take"]
    sorder = core["perm"][take]                 # original local row
    svalid = core["out"][take]
    m = svalid.sum()
    szero = core["zero_seq"][take] & svalid
    vt_orig = core["vtype_orig"]
    sp_hi = torch.where(szero, 0, core["packed_hi"][sorder])
    sp_lo = torch.where(szero, vt_orig[sorder], core["packed_lo"][sorder])
    svt = vt_orig[sorder]
    vl = vlens.to(i64)
    svlen = torch.where(svalid, vl[sorder], 0)
    svoff = (torch.cumsum(vl, 0) - vl)[sorder]
    host_resolve_any = core["host_resolve"].any()
    del core, take

    # --- full internal-key matrix (user key + 8-byte LE trailer) ---
    shifts = torch.arange(4, dtype=i64, device=device) * 8
    tb = torch.cat([(sp_lo[:, None] >> shifts) & 0xFF,
                    (sp_hi[:, None] >> shifts) & 0xFF], dim=1)
    ikey = torch.cat([kb[sorder], tb.to(torch.uint8)], dim=1)  # [p, K]
    del tb

    # --- shared-prefix lengths between consecutive survivors ---
    # The constant-K clamp turns the kernel's 128 for an equal row into K.
    lcp = kernels.shared_prefix_lengths(
        ikey, torch.full((p,), K, dtype=torch.int32, device=device)).to(i64)
    lcp = torch.where(svalid & (iota > 0), lcp, 0)

    # --- per-entry sizes (single-byte varints; host gates K, vlen < 128) ---
    sz_cont = torch.where(svalid, 3 + (K - lcp) + svlen, 0)
    sz_rst = torch.where(svalid, 3 + K + svlen, 0)
    delta = sz_rst - sz_cont                    # == lcp for valid rows
    S = torch.cumsum(sz_cont, 0)                # inclusive
    S0 = S - sz_cont                            # exclusive

    # --- greedy block cuts: next_start[j] for every possible start j ---
    # total(j, i) = S[i]-S0[j] + D_m[i]-D0_m[j] + 4*floor((i-j)/R) + 8
    # with m = j mod R and D_m = cumsum(delta at positions = m (mod R)).
    nxt = torch.full((p,), p - 1, dtype=i64, device=device)
    for mc in range(R):
        cls = (iota % R) == mc
        dm = torch.where(cls, delta, 0)
        D = torch.cumsum(dm, 0)
        D0 = D - dm
        rm = (iota - mc) % R
        a = (iota - rm - mc) // R
        U = S + D + 4 * a
        b_j = (iota - mc) // R
        T = (B - 8) + S0 + D0 + 4 * b_j
        cand = torch.searchsorted(U, T)
        nxt = torch.where(cls, cand, nxt)
    del S, S0, delta, D, D0, dm, U, T, cand
    f = torch.clamp(nxt + 1, 1, p)              # cut AFTER entry nxt[j]
    f_ext = torch.cat([f, f.new_full((1,), p)])

    # --- mark the orbit of 0 under f (actual block starts) ---
    # Pointer doubling: after round r, reach marks the nodes 0 reaches in
    # fewer than 2^r steps. Each round every reached node marks its jump
    # target (the reference's scatter-max of reach over g). Unreached nodes
    # write to a private slot past p instead of taking part in a max: g
    # maps millions of rows onto the few block starts, and a scatter-max
    # over all of them serializes on those addresses. Along the orbit g
    # strictly increases, so reached nodes' writes meet only at p.
    private = torch.arange(p + 1, 2 * (p + 1), dtype=i64, device=device)
    reach = torch.zeros(p + 1, dtype=torch.uint8, device=device)
    reach[0] = 1
    g = f_ext
    for _ in range((p - 1).bit_length() + 1):  # ceil(log2 p) + 1 rounds
        hit = torch.zeros(2 * (p + 1), dtype=torch.uint8, device=device)
        hit.index_fill_(0, torch.where(reach > 0, g, private), 1)
        reach = reach | hit[: p + 1]
        g = g[g]
    start = (reach[:p] > 0) & (iota < m)
    del reach, g, hit, private

    # --- compact blocks to the front ---
    border = ck._stable_partition(start)
    bpos = border[:nbp]                         # block start positions
    nbl = bpos.shape[0]
    nb = start.sum()
    blk_id = torch.clamp(torch.cumsum(start.to(i64), 0) - 1, 0, nbl - 1)

    # --- per-entry block geometry ---
    # Each entry's block start: the reference's cummax over the start
    # positions, equal to the position of the entry's block (a gather, not
    # a sequential scan on the card).
    bstart = bpos[blk_id]
    q = iota - bstart
    is_rst = (q % R) == 0
    sz = torch.where(is_rst, sz_rst, sz_cont)
    Csz = torch.cumsum(sz, 0)
    E0 = Csz - sz                               # exclusive entry offsets
    eoff_in_blk = E0 - E0[torch.clamp(bstart, 0, p - 1)]
    shared = torch.where(is_rst, 0, lcp)
    nonshared = K - shared
    del bstart, q, is_rst, sz_cont, sz_rst, lcp

    bidx = torch.arange(nbl, dtype=i64, device=device)
    bvalid = bidx < nb
    bpos_c = torch.clamp(bpos, 0, p - 1)
    bnext = torch.minimum(f_ext[bpos_c], m)
    bcnt = torch.where(bvalid, bnext - bpos, 0)
    blast = torch.clamp(bpos + bcnt - 1, 0, p - 1)
    bentry_bytes = torch.where(bvalid, Csz[blast] - E0[bpos], 0)
    bnr = torch.where(bvalid, 1 + (torch.clamp(bcnt, min=1) - 1) // R, 0)
    bpayload = torch.where(bvalid, bentry_bytes + 4 * bnr + 4, 0)
    bout = torch.cumsum(bpayload, 0) - bpayload  # block payload start
    total_payload = bpayload.sum()
    entry_global = bout[blk_id] + eoff_in_blk
    del Csz, eoff_in_blk, blk_id

    # --- emit records: [p, max_rec] byte matrix scattered once ---
    # Writes the reference drops (mode="drop") go to a sink byte at ubp.
    out = torch.zeros(ubp + 1, dtype=torch.uint8, device=device)
    col = torch.arange(max_rec, dtype=i64, device=device)[None, :]
    keyb = torch.gather(
        ikey, 1, torch.clamp(shared[:, None] + col - 3, 0, K - 1))
    vpos = svoff[:, None] + (col - 3 - nonshared[:, None])
    valb = vflat[torch.clamp(vpos, 0, vflat.shape[0] - 1)]
    del vpos, ikey
    rec = torch.where(col < 3 + nonshared[:, None], keyb, valb)
    del keyb, valb
    rec[:, 0] = shared.to(torch.uint8)
    rec[:, 1] = nonshared.to(torch.uint8)
    rec[:, 2] = svlen.to(torch.uint8)
    flat_idx = entry_global[:, None] + col
    flat_idx = torch.where((col < sz[:, None]) & svalid[:, None]
                           & (flat_idx < ubp), flat_idx, ubp)
    out.scatter_(0, flat_idx.reshape(-1), rec.reshape(-1))
    del flat_idx, rec, entry_global

    # --- emit restart arrays: [nbp, (max_rwords+1)*4] scattered once ---
    max_rwords = B // (3 * R) + 2
    w = torch.arange(max_rwords + 1, dtype=i64, device=device)[None, :]
    rpos = torch.clamp(bpos[:, None] + w * R, 0, p - 1)
    roffs = E0[rpos] - E0[bpos_c][:, None]
    word = torch.where(w < bnr[:, None], roffs, bnr[:, None])
    wb = torch.arange((max_rwords + 1) * 4, dtype=i64, device=device)[None, :]
    wsel = wb // 4
    wvals = word[:, wsel[0]]
    rbytes = ((wvals >> (8 * (wb % 4))) & 0xFF).to(torch.uint8)
    rdst = (bout + bentry_bytes)[:, None] + wb
    rdst = torch.where((wsel <= bnr[:, None]) & bvalid[:, None]
                       & (rdst < ubp), rdst, ubp)
    out.scatter_(0, rdst.reshape(-1), rbytes.reshape(-1))
    out = out[:ubp]

    # --- block boundary rows + stats ---
    zbit = 1 << 30
    bfirst = torch.where(
        bvalid, sorder[bpos_c] | torch.where(szero[bpos_c], zbit, 0), -1)
    blast_r = torch.where(
        bvalid, sorder[blast] | torch.where(szero[blast], zbit, 0), -1)
    # Survivor bitmap over ORIGINAL local rows (1 bit per row): the host
    # derives the bloom's selection from it without the full order.
    surv = torch.zeros(p + (-p) % 8, dtype=i64, device=device)
    surv[:p].scatter_(0, sorder, svalid.to(i64))
    weights = (1 << torch.arange(8, dtype=i64, device=device))[None, :]
    surv_bitmap = (surv.reshape(-1, 8) * weights).sum(dim=1).to(torch.uint8)

    num_del = (svalid & ((svt == int(ValueType.DELETION))
                         | (svt == int(ValueType.SINGLE_DELETION)))).sum()
    raw_value = svlen.sum()
    s_hi = sp_hi >> 8
    s_lo = ((sp_lo >> 8) | (sp_hi << 24)) & _M32
    seq_hi = torch.where(svalid, s_hi, _M32)
    seq_lo = torch.where(svalid, s_lo, _M32)
    smin_hi = seq_hi.min()
    smin_lo = torch.where(seq_hi == smin_hi, seq_lo, _M32).min()
    seq_hi_mx = torch.where(svalid, s_hi, 0)
    seq_lo_mx = torch.where(svalid, s_lo, 0)
    smax_hi = seq_hi_mx.max()
    smax_lo = torch.where(seq_hi_mx == smax_hi, seq_lo_mx, 0).max()
    meta = torch.cat([
        torch.stack([nb, m, total_payload, host_resolve_any.to(i64),
                     num_del, raw_value]).to(torch.int32),
        ck._i32(torch.stack([smin_hi, smin_lo, smax_hi, smax_lo])),
    ])
    i32 = torch.int32
    return (out, meta, bcnt.to(i32), bpayload.to(i32), bfirst.to(i32),
            blast_r.to(i32), surv_bitmap)


def budgets(p: int, K: int, vlens: np.ndarray, R: int, B: int):
    """Static shapes of one assembly program: (max_rec, ubp, nbp) — the
    widest record, and pow2 bounds on the payload bytes and block count
    (p rows of K-byte keys, per-row value lengths vlens, restart interval
    R, block size B)."""
    max_rec = 3 + K + int(vlens.max())
    ub0 = int((3 + K) * p + int(vlens.sum()))
    nb_ub = ub0 // B + 2
    ub0 += 4 * (p // R + nb_ub + 2) + 4 * nb_ub
    return max_rec, ck._next_pow2(ub0), ck._next_pow2(nb_ub)


def assembly_supported(device_blocks: bool, table_options, kv, shards,
                       any_complex, max_output_file_size, vtypes) -> bool:
    """Gate for the on-device block-assembly route: off unless the caller
    asks for it (`device_blocks`), and only for the jobs whose blocks the
    device builds byte-identically. `vtypes`: the caller's decoded per-row
    trailer types."""
    if not device_blocks:
        return False
    if shards is None or len(shards) != 1 or any_complex:
        return False
    if table_options.format != "block":
        return False
    if table_options.compression != fmt.NO_COMPRESSION:
        return False
    if table_options.filter_policy is not None and (
            not table_options.whole_key_filtering
            or table_options.prefix_extractor is not None):
        # Prefix filter keys exist only on the per-entry route; a
        # whole-key-only bloom here would break byte parity.
        return False
    if not kv.n:
        return False
    K = int(kv.key_lens[0])
    if not (0 < K < 128):
        return False
    if int(kv.val_lens.max()) >= 128:
        return False
    # Single output file only (the block layout must match the unsplit
    # build): a 2x margin over the raw estimate covers block trailers,
    # restarts and the index even at tiny block sizes.
    est = int(kv.key_lens.sum()) + int(kv.val_lens.sum()) + 8 * kv.n
    if est * 2 + 65536 >= max_output_file_size or est >= 2 ** 30:
        return False
    if bool(np.any(vtypes == int(ValueType.BLOB_INDEX))):
        return False
    if table_options.block_size < 64 or table_options.restart_interval < 1:
        return False
    return True


def _download_sections(out, bpayload, nb: int):
    """Enqueue the payload's download in ~_SECTION_BYTES sections cut at
    block ends. Returns [(blk_lo, blk_hi, host_view, event)]; on the CPU
    the views are the tensor itself and there are no events."""
    bends = np.cumsum(bpayload, dtype=np.int64)
    total = int(bends[-1]) if nb else 0
    cuda = out.device.type == "cuda"
    host = (torch.empty(total, dtype=torch.uint8, pin_memory=True)
            if cuda else out[:total])
    sections = []
    blk_lo = base = 0
    for b in range(nb):
        end = int(bends[b])
        if end - base >= _SECTION_BYTES or b == nb - 1:
            view = host[base:end]
            ev = None
            if cuda:
                view.copy_(out[base:end], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(out.device))
            sections.append((blk_lo, b + 1, view, ev))
            blk_lo, base = b + 1, end
    return sections


def run_block_assembly(env, dbname, icmp, kv, shard, cover, snapshots,
                       bottommost, table_options, new_file_number,
                       creation_time, tombs, device,
                       column_family=(0, "default"), stats=None):
    """Run the block-assembly program for a single-shard job on `device` and
    write the output SST (host: block trailers + index/meta/footer).
    Returns the same (fnum, path, props, smallest, largest, sel) tuples as
    write_tables_columnar; `sel` (from the downloaded survivor bitmap) is
    materialized only when a whole-key bloom builds from it. Raises
    NotSupported before any file is created when the program refuses the
    job (budgets exceeded, complex groups). `stats` (optional) gets the
    upload, device-wait and write phases."""
    from toplingdb_tpu_torch.ops.columnar_io import _ColumnarSST
    from toplingdb_tpu_torch.ops.device_compaction import _ranges_lmap

    if len(snapshots) > ck.MAX_SNAPSHOTS:
        raise NotSupported(
            f"device GC supports <= {ck.MAX_SNAPSHOTS} live snapshots")
    t_up = time.time()
    chunks, ranges = shard
    covers_s = None if cover is None else [cover[lo:hi] for lo, hi in ranges]
    h = ck.upload_uniform_shard(chunks, covers_s, device=device)
    uk_len = h["uk_len"]
    K = uk_len + 8
    p = int(h["pkb"].shape[0])

    # Values: per-row lengths + dense bytes, in the same local row order.
    vlens = np.zeros(p, dtype=np.int32)
    vparts = []
    pos = 0
    for lo, hi in ranges:
        vlens[pos:pos + (hi - lo)] = kv.val_lens[lo:hi]
        b0 = int(kv.val_offs[lo])
        b1 = int(kv.val_offs[hi - 1]) + int(kv.val_lens[hi - 1])
        vparts.append(kv.val_buf[b0:b1])
        pos += hi - lo
    vflat = np.concatenate(vparts) if vparts else np.zeros(0, np.uint8)
    vf = np.zeros(ck._next_pow2(max(8, len(vflat))), dtype=np.uint8)
    vf[: len(vflat)] = vflat

    R = int(table_options.restart_interval)
    B = int(table_options.block_size)
    max_rec, ubp, nbp = budgets(p, K, vlens, R, B)

    snap_hi, snap_lo = ck._split_snapshots(snapshots)
    (out, meta, bcnt, bpayload, bfirst, blast,
     surv_bitmap) = assemble_blocks(
        ck.shard_key_matrix(h), h["pkb"], h["starts"], h["min_his"],
        h["min_los"], ck._to_device(vlens, device), ck._to_device(vf, device),
        h["tomb_hi"], h["tomb_lo"], ck._to_device(snap_hi, device),
        ck._to_device(snap_lo, device), h["total"], (max(uk_len, 4) + 3) // 4,
        uk_len, bool(bottommost), R, B, max_rec, ubp, nbp,
        run_starts=h["run_starts"], merge_mode=ck.shard_merge_mode(h),
    )
    del h
    want_bloom = (table_options.filter_policy is not None
                  and table_options.whole_key_filtering)
    t_wait = time.time()
    small = torch.cat([meta, bcnt, bpayload, bfirst, blast]).cpu().numpy()
    surv_bits = surv_bitmap.cpu().numpy() if want_bloom else None
    meta = small[:10]
    nb, mtot, total_payload, has_complex = (
        int(meta[0]), int(meta[1]), int(meta[2]), bool(meta[3]))
    if has_complex:
        raise NotSupported("complex groups reached block assembly")
    if nb > nbp or total_payload > ubp:
        # The static budgets were undersized for this shape (the scatters
        # sent out-of-range writes to the sink, so nothing corrupt was
        # produced).
        raise NotSupported("block assembly budgets exceeded")
    nbl = bcnt.shape[0]
    bcnt = small[10:10 + nbl][:nb]
    bpayload = small[10 + nbl:10 + 2 * nbl][:nb]
    bfirst = small[10 + 2 * nbl:10 + 3 * nbl][:nb]
    blast = small[10 + 3 * nbl:][:nb]
    sections = _download_sections(out, bpayload, nb)
    t_wr = time.time()
    ev_usec = 0

    lmap = _ranges_lmap(ranges)
    if want_bloom:
        surv = np.unpackbits(surv_bits, bitorder="little")[: len(lmap)]
        sel = lmap[np.flatnonzero(surv)]
    else:
        sel = np.empty(0, dtype=np.int64)  # nothing consumes it

    def boundary_ikey(enc: int) -> bytes:
        ik = kv.ikey(int(lmap[enc & ((1 << 30) - 1)]))
        if enc & (1 << 30):
            # A zeroed trailer keeps only the value type byte.
            ik = ik[:-8] + int(ik[-8]).to_bytes(8, "little")
        return ik

    lib = native.lib()
    fnum = new_file_number()
    sst = _ColumnarSST(env, dbname, fnum, icmp, table_options, creation_time,
                       column_family)
    try:
        # Frame blocks: payload + type(0) + masked crc32c, one framed run
        # per downloaded section, each as soon as its copy completes.
        for s_lo, s_hi, view, ev in sections:
            if ev is not None:
                t_ev = time.time()
                ev.synchronize()
                ev_usec += int((time.time() - t_ev) * 1e6)
            chunk = view.numpy()
            section = bytearray()
            blocks = []
            off = 0
            for b in range(s_lo, s_hi):
                pl = int(bpayload[b])
                raw = chunk[off:off + pl].tobytes()
                off += pl
                crc = crc32c.mask(crc32c.extend(0, raw + b"\x00"))
                section += raw + b"\x00" + crc.to_bytes(4, "little")
                blocks.append((pl, boundary_ikey(int(bfirst[b])),
                               boundary_ikey(int(blast[b])), int(bcnt[b])))
            sst.add_framed_section(bytes(section), blocks)
        pre = {
            "num_entries": mtot,
            "raw_key_size": mtot * K,
            "raw_value_size": int(meta[5]),
            "num_deletions": int(meta[4]),
            "num_merge_operands": 0,
            "smallest_seqno": ((int(meta[6]) & _M32) << 32
                               | int(meta[7]) & _M32) if mtot else 0,
            "largest_seqno": ((int(meta[8]) & _M32) << 32
                              | int(meta[9]) & _M32) if mtot else 0,
        }
        props, smallest, largest = sst.finish(
            lib, kv, sel, None, None, tombstones=tombs, precomputed=pre)
    except BaseException:
        sst.w.close()
        try:
            env.delete_file(sst.path)
        except Exception:  # noqa: BLE001 - best-effort cleanup
            pass
        raise
    if stats is not None:
        # Upload + program enqueue; waits on the program and the section
        # copies; framing, index, filter and footer.
        stats.transfer_time_usec += int((t_wait - t_up) * 1e6)
        stats.device_wait_usec += int((t_wr - t_wait) * 1e6) + ev_usec
        stats.encode_write_usec += int((time.time() - t_wr) * 1e6) - ev_usec
    return [(fnum, sst.path, props, smallest, largest, sel)]
