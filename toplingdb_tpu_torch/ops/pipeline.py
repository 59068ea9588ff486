"""Pipelined compaction data plane: overlap scan, merge/GC and encode (the
counterpart of toplingdb_tpu/ops/pipeline.py, device compute only).

The serial columnar path (ops/device_compaction.py) is a three-phase chain
(scan every input SST into columnar buffers, the device programs over every
shard, then encode+write the outputs), so its wall clock is the SUM of the
phases. This module runs the same work as a bounded three-stage pipeline at
user-key-range shard granularity:

  reader   per input file, decode the blocks of one key-range shard per
           native call (windowed preads through a FilePrefetchBuffer),
           writing into a properties-sized preallocated ColumnarKV;
           independent files scan on parallel threads
  compute  as soon as EVERY file has scanned past shard s, upload that
           shard's uniform chunks and enqueue its device program
           (ops/compaction_kernels.py) on the compute thread's own CUDA
           stream; shard s+1 uploads while shard s computes, and results
           are finished in shard order
  writer   stream each shard's survivor order into the native block
           builder (write_tables_columnar's chunked-order mode) while later
           shards are still being scanned and computed; for zip outputs
           (`table_options.format == "zip"`, native zip plane only) the
           writer is write_tables_zip_columnar, which drains the whole feed
           before it encodes, so only scan and compute overlap

Key-range shards are cut at user-key boundaries (every version of a user
key lands in exactly one shard), so per-shard GC decisions (snapshot
stripes, tombstone shadowing, bottommost seqno zeroing) equal the global
ones and the concatenated survivor stream is byte-identical to the serial
path's. Jobs the pipeline does not cover (non-uniform key lengths, complex
merge / single-delete groups, missing properties, small inputs,
dictionary-compressed inputs and codecs the native scan does not inflate)
raise PipelineIneligible, and the caller runs the serial path, which
computes the same bytes. A kernel or CUDA failure in any stage is raised to
the caller as it is. When the calling thread carries a sampled trace
(utils/telemetry.py), the stages record `pipeline.scan` (per file and
shard), `pipeline.merge_gc` (per shard) and `pipeline.encode_write` (per
chunk) spans under it.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import sys
import time
from queue import Empty, Full, Queue

import numpy as np
import torch

from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.utils import telemetry
from toplingdb_tpu_torch.utils.status import Corruption, NotSupported
from toplingdb_tpu_torch.utils import concurrency as ccy


class PipelineIneligible(Exception):
    """Job shapes the pipeline does not cover; run the serial path."""


class _Done:
    pass


class _Err:
    def __init__(self, exc):
        self.exc = exc


_DONE = _Done()

# Below this row estimate the serial path wins: thread startup plus
# per-shard dispatch overhead cannot be recouped by overlap.
MIN_PIPELINE_ROWS = 1 << 18

# Reader-stage readahead: shard windows are MBs, so the prefetch buffer
# runs with a much larger ceiling than the per-iterator default.
_PF_READAHEAD = 8 << 20

_PU8 = ctypes.POINTER(ctypes.c_uint8)
_PI32 = ctypes.POINTER(ctypes.c_int32)


def _pipeline_shards(total_rows: int, requested: int | None = None) -> int:
    """Pipeline shard count: `requested` when given; otherwise finer than
    the serial device sharding (the pipeline wants several shards in flight
    even at ~1M rows): ~512K rows per shard, a power of two, at most 32."""
    if requested is not None:
        return max(1, int(requested))
    target = 1 << 19
    s = 1
    while s < 32 and total_rows // s > target:
        s *= 2
    return s


class _FilePlan:
    """Per-input-file scan plan: block handles grouped by shard, the file's
    slice of the preallocated global buffers, and the row bounds of each
    shard (filled in by the reader as decode progresses)."""

    __slots__ = ("reader", "pf", "block_offs", "block_lens", "groups",
                 "ne", "rk", "rv", "n_base", "k_base", "v_base",
                 "row_bounds", "verify")


class _Progress:
    """Reader→compute coordination: per-file shard watermarks plus the first
    error; any failure stops every stage."""

    def __init__(self, n_files: int):
        self._done = [-1] * n_files
        self._cv = ccy.Condition("pipeline._Progress._cv")
        self.err: BaseException | None = None
        self.stop = False
        self.scan_end = 0.0

    def mark(self, fi: int, s: int) -> None:
        with self._cv:
            self._done[fi] = s
            self._cv.notify_all()

    def finish_file(self, fi: int) -> None:
        with self._cv:
            self.scan_end = max(self.scan_end, time.time())

    def fail(self, exc: BaseException) -> None:
        with self._cv:
            if self.err is None:
                self.err = exc
            self.stop = True
            self._cv.notify_all()

    def abort(self) -> None:
        with self._cv:
            self.stop = True
            self._cv.notify_all()

    def wait_shard(self, s: int) -> None:
        with self._cv:
            while True:
                if self.err is not None:
                    raise self.err
                if self.stop:
                    raise PipelineIneligible("pipeline aborted")
                if min(self._done) >= s:
                    return
                self._cv.wait()


def _uk_at(kv, r: int) -> bytes:
    o = int(kv.key_offs[r])
    return kv.key_buf[o: o + int(kv.key_lens[r]) - 8].tobytes()


def _lower_bound(kv, lo: int, hi: int, key: bytes) -> int:
    """First row in [lo, hi) (internal-key sorted) with user key >= key."""
    while lo < hi:
        mid = (lo + hi) // 2
        if _uk_at(kv, mid) < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _range_seq_vtype(kv, lo: int, hi: int):
    """(seq u64, vtype i32) for global rows [lo, hi): generic trailer
    gather (the rows need not be a dense byte span)."""
    offs = kv.key_offs[lo:hi].astype(np.int64)
    lens = kv.key_lens[lo:hi].astype(np.int64)
    tr_idx = (offs + lens - 8)[:, None] + np.arange(8)[None, :]
    trailer = np.ascontiguousarray(kv.key_buf[tr_idx])
    packed = trailer.view(np.uint64).reshape(hi - lo)
    if sys.byteorder == "big":
        packed = packed.byteswap()
    return packed >> np.uint64(8), \
        (packed & np.uint64(0xFF)).astype(np.int32)


def _build_plan(readers, n_shards_req=None):
    """Validate prealloc eligibility, size the global buffers, pick the
    key-range splitters and each file's per-shard block groups. Returns
    (kv, files, splitters) or raises PipelineIneligible."""
    from toplingdb_tpu_torch.ops.columnar_io import ColumnarKV
    from toplingdb_tpu_torch.table import format as fmt
    from toplingdb_tpu_torch.table.prefetch import FilePrefetchBuffer

    if native.lib() is None:
        raise PipelineIneligible("native fused scan unavailable")
    infos = []
    tk = tv = tn = 0
    for r in readers:
        if not hasattr(r, "new_index_iterator"):
            raise PipelineIneligible("non-block input format")
        if r._compression_dict:
            raise PipelineIneligible("dict-compressed input")
        p = r.properties
        ne, rk, rv = int(p.num_entries), int(p.raw_key_size), int(
            p.raw_value_size)
        if ne < 0 or rk < 0 or rv < 0 or (ne > 0 and rk == 0):
            raise PipelineIneligible("implausible input properties")
        idx = r.new_index_iterator()
        idx.seek_to_first()
        handles = []
        sep_uks = []
        for k, enc in idx.entries():
            handles.append(fmt.BlockHandle.decode_exact(enc))
            sep_uks.append(k[:-8])
        if ne and not handles:
            raise PipelineIneligible("entries claimed but no data blocks")
        infos.append((ne, rk, rv, handles, sep_uks))
        tk += rk
        tv += rv
        tn += ne
    if tk > 0x7FFFFF00 or tv > 0x7FFFFF00:
        raise PipelineIneligible("inputs exceed the int32 columnar budget")
    if tn < MIN_PIPELINE_ROWS:
        raise PipelineIneligible("job below the pipeline row floor")

    # Splitters: merged per-file index separator user keys (one per data
    # block, so even index spacing approximates even byte spacing), cut
    # into n_shards quantiles.
    n_shards = _pipeline_shards(tn, n_shards_req)
    if n_shards < 2:
        raise PipelineIneligible("single-shard job")
    all_seps = sorted(uk for _, _, _, _, uks in infos for uk in uks)
    splitters: list[bytes] = []
    for t in range(1, n_shards):
        cand = all_seps[len(all_seps) * t // n_shards]
        if not splitters or cand > splitters[-1]:
            splitters.append(cand)
    if not splitters:
        raise PipelineIneligible("inputs too uniform to shard")
    n_shards = len(splitters) + 1

    kv = ColumnarKV(
        np.empty(tk, dtype=np.uint8), np.empty(tn, dtype=np.int32),
        np.empty(tn, dtype=np.int32), np.empty(tv, dtype=np.uint8),
        np.empty(tn, dtype=np.int32), np.empty(tn, dtype=np.int32),
    )

    files = []
    nb = kb = vb = 0
    for r, (ne, rk, rv, handles, sep_uks) in zip(readers, infos):
        if ne == 0:
            continue
        fp = _FilePlan()
        fp.reader = r
        fp.pf = FilePrefetchBuffer(r._f, max_readahead=_PF_READAHEAD,
                                   initial_readahead=_PF_READAHEAD,
                                   arm_immediately=True)
        fp.block_offs = np.array([h.offset for h in handles], dtype=np.int64)
        fp.block_lens = np.array([h.size for h in handles], dtype=np.int64)
        # Shard s decodes blocks [groups[s], groups[s+1]); the group ends at
        # (inclusive) the first block whose separator user key reaches the
        # splitter; that block may straddle it, and its tail rows belong to
        # the next shard via the row-bound binary search.
        g = [0]
        for spl in splitters:
            g.append(max(g[-1], min(bisect.bisect_left(sep_uks, spl) + 1,
                                    len(handles))))
        g.append(len(handles))
        fp.groups = g
        fp.ne, fp.rk, fp.rv = ne, rk, rv
        fp.n_base, fp.k_base, fp.v_base = nb, kb, vb
        fp.row_bounds = [nb] * n_shards + [nb + ne]
        fp.verify = bool(r.opts.verify_checksums)
        files.append(fp)
        nb += ne
        kb += rk
        vb += rv
    if not files:
        raise PipelineIneligible("no non-empty inputs")
    return kv, files, splitters


def _scan_file(fi, fp, kv, prog, splitters, stats, stats_mu,
               trace_handle=None):
    """Reader worker: decode one file shard-by-shard into its slice of the
    global buffers (snappy and zstd blocks inflate inside the native scan),
    publishing row bounds + progress per shard; one `pipeline.scan` span
    per shard under `trace_handle` when the job is traced."""
    lib = native.lib()
    n_shards = len(splitters) + 1
    try:
        rows = 0
        k_used = v_used = 0
        bound = 0  # file-local row bound of the current shard start
        for s in range(n_shards):
            if prog.stop:
                return
            t_sh = time.time() if trace_handle is not None else 0.0
            blo, bhi = fp.groups[s], fp.groups[s + 1]
            if bhi > blo:
                w0 = int(fp.block_offs[blo])
                w1 = int(fp.block_offs[bhi - 1] + fp.block_lens[bhi - 1]) + 5
                raw = fp.pf.read(w0, w1 - w0)
                rawb = np.frombuffer(raw, dtype=np.uint8)
                boffs = np.ascontiguousarray(fp.block_offs[blo:bhi] - w0)
                blens = np.ascontiguousarray(fp.block_lens[blo:bhi])
                rc = lib.tpulsm_scan_blocks(
                    native.np_u8p(rawb), len(rawb),
                    native.np_i64p(boffs), native.np_i64p(blens), bhi - blo,
                    1 if fp.verify else 0,
                    ctypes.cast(kv.key_buf.ctypes.data + fp.k_base + k_used,
                                _PU8), fp.rk - k_used,
                    ctypes.cast(kv.val_buf.ctypes.data + fp.v_base + v_used,
                                _PU8), fp.rv - v_used,
                    ctypes.cast(kv.key_offs.ctypes.data
                                + 4 * (fp.n_base + rows), _PI32),
                    ctypes.cast(kv.key_lens.ctypes.data
                                + 4 * (fp.n_base + rows), _PI32),
                    ctypes.cast(kv.val_offs.ctypes.data
                                + 4 * (fp.n_base + rows), _PI32),
                    ctypes.cast(kv.val_lens.ctypes.data
                                + 4 * (fp.n_base + rows), _PI32),
                    fp.ne - rows, fp.k_base + k_used, fp.v_base + v_used,
                )
                if rc == -6:
                    raise Corruption("block checksum mismatch (pipeline)")
                if rc == -8:
                    raise Corruption("block decode failed (pipeline)")
                if rc < 0:
                    # -1 a codec the native scan lacks, -2/-3/-4 capacity
                    # disagreements with the properties: the serial path
                    # covers these.
                    raise PipelineIneligible(f"native scan rc={rc}")
                if rc > 0:
                    last = fp.n_base + rows + int(rc) - 1
                    k_used = int(kv.key_offs[last]) \
                        + int(kv.key_lens[last]) - fp.k_base
                    v_used = int(kv.val_offs[last]) \
                        + int(kv.val_lens[last]) - fp.v_base
                rows += int(rc)
                if rows > fp.ne:
                    raise PipelineIneligible("more entries than properties")
            if s < n_shards - 1:
                nb = _lower_bound(kv, fp.n_base + bound, fp.n_base + rows,
                                  splitters[s]) - fp.n_base
                fp.row_bounds[s + 1] = fp.n_base + nb
                bound = nb
            if s == n_shards - 1 and (rows != fp.ne or k_used != fp.rk
                                      or v_used != fp.rv):
                raise PipelineIneligible("scan totals disagree with props")
            if trace_handle is not None and bhi > blo:
                telemetry.span_event_under(
                    trace_handle, "pipeline.scan",
                    (time.time() - t_sh) * 1e6, file=fi, shard=s,
                    blocks=bhi - blo)
            prog.mark(fi, s)
        with stats_mu:
            stats.prefetch_hits += fp.pf.hits
            stats.prefetch_misses += fp.pf.misses
        prog.finish_file(fi)
    except BaseException as e:  # noqa: BLE001 - forwarded to the writer
        prog.fail(e)


def _cover_for_ranges(kv, ranges, frags, snaps):
    """Stripe-clamped max covering tombstone seqno per row of the shard's
    (sorted) per-file ranges, concatenated in range order: the pipeline
    twin of device_compaction._cover_for_parts."""
    if not frags:
        return None
    covs = []
    for lo, hi in ranges:
        n = hi - lo
        cov = np.zeros(n, dtype=np.uint64)
        if n:
            seqs, _vt = _range_seq_vtype(kv, lo, hi)
            if len(snaps):
                idx = np.searchsorted(snaps, seqs, side="left")
                upper = np.where(
                    idx < len(snaps),
                    snaps[np.minimum(idx, len(snaps) - 1)],
                    np.uint64(dbformat.MAX_SEQUENCE_NUMBER),
                )
            else:
                upper = np.full(n, dbformat.MAX_SEQUENCE_NUMBER,
                                dtype=np.uint64)
            for frag in frags:
                flo = _lower_bound(kv, lo, hi, frag.begin) - lo
                fhi = _lower_bound(kv, lo + flo, hi, frag.end) - lo
                if flo < fhi:
                    t = np.uint64(frag.seq)
                    sl = slice(flo, fhi)
                    elig = ((t > seqs[sl]) & (t <= upper[sl])
                            & (t > cov[sl]))
                    cov[sl] = np.where(elig, t, cov[sl])
        covs.append(cov)
    return np.concatenate(covs)


def _shard_ranges(files, s):
    return [(fp.row_bounds[s], fp.row_bounds[s + 1]) for fp in files
            if fp.row_bounds[s + 1] > fp.row_bounds[s]]


def _ranges_lmap(ranges) -> np.ndarray:
    if not ranges:
        return np.empty(0, np.int32)
    return np.concatenate([
        np.arange(lo, hi, dtype=np.int32) for lo, hi in ranges
    ])


def _put(outq, prog, item) -> None:
    """Bounded put that gives up once any stage has failed or aborted."""
    while True:
        if prog.stop:
            raise prog.err or PipelineIneligible("pipeline aborted")
        try:
            outq.put(item, timeout=0.1)
            return
        except Full:
            continue


def _host_compute(kv, files, splitters, prog, outq, shared, snapshots,
                  bottommost, frags, max_dev_key, host_merge):
    """Compute worker, host-twin mode: the native k-way merge with its
    inline GC per shard (the two-pass twin where it refuses the shard, or
    with host_merge=False); publishes global-row survivor chunks with the
    zero-seq rows patched."""
    from toplingdb_tpu_torch.ops import compaction_kernels as ck

    n_shards = len(splitters) + 1
    snaps = np.asarray(sorted(snapshots), dtype=np.uint64)
    for s in range(n_shards):
        prog.wait_shard(s)
        t0 = time.time()
        ranges = _shard_ranges(files, s)
        if not ranges:
            continue
        span = telemetry.span_under(shared.trace, "pipeline.merge_gc",
                                    shard=s)
        soffs = np.concatenate(
            [kv.key_offs[lo:hi] for lo, hi in ranges]).astype(np.int64)
        slens = np.concatenate(
            [kv.key_lens[lo:hi] for lo, hi in ranges]).astype(np.int64)
        mx = int(slens.max())
        if mx - 8 > max_dev_key:
            raise PipelineIneligible("keys exceed the device budget")
        rs = np.cumsum([0] + [hi - lo for lo, hi in ranges],
                       dtype=np.int64)
        cover = _cover_for_ranges(kv, ranges, frags, snaps)
        order, zero, _cx, hc, seq_l, vt_l = ck.host_fused_full(
            kv.key_buf, soffs, slens, max(4, mx - 8), snapshots,
            bottommost, cover, run_starts=rs, host_merge=host_merge)
        if hc:
            raise PipelineIneligible("complex groups present")
        lmap = _ranges_lmap(ranges)
        og = lmap[order]
        shared.seqs[lmap] = seq_l
        shared.vtypes[lmap] = vt_l
        zg = og[zero]
        shared.trailer_override[zg] = shared.vtypes[zg].astype(np.int64)
        shared.seqs[zg] = 0
        shared.stats.host_compute_usec += int((time.time() - t0) * 1e6)
        span.finish()
        _put(outq, prog, og)
    _put(outq, prog, _DONE)


def _device_compute(kv, files, splitters, prog, outq, shared, snapshots,
                    bottommost, frags, max_dev_key, device, mesh_devices):
    """Compute worker: upload each shard's uniform chunks as soon as its
    scan lands (asynchronous host→device copies + program enqueue), finish
    in order, one shard ahead, so shard s+1 transfers while shard s
    computes. With `mesh_devices` (two or more) the shards go round-robin
    over them and the lookahead widens to UPLOAD_DEPTH per entry; an entry
    that fails mid-job demotes the rest of the job to `device`
    (ops/mesh_compaction.py). On CUDA the thread selects its device and
    runs every upload, program and download on a stream of its own
    (PyTorch's current stream is per thread); each shard's download and
    its event stay ordered behind its program on that stream."""
    with contextlib.ExitStack() as on_device:
        if device.type == "cuda":
            on_device.enter_context(torch.cuda.device(device))
            on_device.enter_context(
                torch.cuda.stream(torch.cuda.Stream(device)))
        _compute_shards(kv, files, splitters, prog, outq, shared, snapshots,
                        bottommost, frags, max_dev_key, device, mesh_devices)


def _compute_shards(kv, files, splitters, prog, outq, shared, snapshots,
                    bottommost, frags, max_dev_key, device, mesh_devices):
    from toplingdb_tpu_torch.ops import compaction_kernels as ck
    from toplingdb_tpu_torch.ops import mesh_compaction as mc
    from toplingdb_tpu_torch.parallel import mesh_plan as mp

    n_shards = len(splitters) + 1
    snaps = np.asarray(sorted(snapshots), dtype=np.uint64)
    mesh_devs = mc.pipeline_devices(n_shards, stats=shared.stats,
                                    mesh_devices=mesh_devices)
    # Shards in flight beyond the one being finished.
    depth = [mp.UPLOAD_DEPTH * len(mesh_devs) if mesh_devs else 1]
    pendings = []  # (shard, ranges, lmap, pending, dev, chunks, covers)

    def _demote(exc) -> None:
        # A failing entry: the rest of the job runs on `device`; the bytes
        # are unchanged (the same programs), only the placement degrades.
        mesh_devs.clear()
        depth[0] = 1
        shared.stats.mesh_chips = 1
        shared.stats.mesh_fallbacks = getattr(
            shared.stats, "mesh_fallbacks", 0) + 1
        telemetry.span_event_under(shared.trace, "compaction.mesh.fallback",
                                   0, reason="chip-wedged",
                                   error=type(exc).__name__)

    def start(chunks, covers, dev):
        return ck.fused_uniform_shard_start(
            ck.upload_uniform_shard(chunks, covers, device=dev), snapshots,
            bottommost)

    def finish_one(item):
        if item is None:
            return
        s, ranges, lmap, pending, dev, chunks, covers = item
        t0 = time.time()
        try:
            o, z, _cx, hc = ck.fused_uniform_shard_finish(pending)
        except Exception as e:
            if dev is None or isinstance(e, NotSupported):
                raise
            _demote(e)  # re-run this shard on the job's device
            o, z, _cx, hc = ck.fused_uniform_shard_finish(
                start(chunks, covers, device))
        dwait = time.time() - t0
        shared.stats.device_wait_usec += int(dwait * 1e6)
        telemetry.span_event_under(shared.trace, "pipeline.merge_gc",
                                   dwait * 1e6, shard=s, device=True)
        if dev is not None:
            telemetry.span_event_under(shared.trace, "compaction.mesh.shard",
                                       dwait * 1e6, shard=s, chip=str(dev))
        if hc:
            raise PipelineIneligible("complex groups present")
        og = lmap[o]
        for lo, hi in ranges:
            seq_r, vt_r = _range_seq_vtype(kv, lo, hi)
            shared.seqs[lo:hi] = seq_r
            shared.vtypes[lo:hi] = vt_r
        zg = og[z]
        shared.trailer_override[zg] = shared.vtypes[zg].astype(np.int64)
        shared.seqs[zg] = 0
        _put(outq, prog, og)

    for s in range(n_shards):
        prog.wait_shard(s)
        ranges = _shard_ranges(files, s)
        if not ranges:
            pendings.append(None)
        else:
            t0 = time.time()
            chunks = []
            klen = None
            for lo, hi in ranges:
                lens = kv.key_lens[lo:hi]
                if int(lens.min()) != int(lens.max()):
                    raise PipelineIneligible("non-uniform key length")
                if klen is None:
                    klen = int(lens[0])
                elif klen != int(lens[0]):
                    raise PipelineIneligible("non-uniform key length")
                if klen - 8 > max_dev_key:
                    raise PipelineIneligible("keys exceed the device budget")
                b0 = int(kv.key_offs[lo])
                chunks.append(ck.prepare_uniform_chunk(
                    kv.key_buf[b0:b0 + (hi - lo) * klen], hi - lo, klen,
                ))
            covers = None
            if frags:
                cov = _cover_for_ranges(kv, ranges, frags, snaps)
                covers = []
                pos = 0
                for lo, hi in ranges:
                    covers.append(cov[pos:pos + (hi - lo)])
                    pos += hi - lo
            dev = mesh_devs[s % len(mesh_devs)] if mesh_devs else None
            try:
                if dev is not None and mc._FAULT_HOOK is not None:
                    mc._FAULT_HOOK(s, dev)  # the mesh route's test seam
                pending = start(chunks, covers,
                                dev if dev is not None else device)
            except Exception as e:
                if dev is None or isinstance(e, NotSupported):
                    raise
                _demote(e)
                dev = None
                pending = start(chunks, covers, device)
            shared.stats.transfer_time_usec += int((time.time() - t0) * 1e6)
            pendings.append((s, ranges, _ranges_lmap(ranges), pending, dev,
                             chunks, covers))
        # Keep the lookahead window in flight (one shard serially,
        # UPLOAD_DEPTH per entry on the mesh); finish older shards now.
        while len(pendings) > depth[0]:
            finish_one(pendings.pop(0))
    while pendings:
        finish_one(pendings.pop(0))
    _put(outq, prog, _DONE)


class _Shared:
    """Arrays shared between compute and the writer (aliased per the
    chunked-order contract of write_tables_columnar), the stats, and the
    telemetry handle the stage threads parent their spans under."""

    __slots__ = ("trailer_override", "seqs", "vtypes", "stats", "trace")


def run_pipelined(env, dbname, icmp, compaction, table_cache, table_options,
                  snapshots, new_file_number, creation_time, stats,
                  max_dev_key, column_family=(0, "default"),
                  device=torch.device("cpu"), n_shards=None, zip_plane=True,
                  host_sort=False, host_merge=True, mesh_devices=None):
    """Run one compaction through the three-stage pipeline on `device`
    (CUDA: the kernels; CPU: their plain versions), with `n_shards`
    key-range shards (None: _pipeline_shards). `host_sort=True` computes
    the shards with the host twins instead (the reference's
    TPULSM_HOST_SORT=1; `host_merge=False` is its TPULSM_HOST_MERGE=0, the
    two-pass twin), the same bytes. `mesh_devices`: the device compute
    stage's shards go round-robin over these (ops/mesh_compaction.py).
    Zip outputs take
    write_tables_zip_columnar on the native zip plane; `zip_plane=False`
    makes a zip job PipelineIneligible (the serial route runs the numpy
    encoders). Returns the writer's file tuples, the scanned ColumnarKV
    and the per-row value types (for the outputs' blob refs).

    Raises PipelineIneligible for shapes the serial path must take and
    propagates hard errors (Corruption, IO, kernel and CUDA failures) after
    every stage has stopped and partial outputs are cleaned up by the
    writer."""
    from toplingdb_tpu_torch.compaction.compaction_job import (
        surviving_tombstone_fragments,
    )
    from toplingdb_tpu_torch.db.range_del import (
        RangeDelAggregator,
        RangeTombstone,
        fragment_tombstones,
    )
    from toplingdb_tpu_torch.ops.columnar_io import write_tables_columnar
    from toplingdb_tpu_torch.ops.compaction_kernels import MAX_SNAPSHOTS

    if len(snapshots) > MAX_SNAPSHOTS:
        raise PipelineIneligible("snapshot count exceeds the device cap")
    writer = write_tables_columnar
    if table_options.format == "zip":
        if not zip_plane:
            raise PipelineIneligible("zip outputs without the native plane")
        from toplingdb_tpu_torch.table.zip_table import (
            write_tables_zip_columnar,
        )

        writer = functools.partial(write_tables_zip_columnar,
                                   zip_plane=True)
    if device.type == "cuda" and device.index is None:
        # The compute thread has its own current device: name the caller's.
        device = torch.device("cuda", torch.cuda.current_device())
    readers = [
        table_cache.get_reader(f.number) for _, f in compaction.all_inputs()
    ]
    kv, files, splitters = _build_plan(readers, n_shards)
    stats.input_records = kv.n

    rd = RangeDelAggregator(icmp.user_comparator)
    for r in readers:
        for b, e in r.range_del_entries():
            rd.add(RangeTombstone.from_table_entry(b, e))
    frags = (list(fragment_tombstones(rd.tombstones(),
                                      icmp.user_comparator))
             if not rd.empty() else [])
    tombs = surviving_tombstone_fragments(
        rd, snapshots, compaction.bottommost, icmp.user_comparator,
    )

    shared = _Shared()
    shared.trailer_override = np.full(kv.n, -1, dtype=np.int64)
    shared.seqs = np.zeros(kv.n, dtype=np.uint64)
    shared.vtypes = np.zeros(kv.n, dtype=np.int32)
    shared.stats = stats
    stats.pipelined = True
    # The job's span lives on the calling thread; the stage threads parent
    # their per-shard spans under this exported handle.
    shared.trace = telemetry.current_handle()

    prog = _Progress(len(files))
    outq: Queue = Queue(maxsize=4)
    stats_mu = ccy.Lock("pipeline.run_pipelined.stats_mu")

    t_scan0 = time.time()
    rthreads = [
        ccy.spawn(f"pipeline-scan-{fi}", _scan_file, start=False,
                  args=(fi, fp, kv, prog, splitters, stats, stats_mu,
                        shared.trace))
        for fi, fp in enumerate(files)
    ]
    compute, extra = ((_host_compute, (host_merge,)) if host_sort
                      else (_device_compute, (device, mesh_devices)))
    cthread = ccy.spawn(
        "pipeline-compute", _compute_guard, start=False,
        args=(prog, outq, compute, kv, files, splitters, prog, outq,
              shared, snapshots, compaction.bottommost, frags, max_dev_key,
              *extra),
    )
    for t in rthreads:
        t.start()
    cthread.start()

    def chunk_stream():
        chunk = 0
        t_resumed = None  # when the writer got control back after a yield
        while True:
            t0 = time.time()
            if t_resumed is not None:
                # The time since the previous chunk was handed over is that
                # chunk's encode + write.
                telemetry.span_event_under(
                    shared.trace, "pipeline.encode_write",
                    (t0 - t_resumed) * 1e6, chunk=chunk)
                chunk += 1
            item = outq.get()
            stats.pipeline_stall_usec += int((time.time() - t0) * 1e6)
            if item is _DONE:
                return
            if isinstance(item, _Err):
                raise item.exc
            t_resumed = time.time()
            yield item

    t_wr = time.time()
    try:
        out_files = writer(
            env, dbname, new_file_number, icmp, table_options, kv,
            chunk_stream(), shared.trailer_override, shared.vtypes,
            shared.seqs,
            creation_time if creation_time is not None else int(time.time()),
            max_output_file_size=compaction.max_output_file_size,
            column_family=column_family, tombstones=tombs,
        )
    except BaseException:
        prog.abort()
        _drain_join(outq, [cthread] + rthreads)
        raise
    stats.encode_write_usec = max(0, int(
        (time.time() - t_wr) * 1e6) - stats.pipeline_stall_usec)
    for t in rthreads:
        t.join()
    cthread.join()
    if prog.err is not None:
        raise prog.err
    stats.input_scan_usec = int(
        ((prog.scan_end or time.time()) - t_scan0) * 1e6)
    return out_files, kv, shared.vtypes


def _compute_guard(prog, outq, fn, *args):
    """Run the compute stage; any failure stops every stage and reaches
    the writer through the queue."""
    try:
        fn(*args)
    except BaseException as e:  # noqa: BLE001 - forwarded via the queue
        prog.fail(e)
        try:
            outq.put_nowait(_Err(e))
        except Full:
            # Queue full: make room so the writer sees the error next (it
            # also observes prog.err after draining).
            try:
                outq.get_nowait()
                outq.put_nowait(_Err(e))
            except (Empty, Full):
                pass


def _drain_join(outq: Queue, threads) -> None:
    """Unblock producers stuck on the bounded queue, then join."""
    deadline = time.time() + 10.0
    while any(t.is_alive() for t in threads) and time.time() < deadline:
        try:
            outq.get(timeout=0.05)
        except Empty:
            pass
    for t in threads:
        t.join(timeout=1.0)
