"""Device compaction data plane: host orchestration (the counterpart of
toplingdb_tpu/ops/device_compaction.py).

One compaction job, from input SSTs to output SSTs, by one of three routes:
  - the pipelined plane (the default, `pipeline=True`; ops/pipeline.py):
    per-file scan threads, a compute thread that uploads and runs one
    key-range shard's device program while the next shard uploads, and the
    native SST writer streaming each shard's survivors, all overlapped. Jobs
    it does not cover (fewer than MIN_PIPELINE_ROWS rows, non-uniform key
    lengths, `device_blocks=True`) fall through to the serial route with
    clean stats;
  - the serial route: a native whole-file scan of every input into columnar
    buffers, the range tombstones of every input into a per-row max covering
    tombstone seqno (stripe-clamped on the host; fragments are few), then
    - uniform-length keys: the input runs cut into user-key-range shards of
      about 1M rows, and per shard one device program
      (ops/compaction_kernels.py) - merge of the presorted runs, MVCC GC,
      survivor compaction, packed download - whose survivors stream into
      the native SST writer; or, with `device_blocks=True` and a
      single-shard job that `block_assembly.assembly_supported` accepts,
      the device builds the finished data-block payloads and the host only
      frames them;
    - variable-length keys (dense buffers): one whole-job device program
      (`fused_encode_sort_gc`: encode, full sort, MVCC GC, compaction) and
      the survivor order written in one pass.
Output files are byte-identical to the reference's for the same job.

`run_device_compaction(..., device_name="cuda")` runs the device programs
on the card and raises when there is none; `device_name="cpu"` runs the
plain versions of the kernels. Jobs this slice of the port does not cover
raise NotSupported naming what is missing; nothing is routed elsewhere.
"""

from __future__ import annotations

import sys
import time
import types

import numpy as np
import torch

from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.compaction.compaction_job import (
    CompactionStats,
    surviving_tombstone_fragments,
)
from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.range_del import (
    RangeDelAggregator,
    RangeTombstone,
)
from toplingdb_tpu_torch.ops import block_assembly as ba
from toplingdb_tpu_torch.ops import compaction_kernels as ck
from toplingdb_tpu_torch.table.builder import unsupported_options
from toplingdb_tpu_torch.utils.status import NotSupported

# Longest user key the device path accepts (one sort operand per 4 bytes).
MAX_DEVICE_KEY_BYTES = 128

# Below this row count a job runs as one shard.
_SHARD_MIN_ROWS = 1 << 18
# Target rows per shard (a power-of-two shard count, up to 16).
_SHARD_ROWS = 1 << 20


def _kv_seq_vtype(kv):
    """Trailer columns (packed, seq, vtype) from flat buffers."""
    n = kv.n
    offs = kv.key_offs.astype(np.int64)
    lens = kv.key_lens.astype(np.int64)
    if n and kv.key_lens.min() == kv.key_lens.max() and len(
            kv.key_buf) == n * int(lens[0]) and int(offs[0]) == 0 and int(
            offs[-1]) == (n - 1) * int(lens[0]) and np.array_equal(
            np.diff(offs), lens[:-1]):
        # Uniform key length over a dense buffer: the trailers are a strided
        # view — no [n, 8] gather.
        trailer = np.ascontiguousarray(
            kv.key_buf.reshape(n, int(lens[0]))[:, -8:])
    else:
        tr_idx = (offs + lens - 8)[:, None] + np.arange(8)[None, :]
        trailer = np.ascontiguousarray(kv.key_buf[tr_idx])
    packed = trailer.view(np.uint64).reshape(n)
    if sys.byteorder == "big":  # trailer bytes on disk are LE
        packed = packed.byteswap()
    return types.SimpleNamespace(
        packed=packed,
        seq=packed >> np.uint64(8),
        vtype=(packed & np.uint64(0xFF)).astype(np.int32),
        n=n,
    )


def _part_user_key(part, i: int) -> bytes:
    o = int(part.key_offs[i])
    return part.key_buf[o: o + int(part.key_lens[i]) - 8].tobytes()


def _shard_splitters(part, n_shards: int) -> list[bytes]:
    """Evenly spaced user keys from one sorted part (deduped, ascending)."""
    spl = []
    for s in range(1, n_shards):
        spl.append(_part_user_key(part, part.n * s // n_shards))
    return sorted(set(spl))


def _part_bounds(part, splitters: list[bytes]) -> list[int]:
    """Row bounds [0, b1, ..., n] for one sorted part: b_s = first row whose
    user key >= splitters[s-1] (all copies of a user key land in ONE
    shard)."""
    b = [0]
    for spl in splitters:
        b.append(_part_lower_bound(part, spl, b[-1]))
    b.append(part.n)
    return b


def _part_lower_bound(part, key: bytes, lo: int = 0) -> int:
    """First row of the (sorted) part whose user key >= key."""
    hi = part.n
    while lo < hi:
        mid = (lo + hi) // 2
        if _part_user_key(part, mid) < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _device_shards(total_rows: int, num_shards: int | None = None) -> int:
    """Range-shard count: `num_shards` when given; otherwise shards of
    about _SHARD_ROWS rows, a power of two (so per-shard padded shapes
    repeat), at most 16."""
    if num_shards is not None:
        return max(1, int(num_shards))
    s = 1
    while s < 16 and total_rows // s > _SHARD_ROWS:
        s *= 2
    return s


def _collect_raw_columnar(compaction, table_cache, icmp, num_shards=None):
    """Scan every input file into columnar buffers and its range tombstones
    into an aggregator, split the sorted parts into user-key-range shards
    and prepare each shard's uniform chunk columns on the host. Returns
    (kv, rd, shards, parts); shards is None when the uniform shard path
    does not apply."""
    from toplingdb_tpu_torch.ops.columnar_io import (
        ColumnarKV,
        scan_table_columnar,
        scan_tables_columnar_prealloc,
    )

    readers = [
        table_cache.get_reader(f.number) for _, f in compaction.all_inputs()
    ]
    pre = scan_tables_columnar_prealloc(readers)
    if pre is not None:
        kv, parts = pre
    else:
        parts = [scan_table_columnar(r) for r in readers]
        kv = ColumnarKV.concat(parts)
    rd = RangeDelAggregator(icmp.user_comparator)
    for r in readers:
        for b, e in r.range_del_entries():
            rd.add(RangeTombstone.from_table_entry(b, e))
    return kv, rd, _prepare_uniform_shards(parts, num_shards), parts


def _cover_for_parts(parts, rd: RangeDelAggregator, snapshots):
    """Per-ORIGINAL-row (concat order) max covering tombstone seqno,
    clamped to the row's snapshot stripe: a tombstone counts only when it
    is newer than the row and not newer than the first snapshot at or
    above the row's seqno. Computed per sorted input part with interval
    binary searches (fragments are few, rows are many). Returns
    uint64[sum(part.n)] or None when there are no tombstones."""
    frags = rd.fragments()
    if not frags:
        return None
    snaps = np.asarray(sorted(snapshots), dtype=np.uint64)
    covers = []
    for part in parts:
        n = part.n
        cov = np.zeros(n, dtype=np.uint64)
        if n:
            seqs = _kv_seq_vtype(part).seq
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
                lo = _part_lower_bound(part, frag.begin)
                hi = _part_lower_bound(part, frag.end, lo)
                if lo < hi:
                    t = np.uint64(frag.seq)
                    sl = slice(lo, hi)
                    elig = ((t > seqs[sl]) & (t <= upper[sl])
                            & (t > cov[sl]))
                    cov[sl] = np.where(elig, t, cov[sl])
        covers.append(cov)
    return np.concatenate(covers) if covers else None


def _prepare_uniform_shards(parts, num_shards=None):
    """Host half of the sharded uniform device path: validate density and
    uniform key length, pick range splitters, slice every part into
    per-shard chunks (`num_shards` of them when given, at or above
    _SHARD_MIN_ROWS rows). Returns the shards list or None when
    ineligible."""
    uniform_len = 0
    total_rows = 0
    for part in parts:
        if not part.n:
            continue
        L = int(part.key_lens[0])
        dense_uniform = (
            part.key_lens.min() == part.key_lens.max()
            and len(part.key_buf) == part.n * L
            and int(part.key_offs[0]) == 0
            and np.array_equal(
                part.key_offs[1:],
                (np.cumsum(part.key_lens) - part.key_lens)[1:],
            )
        )
        if not dense_uniform:
            return None
        if uniform_len and L != uniform_len:
            return None
        uniform_len = L
        total_rows += part.n
    if not total_rows:
        return None

    splitters = None
    for part in parts:
        if part.n:
            n_shards = (_device_shards(total_rows, num_shards)
                        if total_rows >= _SHARD_MIN_ROWS else 1)
            splitters = _shard_splitters(part, n_shards)
            break
    shards = [([], []) for _ in range(len(splitters) + 1)]
    row_base = 0
    try:
        for part in parts:
            if not part.n:
                continue
            bounds = _part_bounds(part, splitters)
            for s in range(len(bounds) - 1):
                lo, hi = bounds[s], bounds[s + 1]
                if lo == hi:
                    continue
                blo = int(part.key_offs[lo])
                bhi = int(part.key_offs[hi - 1]) + int(part.key_lens[hi - 1])
                shards[s][0].append(ck.prepare_uniform_chunk(
                    part.key_buf[blo:bhi], hi - lo, uniform_len,
                ))
                shards[s][1].append((row_base + lo, row_base + hi))
            row_base += part.n
    except NotSupported:
        return None
    shards = [sh for sh in shards if sh[0]]
    for chunks, _ranges in shards:
        if sum(c[3] for c in chunks) > ck.MAX_SHARD_ROWS:
            return None  # skewed splitters blew the 24-bit row budget
    return shards or None


def _ranges_lmap(ranges) -> np.ndarray:
    """Local shard row -> global concat row map for a shard's chunk
    (global_lo, global_hi) spans."""
    if not ranges:
        return np.empty(0, np.int32)
    return np.concatenate([
        np.arange(lo, hi, dtype=np.int32) for lo, hi in ranges
    ])


def _outputs_from_files(env, files, stats):
    """Output FileMetaData list from write_tables_columnar tuples; empty
    outputs are deleted."""
    from toplingdb_tpu_torch.db.version_edit import FileMetaData

    outputs = []
    for fnum, path, props, smallest, largest, _sel in files:
        if props.num_entries == 0 and props.num_range_deletions == 0:
            env.delete_file(path)
            continue
        meta = FileMetaData(
            number=fnum, file_size=env.get_file_size(path),
            smallest=smallest, largest=largest,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno,
            num_entries=props.num_entries,
            num_deletions=props.num_deletions,
            num_range_deletions=props.num_range_deletions,
        )
        outputs.append(meta)
        stats.output_bytes += meta.file_size
        stats.output_files += 1
        stats.output_records += props.num_entries
    return outputs


def _dispatch_shards(shards, cover, snapshots, bottommost, device):
    """Serial shard dispatch: every shard is uploaded (with its rows'
    tombstone cover, when there is one) and its device program enqueued up
    front on one device (uploads and launches are asynchronous, so shard
    s+1's copies stream while shard s computes, and each result's download
    is enqueued behind its program). Returns finish(s), to be called for
    s = 0..n-1 in order."""
    pending = [
        ck.fused_uniform_shard_start(
            ck.upload_uniform_shard(
                chunks,
                None if cover is None else [cover[lo:hi]
                                            for lo, hi in ranges],
                device=device),
            snapshots, bottommost)
        for chunks, ranges in shards
    ]

    def finish(s):
        out = ck.fused_uniform_shard_finish(pending[s])
        pending[s] = None
        return out

    return finish


def resolve_device(device_name: str) -> torch.device:
    """"cuda" → the card, which must exist; "cpu" → the plain versions on
    the host. Nothing falls back."""
    device = torch.device(device_name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device_name={device_name!r}: no CUDA device is available "
                "(pass device_name='cpu' to run the plain versions)")
        return device
    if device.type == "cpu":
        return device
    raise NotSupported(f"device {device_name!r}: use 'cuda' or 'cpu'")


def _run_device_compaction_columnar(env, dbname, icmp, compaction,
                                    table_cache, table_options, snapshots,
                                    new_file_number, creation_time, device,
                                    column_family=(0, "default"),
                                    device_blocks=False, num_shards=None,
                                    pipeline=True, pipeline_shards=None):
    from toplingdb_tpu_torch.ops import pipeline as pl
    from toplingdb_tpu_torch.ops.columnar_io import write_tables_columnar

    t0 = time.time()
    stats = CompactionStats(device=str(device))
    stats.input_bytes = compaction.total_input_bytes()
    stats.input_files = len(compaction.all_inputs())
    # Pipelined data plane first (on-device block assembly has its own data
    # plane): scan, device programs and encode overlap at key-range-shard
    # granularity, byte-identical outputs. Shapes it does not cover fall
    # through to the serial route below with clean stats.
    if pipeline and not device_blocks:
        pstats = CompactionStats(device=str(device))
        pstats.input_bytes = stats.input_bytes
        pstats.input_files = stats.input_files
        try:
            pfiles = pl.run_pipelined(
                env, dbname, icmp, compaction, table_cache, table_options,
                snapshots, new_file_number, creation_time, pstats,
                MAX_DEVICE_KEY_BYTES, column_family, device=device,
                n_shards=pipeline_shards,
            )
        except (pl.PipelineIneligible, NotSupported):
            pass  # the serial route decides (and raises what it must)
        else:
            outputs = _outputs_from_files(env, pfiles, pstats)
            pstats.work_time_usec = int((time.time() - t0) * 1e6)
            return outputs, pstats
    kv, rd, shards, parts = _collect_raw_columnar(
        compaction, table_cache, icmp, num_shards)
    stats.input_scan_usec = int((time.time() - t0) * 1e6)
    stats.input_records = kv.n
    if kv.n == 0 and rd.empty():
        stats.work_time_usec = int((time.time() - t0) * 1e6)
        return [], stats
    if kv.n and int(kv.key_lens.max()) - 8 > MAX_DEVICE_KEY_BYTES:
        raise NotSupported(
            f"user keys over {MAX_DEVICE_KEY_BYTES}B are not supported by "
            "the device path")
    t_fin = time.time()
    col = _kv_seq_vtype(kv)
    _VT = dbformat.ValueType
    if np.any((col.vtype == int(_VT.MERGE))
              | (col.vtype == int(_VT.SINGLE_DELETION))):
        raise NotSupported(
            "MERGE / SINGLE_DELETION groups (the host resolve through "
            "CompactionIterator) are not ported yet")
    if np.any(col.vtype == int(_VT.BLOB_INDEX)):
        raise NotSupported("blob values are not ported yet")
    if len(snapshots) > ck.MAX_SNAPSHOTS:
        raise NotSupported(
            f"device GC supports <= {ck.MAX_SNAPSHOTS} live snapshots")
    tombs = surviving_tombstone_fragments(
        rd, snapshots, compaction.bottommost, icmp.user_comparator)
    stats.finish_usec += int((time.time() - t_fin) * 1e6)
    if creation_time is None:
        creation_time = int(time.time())
    # Range tombstones ride the device programs as a per-row max covering
    # seqno side input.
    t_cov = time.time()
    cover = None if rd.empty() else _cover_for_parts(parts, rd, snapshots)
    stats.host_compute_usec += int((time.time() - t_cov) * 1e6)

    if ba.assembly_supported(device_blocks, table_options, kv, shards,
                             False, compaction.max_output_file_size,
                             col.vtype):
        files = ba.run_block_assembly(
            env, dbname, icmp, kv, shards[0], cover, snapshots,
            compaction.bottommost, table_options, new_file_number,
            creation_time, tombs, device, column_family, stats=stats)
        outputs = _outputs_from_files(env, files, stats)
        stats.work_time_usec = int((time.time() - t0) * 1e6)
        return outputs, stats

    trailer_override = np.full(kv.n, -1, dtype=np.int64)
    seqs = col.seq.copy()

    def _shard_order_chunks(finish_shard):
        # Each chunk's trailers/seqs land just before the writer consumes
        # it (the writer reads both arrays per native call).
        for s_i, (_chunks, ranges) in enumerate(shards):
            t_dn = time.time()
            o, z, _cx, hc = finish_shard(s_i)
            stats.device_wait_usec += int((time.time() - t_dn) * 1e6)
            if hc:
                raise NotSupported("complex groups reached the device path")
            order_s = _ranges_lmap(ranges)[o]
            zero_s = order_s[z]
            trailer_override[zero_s] = col.vtype[zero_s].astype(np.int64)
            seqs[zero_s] = 0
            yield order_s

    if kv.n and shards is None:
        # Variable-length keys (or shards the uniform path refused): one
        # whole-job program over the raw key bytes; raises NotSupported
        # when the key buffer is not densely packed.
        t_up = time.time()
        pending = ck.fused_encode_sort_gc_start(
            kv.key_buf, kv.key_offs, kv.key_lens,
            max(4, int(kv.key_lens.max()) - 8), snapshots,
            compaction.bottommost, cover, device=device)
        t_dn = time.time()
        stats.transfer_time_usec += int((t_dn - t_up) * 1e6)
        order, zero_flags, _cx, has_complex = ck.fused_encode_sort_gc_finish(
            pending)
        stats.device_wait_usec += int((time.time() - t_dn) * 1e6)
        if has_complex:
            raise NotSupported("complex groups reached the device path")
        t_fin = time.time()
        zero_orig = order[zero_flags]
        trailer_override[zero_orig] = col.vtype[zero_orig].astype(np.int64)
        seqs[zero_orig] = 0
        order_feed = order
        stats.finish_usec += int((time.time() - t_fin) * 1e6)
        if not len(order) and not tombs:
            stats.work_time_usec = int((time.time() - t0) * 1e6)
            return [], stats
    elif kv.n:
        t_up = time.time()
        order_feed = _shard_order_chunks(_dispatch_shards(
            shards, cover, snapshots, compaction.bottommost, device))
        stats.transfer_time_usec += int((time.time() - t_up) * 1e6)
    elif tombs:
        order_feed = np.empty(0, dtype=np.int32)  # tombstones only
    else:
        stats.work_time_usec = int((time.time() - t0) * 1e6)
        return [], stats
    t_wr = time.time()
    files = write_tables_columnar(
        env, dbname, new_file_number, icmp, table_options, kv, order_feed,
        trailer_override, col.vtype, seqs, creation_time,
        max_output_file_size=compaction.max_output_file_size,
        column_family=column_family, tombstones=tombs,
    )
    outputs = _outputs_from_files(env, files, stats)
    stats.encode_write_usec = int((time.time() - t_wr) * 1e6)
    stats.work_time_usec = int((time.time() - t0) * 1e6)
    return outputs, stats


def run_device_compaction(env, dbname, icmp, compaction, table_cache,
                          table_options, snapshots, merge_operator=None,
                          compaction_filter=None, new_file_number=None,
                          creation_time=None, device_name="cuda",
                          blob_resolver=None, blob_gc=None,
                          column_family=(0, "default"), device_blocks=False,
                          num_shards=None, pipeline=True,
                          pipeline_shards=None):
    """Run one compaction job through the device data plane; the same
    signature as the reference's run_device_compaction and byte-identical
    outputs (including output cutting). Returns (outputs, stats).

    device_name: "cuda" (default; raises when no card is present) or "cpu"
    (the plain versions of the kernels). pipeline: try the pipelined plane
    first (the reference's default, TPULSM_PIPELINE=1); jobs it does not
    cover take the serial route. pipeline_shards: the pipeline's key-range
    shard count (the reference's TPULSM_PIPELINE_SHARDS; None sizes shards
    to about 2^19 rows). device_blocks: take the on-device block-assembly
    route where its gate admits the job (the reference's
    TPULSM_DEVICE_BLOCKS=1, which also turns the pipeline off); other jobs
    take the packed-download route. num_shards: the serial route's
    key-range shard count for jobs of at least _SHARD_MIN_ROWS rows (the
    reference's TPULSM_DEVICE_SHARDS; None sizes shards to about _SHARD_ROWS
    rows). Raises NotSupported for what this slice of the port does not
    cover: compaction filters, blob GC, non-bytewise comparators, table
    options other than uncompressed block-based tables with a binary index,
    MERGE / SINGLE_DELETION rows, blob values, variable-length keys in a
    sparse key buffer and more than 1024 snapshots. No output is left
    behind: the serial route raises before writing, and a pipelined attempt
    that gives up deletes what it wrote."""
    device = resolve_device(device_name)
    del merge_operator, blob_resolver  # used only by complex groups
    if native.lib() is None:
        raise NotSupported("the native host library could not be built")
    if compaction_filter is not None:
        raise NotSupported("compaction filters are not ported yet")
    if blob_gc is not None and getattr(blob_gc, "active", True):
        raise NotSupported("blob GC is not ported yet")
    if icmp.user_comparator.name() != dbformat.BYTEWISE.name():
        raise NotSupported(
            "device compaction requires the bytewise comparator, got "
            f"{icmp.user_comparator.name()!r}")
    bad = unsupported_options(table_options)
    if bad:
        raise NotSupported("table options not ported yet: " + ", ".join(bad))
    return _run_device_compaction_columnar(
        env, dbname, icmp, compaction, table_cache, table_options,
        snapshots, new_file_number, creation_time, device, column_family,
        device_blocks=device_blocks, num_shards=num_shards,
        pipeline=pipeline, pipeline_shards=pipeline_shards,
    )
