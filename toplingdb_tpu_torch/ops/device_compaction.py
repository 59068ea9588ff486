"""Device compaction data plane: host orchestration (the counterpart of
toplingdb_tpu/ops/device_compaction.py).

One compaction job, from input SSTs to output SSTs, by one of two routes:

- the columnar route, for jobs without a compaction filter, active blob
  GC or property collectors whose outputs are block-based tables with a
  binary index or zip tables. It tries the pipelined plane first
  (`pipeline=True`, the default; ops/pipeline.py): per-file scan
  threads, a compute thread that uploads and runs one key-range shard's
  device program while the next shard uploads, and the native SST writer
  streaming each shard's survivors.
  Jobs it does not cover (fewer than MIN_PIPELINE_ROWS rows, non-uniform
  key lengths, MERGE / SINGLE_DELETION groups, `device_blocks=True`) fall
  through to the serial route with clean stats: a native whole-file scan
  into columnar buffers, the range tombstones into a per-row max covering
  tombstone seqno, then
    - uniform-length keys: the runs cut into user-key-range shards, one
      device program per shard (ops/compaction_kernels.py: merge of the
      presorted runs, MVCC GC, survivor compaction, packed download); with
      `device_blocks=True` and a single-shard job that
      `block_assembly.assembly_supported` accepts, the device builds the
      finished data-block payloads;
    - variable-length keys in a dense buffer: one whole-job device program
      (`fused_encode_sort_gc`).
  The survivors go to the native block writer (`write_tables_columnar`)
  or, for zip outputs, to `write_tables_zip_columnar` (the native zip
  plane unless `zip_plane=False`).
  The device flags the user-key groups holding MERGE or SINGLE_DELETION
  rows; every shard is then collected before the writer, and those groups
  fold on the host through CompactionIterator._process_group
  (`_resolve_complex_stream`), their results patched into the columns the
  writer reads;
- the per-entry route, for compaction filters, active blob GC, property
  collectors, two-level indexes, the single_fast, plain and cuckoo
  formats and a timestamp DB's jobs (with the history trim over the
  survivor stream), and for the jobs the columnar route hands over
  (`_FallbackToEntries`: inputs that are not block-based tables, keys over
  MAX_DEVICE_KEY_BYTES, a sparse key buffer, a value buffer past its int32
  budget, a fold the columns cannot hold, a writer that refuses the job —
  the zip writer refuses non-uniform keys, prefix extractors and
  collectors): every entry read in Python (`collect_raw_entries`), sorted
  and GC-masked on the same device (`device_gc_entries`: `device_sort`,
  `gc_mask`, whose core is the `gc_rows` kernel), complex groups and the
  filter applied on the host, blob GC rewriting the stream, and the
  per-entry table builder (`build_outputs`).

With `protection_bytes_per_key` set, every output is re-read and each
entry checked against the entries meant for it (`verify_output_table`) on
every route. Output files, and blob files where GC writes one, are
byte-identical to the reference's for the same job. `device_name="cuda"`
runs the device programs on the card and raises when there is none;
`device_name="cpu"` runs the plain versions of the kernels. A kernel or
CUDA failure on either route reaches the caller; only NotSupported inside
the columnar route sends a job to the per-entry route, as in the
reference.
"""

from __future__ import annotations

import bisect
import functools
import sys
import time
import types

import numpy as np
import torch

from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.compaction.compaction_iterator import (
    CompactionIterator,
    trim_history,
)
from toplingdb_tpu_torch.compaction.compaction_job import (
    CompactionStats,
    build_outputs,
    surviving_tombstone_fragments,
    verify_output_table,
)
from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.blob import decode_blob_index
from toplingdb_tpu_torch.db.range_del import (
    RangeDelAggregator,
    RangeTombstone,
)
from toplingdb_tpu_torch.ops import block_assembly as ba
from toplingdb_tpu_torch.ops import compaction_kernels as ck
from toplingdb_tpu_torch.ops.columnar import ColumnarEntries
from toplingdb_tpu_torch.utils import protection, telemetry
from toplingdb_tpu_torch.utils.compaction_filter import Decision
from toplingdb_tpu_torch.utils.status import NotSupported

# Longest user key the device routes accept (one sort operand per 4 bytes).
# On a timestamp DB it counts the STORED key: the plain key with each 0x00
# byte escaped to two bytes, the 2-byte terminator and the 8-byte timestamp
# suffix, so a plain key without zero bytes may hold up to 118 bytes.
MAX_DEVICE_KEY_BYTES = 128

# The comparators whose stored-byte order the device sort realizes: plain
# bytewise, and bytewise with a u64 timestamp, whose order (key asc, ts
# desc) is baked into the stored bytes (dbformat.encode_ts_key).
_DEVICE_COMPARATORS = (dbformat.BYTEWISE.name(),
                       dbformat.U64_TS_BYTEWISE.name())

# Below this row count a job runs as one shard.
_SHARD_MIN_ROWS = 1 << 18
# Target rows per shard (a power-of-two shard count, up to 16).
_SHARD_ROWS = 1 << 20


# ---------------------------------------------------------------------------
# The per-entry route
# ---------------------------------------------------------------------------


def collect_raw_entries(compaction, table_cache, icmp, stats=None):
    """Sequentially read every input file's entries (no host merge: the
    device sort is the merge). Returns (entries list, RangeDelAggregator);
    `stats` (CompactionStats) accumulates the scan's readahead counters."""
    entries: list[tuple[bytes, bytes]] = []
    rd = RangeDelAggregator(icmp.user_comparator)
    for _, f in compaction.all_inputs():
        r = table_cache.get_reader(f.number)
        it = r.new_iterator()
        it.seek_to_first()
        entries.extend(it.entries())
        if stats is not None and hasattr(it, "prefetch_counts"):
            # Block-based tables read through a readahead buffer; the
            # in-memory formats have none.
            h, m = it.prefetch_counts()
            stats.prefetch_hits += h
            stats.prefetch_misses += m
        for b, e in r.range_del_entries():
            rd.add(RangeTombstone.from_table_entry(b, e))
    return entries, rd


def _tombstone_cover(sorted_user_keys: list[bytes], rd: RangeDelAggregator,
                     sorted_seqs, snapshots) -> np.ndarray | None:
    """Per-sorted-entry max covering tombstone seqno (uint64), clamped to
    each entry's snapshot stripe: a tombstone above the next snapshot must
    not mask an in-stripe one. Interval mapping on the host (fragments are
    few, entries many)."""
    if rd.empty():
        return None
    n = len(sorted_user_keys)
    cover = np.zeros(n, dtype=np.uint64)
    seqs = np.asarray(sorted_seqs, dtype=np.uint64)
    snaps = np.asarray(sorted(snapshots), dtype=np.uint64)
    if len(snaps):
        idx = np.searchsorted(snaps, seqs, side="left")
        upper = np.where(
            idx < len(snaps), snaps[np.minimum(idx, len(snaps) - 1)],
            np.uint64(dbformat.MAX_SEQUENCE_NUMBER),
        )
    else:
        upper = np.full(n, dbformat.MAX_SEQUENCE_NUMBER, dtype=np.uint64)
    for frag in rd.fragments():
        lo = bisect.bisect_left(sorted_user_keys, frag.begin)
        hi = bisect.bisect_left(sorted_user_keys, frag.end)
        if lo < hi:
            t = np.uint64(frag.seq)
            sl = slice(lo, hi)
            elig = (t > seqs[sl]) & (t <= upper[sl]) & (t > cover[sl])
            cover[sl] = np.where(elig, t, cover[sl])
    return cover


def device_gc_entries(entries, icmp, snapshots, bottommost,
                      merge_operator=None, compaction_filter=None,
                      compaction_filter_level=0, rd=None,
                      max_key_bytes=None, blob_resolver=None,
                      device_name="cuda", full_history_ts_low=0):
    """Run the device data plane over raw (unsorted) entries on
    `device_name`; yields the surviving (internal_key, value) stream,
    identical to CompactionIterator(..., full_history_ts_low=).entries()
    over the merged sorted input. The sort and the GC mask run on the
    device; complex groups, the compaction filter and a timestamp DB's
    history trim are applied on the host. Raises NotSupported for user keys
    over MAX_DEVICE_KEY_BYTES, a comparator other than bytewise or bytewise
    with a u64 timestamp, and more than MAX_SNAPSHOTS snapshots."""
    stream = _device_gc_stream(
        entries, icmp, snapshots, bottommost, merge_operator,
        compaction_filter, compaction_filter_level, rd, max_key_bytes,
        blob_resolver, device_name)
    ts_sz = icmp.user_comparator.timestamp_size
    if ts_sz and full_history_ts_low:
        earliest = min(snapshots) if snapshots \
            else dbformat.MAX_SEQUENCE_NUMBER
        stream = trim_history(stream, full_history_ts_low, earliest,
                              bottommost, ts_sz)
    yield from stream


def _check_device_comparator(icmp) -> None:
    name = icmp.user_comparator.name()
    if name not in _DEVICE_COMPARATORS:
        # The device sort realizes bytewise order of the stored keys (the
        # u64-timestamp comparator's order is bytewise there); the message
        # is the reference's.
        raise NotSupported(
            f"device compaction requires the bytewise comparator, "
            f"got {name!r}")


def _device_gc_stream(entries, icmp, snapshots, bottommost, merge_operator,
                      compaction_filter, compaction_filter_level, rd,
                      max_key_bytes, blob_resolver, device_name):
    if not entries:
        return
    ts_sz = icmp.user_comparator.timestamp_size
    if max_key_bytes is None:
        longest = max(len(k) for k, _ in entries) - 8
        if longest > MAX_DEVICE_KEY_BYTES:
            what = ("stored keys (escaped key + terminator + timestamp)"
                    if ts_sz else "user keys")
            raise NotSupported(
                f"{what} up to {longest}B exceed the device key budget "
                f"({MAX_DEVICE_KEY_BYTES}B)")
    _check_device_comparator(icmp)
    device = resolve_device(device_name)
    col = ColumnarEntries.from_entries(entries, max_key_bytes)
    sorted_cols, perm = ck.device_sort(ck.pad_columns(col), device)
    cover = None
    if rd is not None:
        sorted_uks = [col.user_key(i) for i in perm]
        cover = _tombstone_cover(sorted_uks, rd, col.seq[perm], snapshots)
    # A timestamp DB's group is one version of a key: its bottommost
    # tombstone still shadows the older versions, so it stays (as in
    # CompactionIterator).
    keep, zero_seq, host_resolve, group_id = ck.gc_mask(
        sorted_cols, snapshots, cover, bottommost,
        keep_tombstones=bool(ts_sz))
    del sorted_cols

    # Host-side finishing: complex groups through the reference state
    # machine; simple survivors filtered / zeroed to match it exactly.
    helper = CompactionIterator(
        _EmptyIter(), icmp, snapshots, bottommost_level=bottommost,
        merge_operator=merge_operator, compaction_filter=compaction_filter,
        compaction_filter_level=compaction_filter_level, range_del_agg=rd,
        blob_resolver=blob_resolver,
    )
    earliest = min(snapshots) if snapshots else dbformat.MAX_SEQUENCE_NUMBER
    n = col.n
    values = col.values
    ikeys = col.ikeys
    fast = compaction_filter is None  # emit the original key bytes
    i = 0
    while i < n:
        if host_resolve[i]:
            g = group_id[i]
            j = i
            group = []
            while j < n and group_id[j] == g:
                oi = perm[j]
                group.append((int(col.seq[oi]), int(col.vtype[oi]),
                              values[oi]))
                j += 1
            yield from helper._process_group(col.user_key(perm[i]), group)
            i = j
            continue
        if keep[i]:
            oi = perm[i]
            if fast:
                if zero_seq[i]:
                    yield dbformat.make_internal_key(
                        ikeys[oi][:-8], 0, int(col.vtype[oi])), values[oi]
                else:
                    yield ikeys[oi], values[oi]
                i += 1
                continue
            seq, t = int(col.seq[oi]), int(col.vtype[oi])
            val = values[oi]
            uk = col.user_key(oi)
            if t == dbformat.ValueType.VALUE and seq <= earliest:
                d, newv = compaction_filter.filter(
                    compaction_filter_level, uk, val)
                if d == Decision.REMOVE:
                    i += 1
                    continue
                if d == Decision.CHANGE_VALUE:
                    val = newv if newv is not None else b""
            if zero_seq[i]:
                seq = 0
            yield dbformat.make_internal_key(uk, seq, t), val
        i += 1


class _EmptyIter:
    def valid(self):
        return False


class _FallbackToEntries(Exception):
    """Raised inside the columnar route when the job needs the per-entry
    route (the reference's routing; the per-entry route runs on the same
    device)."""


def _run_per_entry(env, dbname, icmp, compaction, table_cache,
                   table_options, snapshots, merge_operator,
                   compaction_filter, new_file_number, creation_time,
                   device_name, blob_resolver, blob_gc, column_family):
    """The per-entry route: read every entry, device_gc_entries (with a
    timestamp DB's history trim at compaction.full_history_ts_low), blob
    GC, build_outputs. A failure deletes every output and the half-written
    blob file before it propagates."""
    t0 = time.time()
    stats = CompactionStats(device=str(device_name))
    stats.input_bytes = compaction.total_input_bytes()
    stats.input_files = len(compaction.all_inputs())
    entries, rd = collect_raw_entries(compaction, table_cache, icmp, stats)
    stats.input_records = len(entries)
    stats.input_scan_usec = int((time.time() - t0) * 1e6)
    stream = device_gc_entries(
        entries, icmp, snapshots, compaction.bottommost,
        merge_operator=merge_operator, compaction_filter=compaction_filter,
        compaction_filter_level=compaction.output_level,
        rd=None if rd.empty() else rd, blob_resolver=blob_resolver,
        device_name=device_name,
        full_history_ts_low=getattr(compaction, "full_history_ts_low", 0),
    )
    tombs = surviving_tombstone_fragments(
        rd, snapshots, compaction.bottommost, icmp.user_comparator)
    if blob_gc is not None and blob_gc.active:
        stream = blob_gc.rewrite(stream)
    t_wr = time.time()
    try:
        outputs = build_outputs(
            env, dbname, icmp, compaction, stream, tombs, new_file_number,
            table_options, stats,
            creation_time if creation_time is not None else int(time.time()),
            column_family=column_family,
        )
    except BaseException:
        if blob_gc is not None:
            blob_gc.abort()
        raise
    if blob_gc is not None:
        blob_gc.finish()
    # The stream's device work and host fold run inside the writer's loop.
    stats.encode_write_usec = int((time.time() - t_wr) * 1e6)
    stats.work_time_usec = int((time.time() - t0) * 1e6)
    return outputs, stats


# ---------------------------------------------------------------------------
# The columnar route
# ---------------------------------------------------------------------------


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


def _collect_raw_columnar(compaction, table_cache, icmp, num_shards=None,
                          want_uploads=True):
    """Scan every input file into columnar buffers and its range tombstones
    into an aggregator, split the sorted parts into user-key-range shards
    and prepare each shard's uniform chunk columns on the host. Returns
    (kv, rd, shards, parts); shards is None when the uniform shard path
    does not apply, or with want_uploads=False (the host twins)."""
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
    shards = (_prepare_uniform_shards(parts, num_shards) if want_uploads
              else None)
    return kv, rd, shards, parts


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


def _kv_user_key(kv, r: int) -> bytes:
    o = int(kv.key_offs[r])
    return kv.key_buf[o: o + int(kv.key_lens[r]) - 8].tobytes()


def _patch_kv_values(kv, rows: list[int], vals: list[bytes]) -> None:
    """Append replacement values (folded merge results) to kv's value
    buffer and repoint the rows at them; the columnar writer then emits
    them as it emits any value."""
    side = b"".join(vals)
    base = len(kv.val_buf)
    if base + len(side) > 2 ** 31 - 8:
        raise _FallbackToEntries()  # int32 offset budget
    kv.val_buf = np.concatenate([
        kv.val_buf, np.frombuffer(side, dtype=np.uint8)
    ])
    if not kv.val_offs.flags.writeable:
        kv.val_offs = kv.val_offs.copy()
    if not kv.val_lens.flags.writeable:
        kv.val_lens = kv.val_lens.copy()
    off = base
    for r, v in zip(rows, vals):
        kv.val_offs[r] = off
        kv.val_lens[r] = len(v)
        off += len(v)


def _resolve_complex_stream(kv, order, cx_flags, trailer_override, seqs,
                            vtypes, helper):
    """Fold the complex (MERGE / SINGLE_DELETION) user-key groups the
    device flagged in the survivor stream through the reference state
    machine (CompactionIterator._process_group, RocksDB's
    MergeHelper::MergeUntil role) without leaving the columnar route: each
    group's emitted entries overwrite the group's leading rows (trailer /
    seq / vtype overrides, replacement values appended to kv's value
    buffer); surplus rows drop out of the order. Returns the filtered
    order; mutates trailer_override / seqs / vtypes and patches kv."""
    keep_mask = np.ones(len(order), dtype=bool)
    repl_rows: list[int] = []
    repl_vals: list[bytes] = []
    pos_list = np.flatnonzero(cx_flags)
    i = 0
    P = len(pos_list)
    while i < P:
        p0 = int(pos_list[i])
        uk = _kv_user_key(kv, int(order[p0]))
        j = i + 1
        while (j < P and int(pos_list[j]) == int(pos_list[j - 1]) + 1
               and _kv_user_key(kv, int(order[int(pos_list[j])])) == uk):
            j += 1
        rows = [int(order[int(pos_list[t])]) for t in range(i, j)]
        group = [(int(seqs[r]), int(vtypes[r]), kv.value(r)) for r in rows]
        emitted = list(helper._process_group(uk, group))
        if len(emitted) > len(rows):
            raise _FallbackToEntries()  # cannot happen; belt and braces
        for t, (ik, v) in enumerate(emitted):
            r = rows[t]
            if ik[:-8] != uk:
                raise _FallbackToEntries()
            packed = int.from_bytes(ik[-8:], "little")
            if packed >= 2 ** 63:
                raise _FallbackToEntries()  # int64 trailer budget
            trailer_override[r] = packed
            seqs[r] = packed >> 8
            vtypes[r] = packed & 0xFF
            if v != kv.value(r):
                repl_rows.append(r)
                repl_vals.append(v)
        for t in range(len(emitted), len(rows)):
            keep_mask[int(pos_list[i + t])] = False
        i = j
    if repl_rows:
        _patch_kv_values(kv, repl_rows, repl_vals)
    return order[keep_mask]


def _verify_columnar_output(env, icmp, table_options, path, kv, vtypes,
                            sel) -> None:
    """Per-entry protection check of one columnar output file: the entries
    on disk must be exactly the surviving input rows `sel` (values as the
    complex-group fold patched them; seqno zeroing does not enter the
    checksum)."""
    pb = table_options.protection_bytes_per_key
    expected: dict[int, int] = {}
    for r in sel.tolist():
        ik = kv.ikey(r)
        cs = protection.truncate(
            protection.protect_entry(int(vtypes[r]), ik[:-8], kv.value(r)),
            pb)
        expected[cs] = expected.get(cs, 0) + 1
    verify_output_table(env, path, icmp, table_options, expected, len(sel))


def _outputs_from_files(env, files, kv, vtypes, stats, icmp, table_options):
    """Output FileMetaData list from the columnar writers' tuples: empty
    outputs deleted, blob refs decoded from the surviving BLOB_INDEX rows.
    With protection on, every output is re-read and verified against its
    surviving rows first (_verify_columnar_output); a failure deletes every
    output of the job before it propagates."""
    from toplingdb_tpu_torch.db.version_edit import FileMetaData

    if table_options.protection_bytes_per_key:
        try:
            for _fnum, path, props, _s, _l, sel in files:
                if props.num_entries or props.num_range_deletions:
                    _verify_columnar_output(env, icmp, table_options, path,
                                            kv, vtypes, sel)
        except BaseException:
            for f in files:
                env.delete_file(f[1])
            raise
    outputs = []
    for fnum, path, props, smallest, largest, sel in files:
        if props.num_entries == 0 and props.num_range_deletions == 0:
            env.delete_file(path)
            continue
        blob_refs = set()
        bi_mask = vtypes[sel] == dbformat.ValueType.BLOB_INDEX
        if bi_mask.any():
            for oi in sel[bi_mask]:
                blob_refs.add(decode_blob_index(kv.value(oi))[0])
        meta = FileMetaData(
            number=fnum, file_size=env.get_file_size(path),
            smallest=smallest, largest=largest,
            smallest_seqno=props.smallest_seqno,
            largest_seqno=props.largest_seqno,
            num_entries=props.num_entries,
            num_deletions=props.num_deletions,
            num_range_deletions=props.num_range_deletions,
            blob_refs=sorted(blob_refs),
        )
        outputs.append(meta)
        stats.output_bytes += meta.file_size
        stats.output_files += 1
        stats.output_records += props.num_entries
    return outputs


def _dispatch_shards(shards, cover, snapshots, bottommost, device,
                     stats=None, any_complex=False, mesh_devices=None):
    """The serial route's shard dispatch, through the mesh seam
    (ops/mesh_compaction.dispatch_shards): without a mesh plan every shard
    is uploaded (with its rows' tombstone cover, when there is one) and its
    device program enqueued up front on `device` (uploads and launches are
    asynchronous, so shard s+1's copies stream while shard s computes, and
    each result's download is enqueued behind its program); with one
    (`mesh_devices`, an eligible job) the shards go round-robin over the
    plan's devices, double-buffered per device. Returns finish(s), to be
    called for s = 0..n-1 in order."""
    from toplingdb_tpu_torch.ops import mesh_compaction as mc

    finish, _mesh_on = mc.dispatch_shards(
        shards, cover, snapshots, bottommost, stats=stats,
        any_complex=any_complex, trace=telemetry.current_handle(),
        device=device, mesh_devices=mesh_devices)
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
                                    merge_operator, new_file_number,
                                    creation_time, device,
                                    column_family=(0, "default"),
                                    blob_resolver=None, device_blocks=False,
                                    num_shards=None, pipeline=True,
                                    pipeline_shards=None, zip_plane=True,
                                    host_sort=False, host_merge=True,
                                    mesh_devices=None):
    """The columnar route. Raises _FallbackToEntries where the reference
    hands the job to the per-entry route; partial outputs are gone by
    then. host_sort=True: the host twins order and GC the rows (pipelined
    per shard, or one whole-job call on the serial route)."""
    from toplingdb_tpu_torch.ops import pipeline as pl
    from toplingdb_tpu_torch.ops.columnar_io import write_tables_columnar
    from toplingdb_tpu_torch.table.zip_table import write_tables_zip_columnar

    t0 = time.time()
    stats = CompactionStats(device=str(device))
    stats.input_bytes = compaction.total_input_bytes()
    stats.input_files = len(compaction.all_inputs())
    # Pipelined data plane first (on-device block assembly has its own data
    # plane): scan, device programs and encode overlap at key-range-shard
    # granularity, byte-identical outputs. Shapes it does not cover fall
    # through to the serial route below with clean stats. Zip outputs ride
    # it on the native zip plane only.
    zip_out = table_options.format == "zip"
    if pipeline and not device_blocks and (zip_plane or not zip_out):
        pstats = CompactionStats(device=str(device))
        pstats.input_bytes = stats.input_bytes
        pstats.input_files = stats.input_files
        try:
            pfiles, pkv, pvt = pl.run_pipelined(
                env, dbname, icmp, compaction, table_cache, table_options,
                snapshots, new_file_number, creation_time, pstats,
                MAX_DEVICE_KEY_BYTES, column_family, device=device,
                n_shards=pipeline_shards, zip_plane=zip_plane,
                host_sort=host_sort, host_merge=host_merge,
                mesh_devices=mesh_devices,
            )
        except (pl.PipelineIneligible, NotSupported):
            pass  # the serial route decides (and raises what it must)
        else:
            outputs = _outputs_from_files(env, pfiles, pkv, pvt, pstats,
                                          icmp, table_options)
            pstats.work_time_usec = int((time.time() - t0) * 1e6)
            return outputs, pstats
    try:
        kv, rd, shards, parts = _collect_raw_columnar(
            compaction, table_cache, icmp, num_shards,
            want_uploads=not host_sort)
    except NotSupported:
        raise _FallbackToEntries()  # buffers over the int32 budget etc.
    stats.input_scan_usec = int((time.time() - t0) * 1e6)
    stats.input_records = kv.n
    if kv.n == 0 and rd.empty():
        stats.work_time_usec = int((time.time() - t0) * 1e6)
        return [], stats
    if kv.n and int(kv.key_lens.max()) - 8 > MAX_DEVICE_KEY_BYTES:
        raise _FallbackToEntries()  # the per-entry route refuses them too
    t_fin = time.time()
    col = any_complex = None
    if not host_sort:
        # The host twins return the trailer columns themselves.
        col = _kv_seq_vtype(kv)
        _VT = dbformat.ValueType
        any_complex = bool(kv.n) and bool(np.any(
            (col.vtype == int(_VT.MERGE))
            | (col.vtype == int(_VT.SINGLE_DELETION))))
    tombs = surviving_tombstone_fragments(
        rd, snapshots, compaction.bottommost, icmp.user_comparator)
    stats.finish_usec += int((time.time() - t_fin) * 1e6)
    if creation_time is None:
        creation_time = int(time.time())
    streamed = False
    order = zero_flags = cx_flags = None
    has_complex = False
    try:
        # Range tombstones ride the device programs as a per-row max
        # covering seqno side input.
        t_cov = time.time()
        cover = (None if rd.empty()
                 else _cover_for_parts(parts, rd, snapshots))
        stats.host_compute_usec += int((time.time() - t_cov) * 1e6)
        if not host_sort and ba.assembly_supported(
                device_blocks, table_options, kv, shards, any_complex,
                compaction.max_output_file_size, col.vtype):
            files = ba.run_block_assembly(
                env, dbname, icmp, kv, shards[0], cover, snapshots,
                compaction.bottommost, table_options, new_file_number,
                creation_time, tombs, device, column_family, stats=stats)
            outputs = _outputs_from_files(env, files, kv, col.vtype, stats,
                                          icmp, table_options)
            stats.work_time_usec = int((time.time() - t0) * 1e6)
            return outputs, stats
        if host_sort:
            # One whole-job call over the job's presorted input runs.
            t_hc = time.time()
            rs = np.cumsum([0] + [p_.n for p_ in parts], dtype=np.int64)
            mkb = max(4, int(kv.key_lens.max()) - 8) if kv.n else 4
            order, zero_flags, cx_flags, has_complex, seq_a, vt_a = \
                ck.host_fused_full(
                    kv.key_buf, kv.key_offs, kv.key_lens, mkb, snapshots,
                    compaction.bottommost, cover, run_starts=rs,
                    host_merge=host_merge)
            stats.host_compute_usec += int((time.time() - t_hc) * 1e6)
            col = types.SimpleNamespace(seq=seq_a, vtype=vt_a, n=kv.n)
        elif kv.n and shards is not None:
            t_up = time.time()
            finish_shard = _dispatch_shards(
                shards, cover, snapshots, compaction.bottommost, device,
                stats=stats, any_complex=any_complex,
                mesh_devices=mesh_devices)
            stats.transfer_time_usec += int((time.time() - t_up) * 1e6)
            if not any_complex:
                # Stream each shard's survivors straight into the writer.
                streamed = True
            else:
                # Complex groups must fold before the writer hoists its
                # value-buffer pointers, so every shard is collected first;
                # the shard programs still overlap each other.
                orders, zfs, cxs = [], [], []
                for s_i, (_chunks, ranges) in enumerate(shards):
                    t_dn = time.time()
                    o, z, cx, hc = finish_shard(s_i)
                    stats.device_wait_usec += int(
                        (time.time() - t_dn) * 1e6)
                    orders.append(_ranges_lmap(ranges)[o])
                    zfs.append(z)
                    cxs.append(cx)
                    has_complex = has_complex or hc
                order = np.concatenate(orders)
                zero_flags = np.concatenate(zfs)
                cx_flags = np.concatenate(cxs)
        elif kv.n:
            # Variable-length keys (or shards the uniform path refused):
            # one whole-job program over the raw key bytes; NotSupported
            # for a sparse key buffer.
            t_up = time.time()
            pending = ck.fused_encode_sort_gc_start(
                kv.key_buf, kv.key_offs, kv.key_lens,
                max(4, int(kv.key_lens.max()) - 8), snapshots,
                compaction.bottommost, cover, device=device)
            t_dn = time.time()
            stats.transfer_time_usec += int((t_dn - t_up) * 1e6)
            order, zero_flags, cx_flags, has_complex = \
                ck.fused_encode_sort_gc_finish(pending)
            stats.device_wait_usec += int((time.time() - t_dn) * 1e6)
        else:
            order = np.empty(0, dtype=np.int32)  # tombstones only
            zero_flags = cx_flags = np.empty(0, dtype=bool)
    except NotSupported:
        raise _FallbackToEntries()  # sparse buffers, > MAX_SNAPSHOTS etc.

    t_fin = time.time()
    trailer_override = np.full(kv.n, -1, dtype=np.int64)
    seqs = col.seq.copy()
    vtypes = col.vtype
    if not streamed:
        # The packed trailer of seq 0 is the type byte. Complex rows' zero
        # flags are provisional: _process_group decides them.
        zmask = zero_flags if not has_complex else (zero_flags & ~cx_flags)
        zero_orig = order[zmask]
        trailer_override[zero_orig] = col.vtype[zero_orig].astype(np.int64)
        seqs[zero_orig] = 0
        if has_complex:
            vtypes = vtypes.copy()
            helper = CompactionIterator(
                _EmptyIter(), icmp, snapshots,
                bottommost_level=compaction.bottommost,
                merge_operator=merge_operator,
                range_del_agg=None if rd.empty() else rd,
                blob_resolver=blob_resolver,
            )
            t_rs = time.time()
            order = _resolve_complex_stream(
                kv, order, cx_flags, trailer_override, seqs, vtypes, helper)
            stats.resolve_usec = int((time.time() - t_rs) * 1e6)
        order_feed = order
    else:
        def _shard_order_chunks():
            # Each chunk's trailers / seqs land just before the writer
            # consumes it (the writer reads both arrays per native call).
            for s_i, (_chunks, ranges) in enumerate(shards):
                t_dn = time.time()
                o, z, _cx, hc = finish_shard(s_i)
                stats.device_wait_usec += int((time.time() - t_dn) * 1e6)
                if hc:
                    raise _FallbackToEntries()
                order_s = _ranges_lmap(ranges)[o]
                zero_s = order_s[z]
                trailer_override[zero_s] = col.vtype[zero_s].astype(
                    np.int64)
                seqs[zero_s] = 0
                yield order_s

        order_feed = _shard_order_chunks()
    # finish = zero-seq patch and tombstones, minus the complex-group
    # resolve reported apart.
    stats.finish_usec += max(
        0, int((time.time() - t_fin) * 1e6) - stats.resolve_usec)
    outputs = []
    t_wr = time.time()
    if order is None or len(order) or tombs:
        writer = write_tables_columnar
        if zip_out:
            writer = functools.partial(write_tables_zip_columnar,
                                       zip_plane=zip_plane)
        try:
            files = writer(
                env, dbname, new_file_number, icmp, table_options, kv,
                order_feed, trailer_override, vtypes, seqs, creation_time,
                max_output_file_size=compaction.max_output_file_size,
                column_family=column_family, tombstones=tombs,
            )
        except NotSupported:
            # The writer refused the job (an entry the native builder
            # cannot hold; for zip, non-uniform keys or a prefix extractor;
            # partial outputs are already deleted): the per-entry route
            # takes it.
            raise _FallbackToEntries()
        outputs = _outputs_from_files(env, files, kv, vtypes, stats, icmp,
                                      table_options)
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
                          pipeline_shards=None, zip_plane=True,
                          host_sort=False, host_merge=True,
                          mesh_devices=None):
    """Run one compaction job through the device data plane; the same
    signature as the reference's run_device_compaction and byte-identical
    outputs (including output cutting, and the blob file blob GC writes).
    Returns (outputs, stats).

    device_name: "cuda" (default; raises when no card is present) or "cpu"
    (the plain versions of the kernels). merge_operator: folds MERGE groups
    (a job with MERGE rows and none raises Corruption, as the reference's).
    compaction_filter: consulted for surviving VALUE rows at or below the
    earliest snapshot; takes the per-entry route. blob_resolver: a
    BLOB_INDEX payload → value callable (BlobSource.get), needed by a merge
    over a blob base. blob_gc: a BlobGarbageCollector; when active the job
    takes the per-entry route and its survivors are rewritten out of the
    oldest blob files. pipeline: try the pipelined plane first (the
    reference's default, TPULSM_PIPELINE=1). pipeline_shards: the
    pipeline's key-range shard count (TPULSM_PIPELINE_SHARDS; None sizes
    shards to about 2^19 rows). device_blocks: take the on-device
    block-assembly route where its gate admits the job (the reference's
    TPULSM_DEVICE_BLOCKS=1, which also turns the pipeline off). num_shards:
    the serial route's key-range shard count for jobs of at least
    _SHARD_MIN_ROWS rows (TPULSM_DEVICE_SHARDS; None sizes shards to about
    _SHARD_ROWS rows). zip_plane: zip outputs through the native zip
    plane (the default; a failure of it raises), or with False through the
    numpy encoders (the same bytes; the reference's TPULSM_ZIP_PLANE=0,
    which also keeps zip jobs off the pipeline). host_sort: the columnar
    route's rows are ordered and GC'd by the host twins
    (compaction_kernels.host_fused_full: the native run merge with its
    inline GC, pipelined per shard or whole-job on the serial route), the
    reference's TPULSM_HOST_SORT=1, with the same bytes; it needs the
    native library and raises NotSupported without it. host_merge=False
    (the reference's TPULSM_HOST_MERGE=0) makes the host twins take the
    two-pass route (a native full sort, then the numpy GC mask). A device
    job never drops to the host twins. mesh_devices: a list of devices
    (torch.device or names; they may repeat) over which an eligible job's
    uniform shards go round-robin, pipelined or serial
    (ops/mesh_compaction.py; the reference's TPULSM_MESH_COMPACT=1 over
    its chips), the same bytes; a failing entry's shards move to the
    others, then to `device_name`'s device, never to the host.

    Every table format (`table_options.format`: block, single_fast,
    cuckoo, plain, zip) and table option of the reference's device route
    is taken, inputs of every format are read, and outputs may be
    compressed with any codec of `table/format.py`, with or without a ZSTD
    dictionary. A job under the u64-timestamp comparator, whose
    stored-byte order is bytewise, takes the per-entry route with its
    history trim at `compaction.full_history_ts_low` (toplingdb_tpu's device
    route refuses that comparator and its executor runs the job on the host
    path, whose outputs these equal). Raises NotSupported for what the
    reference's device data plane also refuses (user keys over
    MAX_DEVICE_KEY_BYTES, any other comparator, more than MAX_SNAPSHOTS
    snapshots) and what a format refuses (cuckoo: several versions of a
    key, range deletions). With
    `protection_bytes_per_key` set a corrupted output raises Corruption. No
    output is left behind on any failure."""
    device = resolve_device(device_name)
    _check_device_comparator(icmp)
    if mesh_devices is not None:
        mesh_devices = [torch.device(d) for d in mesh_devices]
    if host_sort and native.lib() is None:
        raise NotSupported("host_sort=True needs the native library, which "
                           "could not be built or loaded")
    # A timestamp DB's jobs take the per-entry route: the history trim is
    # a pass over its survivor stream.
    if (native.lib() is not None and compaction_filter is None
            and icmp.user_comparator.timestamp_size == 0
            and (blob_gc is None or not blob_gc.active)
            and not table_options.properties_collector_factories
            and table_options.format in ("block", "zip")
            and table_options.index_type == "binary"):
        try:
            return _run_device_compaction_columnar(
                env, dbname, icmp, compaction, table_cache, table_options,
                snapshots, merge_operator, new_file_number, creation_time,
                device, column_family, blob_resolver=blob_resolver,
                device_blocks=device_blocks, num_shards=num_shards,
                pipeline=pipeline, pipeline_shards=pipeline_shards,
                zip_plane=zip_plane, host_sort=host_sort,
                host_merge=host_merge, mesh_devices=mesh_devices,
            )
        except _FallbackToEntries:
            pass
    return _run_per_entry(
        env, dbname, icmp, compaction, table_cache, table_options,
        snapshots, merge_operator, compaction_filter, new_file_number,
        creation_time, device_name, blob_resolver, blob_gc, column_family)
