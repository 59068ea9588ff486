"""Chunked forward-scan data plane: native block decode + k-way merge
for DBIter (copied from toplingdb_tpu/ops/scan_plane.py, with the scan's
protection bank, ReadOptions.readahead_size's fixed window and the async
read plane's ring windows).

The per-entry read path (DBIter over MergingIterator) pays a Python heap
pop/push, a comparator call, and an internal-key split for EVERY version
of every key — while compaction (ops/pipeline.py) and MultiGet already
run native and batched. This module gives forward scans the same shape:

  source runs   each SST source decodes a run of entries per native
                call (`tpulsm_scan_blocks` through a pre-armed
                FilePrefetchBuffer window, reusing the pipeline's
                machinery; zip tables instead decode a window of entries
                via `ZipTableReader.scan_columnar` — bulk key
                front-decode plus `tpulsm_zip_group_decode` over the
                compressed value groups, no whole-file inflate); the
                memtable contributes its run via the native rep export
                (`tpulsm_skiplist_export`)
  merge         ONE `tpulsm_merge_runs` call (native full-sort fallback
                for >8B user keys) orders the concatenated runs and
                hands back per-row (seq, type) trailers + new-key marks
  resolve       snapshot visibility, newest-visible-per-key selection,
                point/range-tombstone masking — all vectorized numpy
                over the merged chunk; only emitted survivors touch
                Python

DBIter serves key()/value()/next() from the resulting chunk cursor and
the plane refills from the per-source resume positions when the cursor
runs out. Chunk boundaries are cut at the minimum last-buffered user key
over the non-exhausted sources, so every emitted key's visible-version
group is complete (versions of one user key may be spread over every
source). `iterate_upper_bound` prunes block/file fetch so chunking never
over-reads more than one index block past the bound.

Fallbacks — the plane is not built (construction) or bails mid-stream
(PlaneIneligible, DBIter degrades to the per-entry path at the current
position) for: a chunk of 0 rows (`DB.open(iter_chunk_rows=0)`),
non-bytewise comparators, merge operators, backward iteration
(seek_to_last/seek_for_prev/prev), block files that are dict-compressed
or use codecs the native scanner can't inflate, zip files whose native
decoders are unavailable (ticked as ZIP_PLANE_FALLBACKS), and any other
table format. The native library itself is required: DB.open refuses
iter_chunk_rows > 0 without it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.dbformat import ValueType
from toplingdb_tpu_torch.table.prefetch import FilePrefetchBuffer
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils import protection as _p
from toplingdb_tpu_torch.utils import statistics as _stats_mod
from toplingdb_tpu_torch.utils.status import Corruption


class PlaneIneligible(Exception):
    """Shapes the chunked plane does not cover; DBIter re-runs the
    current operation on the per-entry path (which also produces the
    canonical error for corrupt inputs)."""


# Rows per chunk of toplingdb_tpu's default (its TPULSM_ITER_CHUNK unset),
# the default of DB.open(iter_chunk_rows=).
DEFAULT_CHUNK = 4096
# Blocks decoded per source fetch: starts at 1 (a seek costs one block,
# like the per-entry path) and doubles on sequential refills.
_MAX_FETCH_BLOCKS = 64
_PF_INIT = 64 << 10
_PF_MAX = 4 << 20

_U64P = ctypes.POINTER(ctypes.c_uint64)

# Value types the resolver can surface (everything else bails to the
# per-entry path, which raises the canonical error).
_EMIT_TYPES = (int(ValueType.VALUE), int(ValueType.BLOB_INDEX),
               int(ValueType.WIDE_COLUMN_ENTITY))


def _native_order(lib, kb, ko, kl, run_starts):
    """(order, new_key, packed) over the concatenated presorted runs:
    `tpulsm_merge_runs` (k-way, multi-threaded, 8B-key fast path) with
    the `tpulsm_sort_entries` stable sort as the general fallback. The
    order is the internal-key order: user key, its length, newest
    version first."""
    n = len(ko)
    offs = np.ascontiguousarray(ko, dtype=np.int64)
    lens = np.ascontiguousarray(kl, dtype=np.int64)
    kbc = np.ascontiguousarray(kb)
    order = np.empty(n, dtype=np.int32)
    new_key = np.empty(n, dtype=np.uint8)
    packed = np.empty(n, dtype=np.uint64)
    rc = -1
    rs = np.ascontiguousarray(run_starts, dtype=np.int64)
    if n and len(rs) > 1:
        rc = lib.tpulsm_merge_runs(
            native.np_u8p(kbc), native.np_i64p(offs), native.np_i64p(lens),
            n, native.np_i64p(rs), len(rs) - 1,
            native.np_i32p(order), native.np_u8p(new_key),
            packed.ctypes.data_as(_U64P),
        )
    if rc != 0:
        rc = lib.tpulsm_sort_entries(
            native.np_u8p(kbc), native.np_i64p(offs), native.np_i64p(lens),
            n, native.np_i32p(order), native.np_u8p(new_key),
            packed.ctypes.data_as(_U64P),
        )
    if rc != 0:
        raise PlaneIneligible("native merge unavailable")
    return order, new_key, packed


class _Pending:
    """One source's decoded-but-unconsumed rows, columnar. Offsets are
    absolute into kb/vb and contiguous ascending (decode order), so the
    live byte span can be sliced without per-row work."""

    __slots__ = ("kb", "ko", "kl", "vb", "vo", "vl", "start", "n", "_vbb")

    def __init__(self):
        self.clear()

    def clear(self):
        self.kb = self.vb = None
        self.ko = self.kl = self.vo = self.vl = None
        self.start = self.n = 0
        self._vbb = None

    def vb_bytes(self) -> bytes:
        """The value buffer as one Python bytes object (bulk memcpy once
        per refill; Python-level slicing beats per-row ndarray views)."""
        b = self._vbb
        if b is None:
            b = self._vbb = self.vb.tobytes()
        return b

    def rows(self) -> int:
        return self.n - self.start

    def uk_at(self, i: int) -> bytes:
        o = int(self.ko[i])
        return self.kb[o: o + int(self.kl[i]) - 8].tobytes()

    def ik_at(self, i: int) -> bytes:
        o = int(self.ko[i])
        return self.kb[o: o + int(self.kl[i])].tobytes()

    def last_uk(self) -> bytes:
        return self.uk_at(self.n - 1)

    def drop_below(self, uk: bytes) -> None:
        """Consume every row whose user key sorts below `uk` (rows are
        internal-key sorted, so user keys are nondecreasing)."""
        lo, hi = self.start, self.n
        while lo < hi:
            mid = (lo + hi) // 2
            if self.uk_at(mid) < uk:
                lo = mid + 1
            else:
                hi = mid
        self.start = lo

    def drop_upto(self, uk: bytes) -> None:
        """Consume every row whose user key sorts at or below `uk`."""
        lo, hi = self.start, self.n
        while lo < hi:
            mid = (lo + hi) // 2
            if self.uk_at(mid) <= uk:
                lo = mid + 1
            else:
                hi = mid
        self.start = lo

    def drop_all(self) -> None:
        self.start = self.n

    def first_ge(self, ikey: bytes, icmp) -> int:
        """Index of the first row with internal key >= ikey."""
        lo, hi = self.start, self.n
        while lo < hi:
            mid = (lo + hi) // 2
            if icmp.compare(self.ik_at(mid), ikey) < 0:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def append(self, kb, ko, kl, vb, vo, vl) -> None:
        self._vbb = None
        if self.rows() == 0:
            self.kb, self.ko, self.kl = kb, ko, kl
            self.vb, self.vo, self.vl = vb, vo, vl
            self.start, self.n = 0, len(ko)
            return
        st, n = self.start, self.n
        k0 = int(self.ko[st])
        k1 = int(self.ko[n - 1]) + int(self.kl[n - 1])
        v0 = int(self.vo[st])
        v1 = int(self.vo[n - 1]) + int(self.vl[n - 1])
        self.kb = np.concatenate([self.kb[k0:k1], kb])
        self.ko = np.concatenate([self.ko[st:n] - k0, ko + (k1 - k0)])
        self.kl = np.concatenate([self.kl[st:n], kl])
        self.vb = np.concatenate([self.vb[v0:v1], vb])
        self.vo = np.concatenate([self.vo[st:n] - v0, vo + (v1 - v0)])
        self.vl = np.concatenate([self.vl[st:n], vl])
        self.start, self.n = 0, len(self.ko)


def _bank_rows(bank: set, pb: int, kb, ko, kl, vb, vo, vl,
               start: int, n: int) -> None:
    """Record each decoded row's (user_key, value) checksum at the moment
    it enters a pending buffer — the scan plane's source-side half of the
    protection handoff. Emission re-hashes and requires membership
    (ScanPlane._verify_emission), so bytes garbled anywhere between the
    native block decode and chunk emission are caught before serving."""
    for i in range(start, n):
        o = int(ko[i])
        uk = kb[o: o + int(kl[i]) - 8].tobytes()
        vo_i = int(vo[i])
        v = vb[vo_i: vo_i + int(vl[i])].tobytes()
        bank.add(_p.truncate(_p.kv_checksum(uk, v), pb))


class _MemSource:
    """Memtable run: materialized ONCE (lazily, at first use) via the
    rep's native columnar export when available, else a Python walk of
    iter_entries(). The copy pins the iterator's view — later inserts
    carry seqnos above the snapshot anyway, so missing them is exactly
    the per-entry path's visibility behavior."""

    def __init__(self, mem, prot_bank=None, protection_bytes: int = 0):
        self._mem = mem
        self.pending = _Pending()
        self.exhausted = True
        self._mat = False
        self._kb = None  # materialized arrays (seek re-slices them)
        self._n = 0
        self._vbb_cache = None  # bytes view of _vb, shared across seeks
        self._prot_bank = prot_bank
        self._pb = protection_bytes

    def _materialize(self) -> None:
        self._mat = True
        mem = self._mem
        res = None
        try:
            res = mem.export_columnar()
        except Exception as e:  # noqa: BLE001 — concurrent mutation: slow path
            _errors.swallow(reason="memtable-export-race", exc=e)
            res = None
        if res is not None:
            kv, _seqs, _vtypes = res
            self._kb = kv.key_buf
            self._ko = kv.key_offs.astype(np.int64)
            self._kl = kv.key_lens.astype(np.int64)
            self._vb = kv.val_buf
            self._vo = kv.val_offs.astype(np.int64)
            self._vl = kv.val_lens.astype(np.int64)
            self._n = kv.n
            return
        ks, vs = [], []
        for ik, v in mem.iter_entries():
            ks.append(ik)
            vs.append(v)
        self._n = len(ks)
        self._kb = np.frombuffer(b"".join(ks), dtype=np.uint8)
        self._kl = np.fromiter((len(k) for k in ks), np.int64, self._n)
        self._ko = np.zeros(self._n, dtype=np.int64)
        np.cumsum(self._kl[:-1], out=self._ko[1:])
        self._vb = np.frombuffer(b"".join(vs), dtype=np.uint8)
        self._vl = np.fromiter((len(v) for v in vs), np.int64, self._n)
        self._vo = np.zeros(self._n, dtype=np.int64)
        np.cumsum(self._vl[:-1], out=self._vo[1:])

    def seek(self, target: bytes | None, icmp) -> None:
        if not self._mat:
            self._materialize()
            if self._prot_bank is not None and self._n:
                _bank_rows(self._prot_bank, self._pb, self._kb, self._ko,
                           self._kl, self._vb, self._vo, self._vl,
                           0, self._n)
        self.pending.clear()
        if self._n == 0:
            return
        self.pending.kb, self.pending.ko, self.pending.kl = \
            self._kb, self._ko, self._kl
        self.pending.vb, self.pending.vo, self.pending.vl = \
            self._vb, self._vo, self._vl
        self.pending.start, self.pending.n = 0, self._n
        if self._vbb_cache is None:
            self._vbb_cache = self._vb.tobytes()
        self.pending._vbb = self._vbb_cache
        if target is not None:
            self.pending.start = self.pending.first_ge(target, icmp)

    def top_up(self, min_rows: int) -> None:
        pass  # fully materialized

    def prefetch_counts(self) -> tuple[int, int]:
        return 0, 0


class _NoPf:
    """Prefetch-buffer stand-in for zip files: the reader is fully
    resident (sections mmap'd/loaded at open), so there is nothing to
    prefetch and the counters stay zero."""

    hits = 0
    misses = 0

    def reset(self) -> None:
        pass


class _SSTSource:
    """A sorted run of SST files (one L0 file, or one level's disjoint
    file chain). Files open lazily through the table cache (the pinned
    Version keeps them on disk); per fetch, one `tpulsm_scan_blocks`
    call decodes a doubling window of data blocks read through a
    pre-armed FilePrefetchBuffer. Zip files window in entries instead:
    `scan_columnar` bulk-decodes value groups natively, so the plane
    keeps chunk-merge eligibility on searchable-compression levels."""

    def __init__(self, files, table_cache, icmp, upper_target,
                 readahead_size: int = 0, prot_bank=None,
                 protection_bytes: int = 0, stats=None, aio_ring=None):
        self._files = files
        self._tc = table_cache
        self._icmp = icmp
        self._upper_t = upper_target
        self._stats = stats
        self._ra = readahead_size
        # Async read plane: readahead windows become reader-ring tasks.
        self._aio = aio_ring
        self._prot_bank = prot_bank
        self._pb = protection_bytes
        self.pending = _Pending()
        self.exhausted = not files
        self._next_fi = 0
        self._reader = None
        self._pf = None
        self._zip = False
        self._win = 1
        self._seek_t: bytes | None = None
        # file number -> (reader, offs, lens, seps, pf): repeated seeks
        # into the same file must not re-walk its index block.
        self._fmemo: dict = {}

    # -- positioning ---------------------------------------------------

    def seek(self, target: bytes | None, icmp) -> None:
        self.pending.clear()
        self._close_file()
        self._win = 1
        self._seek_t = target
        self.exhausted = False
        if target is None:
            self._next_fi = 0
        else:
            lo, hi = 0, len(self._files) - 1
            pick = len(self._files)
            while lo <= hi:
                mid = (lo + hi) // 2
                if self._icmp.compare(self._files[mid].largest, target) >= 0:
                    pick = mid
                    hi = mid - 1
                else:
                    lo = mid + 1
            self._next_fi = pick
        if self._next_fi >= len(self._files):
            self.exhausted = True

    def _close_file(self) -> None:
        self._reader = None
        self._pf = None
        self._zip = False

    def _open_next_file(self) -> None:
        self._close_file()
        if self._next_fi >= len(self._files):
            self.exhausted = True
            return
        meta = self._files[self._next_fi]
        if self._upper_t is not None and self._icmp.compare(
                meta.smallest, self._upper_t) >= 0:
            # Every key of this (and, for level runs, any later) file is
            # at or beyond the upper bound: stop fetching entirely.
            self.exhausted = True
            return
        self._next_fi += 1
        memo = self._fmemo.get(meta.number)
        if memo is None:
            reader = self._tc.get_reader(meta.number)
            if hasattr(reader, "scan_columnar"):
                # Zip table: served natively through scan_columnar, no
                # index/prefetch machinery (sections are resident).
                if not reader.scan_native_ready():
                    if self._stats is not None:
                        self._stats.record_tick(
                            _stats_mod.ZIP_PLANE_FALLBACKS)
                    raise PlaneIneligible("zip plane disabled/unavailable")
                memo = (reader, None, None, None, _NoPf())
                self._fmemo[meta.number] = memo
                self._open_memo(memo)
                return
            elif not hasattr(reader, "new_index_iterator") or \
                    getattr(reader, "_compression_dict", b""):
                raise PlaneIneligible("non-block or dict-compressed input")
            idx = reader.new_index_iterator()
            idx.seek_to_first()
            handles, seps = [], []
            from toplingdb_tpu_torch.table import format as fmt

            for k, enc in idx.entries():
                handles.append(fmt.BlockHandle.decode_exact(enc))
                seps.append(k)
            if self._ra > 0:
                pf = FilePrefetchBuffer(
                    reader._f, max_readahead=self._ra,
                    initial_readahead=self._ra, arm_immediately=True,
                    aio_ring=self._aio)
            else:
                # Auto-scaling: the window arms after two sequential span
                # reads and doubles per refill; a point seek pays one
                # block-sized pread, like the per-entry path.
                pf = FilePrefetchBuffer(
                    reader._f, max_readahead=_PF_MAX,
                    initial_readahead=_PF_INIT, aio_ring=self._aio)
            memo = (reader,
                    np.array([h.offset for h in handles], dtype=np.int64),
                    np.array([h.size for h in handles], dtype=np.int64),
                    seps, pf)
            self._fmemo[meta.number] = memo
        self._open_memo(memo)

    def _open_memo(self, memo) -> None:
        reader, self._offs, self._lens, seps, pf = memo
        self._reader = reader
        if self._seek_t is not None:
            pf.reset()  # seek: restart the auto-scaling readahead ramp
        self._pf = pf
        if self._offs is None:
            # Zip file: windows advance in entries (value-group
            # multiples); positioning is exact via entry_lower_bound, so
            # there is no straddling block to include at either end.
            self._zip = True
            self._nwin = reader.n
            bi = (reader.entry_lower_bound(self._seek_t)
                  if self._seek_t is not None else 0)
            bstop = (reader.entry_lower_bound(self._upper_t)
                     if self._upper_t is not None else reader.n)
            self._bi, self._bstop = bi, max(bi, bstop)
            return
        self._verify = bool(reader.opts.verify_checksums)
        self._nwin = len(self._offs)
        bi = 0
        if self._seek_t is not None:
            lo, hi = 0, len(seps)
            while lo < hi:
                mid = (lo + hi) // 2
                if self._icmp.compare(seps[mid], self._seek_t) < 0:
                    lo = mid + 1
                else:
                    hi = mid
            bi = lo
        bstop = len(self._offs)
        if self._upper_t is not None:
            lo, hi = bi, len(seps)
            while lo < hi:
                mid = (lo + hi) // 2
                if self._icmp.compare(seps[mid], self._upper_t) < 0:
                    lo = mid + 1
                else:
                    hi = mid
            # Include the straddling block; later blocks hold only keys
            # at or beyond the bound.
            bstop = min(lo + 1, len(self._offs))
        self._bi, self._bstop = bi, bstop

    # -- fetching ------------------------------------------------------

    def top_up(self, min_rows: int) -> None:
        lib = native.lib()
        while not self.exhausted and self.pending.rows() < min_rows:
            if self._reader is None or self._bi >= self._bstop:
                if self._reader is not None and self._bi >= self._bstop \
                        and self._bstop < self._nwin:
                    # Upper-bound prune hit inside the file: the rest of
                    # this run is entirely at/beyond the bound.
                    self.exhausted = True
                    return
                self._open_next_file()
                continue
            if self._zip:
                self._fetch_zip_window()
            else:
                self._fetch_window(lib)

    def _fetch_window(self, lib) -> None:
        b0 = self._bi
        b1 = min(b0 + self._win, self._bstop)
        self._win = min(self._win * 2, _MAX_FETCH_BLOCKS)
        w0 = int(self._offs[b0])
        w1 = int(self._offs[b1 - 1] + self._lens[b1 - 1]) + 5
        raw = self._pf.read(w0, w1 - w0)
        rawb = np.frombuffer(raw, dtype=np.uint8)
        boffs = np.ascontiguousarray(self._offs[b0:b1] - w0)
        blens = np.ascontiguousarray(self._lens[b0:b1])
        span = int(blens.sum())
        n_cap = 192 * (b1 - b0) + 64
        k_cap = span * 3 + 4096
        v_cap = span * 3 + 4096
        for _ in range(4):
            kb = np.empty(k_cap, dtype=np.uint8)
            vb = np.empty(v_cap, dtype=np.uint8)
            ko = np.empty(n_cap, dtype=np.int32)
            kl = np.empty(n_cap, dtype=np.int32)
            vo = np.empty(n_cap, dtype=np.int32)
            vl = np.empty(n_cap, dtype=np.int32)
            rc = lib.tpulsm_scan_blocks(
                native.np_u8p(rawb), len(rawb),
                native.np_i64p(boffs), native.np_i64p(blens), b1 - b0,
                1 if self._verify else 0,
                native.np_u8p(kb), k_cap, native.np_u8p(vb), v_cap,
                native.np_i32p(ko), native.np_i32p(kl),
                native.np_i32p(vo), native.np_i32p(vl), n_cap, 0, 0,
            )
            if rc == -2:
                k_cap *= 4
            elif rc == -3:
                v_cap *= 4
            elif rc == -4:
                n_cap *= 4
            else:
                break
        if rc < 0:
            # Codec/corruption/capacity shapes the plane doesn't cover:
            # the per-entry path re-reads and raises the canonical error.
            raise PlaneIneligible(f"native scan rc={rc}")
        if _stats_mod.perf_level:
            # PerfContext parity with the per-entry path: every data block
            # this window decoded counts once, bytes at on-disk block size
            # (== decoded size for the uncompressed blocks the plane
            # serves natively).
            _pctx = _stats_mod.perf_context()
            _pctx.block_read_count += b1 - b0
            _pctx.block_read_byte += span
        self._bi = b1
        if rc == 0:
            return
        ko = ko[:rc].astype(np.int64)
        kl = kl[:rc].astype(np.int64)
        vo = vo[:rc].astype(np.int64)
        vl = vl[:rc].astype(np.int64)
        lo = 0
        if self._seek_t is not None:
            tmp = _Pending()
            tmp.kb, tmp.ko, tmp.kl = kb, ko, kl
            tmp.start, tmp.n = 0, rc
            lo = tmp.first_ge(self._seek_t, self._icmp)
            if lo >= rc:
                return
            self._seek_t = None
        if self._prot_bank is not None:
            _bank_rows(self._prot_bank, self._pb, kb, ko, kl, vb, vo, vl,
                       lo, rc)
        self.pending.append(kb, ko[lo:], kl[lo:], vb, vo[lo:], vl[lo:])

    def _fetch_zip_window(self) -> None:
        """Zip analogue of _fetch_window: one scan_columnar call decodes
        a doubling window of entries (sized in value groups so each
        group's zstd inflate amortizes over a full window). No seek trim
        is needed — _open_memo positioned _bi with entry_lower_bound."""
        r = self._reader
        vg = max(1, int(r.VG))
        e0 = self._bi
        e1 = min(e0 + self._win * vg, self._bstop)
        self._win = min(self._win * 2, _MAX_FETCH_BLOCKS)
        kb, ko, kl, vb, vo, vl = r.scan_columnar(e0, e1)
        self._bi = e1
        n = e1 - e0
        if n <= 0:
            return
        self._seek_t = None
        if self._stats is not None:
            self._stats.record_tick(
                _stats_mod.ZIP_GROUP_DECODES, -(-e1 // vg) - e0 // vg)
            self._stats.record_tick(
                _stats_mod.ZIP_GROUP_DECODE_BYTES, int(len(vb)))
        if self._prot_bank is not None:
            _bank_rows(self._prot_bank, self._pb, kb, ko, kl, vb, vo, vl,
                       0, n)
        self.pending.append(kb, ko, kl, vb, vo, vl)

    def prefetch_counts(self) -> tuple[int, int]:
        h = m = 0
        for _r, _o, _l, _s, pf in self._fmemo.values():
            h += pf.hits
            m += pf.misses
        return h, m


class ScanPlane:
    """Forward-scan chunk server for DBIter. Cursor surface:
    seek_first()/seek(user_key)/advance() position it; is_valid,
    cur_key, cur_value, cur_type expose the current entry."""

    def __init__(self, sources, icmp, snap_seq: int, rd, upper, lower,
                 blob_resolver, stats, chunk: int, prot_bank=None,
                 protection_bytes: int = 0):
        self._srcs = sources
        self._icmp = icmp
        self._seq = snap_seq
        self._rd = rd
        self._upper = upper
        self._lower = lower
        self._blob = blob_resolver
        self._stats = stats
        # Protection (Options.protection_bytes_per_key): sources banked
        # every decoded row's checksum into prot_bank; emission must find
        # each served (user_key, value) there (_verify_emission).
        self._prot_bank = prot_bank
        self._pb = protection_bytes
        self._chunk = max(2, chunk)
        self.is_valid = False
        self.cur_key = self.cur_value = None
        self.cur_type = int(ValueType.VALUE)
        self._keys: list = []
        self._vals: list = []
        self._types: list = []
        self._i = 0
        self._done = False
        self._pf_banked = (0, 0)
        # Per-source refill quota: small right after a seek (a point
        # lookup decodes ~one block per source), doubling on sequential
        # refills up to the chunk budget.
        self._quota_max = max(64, self._chunk // max(1, len(sources)))
        self._quota = 64

    # -- positioning ---------------------------------------------------

    def seek_first(self) -> None:
        self.seek(self._lower if self._lower is not None else None)

    def seek(self, user_key: bytes | None) -> None:
        self._done = False
        self._keys, self._vals, self._types = [], [], []
        self._i = 0
        self.is_valid = False
        target = None
        if user_key is not None:
            if self._upper is not None and user_key >= self._upper:
                self._done = True
                return
            target = dbformat.make_internal_key(
                user_key, self._seq, dbformat.VALUE_TYPE_FOR_SEEK)
        self._quota = 64
        for s in self._srcs:
            s.seek(target, self._icmp)
        self._refill()

    def advance(self) -> None:
        i = self._i + 1
        if i < len(self._keys):
            self._i = i
            self.cur_key = self._keys[i]
            self.cur_value = self._vals[i]
            self.cur_type = self._types[i]
            return
        self._keys, self._vals, self._types = [], [], []
        self._i = 0
        self.is_valid = False
        self._refill()

    # -- refill --------------------------------------------------------

    def _bank_prefetch(self) -> None:
        if self._stats is None:
            return
        h = m = 0
        for s in self._srcs:
            sh, sm = s.prefetch_counts()
            h += sh
            m += sm
        dh, dm = h - self._pf_banked[0], m - self._pf_banked[1]
        if dh or dm:
            if dh:
                self._stats.record_tick(_stats_mod.PREFETCH_HITS, dh)
            if dm:
                self._stats.record_tick(_stats_mod.PREFETCH_MISSES, dm)
            self._pf_banked = (h, m)

    def _refill(self) -> None:
        if self._done:
            return
        lib = native.lib()
        if lib is None:
            raise PlaneIneligible("native lib unavailable")
        quota = self._quota
        self._quota = min(self._quota * 2, self._quota_max)
        keys, vals, types = self._keys, self._vals, self._types
        while not keys and not self._done:
            for s in self._srcs:
                if not s.exhausted:
                    s.top_up(quota)
            parts = [s for s in self._srcs if s.pending.rows() > 0]
            if not parts:
                self._done = True
                break
            bound = None
            for s in self._srcs:
                if not s.exhausted and s.pending.rows() > 0:
                    u = s.pending.last_uk()
                    if bound is None or u < bound:
                        bound = u
            cat_kb, cat_ko, cat_kl, rs, src_of, loc_of = self._concat(parts)
            order, new_key, packed = _native_order(
                lib, cat_kb, cat_ko, cat_kl, rs)
            n = len(order)
            cut = n
            if bound is not None:
                lo, hi = 0, n
                while lo < hi:
                    mid = (lo + hi) // 2
                    r = int(order[mid])
                    o = int(cat_ko[r])
                    if cat_kb[o: o + int(cat_kl[r]) - 8].tobytes() < bound:
                        lo = mid + 1
                    else:
                        hi = mid
                cut = lo
            if cut == 0:
                quota *= 2  # one user key spans every buffered row
                continue
            # Emission cap: bounds the Python materialization during the
            # post-seek ramp; at steady state (quota maxed) refills emit
            # the whole cut so nothing is ever re-merged.
            cap = quota * len(parts) if quota < self._quota_max else None
            consume_uk = self._resolve(
                cat_kb, cat_ko, cat_kl, order, new_key, packed,
                cut, parts, src_of, loc_of, keys, vals, types, cap=cap)
            if not self._done:
                for s in parts:
                    if consume_uk is not None:
                        # Emission was capped: keep the unprocessed tail
                        # of the cut buffered for the next refill.
                        s.pending.drop_upto(consume_uk)
                    elif bound is None:
                        s.pending.drop_all()
                    else:
                        s.pending.drop_below(bound)
            if self._stats is not None:
                self._stats.record_tick(_stats_mod.ITER_CHUNK_REFILLS)
            self._bank_prefetch()
        if keys:
            self.is_valid = True
            self.cur_key = keys[0]
            self.cur_value = vals[0]
            self.cur_type = types[0]

    def _concat(self, parts):
        kbs, kos, kls, counts, locs = [], [], [], [], []
        base = 0
        for s in parts:
            p = s.pending
            st_, n = p.start, p.n
            k0 = int(p.ko[st_])
            k1 = int(p.ko[n - 1]) + int(p.kl[n - 1])
            kbs.append(p.kb[k0:k1])
            kos.append(p.ko[st_:n] - k0 + base)
            kls.append(p.kl[st_:n])
            locs.append(np.arange(st_, n, dtype=np.int64))
            counts.append(n - st_)
            base += k1 - k0
        cat_kb = kbs[0] if len(kbs) == 1 else np.concatenate(kbs)
        cat_ko = kos[0] if len(kos) == 1 else np.concatenate(kos)
        cat_kl = kls[0] if len(kls) == 1 else np.concatenate(kls)
        rs = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=rs[1:])
        src_of = np.repeat(np.arange(len(parts), dtype=np.int32), counts)
        loc_of = locs[0] if len(locs) == 1 else np.concatenate(locs)
        return cat_kb, cat_ko, cat_kl, rs, src_of, loc_of

    def _resolve(self, cat_kb, cat_ko, cat_kl, order, new_key, packed,
                 cut, parts, src_of, loc_of, keys, vals, types, cap=None):
        """Newest-visible-per-user-key selection over merged positions
        [0, cut), tombstone masking, emission. Everything but blob
        resolution and range-tombstone probes is vectorized.

        Returns the consume boundary: None = the whole cut was
        processed; a user key = emission was capped at it (consume
        through that key, keep the rest buffered)."""
        import bisect

        ordc = order[:cut]
        pk = packed[ordc]
        seqs = pk >> np.uint64(8)
        vts = (pk & np.uint64(0xFF)).astype(np.int32)
        vis = seqs <= np.uint64(self._seq)
        pos = np.nonzero(vis)[0]
        if not len(pos):
            return None
        gid = np.cumsum(new_key[:cut], dtype=np.int64)
        _, first = np.unique(gid[pos], return_index=True)
        win = pos[first]
        consume_uk = None
        if cap is not None and len(win) > cap:
            win = win[:cap]
            last = int(ordc[int(win[-1])])
            o = int(cat_ko[last])
            consume_uk = cat_kb[o: o + int(cat_kl[last]) - 8].tobytes()
        vtw = vts[win]
        if np.any(vtw == int(ValueType.MERGE)):
            # Merge chains need operand folding (or the per-entry path's
            # MergeInProgress when no operator is configured).
            raise PlaneIneligible("merge operands in chunk")
        live = (vtw != int(ValueType.DELETION)) \
            & (vtw != int(ValueType.SINGLE_DELETION))
        if not live.any():
            return consume_uk
        win = win[live]
        vtw = vtw[live]
        if not np.all(np.isin(vtw, _EMIT_TYPES)):
            raise PlaneIneligible("unexpected value type in chunk")
        wrows = ordc[win]
        uo = cat_kl[wrows] - 8  # reuse as length first
        uks_o = cat_ko[wrows]
        kbytes = cat_kb.tobytes()
        uks = [kbytes[o:e] for o, e in
               zip(uks_o.tolist(), (uks_o + uo).tolist())]
        if self._upper is not None:
            c = bisect.bisect_left(uks, self._upper)  # winners are sorted
            if c < len(uks):
                self._done = True
                uks = uks[:c]
                win, vtw, wrows = win[:c], vtw[:c], wrows[:c]
            if not uks:
                return consume_uk
        if self._rd is not None:
            seq_l = seqs[win].tolist()
            keep = [j for j, uk in enumerate(uks)
                    if self._rd.max_covering_seq(uk, self._seq) <= seq_l[j]]
            if len(keep) != len(uks):
                if not keep:
                    return consume_uk
                ki = np.asarray(keep)
                uks = [uks[j] for j in keep]
                vtw, wrows = vtw[ki], wrows[ki]
        k = len(wrows)
        wsrc = src_of[wrows]
        wloc = loc_of[wrows]
        wvo = np.empty(k, dtype=np.int64)
        wve = np.empty(k, dtype=np.int64)
        for i, s in enumerate(parts):
            m = wsrc == i
            if m.any():
                lo = wloc[m]
                o = s.pending.vo[lo]
                wvo[m] = o
                wve[m] = o + s.pending.vl[lo]
        vbufs = [s.pending.vb_bytes() for s in parts]
        ws_l = wsrc.tolist()
        wvo_l = wvo.tolist()
        wve_l = wve.tolist()
        if np.all(vtw == int(ValueType.VALUE)):
            if self._prot_bank is None:
                keys.extend(uks)
                vals.extend(vbufs[s][o:e]
                            for s, o, e in zip(ws_l, wvo_l, wve_l))
                types.extend([int(ValueType.VALUE)] * k)
                return consume_uk
            emit_vals = [vbufs[s][o:e]
                         for s, o, e in zip(ws_l, wvo_l, wve_l)]
            for j in range(k):
                self._verify_emission(uks[j], emit_vals[j])
            keys.extend(uks)
            vals.extend(emit_vals)
            types.extend([int(ValueType.VALUE)] * k)
            return consume_uk
        vt_l = vtw.tolist()
        for j in range(k):
            v = vbufs[ws_l[j]][wvo_l[j]: wve_l[j]]
            t = vt_l[j]
            if self._prot_bank is not None:
                # Verify the raw bytes BEFORE blob resolution rewrites them.
                self._verify_emission(uks[j], v)
            if t == int(ValueType.BLOB_INDEX):
                v = self._blob(v)
                t = int(ValueType.VALUE)
            keys.append(uks[j])
            vals.append(v)
            types.append(t)
        return consume_uk

    def _verify_emission(self, uk: bytes, value: bytes) -> None:
        """Scan-plane chunk-emission protection check: the served bytes
        must re-hash to a checksum banked when the row was decoded."""
        cs = _p.truncate(_p.kv_checksum(uk, value), self._pb)
        if cs not in self._prot_bank:
            if self._stats is not None:
                self._stats.record_tick(
                    _stats_mod.INTEGRITY_PROTECTION_MISMATCHES)
            raise Corruption(
                f"scan-plane protection mismatch emitting key {uk!r}: "
                f"served bytes match no decoded source row"
            )


def make_scan_plane(mems, l0_files, level_runs, table_cache, icmp,
                    snap_seq, rd, lower, upper, blob_resolver,
                    merge_operator, prefix_mode, excluded, read_ts, stats,
                    chunk: int, readahead_size: int = 0,
                    protection_bytes: int = 0, aio_rings=None):
    """Build a ScanPlane for DB.new_iterator, or None when the iterator
    shape is ineligible at construction time (per-file eligibility is
    checked lazily and bails mid-stream instead). `chunk` is the DB's
    iter_chunk_rows (0 = no plane); `aio_rings` the DB's
    AsyncReadBatcher when the async read plane is on. Prefix-mode
    iteration, WritePrepared exclusion ranges (`excluded`) and a read
    timestamp take the per-entry path."""
    if chunk == 0 or merge_operator is not None or prefix_mode \
            or excluded or read_ts is not None:
        return None
    if icmp.user_comparator.name() != "tpulsm.BytewiseComparator":
        return None
    # L0 readers are already open (new_iterator built children from
    # them): reject known-bad formats now instead of bailing later.
    for f in l0_files:
        r = table_cache.get_reader(f.number)
        if hasattr(r, "scan_columnar"):
            if not r.scan_native_ready():
                if stats is not None:
                    stats.record_tick(_stats_mod.ZIP_PLANE_FALLBACKS)
                return None
        elif not hasattr(r, "new_index_iterator") or \
                getattr(r, "_compression_dict", b""):
            return None
    upper_t = None
    if upper is not None:
        upper_t = dbformat.make_internal_key(
            upper, dbformat.MAX_SEQUENCE_NUMBER, dbformat.VALUE_TYPE_FOR_SEEK)
    bank = set() if protection_bytes else None
    sources: list = [_MemSource(m, prot_bank=bank,
                                protection_bytes=protection_bytes)
                     for m in mems]
    # Async read plane: each SST source pins one reader ring so its
    # doubling readahead windows stay ordered per source while distinct
    # sources overlap their I/O.
    def _ring(seq):
        return aio_rings.ring_for(seq) if aio_rings is not None else None

    for i, f in enumerate(l0_files):
        sources.append(_SSTSource([f], table_cache, icmp, upper_t,
                                  readahead_size, prot_bank=bank,
                                  protection_bytes=protection_bytes,
                                  stats=stats, aio_ring=_ring(i)))
    for i, files in enumerate(level_runs):
        sources.append(_SSTSource(list(files), table_cache, icmp, upper_t,
                                  readahead_size, prot_bank=bank,
                                  protection_bytes=protection_bytes,
                                  stats=stats,
                                  aio_ring=_ring(len(l0_files) + i)))
    if not sources:
        return None
    return ScanPlane(sources, icmp, snap_seq, rd, upper, lower,
                     blob_resolver, stats, chunk, prot_bank=bank,
                     protection_bytes=protection_bytes)
