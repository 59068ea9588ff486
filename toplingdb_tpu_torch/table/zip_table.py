"""ZipTable: the searchable-compression SST format for cold levels (copied
from toplingdb_tpu/table/zip_table.py, without the async read plane's
hooks).

The role of ToplingDB's ToplingZipTable ("searchable compression": a
succinct key index and entropy-coded values, so point lookups never
decompress a 4KB block), with array-friendly structures instead of a
trie:

  keys    a front-coded dictionary in groups of G: each group's head key is
          stored whole, followers as (shared-prefix len, suffix). Lookup =
          binary search over group heads + a <=G-entry in-group decode —
          no data blocks, no restart arrays, the whole dictionary stays
          resident as flat numpy arrays.
  values  compressed in mini-groups of VG with one ZSTD dictionary trained
          over the file's values (util/compression dict training role), so
          a point read decompresses ~1-4KB ONCE per group (cached) rather
          than a block per miss; groups that don't shrink are stored raw
          (per-group flag bit).

Shares filter / properties / range-del meta blocks and the footer shape
with the other formats; dispatched by footer magic ("tpulsmZT") through
table/factory.py. Builder surface matches TableBuilder (build_outputs
compatible).

Two encoders write the same bytes: the native zip plane (`tpulsm_zip_*` in
the port's native library: front-coding, value-group gather, ZDICT
training and parallel zstd) and the numpy encoders. `zip_plane=True`, the
default of `write_tables_zip_columnar` and of the compaction entry points,
runs the native plane and raises on any failure of it; only
`zip_plane=False` runs the numpy encoders. The per-entry ZipTableBuilder
always runs the Python encoders, as the reference's does.
"""

from __future__ import annotations

import os

import numpy as np

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator, ValueType
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.block import BlockBuilder, BlockIter
from toplingdb_tpu_torch.table.builder import (
    METAINDEX_FILTER,
    METAINDEX_PROPERTIES,
    METAINDEX_RANGE_DEL,
    CompressionOptions,
    TableOptions,
)
from toplingdb_tpu_torch.table.filter import (
    filter_from_keys,
    filter_policy_from_name,
)
from toplingdb_tpu_torch.table.properties import TableProperties
from toplingdb_tpu_torch.utils import coding
from toplingdb_tpu_torch.utils.status import Corruption, NotSupported

METAINDEX_PARAMS = b"tpulsm.zt.params"
METAINDEX_KEY_META = b"tpulsm.zt.k.meta"
METAINDEX_KEY_SFX = b"tpulsm.zt.k.sfx"
METAINDEX_KEY_GSO = b"tpulsm.zt.k.gso"
METAINDEX_VAL_LENS = b"tpulsm.zt.v.lens"
METAINDEX_VAL_GO = b"tpulsm.zt.v.go"
METAINDEX_VAL_FLAGS = b"tpulsm.zt.v.flags"
METAINDEX_VAL_DICT = b"tpulsm.zt.v.dict"
METAINDEX_VAL_BLOB = b"tpulsm.zt.v.blob"

_VERSION = 1
_FLAG_LENS32 = 1
_FLAG_HAS_DICT = 2
_FLAG_META16 = 4  # key meta is u16 pairs (some internal key > 255 bytes)

# Key-group width: binary search lands on a head, then decodes <= G-1
# follower suffixes. 16 balances in-group decode cost vs head overhead.
GROUP = 16
# Value mini-group target: ~2KB of raw value bytes per compressed unit.
VALUE_GROUP_TARGET = 2048


class ZipTableBuilder:
    """Same surface as TableBuilder (build_outputs/flush compatible)."""

    FOOTER_MAGIC = fmt.ZIP_MAGIC

    def __init__(self, wfile, icmp: InternalKeyComparator,
                 options: TableOptions | None = None,
                 column_family_id: int = 0, column_family_name: str = "",
                 creation_time: int = 0):
        self.opts = options or TableOptions()
        self._w = wfile
        self._icmp = icmp
        self._keys: list[bytes] = []
        self._vals: list[bytes] = []
        self._approx_bytes = 0
        self._filter_keys: list[bytes] = []
        self._last_filter_prefix: bytes | None = None
        self._range_del_block = BlockBuilder(restart_interval=1)
        self.props = TableProperties(
            comparator_name=icmp.user_comparator.name(),
            filter_policy_name=(
                self.opts.filter_policy.name() if self.opts.filter_policy
                else ""
            ),
            compression_name="zip",
            prefix_extractor_name=(
                self.opts.prefix_extractor.name()
                if getattr(self.opts, "prefix_extractor", None) else ""
            ),
            column_family_id=column_family_id,
            column_family_name=column_family_name,
            creation_time=creation_time,
            smallest_seqno=dbformat.MAX_SEQUENCE_NUMBER,
            whole_key_filtering=1 if self.opts.whole_key_filtering else 0,
        )
        self._last_key: bytes | None = None
        self._smallest: bytes | None = None
        self._largest: bytes | None = None
        self._finished = False
        self._collectors = [
            f.create() for f in self.opts.properties_collector_factories
        ]
        self.need_compaction = False

    @property
    def num_entries(self) -> int:
        return self.props.num_entries + self.props.num_range_deletions

    def file_size(self) -> int:
        return self._w.file_size() + self._approx_bytes

    @property
    def smallest_key(self) -> bytes | None:
        return self._smallest

    @property
    def largest_key(self) -> bytes | None:
        return self._largest

    def _track_bounds(self, ikey: bytes) -> None:
        if self._smallest is None or \
                self._icmp.compare(ikey, self._smallest) < 0:
            self._smallest = ikey
        if self._largest is None or \
                self._icmp.compare(ikey, self._largest) > 0:
            self._largest = ikey
        seq = dbformat.extract_seqno(ikey)
        self.props.smallest_seqno = min(self.props.smallest_seqno, seq)
        self.props.largest_seqno = max(self.props.largest_seqno, seq)

    def add(self, ikey: bytes, value: bytes) -> None:
        assert not self._finished
        if self._last_key is not None:
            assert self._icmp.compare(self._last_key, ikey) < 0
        if len(ikey) >= 1 << 16:
            raise NotSupported(
                "zip table keys are capped at 64KiB (front-coding meta "
                "is u16 at most); use the block format"
            )
        self._keys.append(ikey)
        self._vals.append(value)
        self._approx_bytes += len(ikey) + len(value) + 4
        self._last_key = ikey
        self._track_bounds(ikey)
        uk, seq_, t = dbformat.split_internal_key(ikey)
        if self.opts.filter_policy:
            if self.opts.whole_key_filtering:
                self._filter_keys.append(uk)
            pe = getattr(self.opts, "prefix_extractor", None)
            if pe is not None and pe.in_domain(uk):
                p = pe.transform(uk)
                if p != self._last_filter_prefix:
                    self._filter_keys.append(p)
                    self._last_filter_prefix = p
        for c in self._collectors:
            c.add_user_key(uk, value, t, seq_, self._approx_bytes)
        self.props.num_entries += 1
        self.props.raw_key_size += len(ikey)
        self.props.raw_value_size += len(value)
        if t in (ValueType.DELETION, ValueType.SINGLE_DELETION):
            self.props.num_deletions += 1
        elif t == ValueType.MERGE:
            self.props.num_merge_operands += 1

    def add_tombstone(self, begin_ikey: bytes, end_user_key: bytes) -> None:
        assert not self._finished
        self._range_del_block.add(begin_ikey, end_user_key)
        self.props.num_range_deletions += 1
        self._track_bounds(begin_ikey)
        end_ikey = dbformat.make_internal_key(
            end_user_key, dbformat.MAX_SEQUENCE_NUMBER,
            dbformat.VALUE_TYPE_FOR_SEEK,
        )
        if self._largest is None or \
                self._icmp.compare(end_ikey, self._largest) > 0:
            self._largest = end_ikey

    def _encode_keys(self) -> tuple[bytes, bytes, bytes, bool]:
        """(meta (plen,slen) pairs, sfx blob, gso u32[nG], meta16) —
        the front-coded key dictionary. Meta pairs are u8 unless any key
        exceeds 255 bytes (then u16, flagged in params)."""
        meta16 = any(len(k) > 255 for k in self._keys)
        cap = 0xFFFF if meta16 else 0xFF
        meta: list[int] = []
        sfx = bytearray()
        gso = []
        prev = b""
        for i, k in enumerate(self._keys):
            if i % GROUP == 0:
                gso.append(len(sfx))
                plen = 0
            else:
                mx = min(len(prev), len(k))
                plen = 0
                while plen < mx and prev[plen] == k[plen]:
                    plen += 1
                plen = min(plen, cap)
            meta.append(plen)
            meta.append(len(k) - plen)
            sfx += k[plen:]
            prev = k
        mraw = np.asarray(meta, dtype="<u2" if meta16 else np.uint8).tobytes()
        return (mraw, bytes(sfx),
                np.asarray(gso, dtype="<u4").tobytes(), meta16)

    def _encode_values(self):
        """(lens bytes, go u32[nVG+1], flags bitmask, dict, blob, vg,
        lens32)"""
        from toplingdb_tpu_torch.utils import codecs

        n = len(self._vals)
        avg = (self.props.raw_value_size // n) if n else 1
        vg = max(1, min(256, VALUE_GROUP_TARGET // max(1, avg)))
        copts = getattr(self.opts, "compression_opts", None) \
            or CompressionOptions()
        compress = (self.opts.compression != fmt.NO_COMPRESSION
                    and codecs.available("zstd"))
        groups = [b"".join(self._vals[i:i + vg]) for i in range(0, n, vg)]
        zdict = b""
        if compress and copts.max_dict_bytes > 0 and len(groups) >= 8:
            zdict = codecs.zstd_train_dictionary(
                groups[:: max(1, len(groups) // 256)] or groups,
                copts.max_dict_bytes,
            )
        blob = bytearray()
        go = [0]
        flags = bytearray((len(groups) + 7) // 8)
        for gi, raw in enumerate(groups):
            payload = raw
            if compress and len(raw) >= 32:
                z = codecs.zstd_compress(
                    raw, copts.level if copts.level is not None else 3,
                    zdict)
                if len(z) < len(raw):
                    payload = z
                    flags[gi // 8] |= 1 << (gi % 8)
            blob += payload
            go.append(len(blob))
        lens32 = any(len(v) >= 1 << 16 for v in self._vals)
        lens = np.asarray([len(v) for v in self._vals],
                          dtype="<u4" if lens32 else "<u2").tobytes()
        if compress:
            self.props.compression_name = "zip+zstd"
        return (lens, np.asarray(go, dtype="<u4").tobytes(), bytes(flags),
                zdict, bytes(blob), vg, lens32)

    def finish(self) -> TableProperties:
        assert not self._finished
        for c in self._collectors:
            self.props.user_collected.update(c.finish())
            if c.need_compact():
                self.need_compaction = True
        kmeta, ksfx, kgso, meta16 = self._encode_keys()
        vlens, vgo, vflags, vdict, vblob, vg, lens32 = self._encode_values()
        n = len(self._keys)
        self._keys = []
        self._vals = []
        fdata = None
        if self.opts.filter_policy and self._filter_keys:
            fdata = filter_from_keys(self.opts.filter_policy,
                                     self._filter_keys)
        rd_raw = None if self._range_del_block.empty() \
            else self._range_del_block.finish()
        _write_zip_file(
            self._w, self.props, n, vg, meta16, lens32,
            kmeta, ksfx, kgso, vlens, vgo, vflags, vdict, vblob,
            fdata, rd_raw,
        )
        self._finished = True
        return self.props


def _write_zip_file(w, props, n, vg, meta16, lens32, kmeta, ksfx, kgso,
                    vlens, vgo, vflags, vdict, vblob, filter_data,
                    range_del_raw) -> None:
    """Write the zip-file sections + metaindex + footer (shared by the
    per-entry builder and the vectorized columnar writer, so the two can't
    diverge byte-wise). Mutates props size fields."""
    meta_entries = []
    metaindex = BlockBuilder(restart_interval=1)
    flags = (_FLAG_LENS32 if lens32 else 0) | \
        (_FLAG_HAS_DICT if vdict else 0) | \
        (_FLAG_META16 if meta16 else 0)
    params = b"".join(coding.encode_fixed32(x) for x in (
        _VERSION, GROUP, vg, n, flags,
    ))
    for name, payload in (
        (METAINDEX_PARAMS, params),
        (METAINDEX_KEY_META, kmeta),
        (METAINDEX_KEY_SFX, ksfx),
        (METAINDEX_VAL_LENS, vlens),
        (METAINDEX_VAL_GO, vgo),
        (METAINDEX_VAL_FLAGS, vflags),
        (METAINDEX_VAL_DICT, vdict),
        (METAINDEX_VAL_BLOB, vblob),
    ):
        if name == METAINDEX_VAL_DICT and not vdict:
            continue
        h = fmt.write_block(w, payload, fmt.NO_COMPRESSION)
        meta_entries.append((name, h))
        if name == METAINDEX_VAL_BLOB:
            props.data_size = len(vblob)
    props.num_data_blocks = (n + vg - 1) // vg if n else 0
    if filter_data is not None:
        fh = fmt.write_block(w, filter_data, fmt.NO_COMPRESSION)
        props.filter_size = len(filter_data)
        meta_entries.append((METAINDEX_FILTER, fh))
    if range_del_raw is not None:
        rh = fmt.write_block(w, range_del_raw, fmt.NO_COMPRESSION)
        meta_entries.append((METAINDEX_RANGE_DEL, rh))
    props.index_size = len(kgso)
    pblock = props.encode_block()
    ph = fmt.write_block(w, pblock, fmt.NO_COMPRESSION)
    meta_entries.append((METAINDEX_PROPERTIES, ph))
    for name, handle in sorted(meta_entries):
        metaindex.add(name, handle.encode())
    mih = fmt.write_block(w, metaindex.finish(), fmt.NO_COMPRESSION)
    ih = fmt.write_block(w, kgso, fmt.NO_COMPRESSION)
    w.append(fmt.Footer(mih, ih, magic=fmt.ZIP_MAGIC).encode())
    w.flush()


# The in-memory file view shared with single_fast.
from toplingdb_tpu_torch.table.single_fast import _Mem  # noqa: E402


class ZipTableReader:
    """Same surface as the other readers; the key dictionary and value
    directory stay resident, value groups decompress lazily (cached)."""

    FOOTER_MAGIC = fmt.ZIP_MAGIC

    def __init__(self, rfile, icmp: InternalKeyComparator,
                 options: TableOptions | None = None, block_cache=None,
                 cache_key_prefix: bytes = b""):
        self.opts = options or TableOptions()
        self._icmp = icmp
        size = rfile.size()
        # The file bytes live only for this constructor: every section is
        # copied out below, so keeping them would double resident memory.
        data = rfile.read(0, size)
        rfile.close()
        mem = _Mem(data)
        self.footer = fmt.Footer.decode(data, self.FOOTER_MAGIC)
        meta = fmt.read_block(mem, self.footer.metaindex_handle,
                              self.opts.verify_checksums)
        mit = BlockIter(meta, dbformat.BYTEWISE.compare)
        mit.seek_to_first()
        self._meta_handles = {
            k: fmt.BlockHandle.decode_exact(v) for k, v in mit.entries()
        }
        vc = self.opts.verify_checksums

        def sect(name, required=True):
            h = self._meta_handles.get(name)
            if h is None:
                if required:
                    raise Corruption(f"zip table missing section {name!r}")
                return b""
            return fmt.read_block(mem, h, vc)

        params = sect(METAINDEX_PARAMS)
        if len(params) < 20:
            raise Corruption("zip table params truncated")
        ver = coding.decode_fixed32(params, 0)
        if ver != _VERSION:
            raise Corruption(f"zip table version {ver} unsupported")
        self.G = coding.decode_fixed32(params, 4)
        self.VG = coding.decode_fixed32(params, 8)
        self.n = coding.decode_fixed32(params, 12)
        flags = coding.decode_fixed32(params, 16)
        self._kmeta = np.frombuffer(
            sect(METAINDEX_KEY_META),
            dtype="<u2" if flags & _FLAG_META16 else np.uint8,
        )
        self._ksfx = sect(METAINDEX_KEY_SFX)
        # Group head offsets double as the footer's index block.
        self._kgso = np.frombuffer(
            fmt.read_block(mem, self.footer.index_handle, vc), dtype="<u4")
        self._vlens = np.frombuffer(
            sect(METAINDEX_VAL_LENS),
            dtype="<u4" if flags & _FLAG_LENS32 else "<u2",
        )
        self._vgo = np.frombuffer(sect(METAINDEX_VAL_GO), dtype="<u4")
        self._vflags = np.frombuffer(sect(METAINDEX_VAL_FLAGS),
                                     dtype=np.uint8)
        self._vdict = sect(METAINDEX_VAL_DICT, required=False) \
            if flags & _FLAG_HAS_DICT else b""
        self._vblob = sect(METAINDEX_VAL_BLOB)
        # Per-group suffix start offsets; entry suffix offsets derive from
        # one global exclusive cumsum of slen (kmeta odd bytes).
        slen = self._kmeta[1::2].astype(np.int64)
        self._soff = np.cumsum(slen) - slen
        self.properties = TableProperties()
        ph = self._meta_handles.get(METAINDEX_PROPERTIES)
        if ph is not None:
            self.properties = TableProperties.decode_block(
                fmt.read_block(mem, ph, vc))
        self._filter_data = None
        self._filter_policy = None
        fh = self._meta_handles.get(METAINDEX_FILTER)
        if fh is not None:
            self._filter_data = fmt.read_block(mem, fh, vc)
            self._filter_policy = filter_policy_from_name(
                self.properties.filter_policy_name)
        rh = self._meta_handles.get(METAINDEX_RANGE_DEL)
        self._range_del_data = fmt.read_block(mem, rh, vc) \
            if rh is not None else None
        self._nG = len(self._kgso)
        from toplingdb_tpu_torch.utils.slice_transform import (
            resolve_file_extractor,
        )

        self._resolved_pe = resolve_file_extractor(
            getattr(self.opts, "prefix_extractor", None),
            self.properties.prefix_extractor_name,
        )

    # --- key access ---

    def _head(self, g: int) -> bytes:
        o = int(self._kgso[g])
        return self._ksfx[o: o + int(self._kmeta[2 * g * self.G + 1])]

    def key_at(self, i: int) -> bytes:
        """Decode entry i's internal key (walks its group prefix chain)."""
        g = i // self.G
        base = g * self.G
        k = self._head(g)
        for j in range(base + 1, i + 1):
            pl = int(self._kmeta[2 * j])
            o = int(self._soff[j])
            k = k[:pl] + self._ksfx[o: o + int(self._kmeta[2 * j + 1])]
        return k

    def group_keys(self, g: int) -> list[bytes]:
        """All internal keys of group g, decoded in one pass."""
        base = g * self.G
        end = min(base + self.G, self.n)
        k = self._head(g)
        out = [k]
        for j in range(base + 1, end):
            pl = int(self._kmeta[2 * j])
            o = int(self._soff[j])
            k = k[:pl] + self._ksfx[o: o + int(self._kmeta[2 * j + 1])]
            out.append(k)
        return out

    def _group_for(self, target: bytes) -> int:
        """Last group whose head <= target (internal order), or 0."""
        lo, hi = 0, self._nG - 1
        cmp = self._icmp.compare
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if cmp(self._head(mid), target) <= 0:
                lo = mid
            else:
                hi = mid - 1
        return lo

    # --- value access ---

    def _value_group(self, vg: int) -> tuple[bytes, np.ndarray]:
        """(decoded group payload, in-group exclusive offsets). Stateless —
        the reader is shared across threads via TableCache, so caching
        lives in each (single-threaded) iterator instead."""
        payload = self._vblob[int(self._vgo[vg]): int(self._vgo[vg + 1])]
        if len(self._vflags) and self._vflags[vg // 8] & (1 << (vg % 8)):
            from toplingdb_tpu_torch.utils import codecs

            payload = codecs.zstd_decompress(bytes(payload), self._vdict)
        base = vg * self.VG
        ls = self._vlens[base: base + self.VG].astype(np.int64)
        return payload, np.concatenate([[0], np.cumsum(ls)])

    def value_at(self, i: int) -> bytes:
        """Uncached single-value decode (prefer iterator.value(), which
        caches the group across adjacent reads)."""
        payload, offs = self._value_group(i // self.VG)
        off = int(offs[i % self.VG])
        return bytes(payload[off: off + int(self._vlens[i])])

    # --- reader surface ---

    def key_may_match(self, user_key: bytes) -> bool:
        if self._filter_data is None or self._filter_policy is None:
            return True
        if self.properties.whole_key_filtering:
            return self._filter_policy.key_may_match(user_key,
                                                     self._filter_data)
        pe = self._resolved_pe
        if pe is not None and pe.in_domain(user_key):
            return self._filter_policy.key_may_match(pe.transform(user_key),
                                                     self._filter_data)
        return True

    def new_iterator(self, preread=None) -> "ZipTableIterator":
        """`preread`: the async read plane's preload — {value-group
        ordinal → completion token} whose wait() returns
        `_value_group(vg)`'s result, so mini-group zstd inflates ran on a
        reader ring while the request thread was elsewhere
        (env/async_reads.py)."""
        return ZipTableIterator(self, preload=preread)

    def plan_value_groups(self, seek_ikeys) -> list[int]:
        """The value-group ordinals the entries landed on by each internal
        seek key live in, deduplicated, compressed groups only (the async
        read plane's planner: it preloads these decodes)."""
        out: list[int] = []
        seen: set[int] = set()
        for ik in seek_ikeys:
            i = self.entry_lower_bound(ik)
            if not 0 <= i < self.n:
                continue
            vg = i // self.VG
            if vg in seen:
                continue
            seen.add(vg)
            if len(self._vflags) and self._vflags[vg // 8] & (1 << (vg % 8)):
                out.append(vg)
        return out

    def range_del_entries(self):
        if self._range_del_data is None:
            return []
        it = BlockIter(self._range_del_data, self._icmp.compare)
        it.seek_to_first()
        return list(it.entries())

    def approximate_offset_of(self, ikey: bytes) -> int:
        if not self.n:
            return 0
        g = self._group_for(ikey)
        return int(self._vgo[min(g * self.G // self.VG,
                                 len(self._vgo) - 1)])

    def anchors(self, max_anchors: int = 32):
        if not self.n:
            return []
        step = max(1, self.n // max_anchors)
        return [self.key_at(i)
                for i in range(0, self.n, step)][:max_anchors]

    # --- batched data-plane surface (native kernels) ---

    def scan_native_ready(self) -> bool:
        """True when scan_columnar can run (the native library is there
        and the file holds entries)."""
        from toplingdb_tpu_torch import native

        return bool(self.n) and native.lib() is not None

    def _scan_sections(self):
        """Zero-copy u8 views over the resident sections plus per-entry
        key-length cumsums — the operands the native kernels take. Built
        once; the views pin the backing bytes for the handle's lifetime."""
        s = getattr(self, "_scan_sect", None)
        if s is None:
            def u8(b):
                a = (b.view(np.uint8) if isinstance(b, np.ndarray)
                     else np.frombuffer(b, dtype=np.uint8))
                return a if len(a) else np.zeros(1, dtype=np.uint8)

            kl = (self._kmeta[0::2].astype(np.int64)
                  + self._kmeta[1::2].astype(np.int64))
            s = {
                "kmeta": u8(self._kmeta), "ksfx": u8(self._ksfx),
                "kgso": u8(self._kgso), "vlens": u8(self._vlens),
                "vgo": u8(self._vgo), "vflags": u8(self._vflags),
                "vdict": u8(self._vdict), "vblob": u8(self._vblob),
                "kcum": np.concatenate([[0], np.cumsum(kl)]),
            }
            self._scan_sect = s
        return s

    def entry_lower_bound(self, target: bytes) -> int:
        """First entry index whose internal key >= target (n past end)."""
        if not self.n:
            return 0
        g = self._group_for(target)
        base = g * self.G
        cmp = self._icmp.compare
        for j, k in enumerate(self.group_keys(g)):
            if cmp(k, target) >= 0:
                return base + j
        return min(base + self.G, self.n)

    def scan_columnar(self, e0: int, e1: int):
        """Bulk-decode entries [e0, e1) into columnar slabs: (key_buf,
        key_offs, key_lens, val_buf, val_offs, val_lens), int64 offsets
        into the two uint8 slabs. Values come straight out of compressed
        groups via tpulsm_zip_group_decode — no whole-file inflate, no
        per-entry Python. Callers gate on scan_native_ready()."""
        from toplingdb_tpu_torch import native
        from toplingdb_tpu_torch.utils import telemetry as tele

        lib = native.lib()
        if lib is None:
            raise NotSupported("native library unavailable")
        s = self._scan_sections()
        e0 = max(0, int(e0))
        e1 = min(self.n, int(e1))
        cnt = e1 - e0
        if cnt <= 0:
            z8 = np.zeros(0, dtype=np.uint8)
            z64 = np.zeros(0, dtype=np.int64)
            return z8, z64, z64, z8, z64, z64
        kcap = int(s["kcum"][e1] - s["kcum"][e0])
        key_out = np.empty(kcap, dtype=np.uint8)
        key_offs = np.empty(cnt, dtype=np.int64)
        key_lens = np.empty(cnt, dtype=np.int64)
        rc = lib.tpulsm_zip_decode_keys(
            native.np_u8p(s["kmeta"]), self._kmeta.nbytes,
            1 if self._kmeta.dtype.itemsize == 2 else 0,
            native.np_u8p(s["ksfx"]), len(self._ksfx),
            native.np_u8p(s["kgso"]), self._kgso.nbytes, self.n, self.G,
            e0, e1, native.np_u8p(key_out), kcap, native.np_i64p(key_offs),
            native.np_i64p(key_lens), 0)
        if rc != kcap:
            raise Corruption(f"zip key decode failed (rc={rc})")
        g0 = e0 // self.VG
        g1 = (e1 + self.VG - 1) // self.VG
        first = g0 * self.VG
        last = min(g1 * self.VG, self.n)
        ls = self._vlens[first:last].astype(np.int64)
        gsz = np.add.reduceat(ls, np.arange(0, len(ls), self.VG))
        raw_offs = np.ascontiguousarray(
            np.concatenate([[0], np.cumsum(gsz)]), dtype=np.int64)
        vcap = int(raw_offs[-1])
        val_out = np.empty(max(1, vcap), dtype=np.uint8)
        with tele.span("zip.group_decode", groups=g1 - g0, nbytes=vcap):
            rc2 = lib.tpulsm_zip_group_decode(
                native.np_u8p(s["vblob"]), len(self._vblob),
                native.np_u8p(s["vgo"]), self._vgo.nbytes,
                native.np_u8p(s["vflags"]), self._vflags.nbytes,
                native.np_u8p(s["vdict"]), len(self._vdict), g0, g1,
                native.np_i64p(raw_offs), native.np_u8p(val_out), vcap)
        if rc2 != vcap:
            raise Corruption(f"zip group decode failed (rc={rc2})")
        voff_all = np.cumsum(ls) - ls
        val_offs = np.ascontiguousarray(voff_all[e0 - first: e1 - first])
        val_lens = np.ascontiguousarray(ls[e0 - first: e1 - first])
        return (key_out, key_offs, key_lens, val_out[:vcap], val_offs,
                val_lens)

    def native_get_handle(self, smallest_uk: bytes, largest_uk: bytes):
        """Handle for the native point-read chain. Unlike the block reader
        (which hands C an index copy and an fd), the zip sections are
        BORROWED by C: the finalize closure pins them until
        tpulsm_table_handle_free runs. Ineligible tables (range tombstones,
        a comparator that is not bytewise, an empty file) get an
        eligible=0 handle, so the chain walk falls back on contact. None
        when the native library is unavailable."""
        h = getattr(self, "_nget_handle", False)
        if h is not False:
            return h
        import ctypes
        import weakref

        from toplingdb_tpu_torch import native
        from toplingdb_tpu_torch.table.reader import _NGET_ID

        cl = native.lib()
        if cl is None:
            self._nget_handle = None
            return None
        eligible = (
            self.n > 0
            and self._range_del_data is None
            and self._icmp.user_comparator.name()
            == "tpulsm.BytewiseComparator"
        )
        filt = b""
        filter_kind = 0
        fname = str(self.properties.filter_policy_name)
        if (eligible and self._filter_data is not None
                and self.properties.whole_key_filtering):
            if fname.startswith("tpulsm.BloomFilter"):
                filt = self._filter_data
            elif fname.startswith("tpulsm.BlockedBloom"):
                filt = self._filter_data
                filter_kind = 1
        u8 = ctypes.POINTER(ctypes.c_uint8)

        def buf(b):
            return ctypes.cast(ctypes.c_char_p(bytes(b)), u8)

        keep = None
        if eligible:
            s = self._scan_sections()
            keep = (s, filt)
            h = cl.tpulsm_zip_table_handle_new(
                next(_NGET_ID), 1 | (filter_kind << 1), self.G, self.VG,
                self.n, 1 if self._kmeta.dtype.itemsize == 2 else 0,
                1 if self._vlens.dtype.itemsize == 4 else 0,
                native.np_u8p(s["kmeta"]), self._kmeta.nbytes,
                native.np_u8p(s["ksfx"]), len(self._ksfx),
                native.np_u8p(s["kgso"]), self._kgso.nbytes,
                native.np_u8p(s["vlens"]), self._vlens.nbytes,
                native.np_u8p(s["vgo"]), self._vgo.nbytes,
                native.np_u8p(s["vflags"]), self._vflags.nbytes,
                native.np_u8p(s["vdict"]), len(self._vdict),
                native.np_u8p(s["vblob"]), len(self._vblob),
                buf(filt), len(filt),
                buf(smallest_uk), len(smallest_uk),
                buf(largest_uk), len(largest_uk),
            )
        else:
            h = cl.tpulsm_zip_table_handle_new(
                next(_NGET_ID), 0, 0, 0, 0, 0, 0,
                None, 0, None, 0, None, 0, None, 0, None, 0, None, 0,
                None, 0, None, 0, None, 0,
                buf(smallest_uk), len(smallest_uk),
                buf(largest_uk), len(largest_uk),
            )
        h = h or None
        self._nget_handle = h
        if h:
            weakref.finalize(self, _zip_handle_free,
                             cl.tpulsm_table_handle_free, h, keep)
        return h

    def close(self) -> None:
        pass


def _zip_handle_free(free_fn, h, _sections):
    # _sections pins the buffers C borrowed until the handle dies with it
    free_fn(h)


class ZipTableIterator:
    """Forward/backward iterator over one ZipTable (TableIterator shape)."""

    def __init__(self, r: ZipTableReader, preload: dict | None = None):
        self._r = r
        self._i = r.n
        self._gkeys: list[bytes] = []
        self._g = -1
        self._vg = -1
        self._vg_payload: bytes = b""
        self._vg_offs: np.ndarray | None = None
        # {vg → token} of ring-side _value_group decodes (async plane);
        # each consumed once, then the sync decode path takes over.
        self._preload = preload

    def _load(self, g: int) -> None:
        if g != self._g:
            self._gkeys = self._r.group_keys(g)
            self._g = g

    def valid(self) -> bool:
        return 0 <= self._i < self._r.n

    def key(self) -> bytes:
        self._load(self._i // self._r.G)
        return self._gkeys[self._i % self._r.G]

    def value(self) -> bytes:
        r = self._r
        vg = self._i // r.VG
        if vg != self._vg:
            tok = self._preload.pop(vg, None) if self._preload else None
            if tok is not None:
                self._vg_payload, self._vg_offs = tok.wait()
            else:
                self._vg_payload, self._vg_offs = r._value_group(vg)
            self._vg = vg
        off = int(self._vg_offs[self._i % r.VG])
        return bytes(
            self._vg_payload[off: off + int(r._vlens[self._i])])

    def seek_to_first(self) -> None:
        self._i = 0

    def seek_to_last(self) -> None:
        self._i = self._r.n - 1

    def seek(self, target: bytes) -> None:
        r = self._r
        if not r.n:
            self._i = 0
            return
        g = r._group_for(target)
        self._load(g)
        cmp = r._icmp.compare
        base = g * r.G
        lo, hi = 0, len(self._gkeys)
        while lo < hi:
            mid = (lo + hi) // 2
            if cmp(self._gkeys[mid], target) < 0:
                lo = mid + 1
            else:
                hi = mid
        # lo == len(gkeys) lands on the next group's head ordinal, which is
        # > target by _group_for's choice; head(0) > target leaves i at 0.
        self._i = base + lo

    def seek_for_prev(self, target: bytes) -> None:
        self.seek(target)
        if not self.valid():
            self.seek_to_last()
            return
        if self._r._icmp.compare(self.key(), target) > 0:
            self.prev()

    def seek_ordinal(self, i: int) -> None:
        self._i = i

    def next(self) -> None:
        self._i += 1

    def prev(self) -> None:
        self._i -= 1

    def entries(self):
        while self.valid():
            yield self.key(), self.value()
            self.next()


def _zip_encode_segment_native(lib, kv, rows, ko_seg, ov_seg, fvl, K, n, vg,
                               compress, copts, meta16):
    """One output segment through the tpulsm_zip_* kernels. Returns the
    encoded sections (kmeta, ksfx, kgso, vlens, vgo, vblob, vflags, zdict,
    lens32), bit-identical to the numpy encoder of write_tables_zip_columnar
    (parity-tested). A kernel that declines raises Corruption: nothing
    switches encoders behind the caller's back."""
    from toplingdb_tpu_torch import native
    from toplingdb_tpu_torch.utils import telemetry as tele

    ko_seg = np.ascontiguousarray(ko_seg, dtype=np.int64)
    ov_seg = np.ascontiguousarray(ov_seg, dtype=np.int64)
    fvl = np.ascontiguousarray(fvl, dtype=np.int64)
    meta_out = np.empty(n * (4 if meta16 else 2), dtype=np.uint8)
    sfx_cap = n * K
    sfx_out = np.empty(max(1, sfx_cap), dtype=np.uint8)
    ngk = (n + GROUP - 1) // GROUP
    gso_out = np.empty(4 * ngk, dtype=np.uint8)
    with tele.span("zip.index_build", rows=n, groups=ngk):
        rc = lib.tpulsm_zip_encode_keys(
            native.np_u8p(kv.key_buf), len(kv.key_buf),
            native.np_i64p(ko_seg), n, K, native.np_i64p(ov_seg), GROUP,
            1 if meta16 else 0, native.np_u8p(meta_out),
            native.np_u8p(sfx_out), sfx_cap, native.np_u8p(gso_out))
    if rc < 0:
        raise Corruption(f"native zip key encode failed (rc={rc})")
    voffs = np.ascontiguousarray(kv.val_offs[rows], dtype=np.int64)
    total_v = int(fvl.sum())
    ngv = (n + vg - 1) // vg
    mdb = int(getattr(copts, "max_dict_bytes", 0) or 0)
    lvl = copts.level if copts.level is not None else 3
    dict_out = np.zeros(max(1, mdb), dtype=np.uint8)
    blob_out = np.empty(max(1, total_v), dtype=np.uint8)
    go_out = np.empty(4 * (ngv + 1), dtype=np.uint8)
    flags_out = np.zeros((ngv + 7) // 8, dtype=np.uint8)
    om = np.zeros(2, dtype=np.int64)
    vb = kv.val_buf if len(kv.val_buf) else np.zeros(1, dtype=np.uint8)
    with tele.span("zip.encode", rows=n, groups=ngv,
                   compress=1 if compress else 0):
        rc2 = lib.tpulsm_zip_encode_values(
            native.np_u8p(vb), len(kv.val_buf), native.np_i64p(voffs),
            native.np_i64p(fvl), n, vg, 1 if compress else 0, int(lvl),
            mdb, native.np_u8p(dict_out), len(dict_out),
            native.np_u8p(blob_out), total_v, native.np_u8p(go_out),
            native.np_u8p(flags_out), native.np_i64p(om))
    if rc2 != ngv:
        raise Corruption(f"native zip value encode failed (rc={rc2}, "
                         f"{ngv} groups)")
    lens32 = bool((fvl >= 1 << 16).any())
    vlens = fvl.astype("<u4" if lens32 else "<u2").tobytes()
    return (meta_out.tobytes(), sfx_out[:rc].tobytes(), gso_out.tobytes(),
            vlens, go_out.tobytes(), blob_out[: int(om[0])].tobytes(),
            flags_out.tobytes(), dict_out[: int(om[1])].tobytes(),
            lens32)


def write_tables_zip_columnar(env, dbname, new_file_number, icmp, options,
                              kv, order, trailer_override, vtypes, seqs,
                              creation_time: int,
                              max_output_file_size: int = 2 ** 62,
                              column_family=(0, "default"), tombstones=(),
                              zip_plane: bool = True):
    """Vectorized ZipTable emission from columnar buffers and a survivor
    order — the zip-format counterpart of write_tables_columnar (the same
    arguments), so device compactions emit searchable-compressed
    bottommost files without a per-entry Python loop. Byte-identical to
    feeding ZipTableBuilder the same stream through build_outputs (cut
    rule included). `order` may be an iterator of chunks (the pipeline):
    the feed is drained before anything is encoded. `zip_plane=True` runs
    the native zip plane, which raises Corruption on any failure;
    `zip_plane=False` runs the numpy encoders. Uniform key length only,
    and no prefix extractor or collectors: NotSupported otherwise (the
    caller takes the per-entry route)."""
    from toplingdb_tpu_torch import native
    from toplingdb_tpu_torch.db import filename as _fn
    from toplingdb_tpu_torch.utils import codecs

    if getattr(options, "prefix_extractor", None) is not None:
        raise NotSupported("zip columnar writer: prefix extractors use the "
                           "per-entry path")
    if getattr(options, "properties_collector_factories", None):
        raise NotSupported("zip columnar writer: collectors use the "
                           "per-entry path")
    if not isinstance(order, np.ndarray):
        # Pipelined callers stream order chunks; the zip encoders work on
        # whole segments, so drain the feed first (the scan/merge stages
        # upstream still overlap with THIS call's encode work).
        chunks = [np.asarray(c, dtype=np.int64) for c in order]
        order = (np.concatenate(chunks) if chunks
                 else np.empty(0, np.int64))
    order = np.ascontiguousarray(order, dtype=np.int64)
    m = len(order)
    if m == 0 and not tombstones:
        return []
    lib = native.lib()
    if zip_plane and lib is None:
        raise NotSupported("native library unavailable")
    use_native = zip_plane
    mat = None

    def _build_mat():
        # internal-key matrix with trailer overrides applied (Python
        # encoder path only; the native kernels patch trailers on the fly)
        nonlocal mat
        if mat is not None:
            return mat
        mat = kv.key_buf[ko[:, None] + np.arange(K)]
        has_ov = ov >= 0
        if has_ov.any():
            tb = (ov[:, None] >> (8 * np.arange(8))) & 0xFF
            mat[has_ov, K - 8:] = tb[has_ov].astype(np.uint8)
        return mat

    if m:
        if int(kv.key_lens.min()) != int(kv.key_lens.max()):
            raise NotSupported("zip columnar writer requires uniform keys")
        K = int(kv.key_lens[0])
        if K >= 1 << 16:
            raise NotSupported("zip table keys are capped at 64KiB")
        ko = kv.key_offs[order].astype(np.int64)
        ov = trailer_override[order]
        vl = kv.val_lens[order].astype(np.int64)
        cum = np.cumsum(K + vl + 4)  # builder.file_size() approximation
        newkey = np.ones(m, dtype=bool)
        if m > 1:
            if use_native:
                nk8 = np.empty(m, dtype=np.uint8)
                rc = lib.tpulsm_zip_newkey(
                    native.np_u8p(kv.key_buf), len(kv.key_buf),
                    native.np_i64p(ko), m, K - 8, native.np_u8p(nk8))
                if rc != m:
                    raise Corruption(
                        f"native zip newkey scan failed (rc={rc})")
                newkey = nk8.view(bool)
            else:
                _build_mat()
                newkey[1:] = (mat[1:, : K - 8]
                              != mat[:-1, : K - 8]).any(axis=1)
        nk_pos = np.flatnonzero(newkey)
    else:
        K = 0

    can_cut = m > 0 and not tombstones
    cuts = [0]
    if can_cut:
        s = 0
        while True:
            base = cum[s - 1] if s else 0
            i0 = int(np.searchsorted(cum, base + max_output_file_size,
                                     side="left")) + 1
            if i0 >= m:
                break
            j = int(np.searchsorted(nk_pos, i0, side="left"))
            if j >= len(nk_pos):
                break
            s = int(nk_pos[j])
            cuts.append(s)
    cuts.append(m)

    results = []
    written = []
    try:
        for fi in range(len(cuts) - 1):
            lo, hi = cuts[fi], cuts[fi + 1]
            rows = order[lo:hi]
            seg = slice(lo, hi)
            n = hi - lo
            props = TableProperties(
                comparator_name=icmp.user_comparator.name(),
                filter_policy_name=(
                    options.filter_policy.name() if options.filter_policy
                    else ""
                ),
                compression_name="zip",
                column_family_id=column_family[0],
                column_family_name=column_family[1],
                creation_time=creation_time,
                smallest_seqno=dbformat.MAX_SEQUENCE_NUMBER,
                whole_key_filtering=1 if options.whole_key_filtering else 0,
            )
            if n:
                fvl = vl[seg]
                meta16 = K > 255
                total_v = int(fvl.sum())
                props.raw_key_size = n * K
                props.raw_value_size = total_v
                avg = total_v // n
                vg = max(1, min(256, VALUE_GROUP_TARGET // max(1, avg)))
                copts = getattr(options, "compression_opts", None) \
                    or CompressionOptions()
                compress = (options.compression != fmt.NO_COMPRESSION
                            and codecs.available("zstd"))
                if use_native:
                    enc = _zip_encode_segment_native(
                        lib, kv, rows, ko[seg], ov[seg], fvl, K, n, vg,
                        compress, copts, meta16)
                    (kmeta, ksfx, kgso_b, vlens, vgo, vblob, vflags_b,
                     zdict, lens32) = enc
                    smallest = kv.key_buf[
                        int(ko[lo]): int(ko[lo]) + K].tobytes()
                    largest = kv.key_buf[
                        int(ko[hi - 1]): int(ko[hi - 1]) + K].tobytes()
                    t0, tn = int(ov[lo]), int(ov[hi - 1])
                    if t0 >= 0:
                        smallest = (smallest[: K - 8]
                                    + t0.to_bytes(8, "little"))
                    if tn >= 0:
                        largest = (largest[: K - 8]
                                   + tn.to_bytes(8, "little"))
                else:
                    fmat = _build_mat()[seg]
                    # --- keys: front-coded groups of GROUP ---
                    pl = np.zeros(n, dtype=np.int64)
                    if n > 1:
                        eq = fmat[1:] == fmat[:-1]
                        all_eq = eq.all(axis=1)
                        pl[1:] = np.where(all_eq, K,
                                          np.argmin(eq, axis=1))
                    pl[np.arange(0, n, GROUP)] = 0
                    slen = K - pl
                    meta = np.empty(2 * n,
                                    dtype="<u2" if meta16 else np.uint8)
                    meta[0::2] = pl
                    meta[1::2] = slen
                    sfx = fmat[np.arange(K)[None, :] >= pl[:, None]]
                    soff = np.cumsum(slen) - slen
                    kgso = soff[::GROUP].astype("<u4")
                    # --- values (order-gathered flat bytes, VG groups) ---
                    if total_v:
                        vpos = np.repeat(
                            kv.val_offs[rows].astype(np.int64), fvl
                        ) + (np.arange(total_v)
                             - np.repeat(np.cumsum(fvl) - fvl, fvl))
                        ordered_v = kv.val_buf[vpos]
                    else:
                        ordered_v = np.zeros(0, dtype=np.uint8)
                    gb = np.concatenate([[0], np.cumsum(np.add.reduceat(
                        fvl, np.arange(0, n, vg)))]).astype(np.int64) \
                        if n else np.zeros(1, np.int64)
                    groups = [
                        ordered_v[gb[i]: gb[i + 1]].tobytes()
                        for i in range(len(gb) - 1)
                    ]
                    zdict = b""
                    if (compress and copts.max_dict_bytes > 0
                            and len(groups) >= 8):
                        zdict = codecs.zstd_train_dictionary(
                            groups[:: max(1, len(groups) // 256)]
                            or groups,
                            copts.max_dict_bytes,
                        )
                    blob = bytearray()
                    go = [0]
                    vflags = bytearray((len(groups) + 7) // 8)
                    if compress:
                        from concurrent.futures import ThreadPoolExecutor

                        lvl = copts.level if copts.level is not None else 3
                        with ThreadPoolExecutor(8) as ex:
                            zs = list(ex.map(
                                lambda raw: codecs.zstd_compress(
                                    raw, lvl, zdict)
                                if len(raw) >= 32 else None, groups))
                    else:
                        zs = [None] * len(groups)
                    for gi, raw in enumerate(groups):
                        payload = raw
                        z = zs[gi]
                        if z is not None and len(z) < len(raw):
                            payload = z
                            vflags[gi // 8] |= 1 << (gi % 8)
                        blob += payload
                        go.append(len(blob))
                    lens32 = bool((fvl >= 1 << 16).any())
                    vlens = fvl.astype(
                        "<u4" if lens32 else "<u2").tobytes()
                    smallest = fmat[0].tobytes()
                    largest = fmat[-1].tobytes()
                    kmeta = meta.tobytes()
                    ksfx = sfx.tobytes()
                    kgso_b = kgso.tobytes()
                    vgo = np.asarray(go, dtype="<u4").tobytes()
                    vblob = bytes(blob)
                    vflags_b = bytes(vflags)
                if compress:
                    props.compression_name = "zip+zstd"
                # --- stats ---
                vt = vtypes[rows]
                props.num_entries = n
                props.num_deletions = int(np.count_nonzero(
                    (vt == int(ValueType.DELETION))
                    | (vt == int(ValueType.SINGLE_DELETION))))
                props.num_merge_operands = int(np.count_nonzero(
                    vt == int(ValueType.MERGE)))
                sq = seqs[rows]
                props.smallest_seqno = int(sq.min())
                props.largest_seqno = int(sq.max())
                # --- bloom (native build, byte-identical to the python
                # policy per the block-format parity tests) ---
                fdata = None
                bp = options.filter_policy
                if bp is not None and options.whole_key_filtering and lib:
                    from toplingdb_tpu_torch.table.filter import (
                        build_filter_block_native,
                    )

                    fdata = build_filter_block_native(
                        lib, bp, kv.key_buf, kv.key_offs[rows],
                        np.full(n, K - 8, dtype=np.int32), n)
            else:
                # Parity with ZipTableBuilder on an entry-less file: its
                # _encode_values computes avg=1 -> vg=256, and its seqno
                # bounds stay at the MAX sentinel until add_tombstone
                # narrows them (finish leaves them if tombstones exist).
                meta16 = lens32 = False
                vg = 256
                kmeta = ksfx = kgso_b = vblob = vflags_b = b""
                vlens = b""
                vgo = np.asarray([0], dtype="<u4").tobytes()
                zdict = b""
                fdata = None
                smallest = largest = None
                props.smallest_seqno = dbformat.MAX_SEQUENCE_NUMBER
                props.largest_seqno = 0
                if (options.compression != fmt.NO_COMPRESSION
                        and codecs.available("zstd")):
                    props.compression_name = "zip+zstd"
            # tombstones ride the LAST file (single output when present)
            rd_raw = None
            file_tombs = tombstones if fi == len(cuts) - 2 else []
            if file_tombs:
                rdb = BlockBuilder(restart_interval=1)
                for frag in file_tombs:
                    b, e = frag.to_table_entry()
                    rdb.add(b, e)
                    props.num_range_deletions += 1
                    if smallest is None or icmp.compare(b, smallest) < 0:
                        smallest = b
                    end_ikey = dbformat.make_internal_key(
                        e, dbformat.MAX_SEQUENCE_NUMBER,
                        dbformat.VALUE_TYPE_FOR_SEEK)
                    if largest is None or icmp.compare(end_ikey, largest) > 0:
                        largest = end_ikey
                    props.smallest_seqno = min(props.smallest_seqno,
                                               frag.seq)
                    props.largest_seqno = max(props.largest_seqno, frag.seq)
                rd_raw = rdb.finish()
            if n == 0 and rd_raw is None:
                continue
            fnum = new_file_number()
            path = _fn.table_file_name(dbname, fnum)
            w = env.new_writable_file(path)
            written.append(path)
            _write_zip_file(w, props, n, vg, meta16, lens32,
                            kmeta, ksfx, kgso_b, vlens, vgo, vflags_b,
                            zdict, vblob, fdata, rd_raw)
            w.sync()
            w.close()
            results.append((fnum, path, props, smallest, largest,
                            rows if n else np.empty(0, np.int64)))
        return results
    except BaseException:
        for p in written:
            try:
                env.delete_file(p)
            except OSError:
                pass  # best-effort cleanup; the job's own error propagates
        raise
