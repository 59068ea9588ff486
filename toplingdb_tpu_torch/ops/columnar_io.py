"""Columnar SST IO: native bulk decode and native table building (copied
from toplingdb_tpu/ops/columnar_io.py). The scans read block-based inputs,
with a flat or two-level index; other formats raise NotSupported (the
caller takes the per-entry route). The writer writes block-based tables
with a binary index and, as the reference's does, one whole-key filter
(no prefix keys, no filter partitions) whatever `prefix_extractor` and
`partition_filters` say.

The host halves of the device compaction data plane: whole-file scans into
flat buffers through the C++ block decoder (snappy and zstd blocks inflate
inside it; dictionary frames and the other codecs inflate in Python
threads), and output building through the C++ data-section and index-block
builders plus the native bloom fill — no per-entry Python. Snappy and zstd
sections compress natively; a ZSTD dictionary and the other codecs take
the per-block path (native block build, Python codecs, optionally on a
thread pool). `write_tables_columnar` cuts outputs at a user-key boundary
once a file's written bytes reach max_output_file_size, exactly as the
reference writer does, so both packages write the same bytes for the same
job.
"""

from __future__ import annotations

import numpy as np

from toplingdb_tpu_torch import native
from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.block import BlockBuilder
from toplingdb_tpu_torch.table.builder import (
    METAINDEX_COMPRESSION_DICT,
    METAINDEX_FILTER,
    METAINDEX_PROPERTIES,
    METAINDEX_RANGE_DEL,
)
from toplingdb_tpu_torch.table.properties import TableProperties
from toplingdb_tpu_torch.utils.status import Corruption, NotSupported

# Soft per-native-call output budget for the bulk block builder: bounds the
# section buffer and the transient Python copy on arbitrarily large jobs.
_SECTION_RUN_BYTES = 8 << 20


class ColumnarKV:
    """Flat-buffer view of N (internal_key, value) entries."""

    __slots__ = ("key_buf", "key_offs", "key_lens", "val_buf", "val_offs",
                 "val_lens", "n")

    def __init__(self, key_buf, key_offs, key_lens, val_buf, val_offs,
                 val_lens):
        self.key_buf = key_buf
        self.key_offs = key_offs
        self.key_lens = key_lens
        self.val_buf = val_buf
        self.val_offs = val_offs
        self.val_lens = val_lens
        self.n = len(key_offs)

    def ikey(self, i: int) -> bytes:
        o = self.key_offs[i]
        return self.key_buf[o: o + self.key_lens[i]].tobytes()

    def value(self, i: int) -> bytes:
        o = self.val_offs[i]
        return self.val_buf[o: o + self.val_lens[i]].tobytes()

    @staticmethod
    def concat(parts: list["ColumnarKV"]) -> "ColumnarKV":
        if len(parts) == 1:
            return parts[0]
        key_buf = np.concatenate([p.key_buf for p in parts])
        val_buf = np.concatenate([p.val_buf for p in parts])
        ko, vo = [], []
        k_shift = 0
        v_shift = 0
        for p in parts:
            ko.append(p.key_offs + k_shift)
            vo.append(p.val_offs + v_shift)
            k_shift += len(p.key_buf)
            v_shift += len(p.val_buf)
        return ColumnarKV(
            key_buf, np.concatenate(ko),
            np.concatenate([p.key_lens for p in parts]),
            val_buf, np.concatenate(vo),
            np.concatenate([p.val_lens for p in parts]),
        )


def _file_scan_prologue(reader):
    """Per-file scan setup: the whole raw file image plus the data block
    handles as arrays — (raw, block_offs, block_lens), or (None, None, None)
    for an empty file."""
    idx = reader.new_index_iterator()  # flat or two-level
    idx.seek_to_first()
    handles = [
        fmt.BlockHandle.decode_exact(enc) for _, enc in idx.entries()
    ]
    if not handles:
        return None, None, None
    raw = reader._f.read(0, reader._f.size())
    block_offs = np.array([h.offset for h in handles], dtype=np.int64)
    block_lens = np.array([h.size for h in handles], dtype=np.int64)
    return raw, block_offs, block_lens


def scan_tables_columnar_prealloc(readers):
    """Scan EVERY input file into ONE preallocated pair of columnar
    buffers, sized exactly from each file's TableProperties
    (raw_key_size/raw_value_size/num_entries). Returns (kv, parts) where kv
    spans all files and parts[i] is a ZERO-COPY per-file view — or None
    when ineligible (properties absent or wrong, a codec the native scan
    does not inflate, dictionary-compressed files, >int32 buffers); the
    caller then scans file by file."""
    lib = native.lib()
    if lib is None:
        return None
    infos = []
    tk = tv = tn = 0
    for r in readers:
        if not hasattr(r, "new_index_iterator"):
            return None  # not a block-based table
        if r._compression_dict:
            # Dictionary frames need the stored dictionary, which the
            # native scan does not carry: the per-file path does.
            return None
        p = r.properties
        ne, rk, rv = int(p.num_entries), int(p.raw_key_size), int(
            p.raw_value_size)
        if ne < 0 or rk < 0 or rv < 0 or (ne > 0 and rk == 0):
            return None
        infos.append((ne, rk, rv))
        tk += rk
        tv += rv
        tn += ne
    if tk > 0x7FFFFF00 or tv > 0x7FFFFF00:
        return None
    key_buf = np.empty(tk, dtype=np.uint8)
    val_buf = np.empty(tv, dtype=np.uint8)
    key_offs = np.empty(tn, dtype=np.int32)
    key_lens = np.empty(tn, dtype=np.int32)
    val_offs = np.empty(tn, dtype=np.int32)
    val_lens = np.empty(tn, dtype=np.int32)

    bases = []
    kb = vb = nb = 0
    for ne, rk, rv in infos:
        bases.append((nb, kb, vb))
        nb += ne
        kb += rk
        vb += rv

    import ctypes as _ct

    def scan_one(i):
        r = readers[i]
        ne, rk, rv = infos[i]
        if ne == 0:
            return 0
        n_base, k_base, v_base = bases[i]
        raw, b_offs, b_lens = _file_scan_prologue(r)
        if raw is None:
            return -100
        rawb = np.frombuffer(raw, dtype=np.uint8)
        return lib.tpulsm_scan_blocks(
            native.np_u8p(rawb), len(rawb),
            native.np_i64p(b_offs), native.np_i64p(b_lens), len(b_offs),
            1 if r.opts.verify_checksums else 0,
            _ct.cast(key_buf.ctypes.data + k_base,
                     _ct.POINTER(_ct.c_uint8)), rk,
            _ct.cast(val_buf.ctypes.data + v_base,
                     _ct.POINTER(_ct.c_uint8)), rv,
            _ct.cast(key_offs.ctypes.data + 4 * n_base,
                     _ct.POINTER(_ct.c_int32)),
            _ct.cast(key_lens.ctypes.data + 4 * n_base,
                     _ct.POINTER(_ct.c_int32)),
            _ct.cast(val_offs.ctypes.data + 4 * n_base,
                     _ct.POINTER(_ct.c_int32)),
            _ct.cast(val_lens.ctypes.data + 4 * n_base,
                     _ct.POINTER(_ct.c_int32)),
            ne, k_base, v_base,
        )

    if len(readers) > 1:
        from concurrent.futures import ThreadPoolExecutor

        # The native decoder runs GIL-free under ctypes.
        with ThreadPoolExecutor(min(8, len(readers))) as ex:
            rcs = list(ex.map(scan_one, range(len(readers))))
    else:
        rcs = [scan_one(0)] if readers else []
    for i, rc in enumerate(rcs):
        if rc == -6:
            raise Corruption("block checksum mismatch (fused scan)")
        if rc == -8:
            raise Corruption("block decode/decompress failed (fused scan)")
        if rc != infos[i][0]:
            # Entry-count disagreement with the properties, or a codec the
            # native scan does not inflate: the per-file path decides.
            return None
    kv = ColumnarKV(key_buf, key_offs, key_lens, val_buf, val_offs, val_lens)
    parts = []
    for i, (ne, rk, rv) in enumerate(infos):
        n_base, k_base, v_base = bases[i]
        parts.append(ColumnarKV(
            key_buf[k_base:k_base + rk],
            key_offs[n_base:n_base + ne] - np.int32(k_base),
            key_lens[n_base:n_base + ne],
            val_buf[v_base:v_base + rv],
            val_offs[n_base:n_base + ne] - np.int32(v_base),
            val_lens[n_base:n_base + ne],
        ))
    return kv, parts


def scan_table_columnar(reader) -> ColumnarKV:
    """Whole-file bulk scan through the native block decoder. Uncompressed
    files decode in ONE native call over the raw file bytes, values
    REFERENCED into the file image (the image stays alive as val_buf) and
    keys copied; the value-copying decode decides where that is
    ineligible. Compressed files inflate first: snappy and zstd blocks in
    one multi-threaded native call into a synthetic uncompressed image,
    dictionary frames and the other codecs through `fmt.decompress` on
    Python threads; then the same bulk decode."""
    lib = native.lib()
    if lib is None:
        raise NotSupported("native library unavailable")
    if not hasattr(reader, "new_index_iterator"):
        raise NotSupported("bulk columnar scan requires the block format")
    raw, block_offs, block_lens = _file_scan_prologue(reader)
    if raw is None:
        return ColumnarKV(
            np.zeros(0, np.uint8), np.zeros(0, np.int32),
            np.zeros(0, np.int32), np.zeros(0, np.uint8),
            np.zeros(0, np.int32), np.zeros(0, np.int32),
        )
    verify = reader.opts.verify_checksums
    kv = _refvals_decode(lib, raw, block_offs, block_lens, verify)
    if kv is not None:
        return kv
    kv = _bulk_decode(lib, raw, block_offs, block_lens, verify)
    if kv is not None:
        return kv

    n_blocks = len(block_offs)
    cdict = reader._compression_dict
    if not cdict:
        rawb = np.frombuffer(bytes(raw), dtype=np.uint8)
        out_cap = 4 * int(block_lens.sum()) + 5 * n_blocks + 4096
        out_offs = np.empty(n_blocks, dtype=np.int64)
        out_lens = np.empty(n_blocks, dtype=np.int64)
        for _ in range(4):
            out = np.empty(out_cap, dtype=np.uint8)
            rc = lib.tpulsm_inflate_blocks(
                native.np_u8p(rawb), len(rawb),
                native.np_i64p(block_offs), native.np_i64p(block_lens),
                n_blocks, 1 if verify else 0,
                native.np_u8p(out), out_cap,
                native.np_i64p(out_offs), native.np_i64p(out_lens),
            )
            if rc == -2:
                out_cap *= 4
                continue
            break
        if rc == -6:
            raise Corruption("block checksum mismatch (native inflate)")
        if rc == -3:
            raise Corruption("block decompression failed (native inflate)")
        if rc > 0:
            kv = _bulk_decode(lib, out[: int(rc)], out_offs, out_lens,
                              False)
            if kv is not None:
                return kv
        # rc == -1: a codec the native inflate lacks, or a dictionary frame.
    mv = memoryview(raw)

    def _inflate(i):
        off, size = int(block_offs[i]), int(block_lens[i])
        end = off + size
        payload = bytes(mv[off:end])
        ctype = raw[end]
        if verify:
            from toplingdb_tpu_torch.utils import crc32c as _crc

            stored = _crc.unmask(int.from_bytes(raw[end + 1:end + 5],
                                                "little"))
            if stored != _crc.value(payload + bytes([ctype])):
                raise Corruption(f"block checksum mismatch at {off}")
        return fmt.decompress(payload, ctype, cdict)

    if n_blocks > 8:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(8) as ex:
            blocks = list(ex.map(_inflate, range(n_blocks)))
    else:
        blocks = [_inflate(i) for i in range(n_blocks)]
    trailer = b"\x00" * 5  # type=NO_COMPRESSION + dummy CRC (verify off)
    synth = trailer.join(blocks) + trailer
    lens = np.array([len(b) for b in blocks], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens + 5)[:-1]]).astype(np.int64)
    kv = _bulk_decode(lib, synth, offs, lens, False)
    if kv is None:
        raise Corruption("decompressed blocks failed native bulk decode")
    return kv


def _refvals_decode(lib, raw, block_offs, block_lens, verify):
    """Values-referenced whole-file scan: keys decode into a dense buffer;
    val_offs point INTO the raw file image, which becomes val_buf
    zero-copy. None when ineligible (compressed blocks, int32 budget, long
    keys); the value-copying decode then decides."""
    rawb = np.frombuffer(bytes(raw), dtype=np.uint8)
    file_size = len(rawb)
    if file_size > 0x7FFFFF00:
        return None
    data_bytes = int(block_lens.sum())
    key_cap = 4 * data_bytes + 4096
    max_e = data_bytes // 3 + 64
    while True:
        key_out = np.empty(key_cap, dtype=np.uint8)
        key_offs = np.empty(max_e, dtype=np.int32)
        key_lens = np.empty(max_e, dtype=np.int32)
        val_offs = np.empty(max_e, dtype=np.int32)
        val_lens = np.empty(max_e, dtype=np.int32)
        rc = lib.tpulsm_scan_blocks_refvals(
            native.np_u8p(rawb), file_size,
            native.np_i64p(block_offs), native.np_i64p(block_lens),
            len(block_offs), 1 if verify else 0,
            native.np_u8p(key_out), key_cap,
            native.np_i32p(key_offs), native.np_i32p(key_lens),
            native.np_i32p(val_offs), native.np_i32p(val_lens), max_e,
            0, 0,
        )
        if rc == -2:
            key_cap *= 4
            continue
        if rc == -4:
            max_e *= 4
            continue
        if rc == -6:
            raise Corruption("block checksum mismatch (refvals scan)")
        if rc < 0:
            return None
        n = int(rc)
        key_used = int(key_offs[n - 1] + key_lens[n - 1]) if n else 0
        return ColumnarKV(
            key_out[:key_used].copy(), key_offs[:n].copy(),
            key_lens[:n].copy(),
            rawb, val_offs[:n].copy(), val_lens[:n].copy(),
        )


def _bulk_decode(lib, raw, block_offs, block_lens, verify):
    """One native call decoding every (uncompressed) block of a file image
    into a dense ColumnarKV. None when a block is compressed."""
    file_size = len(raw)
    praw = bytes(raw)
    data_bytes = int(block_lens.sum())
    key_cap = 4 * data_bytes + 4096
    val_cap = data_bytes + 4096
    max_e = data_bytes // 3 + 64
    while True:
        key_out = np.empty(key_cap, dtype=np.uint8)
        val_out = np.empty(val_cap, dtype=np.uint8)
        key_offs = np.empty(max_e, dtype=np.int32)
        key_lens = np.empty(max_e, dtype=np.int32)
        val_offs = np.empty(max_e, dtype=np.int32)
        val_lens = np.empty(max_e, dtype=np.int32)
        rc = lib.tpulsm_decode_blocks(
            praw, file_size,
            native.np_i64p(block_offs), native.np_i64p(block_lens),
            len(block_offs), 1 if verify else 0,
            native.np_u8p(key_out), key_cap,
            native.np_u8p(val_out), val_cap,
            native.np_i32p(key_offs), native.np_i32p(key_lens),
            native.np_i32p(val_offs), native.np_i32p(val_lens), max_e,
        )
        if rc == -2:
            key_cap *= 4
            continue
        if rc == -3:
            val_cap *= 4
            continue
        if rc == -4:
            max_e *= 4
            continue
        if rc == -5:
            return None  # compressed blocks present
        if rc == -6:
            raise Corruption("block checksum mismatch (native bulk scan)")
        if rc == -7:
            raise NotSupported("input too large for native columnar path")
        if rc < 0:
            raise Corruption(f"native bulk decode failed rc={rc}")
        n = int(rc)
        key_used = int(key_offs[n - 1] + key_lens[n - 1]) if n else 0
        val_used = int(val_offs[n - 1] + val_lens[n - 1]) if n else 0
        return ColumnarKV(
            key_out[:key_used].copy(), key_offs[:n].copy(),
            key_lens[:n].copy(),
            val_out[:val_used].copy(), val_offs[:n].copy(),
            val_lens[:n].copy(),
        )


class _ColumnarSST:
    """Framing state for ONE output file of the columnar writer (index,
    props, meta blocks, footer). Data blocks arrive three ways: pre-framed
    sections from the native builder (per-block metadata kept as arrays,
    the whole index block built natively at finish), pre-framed sections
    framed elsewhere (the on-device block assembly; each block indexed as
    it is added), and raw blocks (`add_block`: compressed here, on `pool`
    threads when one is given, in order; a ZSTD dictionary is trained from
    the first train_budget() raw bytes first, as in TableBuilder)."""

    def __init__(self, env, dbname, fnum, icmp, options, creation_time,
                 column_family=(0, "default"), pool=None):
        from toplingdb_tpu_torch.db import filename as _fn

        self.fnum = fnum
        self.path = _fn.table_file_name(dbname, fnum)
        self.w = env.new_writable_file(self.path)
        self._icmp = icmp
        self._options = options
        self._pool = pool
        self._copts = options.compression_opts
        self._dict: bytes | None = (
            b"" if (options.compression == fmt.ZSTD_COMPRESSION
                    and self._copts.max_dict_bytes > 0) else None)
        self._dict_samples: list = []
        self._dict_bytes = 0
        self._pending: list = []  # (future, raw_len, first, last, n)
        self.props = TableProperties(
            comparator_name=icmp.user_comparator.name(),
            filter_policy_name=(
                options.filter_policy.name() if options.filter_policy else ""
            ),
            compression_name=str(options.compression),
            column_family_id=column_family[0],
            column_family_name=column_family[1],
            creation_time=creation_time,
            smallest_seqno=dbformat.MAX_SEQUENCE_NUMBER,
        )
        self._sections: list = []  # (start_pos, counts, plens, base offset)
        self.index_block = BlockBuilder(options.index_restart_interval)
        self.pending_last_key: bytes | None = None
        self.pending_handle = None
        self.first_key: bytes | None = None
        self.last_key: bytes | None = None
        self.num_entries = 0

    def _account_block(self, handle, raw_len: int, block_first: bytes,
                       block_last: bytes, n_entries: int) -> None:
        """Index and properties bookkeeping of one written block."""
        if self.first_key is None:
            self.first_key = block_first
        if self.pending_last_key is not None:
            sep = self._icmp.find_shortest_separator(
                self.pending_last_key, block_first)
            self.index_block.add(sep, self.pending_handle.encode())
        self.pending_handle = handle
        self.pending_last_key = block_last
        self.props.data_size += raw_len
        self.props.num_data_blocks += 1
        self.last_key = block_last
        self.num_entries += n_entries

    def pending_bytes(self) -> int:
        """Raw bytes held for dictionary training or queued for
        compression, counted into the output-cut size check."""
        return self._dict_bytes + sum(p[1] for p in self._pending)

    def add_block(self, raw: bytes, block_first: bytes, block_last: bytes,
                  n_entries: int) -> None:
        if self._dict == b"":
            self._dict_samples.append((raw, block_first, block_last,
                                       n_entries))
            self._dict_bytes += len(raw)
            if self._dict_bytes >= self._copts.train_budget():
                self._train_dict_and_flush()
            return
        if (self._pool is not None
                and self._options.compression != fmt.NO_COMPRESSION):
            fut = self._pool.submit(
                fmt.compress_for_block, raw, self._options.compression,
                self._copts.level, self._dict or b"")
            self._pending.append((fut, len(raw), block_first, block_last,
                                  n_entries))
            self._drain(wait=False)
            return
        handle = fmt.write_block(self.w, raw, self._options.compression,
                                 self._copts.level, self._dict or b"")
        self._account_block(handle, len(raw), block_first, block_last,
                            n_entries)

    def _train_dict_and_flush(self) -> None:
        from toplingdb_tpu_torch.utils import codecs

        self._dict = codecs.zstd_train_dictionary(
            [r for r, _f, _l, _n in self._dict_samples],
            self._copts.max_dict_bytes)
        if self._dict == b"":
            # Training failed: b"" is the pending sentinel, so the replay
            # below would buffer forever; the dictionary is off instead.
            self._dict = None
        samples, self._dict_samples, self._dict_bytes = \
            self._dict_samples, [], 0
        for raw, first, last, n in samples:
            self.add_block(raw, first, last, n)

    def _drain(self, wait: bool) -> None:
        while self._pending and (wait or self._pending[0][0].done()):
            fut, raw_len, first, last, n = self._pending.pop(0)
            payload, out_type = fut.result()
            h = fmt.write_compressed_block(self.w, payload, out_type)
            self._account_block(h, raw_len, first, last, n)

    def add_framed_section_arrays(self, section, counts, plens, rawlens,
                                  nb: int, start_pos: int,
                                  entry_key_fn) -> None:
        """Append a run of framed blocks; per-block metadata is kept as
        arrays for the index build at finish, and only the file's
        first/last keys are materialized here. `rawlens`: the blocks'
        uncompressed payload lengths (the properties' data size)."""
        base = self.w.file_size()
        if self.first_key is None:
            self.first_key = entry_key_fn(start_pos)
        cnts = counts[:nb].astype(np.int64, copy=True)
        pls = plens[:nb].astype(np.int64, copy=True)
        self._sections.append((start_pos, cnts, pls, base))
        self.props.data_size += int(rawlens[:nb].sum())
        self.props.num_data_blocks += nb
        total = int(cnts.sum())
        self.num_entries += total
        self.last_key = entry_key_fn(start_pos + total - 1)
        self.w.append(section)

    def add_framed_section(self, section: bytes, blocks) -> None:
        """Append a pre-framed run of uncompressed blocks (payload + type
        byte + crc trailer, exactly what write_block emits); `blocks` yields
        (payload_len, first_key, last_key, n_entries) per block in file
        order, and each block's index entry is added here."""
        offset = self.w.file_size()
        for payload_len, block_first, block_last, n_entries in blocks:
            self._account_block(fmt.BlockHandle(offset, payload_len),
                                payload_len, block_first, block_last,
                                n_entries)
            offset += payload_len + fmt.BLOCK_TRAILER_SIZE
        self.w.append(section)

    def _native_index_raw(self, lib, kv, order, trailer_override) -> bytes:
        """Build this file's whole index block in one native call from the
        section metadata (separators + block handles)."""
        pos_parts, cnt_parts, off_parts, plen_parts = [], [], [], []
        for start_pos, cnts, pls, base in self._sections:
            cum = np.concatenate(([0], np.cumsum(cnts)[:-1]))
            pos_parts.append(start_pos + cum)
            cnt_parts.append(cnts)
            offcum = np.concatenate(
                ([0], np.cumsum(pls + fmt.BLOCK_TRAILER_SIZE)[:-1]))
            off_parts.append(base + offcum)
            plen_parts.append(pls)
        bpos = np.ascontiguousarray(np.concatenate(pos_parts))
        bcnt = np.ascontiguousarray(np.concatenate(cnt_parts))
        boff = np.ascontiguousarray(np.concatenate(off_parts))
        bpl = np.ascontiguousarray(np.concatenate(plen_parts))
        nb = len(bpos)
        cap = 64 * nb + 8192
        out_len = np.zeros(1, dtype=np.int64)
        while True:
            out = np.empty(cap, dtype=np.uint8)
            rc = lib.tpulsm_build_index_block(
                native.np_u8p(kv.key_buf), native.np_i32p(kv.key_offs),
                native.np_i32p(kv.key_lens), native.np_i64p(trailer_override),
                native.np_i32p(order),
                native.np_i64p(bpos), native.np_i64p(bcnt),
                native.np_i64p(boff), native.np_i64p(bpl),
                nb, self._options.index_restart_interval,
                native.np_u8p(out), cap, native.np_i64p(out_len),
            )
            if rc == -2:
                cap *= 4
                continue
            if rc != nb:
                raise NotSupported(f"native index build failed rc={rc}")
            return out[: int(out_len[0])].tobytes()

    def finish(self, lib, kv, sel, vtypes, seqs, order=None,
               trailer_override=None, tombstones=(), precomputed=None):
        """Write meta blocks + footer; `sel` = the original-index selection
        of this file's entries (stats and bloom are vectorized over it).
        `order`/`trailer_override` feed the native index build of native
        sections. `tombstones`: fragments for the range-del meta block.
        `precomputed`: entry stats already reduced elsewhere (the on-device
        block assembly; its `sel` then only feeds the bloom) — a dict with
        num_entries/raw_key_size/raw_value_size/num_deletions/
        num_merge_operands/smallest_seqno/largest_seqno."""
        if self._dict == b"":
            self._train_dict_and_flush()  # small file: train from the lot
        self._drain(wait=True)
        icmp = self._icmp
        options = self._options
        props = self.props
        n = len(sel)
        if self._sections and self.pending_last_key is not None:
            # Per-block and native index entries would interleave out of
            # order; no writer mixes them in one file.
            raise NotSupported("mixed index modes in one output file")
        if self.pending_last_key is not None:
            succ = icmp.find_short_successor(self.pending_last_key)
            self.index_block.add(succ, self.pending_handle.encode())
        if precomputed is not None:
            for k in ("num_entries", "raw_key_size", "raw_value_size",
                      "num_deletions", "num_merge_operands",
                      "smallest_seqno", "largest_seqno"):
                setattr(props, k, precomputed[k])
        else:
            props.num_entries = n
            props.raw_key_size = int(kv.key_lens[sel].sum()) if n else 0
            props.raw_value_size = int(kv.val_lens[sel].sum()) if n else 0
            vt = vtypes[sel] if n else vtypes[:0]
            props.num_deletions = int(np.count_nonzero(
                (vt == int(dbformat.ValueType.DELETION))
                | (vt == int(dbformat.ValueType.SINGLE_DELETION))
            ))
            props.num_merge_operands = int(np.count_nonzero(
                vt == int(dbformat.ValueType.MERGE)
            ))
            sq = seqs[sel] if n else seqs[:0]
            props.smallest_seqno = int(sq.min()) if n else 0
            props.largest_seqno = int(sq.max()) if n else 0

        meta_entries = []
        metaindex = BlockBuilder(restart_interval=1)
        if options.filter_policy and options.whole_key_filtering and n:
            from toplingdb_tpu_torch.table.filter import (
                build_filter_block_native,
            )

            fdata = build_filter_block_native(
                lib, options.filter_policy, kv.key_buf,
                kv.key_offs[sel], (kv.key_lens[sel] - 8), n)
            fh = fmt.write_block(self.w, fdata)
            props.filter_size = len(fdata)
            meta_entries.append((METAINDEX_FILTER, fh))

        smallest = self.first_key
        largest = self.last_key
        if tombstones:
            rdb = BlockBuilder(restart_interval=1)
            for frag in tombstones:
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
                props.smallest_seqno = min(props.smallest_seqno, frag.seq)
                props.largest_seqno = max(props.largest_seqno, frag.seq)
            rh = fmt.write_block(self.w, rdb.finish())
            meta_entries.append((METAINDEX_RANGE_DEL, rh))

        if self._dict:
            dh = fmt.write_block(self.w, self._dict)
            meta_entries.append((METAINDEX_COMPRESSION_DICT, dh))

        if self._sections:
            iraw = self._native_index_raw(lib, kv, order, trailer_override)
        else:
            iraw = self.index_block.finish()
        props.index_size = len(iraw)
        ph = fmt.write_block(self.w, props.encode_block())
        meta_entries.append((METAINDEX_PROPERTIES, ph))
        for name, handle in sorted(meta_entries):
            metaindex.add(name, handle.encode())
        mih = fmt.write_block(self.w, metaindex.finish())
        ih = fmt.write_block(self.w, iraw, options.compression)
        self.w.append(fmt.Footer(mih, ih).encode())
        self.w.flush()
        self.w.sync()
        self.w.close()
        return props, smallest, largest


def write_tables_columnar(env, dbname, new_file_number, icmp, options,
                          kv: ColumnarKV, order, trailer_override: np.ndarray,
                          vtypes: np.ndarray, seqs: np.ndarray,
                          creation_time: int,
                          max_output_file_size: int = 2 ** 62,
                          column_family=(0, "default"), tombstones=()):
    """Build output SSTs from `kv` entries in `order`, byte-identical to the
    reference writer fed the same stream — including the output-cutting rule
    (cut at a user-key boundary once the file's written bytes reach
    max_output_file_size). `tombstones` (range-tombstone fragments) go into
    the range-del block of the output; while any survive there is one
    output file, as in the reference. trailer_override[i] (per ORIGINAL
    entry index) >= 0 replaces the 8-byte key trailer (seqno zeroing).
    Returns a list of
    (fnum, path, props, smallest, largest, sel) where sel is the
    original-index selection written to that file. On any failure every
    partial output is deleted before re-raising.

    Uncompressed, snappy and dictionary-less zstd output is built in whole
    runs of framed blocks per native call; a ZSTD dictionary and the other
    codecs build one block per native call and compress it in Python (on
    `compression_parallel_threads` threads when that is > 1).

    `order` may also be an ITERATOR of int32 chunks (the device shards:
    shard s's survivors stream into SSTs while shard s+1 is still
    computing). Chunks must be key-range-ordered with no user key spanning a
    chunk boundary, and the caller may update trailer_override/seqs rows for
    a chunk any time before yielding it."""
    lib = native.lib()
    if lib is None:
        raise NotSupported("native library unavailable")
    if isinstance(order, np.ndarray):
        chunks = iter(())
        order = np.ascontiguousarray(order, dtype=np.int32)
        start_filled = len(order)
        start_exhausted = True
    else:
        chunks = iter(order)
        # Survivor count unknown until the last chunk arrives; kv.n bounds it.
        order = np.empty(kv.n, dtype=np.int32)
        start_filled = 0
        start_exhausted = False
        # Streaming callers mutate trailer_override/seqs rows right before
        # yielding each chunk; a dtype/layout conversion here would COPY and
        # silently sever that aliasing, so demand the exact form instead.
        if (trailer_override.dtype != np.int64
                or not trailer_override.flags.c_contiguous):
            raise NotSupported(
                "streamed order requires a C-contiguous int64 "
                "trailer_override (mutations must alias the writer's view)"
            )
    trailer_override = np.ascontiguousarray(trailer_override, dtype=np.int64)

    max_entry = int(kv.key_lens.max() if kv.n else 0) + int(
        kv.val_lens.max() if kv.n else 0
    )
    if not start_exhausted:
        # Streamed callers may hand over buffers that reader threads are
        # still filling: the size is only a capacity guess, clamped to a
        # sane window (the rc == -2 grow loops correct small guesses).
        max_entry = min(max(max_entry, 0), 4 << 20)
    out_cap = options.block_size * 2 + max_entry + 8192

    def entry_key(pos: int) -> bytes:
        e = int(order[pos])
        k = kv.ikey(e)
        t = int(trailer_override[e])
        if t >= 0:
            k = k[:-8] + t.to_bytes(8, "little")
        return k

    def same_user_key(pos_a: int, pos_b: int) -> bool:
        a, b = int(order[pos_a]), int(order[pos_b])
        la, lb = int(kv.key_lens[a]) - 8, int(kv.key_lens[b]) - 8
        if la != lb:
            return False
        oa, ob = int(kv.key_offs[a]), int(kv.key_offs[b])
        return bool(np.array_equal(kv.key_buf[oa:oa + la],
                                   kv.key_buf[ob:ob + lb]))

    # Hoist ctypes pointer conversions out of the per-section loop.
    p_kbuf = native.np_u8p(kv.key_buf)
    p_koff = native.np_i32p(kv.key_offs)
    p_klen = native.np_i32p(kv.key_lens)
    p_vbuf = native.np_u8p(kv.val_buf)
    p_voff = native.np_i32p(kv.val_offs)
    p_vlen = native.np_i32p(kv.val_lens)
    p_tro = native.np_i64p(trailer_override)
    p_order = native.np_i32p(order)

    # The section codec: uncompressed, snappy and dictionary-less zstd runs
    # are built (and compressed) natively; everything else is per block.
    copts = options.compression_opts
    if options.compression == fmt.NO_COMPRESSION:
        use_section, sec_ctype = True, 0
    elif (options.compression in (fmt.SNAPPY_COMPRESSION,
                                  fmt.ZSTD_COMPRESSION)
          and copts.max_dict_bytes <= 0):
        use_section, sec_ctype = True, options.compression
    else:
        use_section, sec_ctype = False, 0
    sec_level = copts.level if copts.level is not None else -(2 ** 31)

    # Each native call emits a whole RUN of framed blocks (payload + type
    # byte + crc trailer) of at most ~_SECTION_RUN_BYTES, so the section
    # buffer and the per-call copy stay bounded for any job size.
    sec_bytes = max(0, int(kv.key_lens.sum()) + int(kv.val_lens.sum())) \
        if kv.n else 0
    sec_cap = min(sec_bytes + sec_bytes // 4,
                  _SECTION_RUN_BYTES + out_cap) + (1 << 16)
    sec_buf = np.empty(sec_cap, dtype=np.uint8)
    max_blocks = sec_cap // max(1, options.block_size) + 1024
    sec_counts = np.empty(max_blocks, dtype=np.int64)
    sec_plens = np.empty(max_blocks, dtype=np.int64)
    sec_rawlens = np.empty(max_blocks, dtype=np.int64)
    sec_len = np.zeros(1, dtype=np.int64)
    p_sec = native.np_u8p(sec_buf)
    p_counts = native.np_i64p(sec_counts)
    p_plens = native.np_i64p(sec_plens)
    p_rawlens = native.np_i64p(sec_rawlens)
    p_seclen = native.np_i64p(sec_len)
    out_buf = np.empty(out_cap, dtype=np.uint8)
    out_len = np.zeros(1, dtype=np.int64)
    p_out = native.np_u8p(out_buf)
    p_outlen = native.np_i64p(out_len)

    pool = None
    if (options.compression != fmt.NO_COMPRESSION
            and options.compression_parallel_threads > 1):
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(
            max_workers=options.compression_parallel_threads)

    can_cut = not tombstones  # single output while tombstones survive
    results = []
    cur: _ColumnarSST | None = None
    lo = 0
    start = 0
    filled = start_filled      # rows of `order` received so far
    exhausted = start_exhausted
    try:
        cur = _ColumnarSST(env, dbname, new_file_number(), icmp, options,
                           creation_time, column_family, pool)
        need_fetch = False
        while True:
            if start >= filled or need_fetch:
                need_fetch = False
                if not exhausted:
                    nxt = next(chunks, None)
                    if nxt is None:
                        exhausted = True
                    else:
                        nxt = np.ascontiguousarray(nxt, dtype=np.int32)
                        order[filled:filled + len(nxt)] = nxt
                        filled += len(nxt)
                    continue
                if start >= filled:
                    break
            limit = filled
            if (can_cut and cur.num_entries
                    and cur.w.file_size() + cur.pending_bytes()
                    >= max_output_file_size):
                if not same_user_key(start, start - 1):
                    # Cut HERE (the per-entry path's pre-add check).
                    sel = order[lo:start]
                    results.append((cur.fnum, cur.path) + cur.finish(
                        lib, kv, sel, vtypes, seqs, order, trailer_override
                    ) + (sel,))
                    cur = _ColumnarSST(env, dbname, new_file_number(), icmp,
                                       options, creation_time, column_family,
                                       pool)
                    lo = start
                else:
                    # Same user key spans the boundary: all its versions
                    # stay in this file; bound the run at the end of the key
                    # so the cut re-check happens there.
                    j = start
                    while j < filled and same_user_key(j, j - 1):
                        j += 1
                    limit = j
            if not use_section:
                rc = lib.tpulsm_build_block(
                    p_kbuf, p_koff, p_klen, p_vbuf, p_voff, p_vlen, p_tro,
                    p_order, start, limit,
                    options.block_size, options.restart_interval,
                    p_out, out_cap, p_outlen,
                )
                if rc == -2:
                    out_cap *= 4
                    out_buf = np.empty(out_cap, dtype=np.uint8)
                    p_out = native.np_u8p(out_buf)
                    continue
                if rc == -3 or rc == -8:
                    raise NotSupported(
                        f"native block build unsupported input rc={rc}")
                if rc <= 0:
                    raise Corruption(f"native block build failed rc={rc}")
                if not exhausted and start + int(rc) == filled:
                    # Possibly starved at the chunk boundary: rebuild this
                    # block once more data arrives.
                    need_fetch = True
                    continue
                cur.add_block(out_buf[: int(out_len[0])].tobytes(),
                              entry_key(start),
                              entry_key(start + int(rc) - 1), int(rc))
                start += int(rc)
                continue
            base_size = cur.w.file_size()
            budget = base_size + _SECTION_RUN_BYTES
            if can_cut and max_output_file_size < budget:
                budget = max_output_file_size
            if sec_ctype:
                rc = lib.tpulsm_build_data_section_c(
                    p_kbuf, p_koff, p_klen, p_vbuf, p_voff, p_vlen,
                    p_tro, p_order, start, limit,
                    options.block_size, options.restart_interval,
                    sec_ctype, sec_level, base_size, budget,
                    p_counts, p_plens, p_rawlens, max_blocks,
                    p_sec, sec_cap, p_seclen,
                )
                if rc == -9:
                    # The codec library is missing on this host: the
                    # per-block path's Python codec raises NotSupported.
                    use_section = False
                    continue
            else:
                rc = lib.tpulsm_build_data_section(
                    p_kbuf, p_koff, p_klen, p_vbuf, p_voff, p_vlen,
                    p_tro, p_order, start, limit,
                    options.block_size, options.restart_interval,
                    base_size, budget,
                    p_counts, p_plens, max_blocks,
                    p_sec, sec_cap, p_seclen,
                )
            if rc == -2:
                sec_cap *= 4
                sec_buf = np.empty(sec_cap, dtype=np.uint8)
                p_sec = native.np_u8p(sec_buf)
                continue
            if rc == -3 or rc == -8:
                raise NotSupported(
                    f"native block build unsupported input rc={rc}")
            if rc <= 0:
                raise Corruption(f"native section build failed rc={rc}")
            nb = int(rc)
            sec_total = int(sec_len[0])
            pos = start + int(sec_counts[:nb].sum())
            if not exhausted and pos == filled:
                # The final block ended at the chunk boundary — it may have
                # been starved, not full. Withhold it until more data
                # arrives so the block layout matches the whole-array build
                # byte for byte.
                last_cnt = int(sec_counts[nb - 1])
                nb -= 1
                pos -= last_cnt
                sec_total -= int(sec_plens[nb]) + fmt.BLOCK_TRAILER_SIZE
                need_fetch = True
                if nb == 0:
                    continue
            # Uncompressed payloads are their own raw lengths.
            cur.add_framed_section_arrays(
                sec_buf[:sec_total].tobytes(), sec_counts, sec_plens,
                sec_rawlens if sec_ctype else sec_plens, nb, start,
                entry_key)
            start = pos
        sel = order[lo:filled]
        results.append((cur.fnum, cur.path) + cur.finish(
            lib, kv, sel, vtypes, seqs, order, trailer_override, tombstones
        ) + (sel,))
        cur = None
        return results
    except BaseException:
        if cur is not None:
            cur.w.close()
            try:
                env.delete_file(cur.path)
            except Exception:  # noqa: BLE001 - best-effort cleanup
                pass
        for r in results:
            try:
                env.delete_file(r[1])
            except Exception:  # noqa: BLE001 - best-effort cleanup
                pass
        raise
    finally:
        if pool is not None:
            pool.shutdown()
