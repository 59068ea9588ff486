"""Production block codecs: Snappy, LZ4/LZ4HC, ZSTD (+ dictionary) (copied
from toplingdb_tpu/utils/codecs.py; the library lock is the named
"codecs._lock").

The reference's production codec set (RocksDB's
include/rocksdb/compression_type.h:22-28: kSnappyCompression=1,
kLZ4Compression=4, kLZ4HCCompression=5, kZSTD=7) with ZSTD dictionary training/compression
(util/compression.h:1435-1476). Bound via ctypes to the system libraries —
the calls release the GIL, so block compression parallelizes across threads
(the reference's parallel-compression role,
block_based_table_builder.cc:818-825).

Payload formats are our own (this is a new SST format, not byte-compatible
with RocksDB): snappy and zstd frames are self-describing; LZ4 raw blocks
carry a varint32 uncompressed-length prefix (same trick the reference uses
for its format_version>=2 LZ4 blocks).
"""

from __future__ import annotations

import ctypes
import ctypes.util

from toplingdb_tpu_torch.utils import coding
from toplingdb_tpu_torch.utils.status import Corruption, NotSupported
from toplingdb_tpu_torch.utils import concurrency as ccy

_lock = ccy.Lock("codecs._lock")
_libs: dict[str, ctypes.CDLL | None] = {}


def _load(name: str, sonames: tuple[str, ...]) -> ctypes.CDLL | None:
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        for so in sonames:
            try:
                lib = ctypes.CDLL(so)
                break
            except OSError:
                continue
        _libs[name] = lib
        return lib


def _snappy():
    lib = _load("snappy", ("libsnappy.so.1", "libsnappy.so"))
    if lib is not None and not getattr(lib, "_tpulsm_ready", False):
        st = ctypes.c_size_t
        lib.snappy_max_compressed_length.restype = st
        lib.snappy_max_compressed_length.argtypes = [st]
        lib.snappy_compress.restype = ctypes.c_int
        lib.snappy_compress.argtypes = [
            ctypes.c_char_p, st, ctypes.c_char_p, ctypes.POINTER(st)]
        lib.snappy_uncompressed_length.restype = ctypes.c_int
        lib.snappy_uncompressed_length.argtypes = [
            ctypes.c_char_p, st, ctypes.POINTER(st)]
        lib.snappy_uncompress.restype = ctypes.c_int
        lib.snappy_uncompress.argtypes = [
            ctypes.c_char_p, st, ctypes.c_char_p, ctypes.POINTER(st)]
        lib._tpulsm_ready = True
    return lib


def _lz4():
    lib = _load("lz4", ("liblz4.so.1", "liblz4.so"))
    if lib is not None and not getattr(lib, "_tpulsm_ready", False):
        i = ctypes.c_int
        lib.LZ4_compressBound.restype = i
        lib.LZ4_compressBound.argtypes = [i]
        lib.LZ4_compress_default.restype = i
        lib.LZ4_compress_default.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, i, i]
        lib.LZ4_compress_HC.restype = i
        lib.LZ4_compress_HC.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, i, i, i]
        lib.LZ4_decompress_safe.restype = i
        lib.LZ4_decompress_safe.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, i, i]
        lib._tpulsm_ready = True
    return lib


def _zstd():
    lib = _load("zstd", ("libzstd.so.1", "libzstd.so"))
    if lib is not None and not getattr(lib, "_tpulsm_ready", False):
        st = ctypes.c_size_t
        p = ctypes.c_char_p
        lib.ZSTD_compressBound.restype = st
        lib.ZSTD_compressBound.argtypes = [st]
        lib.ZSTD_compress.restype = st
        lib.ZSTD_compress.argtypes = [p, st, p, st, ctypes.c_int]
        lib.ZSTD_decompress.restype = st
        lib.ZSTD_decompress.argtypes = [p, st, p, st]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [st]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [p, st]
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_createDCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_compress_usingDict.restype = st
        lib.ZSTD_compress_usingDict.argtypes = [
            ctypes.c_void_p, p, st, p, st, p, st, ctypes.c_int]
        lib.ZSTD_decompress_usingDict.restype = st
        lib.ZSTD_decompress_usingDict.argtypes = [
            ctypes.c_void_p, p, st, p, st, p, st]
        lib.ZDICT_trainFromBuffer.restype = st
        lib.ZDICT_trainFromBuffer.argtypes = [
            p, st, p, ctypes.POINTER(st), ctypes.c_uint]
        lib.ZDICT_isError.restype = ctypes.c_uint
        lib.ZDICT_isError.argtypes = [st]
        lib._tpulsm_ready = True
    return lib


def available(codec: str) -> bool:
    return {"snappy": _snappy, "lz4": _lz4, "zstd": _zstd}[codec]() is not None


def snappy_compress(data: bytes) -> bytes:
    lib = _snappy()
    if lib is None:
        raise NotSupported("libsnappy unavailable")
    out_len = ctypes.c_size_t(lib.snappy_max_compressed_length(len(data)))
    out = ctypes.create_string_buffer(out_len.value)
    if lib.snappy_compress(data, len(data), out, ctypes.byref(out_len)) != 0:
        raise Corruption("snappy_compress failed")
    return out.raw[: out_len.value]


def snappy_decompress(data: bytes) -> bytes:
    lib = _snappy()
    if lib is None:
        raise NotSupported("libsnappy unavailable")
    n = ctypes.c_size_t(0)
    if lib.snappy_uncompressed_length(data, len(data), ctypes.byref(n)) != 0:
        raise Corruption("corrupt snappy block header")
    out = ctypes.create_string_buffer(max(1, n.value))
    out_len = ctypes.c_size_t(n.value)
    if lib.snappy_uncompress(data, len(data), out, ctypes.byref(out_len)) != 0:
        raise Corruption("corrupt snappy block")
    return out.raw[: out_len.value]


def lz4_compress(data: bytes, hc: bool = False, level: int = 0) -> bytes:
    lib = _lz4()
    if lib is None:
        raise NotSupported("liblz4 unavailable")
    bound = lib.LZ4_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    if hc:
        n = lib.LZ4_compress_HC(data, out, len(data), bound, level or 9)
    else:
        n = lib.LZ4_compress_default(data, out, len(data), bound)
    if n <= 0:
        raise Corruption("LZ4 compression failed")
    return coding.encode_varint32(len(data)) + out.raw[:n]


def lz4_decompress(data: bytes) -> bytes:
    lib = _lz4()
    if lib is None:
        raise NotSupported("liblz4 unavailable")
    raw_len, off = coding.decode_varint32(data, 0)
    out = ctypes.create_string_buffer(max(1, raw_len))
    n = lib.LZ4_decompress_safe(data[off:], out, len(data) - off, raw_len)
    if n < 0 or n != raw_len:
        raise Corruption("corrupt LZ4 block")
    return out.raw[:raw_len]


def zstd_compress(data: bytes, level: int = 3, dict_: bytes = b"") -> bytes:
    lib = _zstd()
    if lib is None:
        raise NotSupported("libzstd unavailable")
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    if dict_:
        cctx = lib.ZSTD_createCCtx()
        try:
            n = lib.ZSTD_compress_usingDict(
                cctx, out, bound, data, len(data), dict_, len(dict_), level)
        finally:
            lib.ZSTD_freeCCtx(cctx)
    else:
        n = lib.ZSTD_compress(out, bound, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise Corruption("ZSTD compression failed")
    return out.raw[:n]


def zstd_decompress(data: bytes, dict_: bytes = b"") -> bytes:
    lib = _zstd()
    if lib is None:
        raise NotSupported("libzstd unavailable")
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size in (2 ** 64 - 1, 2 ** 64 - 2):  # ERROR / UNKNOWN
        raise Corruption("corrupt zstd block header")
    # The content size is untrusted frame-header bytes: bound it before
    # allocating (a crafted block can claim ~2^64 and OOM the process).
    # The floor must admit any block a builder can legitimately write —
    # a single huge RLE-friendly value can compress >100000x — so only
    # reject sizes beyond a 4 GiB absolute ceiling.
    if size > max(1 << 32, 1000 * len(data)):
        raise Corruption("zstd block claims implausible content size")
    out = ctypes.create_string_buffer(max(1, size))
    if dict_:
        dctx = lib.ZSTD_createDCtx()
        try:
            n = lib.ZSTD_decompress_usingDict(
                dctx, out, size, data, len(data), dict_, len(dict_))
        finally:
            lib.ZSTD_freeDCtx(dctx)
    else:
        n = lib.ZSTD_decompress(out, size, data, len(data))
    if lib.ZSTD_isError(n) or n != size:
        raise Corruption("corrupt zstd block")
    return out.raw[:size]


def zstd_train_dictionary(samples: list[bytes], max_dict_bytes: int) -> bytes:
    """ZDICT training over sample blocks (reference
    util/compression.h:1435-1476 ZSTD_TrainDictionary). Returns b"" when
    training fails (too few/too-uniform samples) — callers then compress
    without a dictionary, which is always safe."""
    lib = _zstd()
    if lib is None or not samples or max_dict_bytes <= 0:
        return b""
    blob = b"".join(samples)
    sizes = (ctypes.c_size_t * len(samples))(*[len(s) for s in samples])
    out = ctypes.create_string_buffer(max_dict_bytes)
    n = lib.ZDICT_trainFromBuffer(
        out, max_dict_bytes, blob, sizes, len(samples))
    if lib.ZDICT_isError(n):
        return b""
    return out.raw[:n]
