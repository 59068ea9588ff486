"""Loader for the port's native C++ host library.

Builds `_tpulsm_native.so` from the port's own `tpulsm_native.cc` with g++
on first use, into the package's git-ignored build directory
(`toplingdb_tpu_torch/_build/`), and binds the C ABI with ctypes. Callers
check `lib()` for None (no toolchain) and raise NotSupported. The library
is linked with -Bsymbolic and loaded RTLD_LOCAL, and the `fastget`
extension (`fastget.c`, the point read's ctypes-free call) is built under
its own module name and binds the library RTLD_LOCAL: toplingdb_tpu's
library exports the same tpulsm_* names, and neither package's calls may
land in the other's code. The codec
libraries (libsnappy, libzstd) are dlopen'd by the library at run time; a
missing one makes its codec's native paths report "unavailable", and the
callers take the Python codecs instead (the zip plane's encoders, asked
for zstd without the library, report it and their caller raises).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "tpulsm_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(BUILD_DIR, "_tpulsm_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_pylib: ctypes.PyDLL | None = None
_tried = False

# Must match TPULSM_ABI_VERSION in tpulsm_native.cc.
_ABI_VERSION = 6


def _build() -> bool:
    return _compile(_SRC, _SO, ["-O3", "-std=c++17", "-pthread",
                                "-Wl,-Bsymbolic"])


def _compile(src: str, so: str, flags: list[str]) -> bool:
    """Compile to a per-pid temporary, then swap it in (two processes may
    race the first build)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-shared", "-fPIC", *flags, "-o", tmp, src, "-ldl"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _stale(so: str = _SO, src: str = _SRC) -> bool:
    try:
        return not os.path.exists(so) or (
            os.path.getmtime(so) < os.path.getmtime(src))
    except OSError:
        return True


def _load() -> ctypes.CDLL | None:
    l = ctypes.CDLL(_SO)
    l.tpulsm_abi_version.restype = ctypes.c_int32
    l.tpulsm_abi_version.argtypes = []
    if l.tpulsm_abi_version() != _ABI_VERSION:
        return None
    return l


def _bind(l: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    u64p = ctypes.POINTER(ctypes.c_uint64)
    l.tpulsm_crc32c_extend.restype = ctypes.c_uint32
    l.tpulsm_crc32c_extend.argtypes = [
        ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t,
    ]
    l.tpulsm_xxh64.restype = ctypes.c_uint64
    l.tpulsm_xxh64.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
    ]
    l.tpulsm_decode_blocks.restype = i64
    l.tpulsm_decode_blocks.argtypes = [
        ctypes.c_char_p, i64,                       # file buf, len
        i64p, i64p, i64,                            # block offs/lens, n
        ctypes.c_int32,                             # verify_crc
        u8p, i64, u8p, i64,                         # key/val out + caps
        i32p, i32p, i32p, i32p, i64,
    ]
    for name in ("tpulsm_bloom_build", "tpulsm_bloom_build_blocked"):
        fn = getattr(l, name)
        fn.restype = None
        fn.argtypes = [u8p, i32p, i32p, i64, ctypes.c_uint64,
                       ctypes.c_uint32, u8p]
    l.tpulsm_build_data_section.restype = i64
    l.tpulsm_build_data_section.argtypes = [
        u8p, i32p, i32p,                            # key buf/offs/lens
        u8p, i32p, i32p,                            # val buf/offs/lens
        i64p,                                       # trailer_override
        i32p, i64, i64,                             # order, start, limit
        i64, i64,                                   # block_size, restart_int
        i64, i64,                                   # base_size, max_size
        i64p, i64p, i64,                            # counts, plens, max_blocks
        u8p, i64, i64p,                             # out, cap, out_len
    ]
    l.tpulsm_build_block.restype = i64
    l.tpulsm_build_block.argtypes = [
        u8p, i32p, i32p,                            # key buf/offs/lens
        u8p, i32p, i32p,                            # val buf/offs/lens
        i64p,                                       # trailer_override
        i32p, i64, i64,                             # order, start, limit
        i64, i64,                                   # block_size, restart_int
        u8p, i64, i64p,                             # out, cap, out_len
    ]
    l.tpulsm_build_data_section_c.restype = i64
    l.tpulsm_build_data_section_c.argtypes = [
        u8p, i32p, i32p,                            # key buf/offs/lens
        u8p, i32p, i32p,                            # val buf/offs/lens
        i64p,                                       # trailer_override
        i32p, i64, i64,                             # order, start, limit
        i64, i64,                                   # block_size, restart_int
        ctypes.c_int32, ctypes.c_int32,             # ctype, level
        i64, i64,                                   # base_size, max_size
        i64p, i64p, i64p, i64,                      # counts, plens, raw lens
        u8p, i64, i64p,                             # out, cap, out_len
    ]
    l.tpulsm_inflate_blocks.restype = i64
    l.tpulsm_inflate_blocks.argtypes = [
        u8p, i64,                                   # file buf, len
        i64p, i64p, i64,                            # block offs/lens, n
        ctypes.c_int32,                             # verify_crc
        u8p, i64, i64p, i64p,                       # out, cap, offs, lens
    ]
    l.tpulsm_build_index_block.restype = i64
    l.tpulsm_build_index_block.argtypes = [
        u8p, i32p, i32p, i64p, i32p,
        i64p, i64p, i64p, i64p,                     # pos/cnt/offs/plens
        i64, i64,                                   # n_blocks, restart
        u8p, i64, i64p,                             # out, cap, out_len
    ]
    l.tpulsm_scan_blocks.restype = i64
    l.tpulsm_scan_blocks.argtypes = [
        u8p, i64,                                   # file buf, len
        i64p, i64p, i64,                            # block offs/lens, n
        ctypes.c_int32,                             # verify_crc
        u8p, i64, u8p, i64,                         # key/val out + caps
        i32p, i32p, i32p, i32p, i64,
        i64, i64,                                   # key_base, val_base
    ]
    l.tpulsm_scan_blocks_refvals.restype = i64
    l.tpulsm_scan_blocks_refvals.argtypes = [
        u8p, i64,                                   # file buf, len
        i64p, i64p, i64,                            # block offs/lens, n
        ctypes.c_int32,                             # verify_crc
        u8p, i64,                                   # key out + cap
        i32p, i32p, i32p, i32p, i64,
        i64, i64,                                   # key_base, val_image_base
    ]
    # The skiplist memtable's writers (db/memtable.py), on this
    # GIL-releasing handle: concurrent writer threads insert in parallel
    # (the splice is lock-free).
    l.tpulsm_skiplist_insert_batch.restype = i64
    l.tpulsm_skiplist_insert_batch.argtypes = [
        ctypes.c_void_p, u8p, i64p, i32p, u64p, u8p, i64p, i32p, i64,
    ]
    l.tpulsm_skiplist_insert_wb.restype = i64
    l.tpulsm_skiplist_insert_wb.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64, ctypes.c_uint64, i64p,
    ]
    # Per-entry protection (utils/protection.py, bit-identical): the fused
    # verify+insert of a protected batch (every record re-hashed against
    # the carried vector, inserted only if ALL match), the whole-batch
    # vector, and the XOR aggregate over a flush's columnar export.
    l.tpulsm_skiplist_insert_wb_prot.restype = i64
    l.tpulsm_skiplist_insert_wb_prot.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64, ctypes.c_uint64,
        u64p, i64, i32, i64p,
    ]
    l.tpulsm_wb_protect.restype = i64
    l.tpulsm_wb_protect.argtypes = [
        ctypes.c_char_p, i64, i32, i32, u64p, i64,
    ]
    l.tpulsm_columnar_protect.restype = i64
    l.tpulsm_columnar_protect.argtypes = [
        u8p, i32p, i32p, u8p, i32p, i32p, i32p, i64, i32, u64p,
    ]
    l.tpulsm_skiplist_export.restype = i64
    l.tpulsm_skiplist_export.argtypes = [
        ctypes.c_void_p, u8p, i64p, i32p, u64p, i32p,
        u8p, i64p, i32p, i64, i64p,
    ]
    # The zip-table plane (table/zip_table.py).
    l.tpulsm_zip_newkey.restype = i64
    l.tpulsm_zip_newkey.argtypes = [
        u8p, i64, i64p, i64, i32,                   # key buf, offs, n, uklen
        u8p,                                        # newkey out
    ]
    l.tpulsm_zip_encode_keys.restype = i64
    l.tpulsm_zip_encode_keys.argtypes = [
        u8p, i64, i64p, i64, i32,                   # key buf, offs, n, klen
        i64p, i32, i32,                             # trailer_ov, group, m16
        u8p, u8p, i64, u8p,                         # meta, sfx + cap, gso
    ]
    l.tpulsm_zip_encode_values.restype = i64
    l.tpulsm_zip_encode_values.argtypes = [
        u8p, i64, i64p, i64p, i64,                  # val buf, offs, lens, n
        i32, i32, i32, i32,                         # vg, compress, level, mdb
        u8p, i64, u8p, i64,                         # dict + cap, blob + cap
        u8p, u8p, i64p,                             # go, flags, out meta
    ]
    l.tpulsm_zip_decode_keys.restype = i64
    l.tpulsm_zip_decode_keys.argtypes = [
        u8p, i64, i32, u8p, i64,                    # kmeta, meta16, ksfx
        u8p, i64, i64, i32,                         # kgso, n, group
        i64, i64, u8p, i64, i64p, i64p, i64,        # e0, e1, out, key_base
    ]
    l.tpulsm_zip_group_decode.restype = i64
    l.tpulsm_zip_group_decode.argtypes = [
        u8p, i64, u8p, i64, u8p, i64, u8p, i64,     # blob, go, flags, dict
        i64, i64, i64p, u8p, i64,                   # g0, g1, raw offs, out
    ]
    # The scan plane's order (ops/scan_plane.py): host k-way merge of
    # presorted runs, and the stable sort for keys past its 8-byte path.
    for name in ("tpulsm_sort_entries", "tpulsm_merge_runs"):
        getattr(l, name).restype = i32
    l.tpulsm_sort_entries.argtypes = [
        u8p, i64p, i64p, i64,                       # key buf/offs/lens, n
        i32p, u8p, u64p,                            # order, new_key, packed
    ]
    l.tpulsm_merge_runs.argtypes = [
        u8p, i64p, i64p, i64,                       # key buf/offs/lens, n
        i64p, i32,                                  # run_starts, n_runs
        i32p, u8p, u64p,                            # order, new_key, packed
    ]
    # The fused group-commit write plane (db/db.py _native_group_commit):
    # validate a write group, frame its merged WAL record and apply it to
    # the skiplist, GIL-free.
    l.tpulsm_wb_group_commit.restype = i64
    l.tpulsm_wb_group_commit.argtypes = [
        ctypes.c_void_p, i32,                       # mem, mem_kind
        ctypes.POINTER(ctypes.c_char_p), i64p,      # reps, lens
        i64, ctypes.c_uint64,                       # n_batches, first_seq
        u64p, i64, i32,                             # prots, n, pb
        i32,                                        # mode
        i64, i64,                                   # block_off, log_no
        u8p, i64, i64p,                             # wal out/cap, out
    ]
    # The native point-read chain (db/db.py _native_get): table and
    # version handles, then the whole get chain in one GIL-free call
    # against a persistent per-thread context.
    vp = ctypes.c_void_p
    vpp = ctypes.POINTER(ctypes.c_void_p)
    l.tpulsm_table_handle_new.restype = vp
    l.tpulsm_table_handle_new.argtypes = [
        i32, ctypes.c_uint64, i32,                  # fd, cache id, flags
        u8p, i64, u8p, i64,                         # index, filter
        u8p, i32, u8p, i32,                         # smallest, largest uk
    ]
    l.tpulsm_zip_table_handle_new.restype = vp
    l.tpulsm_zip_table_handle_new.argtypes = [
        ctypes.c_uint64, i32, i32, i32,             # cache id, flags, G, VG
        i64, i32, i32,                              # n, meta16, lens32
        u8p, i64, u8p, i64, u8p, i64,               # kmeta, ksfx, kgso
        u8p, i64, u8p, i64, u8p, i64,               # vlens, vgo, vflags
        u8p, i64, u8p, i64,                         # vdict, vblob
        u8p, i64,                                   # filter
        u8p, i32, u8p, i32,                         # smallest, largest uk
    ]
    for name in ("tpulsm_table_handle_free", "tpulsm_version_handle_free",
                 "tpulsm_getctx_free"):
        getattr(l, name).restype = None
        getattr(l, name).argtypes = [vp]
    l.tpulsm_version_handle_new.restype = vp
    l.tpulsm_version_handle_new.argtypes = [vpp, i32, i32p, i32]
    l.tpulsm_block_cache_config.restype = None
    l.tpulsm_block_cache_config.argtypes = [i64, i64p]
    l.tpulsm_db_get.restype = i32
    l.tpulsm_db_get.argtypes = [
        vpp, i32, vp, ctypes.c_char_p, i32, ctypes.c_uint64,
        u8p, i32, i32p, i32p, i64p,
    ]
    l.tpulsm_db_get_kinds.restype = i32
    l.tpulsm_db_get_kinds.argtypes = [
        vpp, i32p, i32, vp, ctypes.c_char_p, i32, ctypes.c_uint64,
        u8p, i32, i32p, i32p, i64p,
    ]
    l.tpulsm_getctx_new.restype = vp
    l.tpulsm_getctx_new.argtypes = [vpp, i32, vp, i64]
    l.tpulsm_getctx_out.restype = vp
    l.tpulsm_getctx_out.argtypes = [vp]
    l.tpulsm_getctx_val.restype = vp
    l.tpulsm_getctx_val.argtypes = [vp]
    l.tpulsm_getctx_set_mem_kind.restype = None
    l.tpulsm_getctx_set_mem_kind.argtypes = [vp, i32, i32]
    l.tpulsm_getctx_get.restype = i32
    l.tpulsm_getctx_get.argtypes = [vp, ctypes.c_char_p, i32,
                                    ctypes.c_uint64]
    l.tpulsm_getctx_multiget.restype = i32
    l.tpulsm_getctx_multiget.argtypes = [
        vp, u8p, i64p, i32p, i64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int8), i64p, i64p, u8p, i64, i64p, i64p,
    ]


def lib() -> ctypes.CDLL | None:
    """The loaded native library, built if needed; None when the
    toolchain is unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale() and not _build():
            return None
        try:
            l = _load()
        except (OSError, AttributeError):
            l = None
        if l is None:
            # A drifted or unreadable artifact: one forced rebuild.
            if not _build():
                return None
            try:
                l = _load()
            except (OSError, AttributeError):
                return None
            if l is None:
                return None
        _bind(l)
        _lib = l
        return _lib


def pylib() -> ctypes.PyDLL | None:
    """GIL-holding handle for the skiplist memtable's short calls (create,
    single insert, seek, step, read a node): no GIL release per call, and
    lockless Python readers see a consistent rep. None when the library
    is unavailable."""
    global _pylib
    if _pylib is not None:
        return _pylib
    if lib() is None:  # builds and checks the library first
        return None
    l = ctypes.PyDLL(_SO)
    vp = ctypes.c_void_p
    l.tpulsm_skiplist_new.restype = vp
    l.tpulsm_skiplist_new.argtypes = []
    l.tpulsm_skiplist_free.restype = None
    l.tpulsm_skiplist_free.argtypes = [vp]
    l.tpulsm_skiplist_insert.restype = ctypes.c_int32
    l.tpulsm_skiplist_insert.argtypes = [
        vp, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint32,
    ]
    l.tpulsm_skiplist_count.restype = ctypes.c_int64
    l.tpulsm_skiplist_count.argtypes = [vp]
    l.tpulsm_skiplist_memory.restype = ctypes.c_int64
    l.tpulsm_skiplist_memory.argtypes = [vp]
    for name in ("tpulsm_skiplist_seek_ge", "tpulsm_skiplist_seek_lt"):
        fn = getattr(l, name)
        fn.restype = vp
        fn.argtypes = [vp, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64]
    for name in ("tpulsm_skiplist_first", "tpulsm_skiplist_last",
                 "tpulsm_skiplist_next"):
        fn = getattr(l, name)
        fn.restype = vp
        fn.argtypes = [vp]
    l.tpulsm_skiplist_node.restype = None
    l.tpulsm_skiplist_node.argtypes = [
        vp, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    with _lock:
        if _pylib is None:
            _pylib = l
    return _pylib


_FASTGET_SRC = os.path.join(_DIR, "fastget.c")
# Not the reference's `tpulsm_fastget`: both extensions may live in one
# process.
_FASTGET_NAME = "tpt_fastget"
_fastget_mod = None
_fastget_tried = False


def _fastget_so_path() -> str:
    # The interpreter's cache tag rides in the file name, so an extension
    # built for another CPython ABI is never loaded.
    import sys

    tag = getattr(sys.implementation, "cache_tag", None) or "py"
    return os.path.join(BUILD_DIR, f"{_FASTGET_NAME}.{tag}.so")


def fastget():
    """The C-extension call of tpulsm_getctx_get (`fastget.c`): get(ctx,
    key, snap_seq) -> bytes (found) | None (a decisive miss) | False (the
    Python chain must run). None when the extension cannot be built or
    loaded (no Python.h, no compiler): callers keep the ctypes call of the
    same native function."""
    global _fastget_mod, _fastget_tried
    if _fastget_mod is not None:
        return _fastget_mod.get
    if _fastget_tried or lib() is None:  # lib() takes _lock itself
        return None
    with _lock:
        if _fastget_mod is not None:
            return _fastget_mod.get
        if _fastget_tried:
            return None
        _fastget_tried = True
        so = _fastget_so_path()
        if _stale(so, _FASTGET_SRC):
            import sysconfig

            inc = sysconfig.get_paths().get("include")
            if not inc or not os.path.exists(os.path.join(inc, "Python.h")):
                return None
            if not _compile(_FASTGET_SRC, so, [f"-I{inc}", "-O2"]):
                return None
        try:
            import importlib.machinery
            import importlib.util

            loader = importlib.machinery.ExtensionFileLoader(
                _FASTGET_NAME, so)
            spec = importlib.util.spec_from_loader(_FASTGET_NAME, loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            mod.bind(_SO)
        except Exception as e:  # noqa: BLE001 - the ctypes call stays
            from toplingdb_tpu_torch.utils import errors

            errors.swallow(reason="fastget-bind-fallback", exc=e)
            return None
        _fastget_mod = mod
        return mod.get


def np_u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def np_i32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def np_i64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
