"""Per-entry protection info (copied from toplingdb_tpu/utils/protection.py).

Role of RocksDB's `protection_bytes_per_key` / ProtectionInfo: every
key/value gets a small checksum the moment it enters a WriteBatch, carried alongside the entry
through the memtable and re-verified at each handoff — batch -> memtable
insert, memtable -> flush emission, compaction output emission, and
scan-plane chunk emission. Block CRCs protect bytes AT REST; protection
info protects them IN FLIGHT across the native/device hops where a buggy
kernel or bit flip could otherwise alter user bytes silently.

As in RocksDB, the checksum is XOR-composable from independently
hashed components (key, value, op type, column family), so a component
can be swapped without re-hashing the rest — `strip_cf` derives the
CF-free form the (per-CF) memtable stores from the CF-tagged form the
WriteBatch carries.

Hot path: this runs TWICE per record on every protected write (compute
at WriteBatch.add, re-verify at memtable insert), so the component hash
is zlib.crc32 (a builtin: no ctypes crossing) followed by ONE
multiply-xorshift lane mix — enough avalanche that even the 1-byte
truncation misses a flip only at the ideal 1/256 rate, at ~1.4us/call.
The hash is internal to the process (never persisted), so it owes no
format compatibility to anything.
"""

from __future__ import annotations

import zlib

_M64 = (1 << 64) - 1

# Domain-separation constants per component (arbitrary odd 64-bit).
_K_KEY = 0x9E3779B97F4A7C15
_K_VAL = 0xC2B2AE3D27D4EB4F
_K_TYPE = 0x165667B19E3779F9
_K_CF = 0x27D4EB2F165667C5

_crc = zlib.crc32


def _mix(h: int) -> int:
    """One multiply + xorshift: spreads the crc into all 8 lanes (the
    shift folds high bits down so low-byte truncation still sees them)."""
    h = (h * 0xBF58476D1CE4E5B9) & _M64
    return h ^ (h >> 29)


# Type terms are a tiny closed set (ValueType.MAX = 0x7F); CF terms
# memoize on demand.
_TYPE_TERMS = [_mix(_K_TYPE ^ t) for t in range(256)]
_CF_TERMS = {0: _mix(_K_CF ^ 1)}


def _cf_term(cf: int) -> int:
    t = _CF_TERMS.get(cf)
    if t is None:
        t = _CF_TERMS[cf] = _mix(_K_CF ^ (cf + 1))
    return t


def protect_entry(t: int, key: bytes, value: bytes | None, cf: int = 0) -> int:
    """Full (64-bit, untruncated) protection of one record. XOR of the
    four component hashes — see strip_cf."""
    v = value if value is not None else b""
    ct = _CF_TERMS.get(cf)
    if ct is None:
        ct = _cf_term(cf)
    return (
        _mix(_K_KEY ^ _crc(key) ^ (len(key) << 32))
        ^ _mix(_K_VAL ^ _crc(v) ^ (len(v) << 32))
        ^ _TYPE_TERMS[t]
        ^ ct
    )


def strip_cf(full: int, cf: int) -> int:
    """Swap the CF component for CF 0 (what a per-CF memtable stores:
    the memtable IS the column family, so the tag is redundant there)."""
    if cf == 0:
        return full
    return full ^ _cf_term(cf) ^ _CF_TERMS[0]


def kv_checksum(key: bytes, value: bytes) -> int:
    """Type/CF-free checksum of a (key, value) pair — the data-plane
    handoff form (scan-plane chunk emission banking)."""
    return (_mix(_K_KEY ^ _crc(key) ^ (len(key) << 32))
            ^ _mix(_K_VAL ^ _crc(value) ^ (len(value) << 32)))


def truncate(cs: int, nbytes: int) -> int:
    """Keep the low `nbytes` bytes (8/4/2/1, RocksDB's semantics)."""
    if nbytes >= 8:
        return cs & _M64
    return cs & ((1 << (8 * nbytes)) - 1)


VALID_PROTECTION_BYTES = (0, 1, 2, 4, 8)


def check_protection_bytes(n: int) -> None:
    if n not in VALID_PROTECTION_BYTES:
        from toplingdb_tpu_torch.utils.status import InvalidArgument

        raise InvalidArgument(
            f"protection_bytes_per_key must be one of "
            f"{VALID_PROTECTION_BYTES}, got {n!r}"
        )
