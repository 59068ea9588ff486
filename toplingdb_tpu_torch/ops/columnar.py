"""Columnar fixed-shape representation of KV entries for the device
programs (copied from toplingdb_tpu/ops/columnar.py).

Keys become [N, W] int32 big-endian words (zero-padded, with an explicit
length word as tie-break); values stay host-side as a Python list indexed
by the `idx` column — the device decides ordering/survival, the host moves
bytes.

Word transform: big-endian packing makes lexicographic byte order equal
numeric word order; XOR 0x80000000 maps unsigned order onto int32 order so
a signed sort orders them correctly.

Encoding is fully vectorized (numpy): one `np.array(keys, 'S...')` pad, one
take_along_axis for the 8-byte trailers — no per-entry Python loop.
"""

from __future__ import annotations

import sys

import numpy as np

_SIGN = np.uint32(0x80000000)
_INV_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


class ColumnarEntries:
    """Host-side columnar view of N internal-key entries."""

    __slots__ = (
        "key_words", "key_len", "inv_hi", "inv_lo", "vtype", "values",
        "ikeys", "seq", "max_key_bytes", "n",
    )

    def __init__(self, key_words, key_len, inv_hi, inv_lo, vtype, values,
                 ikeys, seq, max_key_bytes):
        self.key_words = key_words
        self.key_len = key_len      # user-key lengths [N] int32
        self.inv_hi = inv_hi
        self.inv_lo = inv_lo
        self.vtype = vtype          # [N] int32
        self.values = values        # list[bytes]
        self.ikeys = ikeys          # list[bytes] original internal keys
        self.seq = seq              # [N] uint64 seqnos
        self.max_key_bytes = max_key_bytes
        self.n = len(values)

    @staticmethod
    def from_entries(entries: list[tuple[bytes, bytes]],
                     max_key_bytes: int | None = None) -> "ColumnarEntries":
        """entries: [(internal_key, value)] in any order."""
        n = len(entries)
        ikeys = [k for k, _ in entries]
        values = [v for _, v in entries]
        lens = np.fromiter((len(k) for k in ikeys), dtype=np.int64, count=n)
        if n and lens.min() < 8:
            from toplingdb_tpu_torch.utils.status import Corruption

            raise Corruption("internal key shorter than 8 bytes")
        max_ik = int(lens.max()) if n else 8
        # Zero-padded byte matrix of all internal keys (C-level pad).
        arr = (
            np.array(ikeys, dtype=f"S{max_ik}")
            .view(np.uint8)
            .reshape(n, max_ik)
            if n else np.zeros((0, max_ik), dtype=np.uint8)
        )
        # Little-endian fixed64 trailer per row.
        tr_idx = (lens[:, None] - 8) + np.arange(8)[None, :]
        trailer = np.take_along_axis(arr, tr_idx, axis=1)
        packed = np.ascontiguousarray(trailer).view(np.uint64).reshape(n)
        if sys.byteorder == "big":  # the trailer bytes on disk are LE
            packed = packed.byteswap()
        seq = packed >> np.uint64(8)
        vtype = (packed & np.uint64(0xFF)).astype(np.int32)
        inv = _INV_MAX - packed
        inv_hi = ((inv >> np.uint64(32)).astype(np.uint32) ^ _SIGN).view(np.int32)
        inv_lo = ((inv & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ _SIGN).view(np.int32)

        uk_len = (lens - 8).astype(np.int32)
        maxlen = int(uk_len.max()) if n else 0
        if max_key_bytes is None:
            max_key_bytes = max(4, maxlen)
        if maxlen > max_key_bytes:
            raise ValueError(
                f"key length {maxlen} exceeds device key budget {max_key_bytes}"
            )
        w = (max_key_bytes + 3) // 4
        kb = np.zeros((n, w * 4), dtype=np.uint8)
        span = min(max_ik, w * 4)
        kb[:, :span] = arr[:, :span]
        # Zero out trailer bytes that bled into the key region.
        col = np.arange(w * 4, dtype=np.int64)[None, :]
        kb *= col < uk_len[:, None]
        words = np.ascontiguousarray(kb).reshape(n, w, 4).astype(np.uint32)
        packed_words = (
            (words[:, :, 0] << 24) | (words[:, :, 1] << 16)
            | (words[:, :, 2] << 8) | words[:, :, 3]
        )
        key_words = (packed_words ^ _SIGN).view(np.int32)
        return ColumnarEntries(
            key_words, uk_len, inv_hi, inv_lo, vtype, values, ikeys, seq,
            max_key_bytes,
        )

    def user_key(self, i: int) -> bytes:
        return self.ikeys[i][:-8]

    def seq_type_of(self, i: int) -> tuple[int, int]:
        return int(self.seq[i]), int(self.vtype[i])
