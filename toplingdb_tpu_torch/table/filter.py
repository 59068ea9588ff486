"""Filter policies: classic and cache-line blocked bloom (copied from
toplingdb_tpu/table/filter.py).

A filter over user keys (and, with a prefix extractor, their prefixes),
whole-file or partitioned by the builder, probed before any index or
data-block IO on point lookups; double hashing derived from xxh64.
"""

from __future__ import annotations

import math

from toplingdb_tpu_torch.utils import coding
from toplingdb_tpu_torch.utils.crc32c import xxh64


class FilterPolicy:
    def name(self) -> str:
        raise NotImplementedError

    def create_filter(self, keys: list[bytes]) -> bytes:
        raise NotImplementedError

    def key_may_match(self, key: bytes, filter_data: bytes) -> bool:
        raise NotImplementedError


class BloomFilterPolicy(FilterPolicy):
    """Classic bloom with k probes via double hashing.

    Layout: varint32 num_bits | 1B num_probes | bit array.
    """

    def __init__(self, bits_per_key: float = 10.0):
        self.bits_per_key = bits_per_key
        self.num_probes = max(1, min(30, int(round(bits_per_key * math.log(2)))))

    def name(self) -> str:
        return f"tpulsm.BloomFilter:{self.bits_per_key}"

    def _hashes(self, key: bytes, num_bits: int, num_probes: int):
        h = xxh64(key, 0xA0761D64)
        h1 = h & 0xFFFFFFFFFFFFFFFF
        h2 = ((h >> 33) | (h << 31)) & 0xFFFFFFFFFFFFFFFF | 1
        for i in range(num_probes):
            yield ((h1 + i * h2) & 0xFFFFFFFFFFFFFFFF) % num_bits

    def create_filter(self, keys: list[bytes]) -> bytes:
        n = max(1, len(keys))
        num_bits = max(64, int(n * self.bits_per_key))
        num_bytes = (num_bits + 7) // 8
        num_bits = num_bytes * 8
        bits = bytearray(num_bytes)
        for k in keys:
            for b in self._hashes(k, num_bits, self.num_probes):
                bits[b >> 3] |= 1 << (b & 7)
        out = bytearray()
        out += coding.encode_varint32(num_bits)
        out.append(self.num_probes)
        out += bits
        return bytes(out)

    def key_may_match(self, key: bytes, filter_data: bytes) -> bool:
        if not filter_data:
            return True
        try:
            num_bits, off = coding.decode_varint32(filter_data, 0)
            num_probes = filter_data[off]
            bits = memoryview(filter_data)[off + 1 :]
            if num_bits == 0 or len(bits) * 8 < num_bits:
                return True
            for b in self._hashes(key, num_bits, num_probes):
                if not (bits[b >> 3] >> (b & 7)) & 1:
                    return False
            return True
        except Exception:
            return True  # corrupt filter: fail open


class BlockedBloomFilterPolicy(FilterPolicy):
    """Cache-line blocked bloom (the reference's FastLocalBloom role,
    util/bloom_impl.h:FastLocalBloomImpl): every key's probes land in ONE
    64-byte line, so a filter check costs one DRAM access instead of
    num_probes scattered ones — the standard bloom's ~6 random misses
    dominated the hot Get chain at bench scale.

    Layout: varint32 num_lines | 1B num_probes | num_lines * 64B lines.
    Line = h % num_lines; in-line bits via double hashing mod 512.
    """

    LINE_BYTES = 64
    LINE_BITS = 512

    def __init__(self, bits_per_key: float = 10.0):
        self.bits_per_key = bits_per_key
        self.num_probes = max(1, min(30,
                                     int(round(bits_per_key * math.log(2)))))

    def name(self) -> str:
        return f"tpulsm.BlockedBloom:{self.bits_per_key}"

    def _line_and_bits(self, key: bytes, num_lines: int, num_probes: int):
        h = xxh64(key, 0xA0761D64)
        h1 = h & 0xFFFFFFFFFFFFFFFF
        h2 = ((h >> 33) | (h << 31)) & 0xFFFFFFFFFFFFFFFF | 1
        line = h1 % num_lines
        bits = [((h1 + (i + 1) * h2) & 0xFFFFFFFFFFFFFFFF) % self.LINE_BITS
                for i in range(num_probes)]
        return line, bits

    def create_filter(self, keys: list[bytes]) -> bytes:
        n = max(1, len(keys))
        num_lines = max(1, (int(n * self.bits_per_key) + self.LINE_BITS - 1)
                        // self.LINE_BITS)
        data = bytearray(num_lines * self.LINE_BYTES)
        for k in keys:
            line, bits = self._line_and_bits(k, num_lines, self.num_probes)
            base = line * self.LINE_BYTES
            for b in bits:
                data[base + (b >> 3)] |= 1 << (b & 7)
        out = bytearray()
        out += coding.encode_varint32(num_lines)
        out.append(self.num_probes)
        out += data
        return bytes(out)

    def key_may_match(self, key: bytes, filter_data: bytes) -> bool:
        if not filter_data:
            return True
        try:
            num_lines, off = coding.decode_varint32(filter_data, 0)
            num_probes = filter_data[off]
            data = memoryview(filter_data)[off + 1:]
            if num_lines == 0 or len(data) < num_lines * self.LINE_BYTES:
                return True
            line, bits = self._line_and_bits(key, num_lines, num_probes)
            base = line * self.LINE_BYTES
            for b in bits:
                if not (data[base + (b >> 3)] >> (b & 7)) & 1:
                    return False
            return True
        except Exception:
            return True  # corrupt filter: fail open


def build_filter_block_native(lib, bp: FilterPolicy, key_buf, offs,
                              uk_lens, n: int) -> bytes:
    """The filter-block bytes for n user keys held columnar (numpy
    buffers) — ONE implementation of the wire layout shared by the
    columnar and zip writers. Native fast path per policy kind; the
    Python fallback builds the SAME layout via the policy itself, so the
    data can never mismatch the recorded filter_policy_name (a classic
    layout under a BlockedBloom name would silently fail open on every
    probe)."""
    import numpy as np

    from toplingdb_tpu_torch import native

    name = bp.name()
    if lib is not None and n:
        o = np.ascontiguousarray(offs, dtype=np.int32)
        ln = np.ascontiguousarray(uk_lens, dtype=np.int32)
        if name.startswith("tpulsm.BlockedBloom") and \
                hasattr(lib, "tpulsm_bloom_build_blocked"):
            num_lines = max(1, (int(n * bp.bits_per_key) + 511) // 512)
            bits = np.zeros(num_lines * 64, dtype=np.uint8)
            lib.tpulsm_bloom_build_blocked(
                native.np_u8p(key_buf), native.np_i32p(o),
                native.np_i32p(ln), n, num_lines, bp.num_probes,
                native.np_u8p(bits))
            return (coding.encode_varint32(num_lines)
                    + bytes([bp.num_probes]) + bits.tobytes())
        if name.startswith("tpulsm.BloomFilter") and \
                hasattr(lib, "tpulsm_bloom_build"):
            num_bits = max(64, int(n * bp.bits_per_key))
            num_bytes = (num_bits + 7) // 8
            num_bits = num_bytes * 8
            bits = np.zeros(num_bytes, dtype=np.uint8)
            lib.tpulsm_bloom_build(
                native.np_u8p(key_buf), native.np_i32p(o),
                native.np_i32p(ln), n, num_bits, bp.num_probes,
                native.np_u8p(bits))
            return (coding.encode_varint32(num_bits)
                    + bytes([bp.num_probes]) + bits.tobytes())
    keys = [bytes(key_buf[int(offs[i]): int(offs[i]) + int(uk_lens[i])])
            for i in range(n)]
    return bp.create_filter(keys)


def filter_from_keys(bp: FilterPolicy, keys: list[bytes]) -> bytes:
    """The filter block over `keys` (user keys and, with a prefix
    extractor, prefixes): the native builder when the host library is
    there, the policy itself otherwise — the same bytes either way."""
    import numpy as np

    from toplingdb_tpu_torch import native

    n = len(keys)
    lens = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    offs = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    buf = np.frombuffer(b"".join(keys) or b"\0", dtype=np.uint8)
    return build_filter_block_native(native.lib(), bp, buf, offs, lens, n)


def filter_probe(policy: FilterPolicy | None, filter_data: bytes | None,
                 whole_key_filtering: bool, prefix_extractor,
                 user_key: bytes) -> bool:
    """The point-lookup filter probe shared by the table readers: the
    whole-key probe normally, the prefix probe when the file holds a
    prefix-only filter (whole_key_filtering=0 in its properties). Fails
    open when the filter or a needed extractor is unavailable."""
    if policy is None or filter_data is None:
        return True
    if not whole_key_filtering:
        pe = prefix_extractor
        if pe is None or not pe.in_domain(user_key):
            return True
        return policy.key_may_match(pe.transform(user_key), filter_data)
    return policy.key_may_match(user_key, filter_data)


def filter_policy_from_name(name: str) -> FilterPolicy | None:
    if name.startswith("tpulsm.BloomFilter:"):
        return BloomFilterPolicy(float(name.split(":", 1)[1]))
    if name.startswith("tpulsm.BlockedBloom:"):
        return BlockedBloomFilterPolicy(float(name.split(":", 1)[1]))
    return None
