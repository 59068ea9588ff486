// Native C++ host core of toplingdb_tpu_torch: the SST codec the device
// compaction data plane runs on the host. This is the port's own copy of the
// routines it calls from toplingdb_tpu/native/tpulsm_native.cc, trimmed to
// them: CRC32C, xxhash64, block decode/encode, data-section and index-block
// builds (uncompressed, and snappy / zstd compressed), bloom fills, the
// whole-file columnar scans (inflating snappy / zstd blocks inline), the
// bulk block inflate, the zip-table plane (key front-coding, value-group
// encode with ZSTD dictionaries, key and value-group decode), and the
// skiplist memtable with its WriteBatch wire-image insert, and the DB's
// three host planes: the fused group-commit write plane
// (tpulsm_wb_group_commit), the point-read chain (table / version handles,
// a shared decompressed-block LRU, tpulsm_getctx_*) and the scan plane's
// host k-way merge and sort (tpulsm_merge_runs, tpulsm_sort_entries), and
// the compaction's host twin, the run merge with an inline MVCC GC mask
// (tpulsm_merge_gc_runs). The codec libraries are dlopen'd at run time, so the build needs none of
// their headers.
//
// Build (-Bsymbolic binds the library's calls to its own exports, so a
// second library exporting the same tpulsm_* names in the process, such
// as toplingdb_tpu's, never interposes on them):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -Wl,-Bsymbolic
//       -o lib.so tpulsm_native.cc -ldl
#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <climits>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <list>
#include <memory>
#include <mutex>
#include <numeric>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>
#include <unistd.h>
#ifdef __linux__
#include <sched.h>
#endif
#include <dlfcn.h>

// CPUs this process may run on (cgroup quota / affinity mask), not the
// host's core count.
static size_t effective_cpus() {
#ifdef __linux__
  cpu_set_t s;
  if (sched_getaffinity(0, sizeof(s), &s) == 0) {
    int c = CPU_COUNT(&s);
    if (c > 0) return static_cast<size_t>(c);
  }
#endif
  unsigned h = std::thread::hardware_concurrency();
  return h ? h : 1;
}

// Start a worker thread, or run the work inline when no thread can start.
static inline void spawn_or_inline_th(std::vector<std::thread>& pool,
                                      std::function<void()> fn) {
  try {
    pool.emplace_back(fn);
  } catch (...) {
    fn();
  }
}

extern "C" {

// ABI version handshake: the ctypes loader refuses a .so whose version
// differs from its own expectation. Bump whenever any exported signature
// changes shape.
#define TPULSM_ABI_VERSION 8

int32_t tpulsm_abi_version(void) { return TPULSM_ABI_VERSION; }

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, polynomial 0x82f63b78 reflected), slicing-by-8.
// Semantics match the reference util/crc32c.h: Value/Extend plus the rotated
// mask used to store CRCs of CRC-carrying payloads.
// ---------------------------------------------------------------------------

static uint32_t kCrcTable[8][256];
static std::once_flag kCrcOnce;

static void crc32c_build_tables() {
  const uint32_t poly = 0x82f63b78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = kCrcTable[0][i];
    for (int t = 1; t < 8; t++) {
      c = kCrcTable[0][c & 0xff] ^ (c >> 8);
      kCrcTable[t][i] = c;
    }
  }
}

static inline void crc32c_init() {
  // Parallel compression workers may race the first CRC use; a plain
  // boolean guard was UB (torn table visibility) — call_once fences.
  std::call_once(kCrcOnce, crc32c_build_tables);
}

uint32_t tpulsm_crc32c_extend(uint32_t crc, const uint8_t* data, size_t n) {
  crc32c_init();
  uint32_t c = crc ^ 0xffffffffu;
  // Align to 8 bytes.
  while (n && (reinterpret_cast<uintptr_t>(data) & 7)) {
    c = kCrcTable[0][(c ^ *data++) & 0xff] ^ (c >> 8);
    n--;
  }
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, data, 8);
    w ^= c;
    c = kCrcTable[7][w & 0xff] ^ kCrcTable[6][(w >> 8) & 0xff] ^
        kCrcTable[5][(w >> 16) & 0xff] ^ kCrcTable[4][(w >> 24) & 0xff] ^
        kCrcTable[3][(w >> 32) & 0xff] ^ kCrcTable[2][(w >> 40) & 0xff] ^
        kCrcTable[1][(w >> 48) & 0xff] ^ kCrcTable[0][(w >> 56) & 0xff];
    data += 8;
    n -= 8;
  }
  while (n--) {
    c = kCrcTable[0][(c ^ *data++) & 0xff] ^ (c >> 8);
  }
  return c ^ 0xffffffffu;
}

// ---------------------------------------------------------------------------
// xxHash64 — implemented from the public spec. Used for bloom-filter probes
// and general hashing (the reference vendors xxhash in util/xxhash.h).
// ---------------------------------------------------------------------------

static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl64(acc, 31);
  acc *= P1;
  return acc;
}

static inline uint64_t xxh_merge_round(uint64_t acc, uint64_t val) {
  val = xxh_round(0, val);
  acc ^= val;
  acc = acc * P1 + P4;
  return acc;
}

static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint64_t tpulsm_xxh64(const uint8_t* data, size_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, read64(p)); p += 8;
      v2 = xxh_round(v2, read64(p)); p += 8;
      v3 = xxh_round(v3, read64(p)); p += 8;
      v4 = xxh_round(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge_round(h, v1);
    h = xxh_merge_round(h, v2);
    h = xxh_merge_round(h, v3);
    h = xxh_merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, read64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Block codec: the restart-point entry format of toplingdb_tpu/table/block.py
//   entry = varint32 shared | varint32 non_shared | varint32 value_len
//           | key_delta | value
// with a fixed32 restart array + fixed32 restart count at the end.
// These functions are the native fast path for bulk scans (decode) and
// compaction output building (encode); byte-compatible with the Python
// BlockBuilder/BlockIter by construction (tests assert equality).
// ---------------------------------------------------------------------------

static inline const uint8_t* get_varint32(const uint8_t* p, const uint8_t* end,
                                          uint32_t* v) {
  uint32_t result = 0;
  int shift = 0;
  while (p < end && shift <= 28) {
    uint32_t b = *p++;
    result |= (b & 0x7f) << shift;
    if (b < 0x80) { *v = result; return p; }
    shift += 7;
  }
  return nullptr;
}

static inline const uint8_t* get_varint64(const uint8_t* p, const uint8_t* end,
                                          uint64_t* v) {
  uint64_t result = 0;
  int shift = 0;
  while (p < end && shift <= 63) {
    uint64_t b = *p++;
    result |= (b & 0x7f) << shift;
    if (b < 0x80) { *v = result; return p; }
    shift += 7;
  }
  return nullptr;
}

static inline size_t varint32_len(uint32_t v) {
  size_t n = 1;
  while (v >= 0x80) { v >>= 7; n++; }
  return n;
}

// Length of the common prefix of a[0..n) and b[0..n), word-at-a-time.
static inline uint32_t common_prefix_len(const uint8_t* a, const uint8_t* b,
                                         uint32_t n) {
  uint32_t i = 0;
  while (i + 8 <= n) {
    uint64_t x, y;
    std::memcpy(&x, a + i, 8);
    std::memcpy(&y, b + i, 8);
    uint64_t d = x ^ y;
    if (d) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
      return i + (uint32_t)(__builtin_clzll(d) >> 3);
#else
      return i + (uint32_t)(__builtin_ctzll(d) >> 3);
#endif
    }
    i += 8;
  }
  while (i < n && a[i] == b[i]) i++;
  return i;
}

static inline uint8_t* put_varint32(uint8_t* p, uint32_t v) {
  while (v >= 0x80) { *p++ = (v & 0x7f) | 0x80; v >>= 7; }
  *p++ = (uint8_t)v;
  return p;
}

// Decode one block. Returns the number of entries, or a negative error:
//   -1 corrupt, -2 key buffer too small, -3 value buffer too small,
//   -4 entry arrays too small.
// key bytes are prefix-restored into key_out; values copied into val_out.
int64_t tpulsm_decode_block(
    const uint8_t* block, int64_t block_len,
    uint8_t* key_out, int64_t key_cap,
    uint8_t* val_out, int64_t val_cap,
    int32_t* key_offs, int32_t* key_lens,
    int32_t* val_offs, int32_t* val_lens, int64_t max_entries) {
  if (block_len < 4) return -1;
  uint32_t num_restarts;
  std::memcpy(&num_restarts, block + block_len - 4, 4);
  int64_t limit = block_len - 4 - 4 * (int64_t)num_restarts;
  if (limit < 0) return -1;
  const uint8_t* p = block;
  const uint8_t* end = block + limit;
  int64_t n = 0;
  int64_t key_used = 0, val_used = 0;
  uint8_t* last_key = nullptr;
  uint32_t last_len = 0;
  while (p < end) {
    uint32_t shared, non_shared, vlen;
    if (p + 3 <= end && (p[0] | p[1] | p[2]) < 0x80) {
      // All three lengths are single-byte varints — the dominant case for
      // small-KV workloads; skips three bounds-checked decode calls.
      shared = p[0];
      non_shared = p[1];
      vlen = p[2];
      p += 3;
    } else {
      p = get_varint32(p, end, &shared);
      if (!p) return -1;
      p = get_varint32(p, end, &non_shared);
      if (!p) return -1;
      p = get_varint32(p, end, &vlen);
      if (!p) return -1;
    }
    if (p + non_shared + vlen > end) return -1;
    if (shared > last_len) return -1;
    if (n >= max_entries) return -4;
    uint32_t klen = shared + non_shared;
    if (key_used + klen > key_cap) return -2;
    if (val_used + vlen > val_cap) return -3;
    // Offsets are int32 on the Python side: refuse >2GiB columnar buffers
    // (-7 = too large for the native path; caller falls back).
    if (key_used + klen > 0x7FFFFF00LL || val_used + vlen > 0x7FFFFF00LL)
      return -7;
    uint8_t* kdst = key_out + key_used;
    if (shared) std::memcpy(kdst, last_key, shared);
    std::memcpy(kdst + shared, p, non_shared);
    p += non_shared;
    std::memcpy(val_out + val_used, p, vlen);
    p += vlen;
    key_offs[n] = (int32_t)key_used;
    key_lens[n] = (int32_t)klen;
    val_offs[n] = (int32_t)val_used;
    val_lens[n] = (int32_t)vlen;
    last_key = kdst;
    last_len = klen;
    key_used += klen;
    val_used += vlen;
    n++;
  }
  return n;
}

// Build one data block from columnar entries in `order` starting at `start`.
// Consumes entries until the size estimate reaches block_size_limit (always
// at least one). trailer_override[i] >= 0 replaces the key's trailing 8
// bytes with that little-endian value (seqno zeroing). Returns entries
// consumed; *out_len receives the block byte length (including restart
// array). Returns negative on overflow of out_cap (-2).
int64_t tpulsm_build_block(
    const uint8_t* key_buf, const int32_t* key_offs, const int32_t* key_lens,
    const uint8_t* val_buf, const int32_t* val_offs, const int32_t* val_lens,
    const int64_t* trailer_override,
    const int32_t* order, int64_t start, int64_t n_total,
    int64_t block_size_limit, int64_t restart_interval,
    uint8_t* out, int64_t out_cap, int64_t* out_len) {
  uint8_t last_key[4096];
  uint32_t last_len = 0;
  uint8_t cur_key[4096];
  int64_t used = 0;
  int64_t consumed = 0;
  uint32_t restarts[1024];
  uint32_t num_restarts = 1;
  restarts[0] = 0;
  int64_t counter = 0;
  for (int64_t i = start; i < n_total; i++) {
    int32_t e = order[i];
    uint32_t klen = (uint32_t)key_lens[e];
    if (klen > sizeof(cur_key)) return -3;  // key too long for native path
    std::memcpy(cur_key, key_buf + key_offs[e], klen);
    if (trailer_override[e] >= 0 && klen >= 8) {
      uint64_t t = (uint64_t)trailer_override[e];
      for (int b = 0; b < 8; b++) cur_key[klen - 8 + b] = (t >> (8 * b)) & 0xff;
    }
    uint32_t vlen = (uint32_t)val_lens[e];
    uint32_t shared = 0;
    if (counter < restart_interval) {
      uint32_t mx = klen < last_len ? klen : last_len;
      shared = common_prefix_len(last_key, cur_key, mx);
    } else {
      if (num_restarts >= 1024) {
        // Restart table full: cutting here would diverge byte-wise from the
        // Python BlockBuilder (unbounded restarts) — refuse (-8) so the
        // caller falls back to the per-entry path.
        return -8;
      }
      restarts[num_restarts++] = (uint32_t)used;
      counter = 0;
    }
    uint32_t non_shared = klen - shared;
    bool fast_lens = (shared | non_shared | vlen) < 0x80;
    int64_t need = (fast_lens ? 3
                              : (int64_t)varint32_len(shared) +
                                    varint32_len(non_shared) +
                                    varint32_len(vlen)) +
                   non_shared + vlen;
    if (used + need + 4 * (num_restarts + 1) + 4 > out_cap) return -2;
    uint8_t* p = out + used;
    if (fast_lens) {
      p[0] = (uint8_t)shared;
      p[1] = (uint8_t)non_shared;
      p[2] = (uint8_t)vlen;
      p += 3;
    } else {
      p = put_varint32(p, shared);
      p = put_varint32(p, non_shared);
      p = put_varint32(p, vlen);
    }
    std::memcpy(p, cur_key + shared, non_shared);
    p += non_shared;
    std::memcpy(p, val_buf + val_offs[e], vlen);
    p += vlen;
    used = p - out;
    std::memcpy(last_key, cur_key, klen);
    last_len = klen;
    counter++;
    consumed++;
    // Size estimate mirrors BlockBuilder.current_size_estimate().
    if (used + 4 * (int64_t)num_restarts + 4 >= block_size_limit) break;
  }
  // Restart array + count.
  for (uint32_t r = 0; r < num_restarts; r++) {
    std::memcpy(out + used, &restarts[r], 4);
    used += 4;
  }
  std::memcpy(out + used, &num_restarts, 4);
  used += 4;
  *out_len = used;
  return consumed;
}

// Build a RUN of framed data blocks in one call: each block is the exact
// bytes tpulsm_build_block emits, followed by the uncompressed type byte (0)
// and the masked crc32c trailer — i.e. write_block(NO_COMPRESSION) framing
// (reference table/format.cc block trailer). Stops when entries in
// [start, limit) are exhausted, when the output-file cut budget is reached
// (base_file_size + bytes emitted so far >= max_file_size, checked BEFORE
// every block except the first, mirroring the caller's per-iteration cut
// check), or when the per-block metadata arrays fill. Always emits at least
// one block or returns an error. block_counts[b]/block_payload_lens[b]
// receive entries-consumed and UNFRAMED payload length per block; *out_len
// the total framed section length. Returns blocks emitted, or negative:
// -2 out buffer too small for even one block, -3/-8 propagated from
// tpulsm_build_block on the first block (later blocks: returns the partial
// run and the next call surfaces the error).
int64_t tpulsm_build_data_section(
    const uint8_t* key_buf, const int32_t* key_offs, const int32_t* key_lens,
    const uint8_t* val_buf, const int32_t* val_offs, const int32_t* val_lens,
    const int64_t* trailer_override,
    const int32_t* order, int64_t start, int64_t limit,
    int64_t block_size_limit, int64_t restart_interval,
    int64_t base_file_size, int64_t max_file_size,
    int64_t* block_counts, int64_t* block_payload_lens, int64_t max_blocks,
    uint8_t* out, int64_t out_cap, int64_t* out_len) {
  int64_t pos = start;
  int64_t used = 0;
  int64_t nb = 0;
  while (pos < limit) {
    if (nb > 0) {
      if (base_file_size + used >= max_file_size) break;
      if (nb >= max_blocks) break;
    }
    int64_t payload_len = 0;
    int64_t avail = out_cap - used - 5;  // leave room for the 5-byte trailer
    int64_t rc = (avail <= 0) ? -2 : tpulsm_build_block(
        key_buf, key_offs, key_lens, val_buf, val_offs, val_lens,
        trailer_override, order, pos, limit,
        block_size_limit, restart_interval,
        out + used, avail, &payload_len);
    if (rc <= 0) {
      if (nb > 0) break;  // partial run; next call retries/fails this block
      return rc;
    }
    uint8_t* trailer = out + used + payload_len;
    trailer[0] = 0;  // kNoCompression
    uint32_t crc = tpulsm_crc32c_extend(0, out + used, (size_t)(payload_len + 1));
    uint32_t masked = ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
    std::memcpy(trailer + 1, &masked, 4);
    block_counts[nb] = rc;
    block_payload_lens[nb] = payload_len;
    nb++;
    used += payload_len + 5;
    pos += rc;
  }
  *out_len = used;
  return nb;
}

static inline uint8_t* put_varint64(uint8_t* p, uint64_t v) {
  while (v >= 128) {
    *p++ = (uint8_t)(v | 128);
    v >>= 7;
  }
  *p++ = (uint8_t)v;
  return p;
}

// ---------------------------------------------------------------------------
// Whole-file INDEX block build: per data block, the shortest internal-key
// separator to the next block's first key (InternalKeyComparator::
// FindShortestSeparator over the bytewise user comparator — reference
// db/dbformat.cc:217-239 role, bindings in db/dbformat.py:250) + the
// BlockHandle value, assembled with BlockBuilder prefix/restart semantics.
// Replaces ~2 Python calls per data block (the dominant per-block cost of
// the columnar writer at bench scale). The final entry uses the short
// successor of the last block's last key. Returns index entries emitted,
// -2 when out_cap is too small (caller grows), -3 oversized key.
// ---------------------------------------------------------------------------
int64_t tpulsm_build_index_block(
    const uint8_t* key_buf, const int32_t* key_offs, const int32_t* key_lens,
    const int64_t* trailer_override, const int32_t* order,
    const int64_t* block_pos, const int64_t* block_cnt,
    const int64_t* block_offsets, const int64_t* block_plens,
    int64_t n_blocks, int64_t restart_interval,
    uint8_t* out, int64_t out_cap, int64_t* out_len) {
  if (n_blocks <= 0) return -1;
  constexpr uint32_t kMaxKey = 4096;
  // packed (MAX_SEQUENCE_NUMBER, ValueType::MAX) trailer, little-endian.
  static const uint8_t kSeekTrailer[8] = {0x7F, 0xFF, 0xFF, 0xFF,
                                          0xFF, 0xFF, 0xFF, 0xFF};
  std::vector<uint8_t> last(kMaxKey), nextf(kMaxKey), sep(kMaxKey + 9),
      prev_added(kMaxKey + 9);
  std::vector<uint32_t> restarts;
  restarts.push_back(0);
  uint32_t prev_len = 0;
  int64_t used = 0;
  int64_t counter = 0;
  auto load_key = [&](int64_t pos, uint8_t* dst, uint32_t* len) -> bool {
    int32_t e = order[pos];
    uint32_t kl = (uint32_t)key_lens[e];
    if (kl > kMaxKey) return false;
    std::memcpy(dst, key_buf + key_offs[e], kl);
    if (trailer_override[e] >= 0 && kl >= 8) {
      uint64_t t = (uint64_t)trailer_override[e];
      for (int b = 0; b < 8; b++)
        dst[kl - 8 + b] = (uint8_t)((t >> (8 * b)) & 0xff);
    }
    *len = kl;
    return true;
  };
  for (int64_t b = 0; b < n_blocks; b++) {
    uint32_t last_len = 0;
    if (!load_key(block_pos[b] + block_cnt[b] - 1, last.data(), &last_len))
      return -3;
    uint32_t sep_len = 0;
    if (b + 1 < n_blocks) {
      uint32_t next_len = 0;
      if (!load_key(block_pos[b + 1], nextf.data(), &next_len)) return -3;
      // InternalKeyComparator::FindShortestSeparator (bytewise user cmp).
      uint32_t su = last_len - 8, lu = next_len - 8;
      uint32_t mn = su < lu ? su : lu;
      uint32_t i = 0;
      while (i < mn && last[i] == nextf[i]) i++;
      bool shortened = false;
      if (i < mn) {
        uint8_t c = last[i];
        if (c < 0xFF && (uint32_t)(c + 1) < (uint32_t)nextf[i]) {
          // user separator = last[0..i] + (c+1); shorter than su => tag
          // with the MAX (seq,type) trailer.
          if (i + 1 < su) {
            std::memcpy(sep.data(), last.data(), i);
            sep[i] = (uint8_t)(c + 1);
            std::memcpy(sep.data() + i + 1, kSeekTrailer, 8);
            sep_len = i + 1 + 8;
            shortened = true;
          }
        }
      }
      if (!shortened) {
        std::memcpy(sep.data(), last.data(), last_len);
        sep_len = last_len;
      }
    } else {
      // find_short_successor on the user key.
      uint32_t su = last_len - 8;
      uint32_t i = 0;
      while (i < su && last[i] == 0xFF) i++;
      if (i < su && i + 1 < su) {
        std::memcpy(sep.data(), last.data(), i);
        sep[i] = (uint8_t)(last[i] + 1);
        std::memcpy(sep.data() + i + 1, kSeekTrailer, 8);
        sep_len = i + 1 + 8;
      } else {
        std::memcpy(sep.data(), last.data(), last_len);
        sep_len = last_len;
      }
    }
    uint8_t hval[20];
    uint8_t* hp = put_varint64(hval, (uint64_t)block_offsets[b]);
    hp = put_varint64(hp, (uint64_t)block_plens[b]);
    uint32_t vlen = (uint32_t)(hp - hval);
    // BlockBuilder::add semantics.
    uint32_t shared = 0;
    if (counter < restart_interval) {
      uint32_t mx = sep_len < prev_len ? sep_len : prev_len;
      while (shared < mx && prev_added[shared] == sep[shared]) shared++;
    } else {
      restarts.push_back((uint32_t)used);
      counter = 0;
    }
    uint32_t non_shared = sep_len - shared;
    int64_t need = (int64_t)varint32_len(shared) + varint32_len(non_shared) +
                   varint32_len(vlen) + non_shared + vlen;
    if (used + need + 4 * (int64_t)(restarts.size() + 1) + 4 > out_cap)
      return -2;
    uint8_t* p = out + used;
    p = put_varint32(p, shared);
    p = put_varint32(p, non_shared);
    p = put_varint32(p, vlen);
    std::memcpy(p, sep.data() + shared, non_shared);
    p += non_shared;
    std::memcpy(p, hval, vlen);
    p += vlen;
    used = p - out;
    std::memcpy(prev_added.data(), sep.data(), sep_len);
    prev_len = sep_len;
    counter++;
  }
  for (uint32_t r : restarts) {
    std::memcpy(out + used, &r, 4);
    used += 4;
  }
  uint32_t nr = (uint32_t)restarts.size();
  std::memcpy(out + used, &nr, 4);
  used += 4;
  *out_len = used;
  return n_blocks;
}

// Bulk whole-file decode: every data block parsed in one native call.
// Blocks must be uncompressed (type byte 0) — returns -5 otherwise so the
// caller can fall back to per-block Python decompression. verify_crc != 0
// checks each block's masked crc32c trailer (returns -6 on mismatch).
// Returns total entries, or negative error (same codes as decode_block).
int64_t tpulsm_decode_blocks(
    const uint8_t* file_buf, int64_t file_len,
    const int64_t* block_offs, const int64_t* block_lens, int64_t n_blocks,
    int32_t verify_crc,
    uint8_t* key_out, int64_t key_cap,
    uint8_t* val_out, int64_t val_cap,
    int32_t* key_offs, int32_t* key_lens,
    int32_t* val_offs, int32_t* val_lens, int64_t max_entries) {
  int64_t total = 0;
  int64_t key_used = 0, val_used = 0;
  for (int64_t b = 0; b < n_blocks; b++) {
    int64_t off = block_offs[b];
    int64_t len = block_lens[b];
    // Overflow-safe (see tpulsm_scan_blocks): corrupt handles can carry
    // negative or int64-wrapping off/len.
    if (off < 0 || len < 0 || file_len < 5 || off > file_len - 5 ||
        len > file_len - 5 - off)
      return -1;
    uint8_t ctype = file_buf[off + len];
    if (ctype != 0) return -5;
    if (verify_crc) {
      uint32_t stored;
      std::memcpy(&stored, file_buf + off + len + 1, 4);
      // unmask: rot right 17 after subtracting delta (see utils/crc32c.py).
      uint32_t rot = stored - 0xa282ead8u;
      uint32_t crc = (rot >> 17) | (rot << 15);
      uint32_t actual = tpulsm_crc32c_extend(0, file_buf + off, (size_t)(len + 1));
      if (crc != actual) return -6;
    }
    int64_t rc = tpulsm_decode_block(
        file_buf + off, len,
        key_out + key_used, key_cap - key_used,
        val_out + val_used, val_cap - val_used,
        key_offs + total, key_lens + total,
        val_offs + total, val_lens + total, max_entries - total);
    if (rc < 0) return rc;
    if (key_used > 0x7FFFFF00LL || val_used > 0x7FFFFF00LL) return -7;
    // Shift offsets to the global buffers.
    for (int64_t i = 0; i < rc; i++) {
      key_offs[total + i] += (int32_t)key_used;
      val_offs[total + i] += (int32_t)val_used;
    }
    if (rc > 0) {
      key_used = key_offs[total + rc - 1] + key_lens[total + rc - 1];
      val_used = val_offs[total + rc - 1] + val_lens[total + rc - 1];
    }
    total += rc;
  }
  return total;
}

// Cache-line blocked bloom fill; must match table/filter.py
// BlockedBloomFilterPolicy (the reference's FastLocalBloom role): one
// 64B line per key (line = h % num_lines), in-line probes
// (h + (i+1)*h2) % 512.
void tpulsm_bloom_build_blocked(
    const uint8_t* key_buf, const int32_t* key_offs, const int32_t* key_lens,
    int64_t n, uint64_t num_lines, uint32_t num_probes, uint8_t* data) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = tpulsm_xxh64(key_buf + key_offs[i], (size_t)key_lens[i],
                              0xA0761D64ULL);
    uint64_t h2 = ((h >> 33) | (h << 31)) | 1ULL;
    uint8_t* line = data + (h % num_lines) * 64;
    uint64_t x = h;
    for (uint32_t k = 0; k < num_probes; k++) {
      x += h2;
      uint64_t b = x & 511;
      line[b >> 3] |= (uint8_t)(1u << (b & 7));
    }
  }
}

// Bloom filter bit array fill; must match table/filter.py BloomFilterPolicy:
// h = xxh64(key, 0xA0761D64); h2 = rotr(h, 33) | 1; probe_i = (h + i*h2) % bits.
void tpulsm_bloom_build(
    const uint8_t* key_buf, const int32_t* key_offs, const int32_t* key_lens,
    int64_t n, uint64_t num_bits, uint32_t num_probes, uint8_t* bits) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = tpulsm_xxh64(key_buf + key_offs[i], (size_t)key_lens[i],
                              0xA0761D64ULL);
    uint64_t h2 = ((h >> 33) | (h << 31)) | 1ULL;
    // NOTE: the probe sequence is (h + k*h2) mod 2^64 mod num_bits — the
    // 2^64 wraparound is part of the format (table/filter.py:47), so the
    // per-probe modulo cannot be replaced by incremental reduction.
    uint64_t x = h;
    for (uint32_t k = 0; k < num_probes; k++) {
      uint64_t b = x % num_bits;
      bits[b >> 3] |= (uint8_t)(1u << (b & 7));
      x += h2;
    }
  }
}



// ---------------------------------------------------------------------------
// Bulk block inflate: decompress EVERY data block of an SST image in one
// GIL-free call (snappy / zstd dlopen'd at runtime like the Python codecs
// module binds them), emitting a synthetic uncompressed file image
// (payload + 5-byte trailer per block) that feeds tpulsm_decode_blocks
// directly. Parallelized across the process's CPUs. The per-block Python
// loop this replaces was GIL-bound at ~40us/block.
// ---------------------------------------------------------------------------

namespace {

typedef int (*snappy_len_fn)(const char*, size_t, size_t*);
typedef int (*snappy_unc_fn)(const char*, size_t, char*, size_t*);
typedef size_t (*snappy_maxlen_fn)(size_t);
typedef int (*snappy_cmp_fn)(const char*, size_t, char*, size_t*);
typedef size_t (*zstd_sizefn)(const void*, size_t);
typedef size_t (*zstd_dec_fn)(void*, size_t, const void*, size_t);
typedef size_t (*zstd_cmp_fn)(void*, size_t, const void*, size_t, int);
typedef size_t (*zstd_bound_fn)(size_t);
typedef unsigned (*zstd_err_fn)(size_t);
typedef void* (*zstd_ctx_new_fn)();
typedef size_t (*zstd_ctx_free_fn)(void*);
typedef size_t (*zstd_cmp_dict_fn)(void*, void*, size_t, const void*, size_t,
                                   const void*, size_t, int);
typedef size_t (*zstd_dec_dict_fn)(void*, void*, size_t, const void*, size_t,
                                   const void*, size_t);
typedef size_t (*zdict_train_fn)(void*, size_t, const void*, const size_t*,
                                 unsigned);
typedef unsigned (*zdict_err_fn)(size_t);

struct Codecs {
  snappy_len_fn snappy_len = nullptr;
  snappy_unc_fn snappy_unc = nullptr;
  snappy_maxlen_fn snappy_maxlen = nullptr;
  snappy_cmp_fn snappy_cmp = nullptr;
  zstd_sizefn zstd_size = nullptr;
  zstd_dec_fn zstd_dec = nullptr;
  zstd_cmp_fn zstd_cmp = nullptr;
  zstd_bound_fn zstd_bound = nullptr;
  zstd_err_fn zstd_err = nullptr;
  // Dictionary surface for the zip-table kernels: the same libzstd the
  // Python utils/codecs.py binds, so trained dictionaries and compressed
  // frames are bit-identical across the two encoders.
  zstd_ctx_new_fn zstd_cctx_new = nullptr;
  zstd_ctx_free_fn zstd_cctx_free = nullptr;
  zstd_cmp_dict_fn zstd_cmp_dict = nullptr;
  zstd_ctx_new_fn zstd_dctx_new = nullptr;
  zstd_ctx_free_fn zstd_dctx_free = nullptr;
  zstd_dec_dict_fn zstd_dec_dict = nullptr;
  zdict_train_fn zdict_train = nullptr;
  zdict_err_fn zdict_err = nullptr;
};

const Codecs& codecs() {
  static Codecs c = [] {
    Codecs r;
    void* s = dlopen("libsnappy.so.1", RTLD_NOW);
    if (!s) s = dlopen("libsnappy.so", RTLD_NOW);
    if (s) {
      r.snappy_len =
          (snappy_len_fn)dlsym(s, "snappy_uncompressed_length");
      r.snappy_unc = (snappy_unc_fn)dlsym(s, "snappy_uncompress");
      r.snappy_maxlen =
          (snappy_maxlen_fn)dlsym(s, "snappy_max_compressed_length");
      r.snappy_cmp = (snappy_cmp_fn)dlsym(s, "snappy_compress");
    }
    void* z = dlopen("libzstd.so.1", RTLD_NOW);
    if (!z) z = dlopen("libzstd.so", RTLD_NOW);
    if (z) {
      r.zstd_size = (zstd_sizefn)dlsym(z, "ZSTD_getFrameContentSize");
      r.zstd_dec = (zstd_dec_fn)dlsym(z, "ZSTD_decompress");
      r.zstd_cmp = (zstd_cmp_fn)dlsym(z, "ZSTD_compress");
      r.zstd_bound = (zstd_bound_fn)dlsym(z, "ZSTD_compressBound");
      r.zstd_err = (zstd_err_fn)dlsym(z, "ZSTD_isError");
      r.zstd_cctx_new = (zstd_ctx_new_fn)dlsym(z, "ZSTD_createCCtx");
      r.zstd_cctx_free = (zstd_ctx_free_fn)dlsym(z, "ZSTD_freeCCtx");
      r.zstd_cmp_dict =
          (zstd_cmp_dict_fn)dlsym(z, "ZSTD_compress_usingDict");
      r.zstd_dctx_new = (zstd_ctx_new_fn)dlsym(z, "ZSTD_createDCtx");
      r.zstd_dctx_free = (zstd_ctx_free_fn)dlsym(z, "ZSTD_freeDCtx");
      r.zstd_dec_dict =
          (zstd_dec_dict_fn)dlsym(z, "ZSTD_decompress_usingDict");
      r.zdict_train = (zdict_train_fn)dlsym(z, "ZDICT_trainFromBuffer");
      r.zdict_err = (zdict_err_fn)dlsym(z, "ZDICT_isError");
    }
    return r;
  }();
  return c;
}

}  // namespace

// Inflate n framed blocks (payload at offs[b], len lens[b], type byte at
// offs[b]+lens[b]; types: 0 raw, 1 snappy, 7 zstd-no-dict) into `out` as
// payload + 5-byte zero trailer per block; out_offs/out_lens describe the
// emitted payloads. verify_crc checks the COMPRESSED frame crc first
// (masked crc32c, table/format.py framing). Returns total bytes used, or
// -1 codec unavailable / unsupported type (caller: Python fallback),
// -2 out_cap too small, -3 corrupt, -6 crc mismatch.
int64_t tpulsm_inflate_blocks(const uint8_t* file_buf, int64_t file_len,
                              const int64_t* offs, const int64_t* lens,
                              int64_t n, int32_t verify_crc,
                              uint8_t* out, int64_t out_cap,
                              int64_t* out_offs, int64_t* out_lens) {
  const Codecs& c = codecs();
  // Pass 1: sizes (serial; header peeks are cheap).
  int64_t used = 0;
  for (int64_t b = 0; b < n; b++) {
    int64_t off = offs[b], len = lens[b];
    // Overflow-safe (see tpulsm_scan_blocks): corrupt handles can carry
    // negative or int64-wrapping off/len.
    if (off < 0 || len < 0 || file_len < 5 || off > file_len - 5 ||
        len > file_len - 5 - off)
      return -3;
    uint8_t t = file_buf[off + len];
    size_t ulen = 0;
    if (t == 0) {
      ulen = (size_t)len;
    } else if (t == 1) {
      if (!c.snappy_len || !c.snappy_unc) return -1;
      if (c.snappy_len((const char*)file_buf + off, (size_t)len, &ulen) != 0)
        return -3;
    } else if (t == 7) {
      if (!c.zstd_size || !c.zstd_dec || !c.zstd_err) return -1;
      unsigned long long s =
          (unsigned long long)c.zstd_size(file_buf + off, (size_t)len);
      if (s == (unsigned long long)-1 || s == (unsigned long long)-2)
        return -1;  // unknown size / not a frame (dict etc.): Python path
      if (s > (1ull << 31)) return -3;
      ulen = (size_t)s;
    } else {
      return -1;  // lz4/zlib/bzip2: Python fallback
    }
    out_offs[b] = used;
    out_lens[b] = (int64_t)ulen;
    used += (int64_t)ulen + 5;
  }
  if (used > out_cap) return -2;
  // Pass 2: decompress in parallel.
  size_t nthreads = effective_cpus();
  if (nthreads > 8) nthreads = 8;
  if (n < 16) nthreads = 1;
  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};
  auto worker = [&] {
    while (true) {
      int64_t b = next.fetch_add(1, std::memory_order_relaxed);
      if (b >= n || err.load(std::memory_order_relaxed)) return;
      int64_t off = offs[b], len = lens[b];
      uint8_t t = file_buf[off + len];
      if (verify_crc) {
        uint32_t stored;
        std::memcpy(&stored, file_buf + off + len + 1, 4);
        uint32_t rot = stored - 0xa282ead8u;
        uint32_t crc = (rot >> 17) | (rot << 15);
        uint32_t actual =
            tpulsm_crc32c_extend(0, file_buf + off, (size_t)(len + 1));
        if (crc != actual) {
          err.store(6, std::memory_order_relaxed);
          return;
        }
      }
      uint8_t* dst = out + out_offs[b];
      size_t ulen = (size_t)out_lens[b];
      bool ok = true;
      if (t == 0) {
        std::memcpy(dst, file_buf + off, (size_t)len);
      } else if (t == 1) {
        size_t got = ulen;
        ok = c.snappy_unc((const char*)file_buf + off, (size_t)len,
                          (char*)dst, &got) == 0 && got == ulen;
      } else {
        size_t got = c.zstd_dec(dst, ulen, file_buf + off, (size_t)len);
        if (c.zstd_err(got)) {
          // Dictionary frames land here: not corruption — route the file
          // back to the Python per-block path, which has the dict.
          err.store(1, std::memory_order_relaxed);
          return;
        }
        ok = got == ulen;
      }
      if (!ok) {
        err.store(3, std::memory_order_relaxed);
        return;
      }
      std::memset(dst + ulen, 0, 5);  // type=0 + dummy crc (verify off)
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (size_t i = 1; i < nthreads; i++) {
      try {
        pool.emplace_back(worker);
      } catch (...) {
        break;
      }
    }
    worker();
    for (auto& w : pool) w.join();
  }
  int e = err.load();
  if (e == 6) return -6;
  if (e == 1) return -1;
  if (e) return -3;
  return used;
}

// ---------------------------------------------------------------------------
// Fused whole-file scan: inflate (if compressed) + decode EVERY data block
// in ONE call, writing straight into caller-provided slices of a shared
// columnar buffer (offsets emitted ABSOLUTE via key_base/val_base) — no
// synthetic uncompressed image, no Python-side copies, no concat. The
// per-block scratch is reused, so peak extra memory is one block.
// Returns total entries, or: -1 codec unavailable / exotic type (caller
// falls back), -2/-3 key/val capacity, -4 max_entries, -6 crc mismatch,
// -7 offsets exceed the int32 columnar budget, -8 corrupt.
// ---------------------------------------------------------------------------
int64_t tpulsm_scan_blocks(
    const uint8_t* file_buf, int64_t file_len,
    const int64_t* block_offs, const int64_t* block_lens, int64_t n_blocks,
    int32_t verify_crc,
    uint8_t* key_out, int64_t key_cap,
    uint8_t* val_out, int64_t val_cap,
    int32_t* key_offs, int32_t* key_lens,
    int32_t* val_offs, int32_t* val_lens, int64_t max_entries,
    int64_t key_base, int64_t val_base) {
  const Codecs& c = codecs();
  std::vector<uint8_t> scratch;
  int64_t total = 0, key_used = 0, val_used = 0;
  for (int64_t b = 0; b < n_blocks; b++) {
    int64_t off = block_offs[b];
    int64_t len = block_lens[b];
    // Overflow-safe bounds: a corrupt index handle can carry a negative
    // len or an off/len pair whose sum wraps int64; `off + len + 5` would
    // then pass the naive check and read out of bounds BEFORE the CRC
    // ever sees the block. Every comparison below stays within
    // [0, file_len], so nothing can wrap.
    if (off < 0 || len < 0 || file_len < 5 || off > file_len - 5 ||
        len > file_len - 5 - off)
      return -8;
    uint8_t t = file_buf[off + len];
    if (verify_crc) {
      uint32_t stored;
      std::memcpy(&stored, file_buf + off + len + 1, 4);
      uint32_t rot = stored - 0xa282ead8u;
      uint32_t crc = (rot >> 17) | (rot << 15);
      uint32_t actual =
          tpulsm_crc32c_extend(0, file_buf + off, (size_t)(len + 1));
      if (crc != actual) return -6;
    }
    const uint8_t* payload = file_buf + off;
    int64_t plen = len;
    if (t == 1) {
      if (!c.snappy_len || !c.snappy_unc) return -1;
      size_t ulen = 0;
      if (c.snappy_len((const char*)payload, (size_t)len, &ulen) != 0)
        return -8;
      try {
        if (scratch.size() < ulen) scratch.resize(ulen);
      } catch (...) {
        return -1;  // resource exhaustion, NOT corruption: fall back
      }
      size_t got = ulen;
      if (c.snappy_unc((const char*)payload, (size_t)len, (char*)scratch.data(),
                       &got) != 0 ||
          got != ulen)
        return -8;
      payload = scratch.data();
      plen = (int64_t)ulen;
    } else if (t == 7) {
      if (!c.zstd_size || !c.zstd_dec || !c.zstd_err) return -1;
      unsigned long long s =
          (unsigned long long)c.zstd_size(payload, (size_t)len);
      if (s == (unsigned long long)-1 || s == (unsigned long long)-2)
        return -1;  // unknown size / dict frame: Python path has the dict
      if (s > (1ull << 31)) return -1;  // oversized: compatible path
      try {
        if (scratch.size() < (size_t)s) scratch.resize((size_t)s);
      } catch (...) {
        return -1;  // resource exhaustion, NOT corruption: fall back
      }
      size_t got = c.zstd_dec(scratch.data(), (size_t)s, payload, (size_t)len);
      if (c.zstd_err(got) || got != (size_t)s) return -8;
      payload = scratch.data();
      plen = (int64_t)s;
    } else if (t != 0) {
      return -1;  // lz4/zlib/bzip2: Python fallback
    }
    int64_t rc = tpulsm_decode_block(
        payload, plen, key_out + key_used, key_cap - key_used,
        val_out + val_used, val_cap - val_used, key_offs + total,
        key_lens + total, val_offs + total, val_lens + total,
        max_entries - total);
    if (rc < 0) return rc;
    if (key_base + key_used > 0x7FFFFF00LL ||
        val_base + val_used > 0x7FFFFF00LL)
      return -7;
    int64_t kshift = key_base + key_used, vshift = val_base + val_used;
    for (int64_t i = 0; i < rc; i++) {
      key_offs[total + i] += (int32_t)kshift;
      val_offs[total + i] += (int32_t)vshift;
    }
    if (rc > 0) {
      key_used = key_offs[total + rc - 1] + key_lens[total + rc - 1] -
                 key_base;
      val_used = val_offs[total + rc - 1] + val_lens[total + rc - 1] -
                 val_base;
    }
    total += rc;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Keys-copied / VALUES-REFERENCED whole-file scan: like tpulsm_scan_blocks
// but blocks must already be UNCOMPRESSED in file_buf (a raw nocomp file
// or an inflate_blocks synthetic image), and value offsets point INTO
// that image (val_image_base + block offset + in-block position) instead
// of copying ~val-size bytes per entry out. The caller keeps the image
// alive as the columnar val_buf — at 10M-entry compactions the value
// copy was ~0.2-0.3s of pure memcpy. Returns entries, -2 key capacity,
// -4 entry capacity, -6 crc, -7 int32 offset budget, -8 corrupt,
// -5 a compressed block (caller inflates first).
// ---------------------------------------------------------------------------
int64_t tpulsm_scan_blocks_refvals(
    const uint8_t* file_buf, int64_t file_len,
    const int64_t* block_offs, const int64_t* block_lens, int64_t n_blocks,
    int32_t verify_crc,
    uint8_t* key_out, int64_t key_cap,
    int32_t* key_offs, int32_t* key_lens,
    int32_t* val_offs, int32_t* val_lens, int64_t max_entries,
    int64_t key_base, int64_t val_image_base) {
  int64_t total = 0, key_used = 0;
  uint8_t last_key[4096];
  for (int64_t b = 0; b < n_blocks; b++) {
    int64_t off = block_offs[b];
    int64_t len = block_lens[b];
    // Same overflow-safe bounds as tpulsm_scan_blocks: reject negative
    // lengths and signed-wrap off+len before touching file_buf.
    if (off < 0 || len < 0 || file_len < 5 || off > file_len - 5 ||
        len > file_len - 5 - off)
      return -8;
    if (file_buf[off + len] != 0) return -5;  // compressed: inflate first
    if (verify_crc) {
      uint32_t stored;
      std::memcpy(&stored, file_buf + off + len + 1, 4);
      uint32_t rot = stored - 0xa282ead8u;
      uint32_t crc = (rot >> 17) | (rot << 15);
      uint32_t actual =
          tpulsm_crc32c_extend(0, file_buf + off, (size_t)(len + 1));
      if (crc != actual) return -6;
    }
    const uint8_t* block = file_buf + off;
    if (len < 4) return -8;
    uint32_t num_restarts;
    std::memcpy(&num_restarts, block + len - 4, 4);
    int64_t limit = len - 4 - 4 * (int64_t)num_restarts;
    if (limit < 0) return -8;
    const uint8_t* p = block;
    const uint8_t* end = block + limit;
    uint32_t last_len = 0;
    while (p < end) {
      uint32_t shared, non_shared, vlen;
      if (p + 3 <= end && (p[0] | p[1] | p[2]) < 0x80) {
        shared = p[0];
        non_shared = p[1];
        vlen = p[2];
        p += 3;
      } else {
        p = get_varint32(p, end, &shared);
        if (!p) return -8;
        p = get_varint32(p, end, &non_shared);
        if (!p) return -8;
        p = get_varint32(p, end, &vlen);
        if (!p) return -8;
      }
      if (p + non_shared + vlen > end) return -8;
      if (shared > last_len) return -8;
      if (total >= max_entries) return -4;
      uint32_t klen = shared + non_shared;
      if (klen > sizeof(last_key)) return -8;
      if (key_used + klen > key_cap) return -2;
      if (key_base + key_used + klen > 0x7FFFFF00LL) return -7;
      uint8_t* kdst = key_out + key_used;
      if (shared) std::memcpy(kdst, last_key, shared);
      std::memcpy(kdst + shared, p, non_shared);
      std::memcpy(last_key, kdst, klen);
      last_len = klen;
      p += non_shared;
      int64_t vpos = val_image_base + off + (p - block);
      if (vpos + vlen > 0x7FFFFF00LL) return -7;
      key_offs[total] = (int32_t)(key_base + key_used);
      key_lens[total] = (int32_t)klen;
      val_offs[total] = (int32_t)vpos;
      val_lens[total] = (int32_t)vlen;
      key_used += klen;
      p += vlen;
      total++;
    }
  }
  return total;
}


// Compressed variant of tpulsm_build_data_section: each block builds RAW
// into scratch, compresses with `ctype` (1=snappy, 7=zstd at `level`;
// kept only when < raw - raw/8, the fmt.compress_for_block rule — else
// stored raw with type 0), then frames with the type byte + masked crc.
// block_raw_lens[b] = uncompressed payload length (props accounting).
// Extra return codes: -9 codec unavailable (caller: Python write path).
int64_t tpulsm_build_data_section_c(
    const uint8_t* key_buf, const int32_t* key_offs, const int32_t* key_lens,
    const uint8_t* val_buf, const int32_t* val_offs, const int32_t* val_lens,
    const int64_t* trailer_override,
    const int32_t* order, int64_t start, int64_t limit,
    int64_t block_size_limit, int64_t restart_interval,
    int32_t ctype, int32_t level,
    int64_t base_file_size, int64_t max_file_size,
    int64_t* block_counts, int64_t* block_payload_lens,
    int64_t* block_raw_lens, int64_t max_blocks,
    uint8_t* out, int64_t out_cap, int64_t* out_len) {
  const Codecs& c = codecs();
  if (ctype == 1 && (!c.snappy_maxlen || !c.snappy_cmp)) return -9;
  if (ctype == 7 && (!c.zstd_cmp || !c.zstd_bound || !c.zstd_err)) return -9;
  if (ctype != 1 && ctype != 7) return -9;
  // level semantics must MATCH the Python path byte-for-byte: the caller
  // passes INT32_MIN for "unset" (Python None -> zstd default 3); real
  // levels — including zstd's valid negative fast levels and 0 — pass
  // through unchanged.
  if (level == INT32_MIN) level = 3;

  // The reference's parallel block compression
  // (ParallelCompressionRep, block_based_table_builder.cc:818-825),
  // one-call form: blocks are CUT serially (entry consumption is
  // data-dependent), compressed in PARALLEL in windows (the per-block
  // raw-vs-compressed choice depends only on that block's bytes, so the
  // output is byte-identical to the serial form), then emitted serially
  // under the exact same file-size/out_cap cut rules. Blocks built past
  // a mid-window cut are discarded — wasted work only at file ends.
  struct Blk {
    std::vector<uint8_t> raw;      // unframed payload
    std::vector<uint8_t> framed;   // payload + type byte + masked crc
    int64_t raw_len = 0;
    int64_t payload_len = 0;
    int64_t count = 0;
    size_t bound = 0;
  };
  size_t nthreads = effective_cpus();
  if (nthreads > 8) nthreads = 8;
  int64_t pos = start;
  int64_t used = 0;
  int64_t nb = 0;
  std::vector<Blk> blks;
  bool stopped = false;
  while (pos < limit && !stopped) {
    // Window ≈ blocks remaining in THIS run's byte budget (callers pass
    // a budget every run, not only at file ends), so speculative
    // compression rarely overshoots the emit cut; capped to bound the
    // transient raw/framed memory at large block sizes.
    int64_t remaining = max_file_size - (base_file_size + used);
    int64_t est_blocks = remaining > 0
        ? remaining / (block_size_limit > 0 ? block_size_limit : 4096) + 2
        : 1;
    int64_t window = nthreads >= 2
        ? std::min<int64_t>(est_blocks, 64 * (int64_t)nthreads)
        : 1;
    if (window * (block_size_limit * 2 + 8192) > (int64_t)(256u << 20))
      window = std::max<int64_t>(
          1, (int64_t)(256u << 20) / (block_size_limit * 2 + 8192));
    // Phase 1: serially cut up to `window` raw blocks (speculative).
    blks.clear();
    try {
      blks.reserve((size_t)window);
    } catch (...) {
      *out_len = used;
      return nb > 0 ? nb : -2;
    }
    int64_t wpos = pos;
    for (int64_t w = 0; w < window && wpos < limit; w++) {
      Blk b;
      int64_t cap = block_size_limit * 2 + 8192;
      int64_t rc = -2;
      for (;;) {
        try {
          b.raw.resize((size_t)cap);
        } catch (...) {
          rc = -2;
          break;
        }
        rc = tpulsm_build_block(
            key_buf, key_offs, key_lens, val_buf, val_offs, val_lens,
            trailer_override, order, wpos, limit,
            block_size_limit, restart_interval,
            b.raw.data(), cap, &b.raw_len);
        if (rc == -2) {
          cap *= 2;
          continue;
        }
        break;
      }
      if (rc <= 0) {
        if (nb == 0 && w == 0) return rc;
        stopped = true;
        break;
      }
      b.count = rc;
      wpos += rc;
      blks.push_back(std::move(b));
    }
    if (blks.empty()) break;

    // Phase 2: parallel compress + frame each block into its own buffer.
    std::atomic<int64_t> next{0};
    std::atomic<int> fail{0};
    auto work = [&] {
      // Per-WORKER compress scratch, grown monotonically and reused
      // across this worker's blocks (a fresh zero-filled vector per
      // block would memset > block_size bytes each time).
      std::vector<uint8_t> cbuf;
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= (int64_t)blks.size()) return;
        Blk& b = blks[(size_t)i];
        size_t bound = ctype == 1 ? c.snappy_maxlen((size_t)b.raw_len)
                                  : c.zstd_bound((size_t)b.raw_len);
        b.bound = bound;
        try {
          if (cbuf.size() < bound) cbuf.resize(bound);
        } catch (...) {
          fail.store(1, std::memory_order_relaxed);
          return;
        }
        bool ok = true;
        size_t clen = bound;
        if (ctype == 1) {
          ok = c.snappy_cmp((const char*)b.raw.data(), (size_t)b.raw_len,
                            (char*)cbuf.data(), &clen) == 0;
        } else {
          clen = c.zstd_cmp(cbuf.data(), bound, b.raw.data(),
                            (size_t)b.raw_len, level);
          ok = !c.zstd_err(clen);
        }
        const uint8_t* payload;
        uint8_t tbyte;
        if (ok && (int64_t)clen < b.raw_len - b.raw_len / 8) {
          payload = cbuf.data();
          b.payload_len = (int64_t)clen;
          tbyte = (uint8_t)ctype;
        } else {
          payload = b.raw.data();
          b.payload_len = b.raw_len;
          tbyte = 0;
        }
        try {
          b.framed.resize((size_t)b.payload_len + 5);
        } catch (...) {
          fail.store(1, std::memory_order_relaxed);
          return;
        }
        std::memcpy(b.framed.data(), payload, (size_t)b.payload_len);
        b.framed[(size_t)b.payload_len] = tbyte;
        uint32_t crc = tpulsm_crc32c_extend(0, b.framed.data(),
                                            (size_t)(b.payload_len + 1));
        uint32_t masked = ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
        std::memcpy(b.framed.data() + b.payload_len + 1, &masked, 4);
      }
    };
    {
      std::vector<std::thread> pool;
      size_t nt = std::min(nthreads, blks.size());
      for (size_t t = 1; t < nt; t++) spawn_or_inline_th(pool, work);
      work();
      for (auto& w : pool) w.join();
    }
    if (fail.load()) {
      *out_len = used;
      return nb > 0 ? nb : -2;
    }

    // Phase 3: serial emit under the EXACT serial-path cut rules.
    for (Blk& b : blks) {
      if (nb > 0) {
        if (base_file_size + used >= max_file_size) {
          stopped = true;
          break;
        }
        if (nb >= max_blocks) {
          stopped = true;
          break;
        }
      }
      // Same bound check the serial form applied before compressing.
      if (used + (int64_t)b.bound + 5 > out_cap) {
        if (nb > 0) {
          stopped = true;
          break;
        }
        return -2;
      }
      if (b.framed[b.framed.size() - 5] == 0 &&
          used + b.raw_len + 5 > out_cap) {
        if (nb > 0) {
          stopped = true;
          break;
        }
        return -2;
      }
      std::memcpy(out + used, b.framed.data(), b.framed.size());
      block_counts[nb] = b.count;
      block_payload_lens[nb] = b.payload_len;
      block_raw_lens[nb] = b.raw_len;
      nb++;
      used += (int64_t)b.framed.size();
      pos += b.count;
    }
  }
  *out_len = used;
  return nb;
}

// ---------------------------------------------------------------------------
// Zip-table data plane (table/zip_table.py): batched builder kernels that
// replace the numpy matrix materialization in write_tables_zip_columnar
// (key gather + front-coding + value group compression were the whole
// serial cost), and reader kernels that decode front-coded key groups /
// compressed value groups straight into the scan plane's columnar
// buffers. The builder kernels must be BIT-IDENTICAL to the Python
// encoders — same front-coding ties, same ZDICT sampling stride, same
// per-group "compress only if smaller" decision — because the Python
// writer is the parity oracle.
// ---------------------------------------------------------------------------

static inline uint32_t zload_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// newkey[i] = 1 iff the first `uklen` key bytes of row i differ from row
// i-1 (row 0 always 1): the survivor-boundary vector the zip writer cuts
// value groups on. offs are per-row byte offsets into key_buf. Returns n,
// or -3 on out-of-range offsets.
int64_t tpulsm_zip_newkey(const uint8_t* key_buf, int64_t key_buf_len,
                          const int64_t* offs, int64_t n, int32_t uklen,
                          uint8_t* out) {
  if (n <= 0 || uklen < 0) return -3;
  for (int64_t i = 0; i < n; i++)
    if (offs[i] < 0 || offs[i] > key_buf_len - uklen) return -3;
  out[0] = 1;
  size_t nthreads = effective_cpus();
  if (nthreads > 8) nthreads = 8;
  if (n < (1 << 16)) nthreads = 1;
  std::atomic<int64_t> next_c{1};
  const int64_t kChunk = 1 << 15;
  auto worker = [&] {
    while (true) {
      int64_t lo = next_c.fetch_add(kChunk, std::memory_order_relaxed);
      if (lo >= n) return;
      int64_t hi = lo + kChunk < n ? lo + kChunk : n;
      for (int64_t i = lo; i < hi; i++)
        out[i] = std::memcmp(key_buf + offs[i], key_buf + offs[i - 1],
                             (size_t)uklen) != 0;
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (size_t i = 1; i < nthreads; i++) {
      try {
        pool.emplace_back(worker);
      } catch (...) {
        break;
      }
    }
    worker();
    for (auto& w : pool) w.join();
  }
  return n;
}

// Front-code one zip segment: rows are full internal keys of uniform
// length `klen` at key_buf[offs[i]], with the 8-byte trailer REPLACED by
// the little-endian bytes of trailer_ov[i] when >= 0 (the compaction's
// seqno-zeroing patch, applied on the fly instead of on a materialized
// matrix). Emits (plen, slen) meta pairs (u16 LE when meta16 else u8),
// the concatenated suffix stream, and the per-group suffix offsets
// (u32). Prefix lengths tie byte-for-byte with the numpy argmin over the
// FULL key including the patched trailer. Returns the suffix length, or
// -2 sfx_cap too small, -3 invalid shape/offsets.
int64_t tpulsm_zip_encode_keys(
    const uint8_t* key_buf, int64_t key_buf_len, const int64_t* offs,
    int64_t n, int32_t klen, const int64_t* trailer_ov, int32_t group,
    int32_t meta16, uint8_t* meta_out, uint8_t* sfx_out, int64_t sfx_cap,
    uint8_t* gso_out) {
  if (n <= 0 || group <= 0 || klen < 8) return -3;
  if (meta16 ? klen > 0xFFFF : klen > 0xFF) return -3;
  for (int64_t i = 0; i < n; i++)
    if (offs[i] < 0 || offs[i] > key_buf_len - klen) return -3;
  const int32_t uk = klen - 8;
  auto tbyte = [&](int64_t i, int32_t j) -> uint8_t {
    int64_t ov = trailer_ov[i];
    if (ov >= 0) return (uint8_t)((uint64_t)ov >> (8 * (j - uk)));
    return key_buf[offs[i] + j];
  };
  std::vector<uint32_t> pl(n, 0);
  size_t nthreads = effective_cpus();
  if (nthreads > 8) nthreads = 8;
  if (n < (1 << 14)) nthreads = 1;
  {
    std::atomic<int64_t> next_c{0};
    const int64_t kChunk = 1 << 13;
    auto worker = [&] {
      while (true) {
        int64_t lo = next_c.fetch_add(kChunk, std::memory_order_relaxed);
        if (lo >= n) return;
        int64_t hi = lo + kChunk < n ? lo + kChunk : n;
        for (int64_t i = lo; i < hi; i++) {
          if (i == 0 || i % group == 0) continue;  // group heads: plen 0
          const uint8_t* a = key_buf + offs[i - 1];
          const uint8_t* b = key_buf + offs[i];
          int32_t p = 0;
          while (p < uk && a[p] == b[p]) p++;
          if (p == uk)
            while (p < klen && tbyte(i - 1, p) == tbyte(i, p)) p++;
          pl[i] = (uint32_t)p;
        }
      }
    };
    if (nthreads <= 1) {
      worker();
    } else {
      std::vector<std::thread> pool;
      for (size_t i = 1; i < nthreads; i++) {
        try {
          pool.emplace_back(worker);
        } catch (...) {
          break;
        }
      }
      worker();
      for (auto& w : pool) w.join();
    }
  }
  // Serial: meta pairs, per-row suffix offsets, group directory.
  std::vector<int64_t> soff(n);
  int64_t cum = 0;
  for (int64_t i = 0; i < n; i++) {
    uint32_t p = pl[i], s = (uint32_t)klen - p;
    if (meta16) {
      uint16_t a = (uint16_t)p, b = (uint16_t)s;
      std::memcpy(meta_out + 4 * i, &a, 2);
      std::memcpy(meta_out + 4 * i + 2, &b, 2);
    } else {
      meta_out[2 * i] = (uint8_t)p;
      meta_out[2 * i + 1] = (uint8_t)s;
    }
    soff[i] = cum;
    if (i % group == 0) {
      if (cum > 0xFFFFFFFFll) return -3;  // u32 directory would wrap
      uint32_t v = (uint32_t)cum;
      std::memcpy(gso_out + 4 * (i / group), &v, 4);
    }
    cum += s;
  }
  if (cum > sfx_cap) return -2;
  // Parallel: suffix byte emission.
  {
    std::atomic<int64_t> next_c{0};
    const int64_t kChunk = 1 << 13;
    auto worker = [&] {
      while (true) {
        int64_t lo = next_c.fetch_add(kChunk, std::memory_order_relaxed);
        if (lo >= n) return;
        int64_t hi = lo + kChunk < n ? lo + kChunk : n;
        for (int64_t i = lo; i < hi; i++) {
          int32_t j = (int32_t)pl[i];
          uint8_t* dst = sfx_out + soff[i];
          const uint8_t* src = key_buf + offs[i];
          if (j < uk) {
            std::memcpy(dst, src + j, (size_t)(uk - j));
            dst += uk - j;
            j = uk;
          }
          int64_t ov = trailer_ov[i];
          if (ov >= 0) {
            for (; j < klen; j++)
              *dst++ = (uint8_t)((uint64_t)ov >> (8 * (j - uk)));
          } else if (j < klen) {
            std::memcpy(dst, src + j, (size_t)(klen - j));
          }
        }
      }
    };
    if (nthreads <= 1) {
      worker();
    } else {
      std::vector<std::thread> pool;
      for (size_t i = 1; i < nthreads; i++) {
        try {
          pool.emplace_back(worker);
        } catch (...) {
          break;
        }
      }
      worker();
      for (auto& w : pool) w.join();
    }
  }
  return cum;
}

// Value-plane encoder for one zip segment: gathers each VG-entry value
// group from the columnar value buffer, trains one ZDICT dictionary over
// every (ngroups//256)-th group (the Python sampling stride), compresses
// groups >= 32 raw bytes in parallel, and packs payloads ("compress only
// if strictly smaller" per group, flag bit set) with the u32 offset
// directory. dict_out must hold max_dict_bytes; flags_out arrives
// zeroed. out_meta returns [blob_len, dict_len]. Returns the group
// count, or -1 zstd/ZDICT entry points unavailable (Python fallback),
// -2 blob_cap/dict_cap too small, -3 invalid offsets or a compressor
// error.
int64_t tpulsm_zip_encode_values(
    const uint8_t* val_buf, int64_t val_buf_len, const int64_t* offs,
    const int64_t* lens, int64_t n, int32_t vg, int32_t compress,
    int32_t level, int32_t max_dict_bytes, uint8_t* dict_out,
    int64_t dict_cap, uint8_t* blob_out, int64_t blob_cap,
    uint8_t* go_out, uint8_t* flags_out, int64_t* out_meta) {
  if (n <= 0 || vg <= 0) return -3;
  const int64_t ng = (n + vg - 1) / vg;
  std::vector<int64_t> gb(ng + 1, 0);
  for (int64_t i = 0; i < n; i++) {
    if (lens[i] < 0 || offs[i] < 0 || lens[i] > val_buf_len ||
        offs[i] > val_buf_len - lens[i])
      return -3;
    gb[i / vg + 1] += lens[i];
  }
  for (int64_t g = 0; g < ng; g++) gb[g + 1] += gb[g];
  auto gather = [&](int64_t g, uint8_t* dst) {
    int64_t e1 = (g + 1) * (int64_t)vg;
    if (e1 > n) e1 = n;
    for (int64_t i = g * (int64_t)vg; i < e1; i++) {
      std::memcpy(dst, val_buf + offs[i], (size_t)lens[i]);
      dst += lens[i];
    }
  };
  const Codecs& c = codecs();
  int64_t dlen = 0;
  if (compress) {
    if (!c.zstd_cmp || !c.zstd_bound || !c.zstd_err) return -1;
    if (max_dict_bytes > 0 && ng >= 8) {
      if (!c.zdict_train || !c.zdict_err || !c.zstd_cmp_dict ||
          !c.zstd_cctx_new || !c.zstd_cctx_free)
        return -1;
      if (dict_cap < max_dict_bytes) return -2;
      int64_t stride = ng / 256;
      if (stride < 1) stride = 1;
      std::string sblob;
      std::vector<size_t> sizes;
      for (int64_t g = 0; g < ng; g += stride) {
        size_t base = sblob.size();
        sblob.resize(base + (size_t)(gb[g + 1] - gb[g]));
        gather(g, (uint8_t*)&sblob[base]);
        sizes.push_back((size_t)(gb[g + 1] - gb[g]));
      }
      size_t r = c.zdict_train(dict_out, (size_t)max_dict_bytes,
                               sblob.data(), sizes.data(),
                               (unsigned)sizes.size());
      // Training failure is NOT an error: the Python path gets b"" and
      // compresses dictionary-less (utils/codecs.py contract).
      if (!c.zdict_err(r)) dlen = (int64_t)r;
    }
  }
  std::vector<std::string> zs(ng);  // "" → raw payload
  if (compress) {
    size_t nthreads = effective_cpus();
    if (nthreads > 8) nthreads = 8;
    if (ng < 4) nthreads = 1;
    std::atomic<int64_t> nextg{0};
    std::atomic<int> err{0};
    auto worker = [&] {
      void* cctx = nullptr;
      if (dlen > 0) {
        cctx = c.zstd_cctx_new();
        if (!cctx) {
          err.store(1, std::memory_order_relaxed);
          return;
        }
      }
      std::vector<uint8_t> raw;
      while (true) {
        int64_t g = nextg.fetch_add(1, std::memory_order_relaxed);
        if (g >= ng || err.load(std::memory_order_relaxed)) break;
        int64_t rsz = gb[g + 1] - gb[g];
        if (rsz < 32) continue;  // python skips tiny groups entirely
        if ((int64_t)raw.size() < rsz) raw.resize((size_t)rsz);
        gather(g, raw.data());
        size_t bound = c.zstd_bound((size_t)rsz);
        std::string z;
        z.resize(bound);
        size_t zn = dlen > 0
                        ? c.zstd_cmp_dict(cctx, &z[0], bound, raw.data(),
                                          (size_t)rsz, dict_out,
                                          (size_t)dlen, level)
                        : c.zstd_cmp(&z[0], bound, raw.data(), (size_t)rsz,
                                     level);
        if (c.zstd_err(zn)) {
          err.store(2, std::memory_order_relaxed);
          break;
        }
        z.resize(zn);
        zs[g] = std::move(z);
      }
      if (cctx) c.zstd_cctx_free(cctx);
    };
    if (nthreads <= 1) {
      worker();
    } else {
      std::vector<std::thread> pool;
      for (size_t i = 1; i < nthreads; i++) {
        try {
          pool.emplace_back(worker);
        } catch (...) {
          break;
        }
      }
      worker();
      for (auto& w : pool) w.join();
    }
    if (err.load()) return err.load() == 1 ? -1 : -3;
  }
  // Serial pack: compressed payload only when strictly smaller.
  int64_t cum = 0;
  uint32_t zero = 0;
  std::memcpy(go_out, &zero, 4);
  for (int64_t g = 0; g < ng; g++) {
    int64_t rsz = gb[g + 1] - gb[g];
    bool use_z = !zs[g].empty() && (int64_t)zs[g].size() < rsz;
    int64_t psz = use_z ? (int64_t)zs[g].size() : rsz;
    if (psz > blob_cap - cum) return -2;
    if (use_z) {
      std::memcpy(blob_out + cum, zs[g].data(), (size_t)psz);
      flags_out[g >> 3] |= (uint8_t)(1 << (g & 7));
    } else {
      gather(g, blob_out + cum);
    }
    cum += psz;
    if (cum > 0xFFFFFFFFll) return -3;  // u32 directory would wrap
    uint32_t v = (uint32_t)cum;
    std::memcpy(go_out + 4 * (g + 1), &v, 4);
  }
  out_meta[0] = cum;
  out_meta[1] = dlen;
  return ng;
}

// Reconstruct full internal keys for zip entries [e0, e1) into a
// columnar slab: key_offs/key_lens are emitted per entry (offsets
// ABSOLUTE via key_base). The meta/suffix/directory buffers come straight
// from an on-disk file, so every offset is treated as hostile and
// bounds-checked before use. Returns bytes written, or -2 key_cap too
// small, -3 malformed sections/ranges.
int64_t tpulsm_zip_decode_keys(
    const uint8_t* kmeta, int64_t kmeta_len, int32_t meta16,
    const uint8_t* ksfx, int64_t ksfx_len, const uint8_t* kgso,
    int64_t kgso_len, int64_t n, int32_t group, int64_t e0, int64_t e1,
    uint8_t* key_out, int64_t key_cap, int64_t* key_offs,
    int64_t* key_lens, int64_t key_base) {
  const int64_t kMaxKey = 1 << 17;
  if (n < 0 || group <= 0 || e0 < 0 || e0 > e1 || e1 > n) return -3;
  if (e0 == e1) return 0;
  const int64_t msz = meta16 ? 4 : 2;
  if (n > kmeta_len / msz) return -3;
  const int64_t ng = (n + group - 1) / group;
  if (ng > kgso_len / 4) return -3;
  auto meta_at = [&](int64_t i, uint32_t* p, uint32_t* s) {
    if (meta16) {
      uint16_t a, b;
      std::memcpy(&a, kmeta + 4 * i, 2);
      std::memcpy(&b, kmeta + 4 * i + 2, 2);
      *p = a;
      *s = b;
    } else {
      *p = kmeta[2 * i];
      *s = kmeta[2 * i + 1];
    }
  };
  const int64_t g0 = e0 / group, g1 = (e1 - 1) / group;
  // Serial validation + length prefix: the parallel decode below trusts
  // exactly what this pass proves (front-coding chain, suffix bounds).
  int64_t cum = 0;
  for (int64_t g = g0; g <= g1; g++) {
    uint64_t so = zload_u32(kgso + 4 * g);
    if (so > (uint64_t)ksfx_len) return -3;
    uint64_t klen_prev = 0;
    int64_t jend = (g + 1) * (int64_t)group;
    if (jend > e1) jend = e1;
    for (int64_t j = g * (int64_t)group; j < jend; j++) {
      uint32_t p, s;
      meta_at(j, &p, &s);
      if (j % group == 0 && p != 0) return -3;
      uint64_t klen = (uint64_t)p + s;
      if (p > klen_prev || klen == 0 || klen > (uint64_t)kMaxKey) return -3;
      if (s > (uint64_t)ksfx_len - so) return -3;
      so += s;
      klen_prev = klen;
      if (j >= e0) {
        key_offs[j - e0] = key_base + cum;
        key_lens[j - e0] = (int64_t)klen;
        cum += (int64_t)klen;
      }
    }
  }
  if (cum > key_cap) return -2;
  size_t nthreads = effective_cpus();
  if (nthreads > 8) nthreads = 8;
  if (g1 - g0 < 8) nthreads = 1;
  std::atomic<int64_t> nextg{g0};
  auto worker = [&] {
    std::vector<uint8_t> cur((size_t)kMaxKey);
    while (true) {
      int64_t g = nextg.fetch_add(1, std::memory_order_relaxed);
      if (g > g1) return;
      uint64_t so = zload_u32(kgso + 4 * g);
      int64_t jend = (g + 1) * (int64_t)group;
      if (jend > e1) jend = e1;
      for (int64_t j = g * (int64_t)group; j < jend; j++) {
        uint32_t p, s;
        meta_at(j, &p, &s);
        std::memcpy(cur.data() + p, ksfx + so, s);
        so += s;
        if (j >= e0)
          std::memcpy(key_out + (key_offs[j - e0] - key_base), cur.data(),
                      (size_t)(p + s));
      }
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (size_t i = 1; i < nthreads; i++) {
      try {
        pool.emplace_back(worker);
      } catch (...) {
        break;
      }
    }
    worker();
    for (auto& w : pool) w.join();
  }
  return cum;
}

// Bulk-decode zip value groups [g0, g1) into one contiguous raw buffer:
// raw_offs (g1-g0+1 entries, raw_offs[0] == 0) gives each group's output
// offset AND expected raw size — the caller derives both from the
// v.lens section, and a group that inflates to anything else is
// corruption. Raw (unflagged) groups memcpy straight through. Returns
// total bytes, or -1 zstd unavailable for a flagged group, -2 out_cap
// too small, -3 malformed directory/payload.
int64_t tpulsm_zip_group_decode(
    const uint8_t* vblob, int64_t vblob_len, const uint8_t* vgo,
    int64_t vgo_len, const uint8_t* vflags, int64_t vflags_len,
    const uint8_t* vdict, int64_t vdict_len, int64_t g0, int64_t g1,
    const int64_t* raw_offs, uint8_t* out, int64_t out_cap) {
  if (g0 < 0 || g1 < g0) return -3;
  if (g0 == g1) return 0;
  if (g1 > vgo_len / 4 - 1) return -3;
  if (vflags_len < (g1 + 7) / 8) return -3;
  if (raw_offs[0] != 0) return -3;
  bool any_z = false;
  for (int64_t g = g0; g < g1; g++) {
    int64_t k = g - g0;
    if (raw_offs[k + 1] < raw_offs[k]) return -3;
    uint64_t p0 = zload_u32(vgo + 4 * g);
    uint64_t p1 = zload_u32(vgo + 4 * (g + 1));
    if (p1 < p0 || p1 > (uint64_t)vblob_len) return -3;
    bool flagged = (vflags[g >> 3] >> (g & 7)) & 1;
    if (flagged)
      any_z = true;
    else if (p1 - p0 != (uint64_t)(raw_offs[k + 1] - raw_offs[k]))
      return -3;
  }
  if (raw_offs[g1 - g0] > out_cap) return -2;
  const Codecs& c = codecs();
  if (any_z && (!c.zstd_dec_dict || !c.zstd_dctx_new || !c.zstd_dctx_free))
    return -1;
  if (any_z && vdict_len > 0 && !vdict) return -3;
  size_t nthreads = effective_cpus();
  if (nthreads > 8) nthreads = 8;
  if (g1 - g0 < 4) nthreads = 1;
  std::atomic<int64_t> nextg{g0};
  std::atomic<int> err{0};
  auto worker = [&] {
    void* dctx = nullptr;
    while (true) {
      int64_t g = nextg.fetch_add(1, std::memory_order_relaxed);
      if (g >= g1 || err.load(std::memory_order_relaxed)) break;
      int64_t k = g - g0;
      uint64_t p0 = zload_u32(vgo + 4 * g);
      uint64_t p1 = zload_u32(vgo + 4 * (g + 1));
      uint8_t* dst = out + raw_offs[k];
      size_t rawsz = (size_t)(raw_offs[k + 1] - raw_offs[k]);
      if (!((vflags[g >> 3] >> (g & 7)) & 1)) {
        std::memcpy(dst, vblob + p0, rawsz);
        continue;
      }
      if (!dctx) {
        dctx = c.zstd_dctx_new();
        if (!dctx) {
          err.store(1, std::memory_order_relaxed);
          break;
        }
      }
      size_t got = c.zstd_dec_dict(dctx, dst, rawsz, vblob + p0,
                                   (size_t)(p1 - p0),
                                   vdict_len > 0 ? vdict : nullptr,
                                   (size_t)vdict_len);
      if ((c.zstd_err && c.zstd_err(got)) || got != rawsz) {
        err.store(2, std::memory_order_relaxed);
        break;
      }
    }
    if (dctx) c.zstd_dctx_free(dctx);
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (size_t i = 1; i < nthreads; i++) {
      try {
        pool.emplace_back(worker);
      } catch (...) {
        break;
      }
    }
    worker();
    for (auto& w : pool) w.join();
  }
  int e = err.load();
  if (e == 1) return -1;
  if (e) return -3;
  return raw_offs[g1 - g0];
}

// ---------------------------------------------------------------------------
// Arena skiplist memtable rep (the native analogue of RocksDB's
// InlineSkipList memtable, memtable/inlineskiplist.h; db/memtable.py's
// NativeSkipListRep binds it).
// Ordering: user_key bytewise ascending, then inv_packed (u64) ascending
// (inv = ~(seq<<8|type), so newer versions sort first).
//
// Concurrency: inserts are LOCK-FREE (CAS splice per level, the shape of RocksDB's
// InsertConcurrently, memtable/inlineskiplist.h) and the batch
// entry point is called WITHOUT the GIL (ctypes.CDLL), so multiple Python
// writer threads insert in parallel. Readers (ctypes.PyDLL, under the GIL)
// traverse acquire-loaded next pointers of fully-initialized nodes — safe
// against concurrent writers with no reader-side locking.
// ---------------------------------------------------------------------------

namespace {

struct SLNode {
  const uint8_t* key;
  uint32_t key_len;
  uint64_t inv_packed;
  // Value = pointer to a [u32 len][bytes] arena record; a single atomic so
  // in-place replace (WAL-replay duplicate) can't tear against readers.
  std::atomic<const uint8_t*> val;
  int height;
  std::atomic<SLNode*> next[1];  // variable length

  SLNode* nxt(int level, std::memory_order o = std::memory_order_acquire) {
    return next[level].load(o);
  }
};

struct Arena {
  std::vector<uint8_t*> blocks;
  size_t used = 0;
  size_t cap = 0;
  // Block size grows geometrically from min_block to 1MiB: 257 trie
  // stripes at a fixed 1MiB first block held ~257MiB of mostly-empty
  // arenas for byte-spread keys; the skiplist keeps a 1MiB start.
  size_t min_block = 1u << 20;
  std::atomic<size_t> total{0};   // allocated block bytes (physical)
  std::atomic<size_t> handed{0};  // bytes handed to callers (tight bound)
  std::mutex mu;

  uint8_t* alloc(size_t n) {
    n = (n + 7) & ~size_t(7);
    std::lock_guard<std::mutex> g(mu);
    if (used + n > cap) {
      size_t bs = n > min_block ? n : min_block;
      if (min_block < (1u << 20)) min_block *= 2;
      blocks.push_back(new uint8_t[bs]);
      used = 0;
      cap = bs;
      total.fetch_add(bs, std::memory_order_relaxed);
    }
    uint8_t* p = blocks.back() + used;
    used += n;
    handed.fetch_add(n, std::memory_order_relaxed);
    return p;
  }
  ~Arena() {
    for (auto* b : blocks) delete[] b;
  }
};

static const int kMaxHeight = 12;

static uint64_t random_height_seed() {
  static std::atomic<uint64_t> c{0x9E3779B97F4A7C15ULL};
  return c.fetch_add(0xBF58476D1CE4E5B9ULL, std::memory_order_relaxed);
}

struct SkipList {
  Arena arena;
  SLNode* head;
  std::atomic<int> max_height{1};
  std::atomic<int64_t> count{0};

  SkipList() {
    head = alloc_node(kMaxHeight);
    head->key = nullptr;
    head->key_len = 0;
    for (int i = 0; i < kMaxHeight; i++)
      head->next[i].store(nullptr, std::memory_order_relaxed);
  }

  SLNode* alloc_node(int height) {
    size_t sz = sizeof(SLNode) + (height - 1) * sizeof(std::atomic<SLNode*>);
    SLNode* n = reinterpret_cast<SLNode*>(arena.alloc(sz));
    n->height = height;
    return n;
  }

  int random_height() {
    thread_local uint64_t rnd = random_height_seed();
    rnd ^= rnd << 13; rnd ^= rnd >> 7; rnd ^= rnd << 17;
    int h = 1;
    uint64_t r = rnd;
    while (h < kMaxHeight && (r & 3) == 0) { h++; r >>= 2; }
    return h;
  }

  // <0: a < b (a = node key triple, b = probe)
  static int cmp(const uint8_t* ak, uint32_t al, uint64_t ainv,
                 const uint8_t* bk, uint32_t bl, uint64_t binv) {
    uint32_t m = al < bl ? al : bl;
    int r = m ? std::memcmp(ak, bk, m) : 0;
    if (r) return r;
    if (al != bl) return al < bl ? -1 : 1;
    if (ainv != binv) return ainv < binv ? -1 : 1;
    return 0;
  }

  static int cmp_node(SLNode* a, const uint8_t* k, uint32_t kl, uint64_t inv) {
    return cmp(a->key, a->key_len, a->inv_packed, k, kl, inv);
  }

  // First node with node >= probe; fills prev[] when non-null.
  SLNode* seek_ge(const uint8_t* k, uint32_t kl, uint64_t inv,
                  SLNode** prev) {
    SLNode* x = head;
    int level = max_height.load(std::memory_order_acquire) - 1;
    while (true) {
      SLNode* nxt_ = x->nxt(level);
      bool go_right = nxt_ && cmp_node(nxt_, k, kl, inv) < 0;
      if (go_right) {
        x = nxt_;
      } else {
        if (prev) prev[level] = x;
        if (level == 0) return nxt_;
        level--;
      }
    }
  }

  static void set_val(SLNode* n, Arena& a, const uint8_t* v, uint32_t vl) {
    uint8_t* rec = a.alloc(4 + vl);
    std::memcpy(rec, &vl, 4);
    if (vl) std::memcpy(rec + 4, v, vl);
    n->val.store(rec, std::memory_order_release);
  }

  // Returns 1 on fresh insert, 0 on in-place replace of an exact duplicate.
  // Safe for concurrent callers (CAS splice; duplicates replace the value
  // atomically — only WAL replay produces them, and that is single-threaded,
  // but the path is still race-safe).
  int insert(const uint8_t* k, uint32_t kl, uint64_t inv,
             const uint8_t* v, uint32_t vl) {
    SLNode* prev[kMaxHeight];
    for (int i = 0; i < kMaxHeight; i++) prev[i] = head;
    SLNode* ge = seek_ge(k, kl, inv, prev);
    if (ge && cmp_node(ge, k, kl, inv) == 0) {
      set_val(ge, arena, v, vl);
      return 0;
    }
    int h = random_height();
    int mh = max_height.load(std::memory_order_relaxed);
    while (h > mh &&
           !max_height.compare_exchange_weak(mh, h,
                                             std::memory_order_relaxed)) {
    }
    SLNode* n = alloc_node(h);
    uint8_t* kcopy = arena.alloc(kl);
    std::memcpy(kcopy, k, kl);
    n->key = kcopy;
    n->key_len = kl;
    n->inv_packed = inv;
    set_val(n, arena, v, vl);
    // Splice bottom-up (as RocksDB's InsertConcurrently): the node becomes
    // reachable at level 0 first; higher levels are shortcuts. Only level 0
    // may observe an exact duplicate (n not yet linked there) — at that
    // point replace-in-place and abandon n entirely.
    for (int i = 0; i < h; i++) {
      while (true) {
        // prev[i] may be stale after a lost race: re-walk right as needed.
        SLNode* p = prev[i];
        SLNode* nx = p->nxt(i);
        while (nx && nx != n && cmp_node(nx, k, kl, inv) < 0) {
          p = nx;
          nx = p->nxt(i);
        }
        if (i == 0 && nx && cmp_node(nx, k, kl, inv) == 0) {
          // Concurrent/replayed duplicate: last value wins, atomically.
          set_val(nx, arena, v, vl);
          return 0;
        }
        n->next[i].store(nx, std::memory_order_relaxed);
        if (p->next[i].compare_exchange_strong(nx, n,
                                               std::memory_order_release)) {
          break;
        }
        prev[i] = p;  // retry from the rescanned position
      }
    }
    count.fetch_add(1, std::memory_order_relaxed);
    return 1;
  }
};

}  // namespace

void* tpulsm_skiplist_new() { return new SkipList(); }
void tpulsm_skiplist_free(void* h) { delete static_cast<SkipList*>(h); }

int32_t tpulsm_skiplist_insert(void* h, const uint8_t* k, uint32_t kl,
                               uint64_t inv, const uint8_t* v, uint32_t vl) {
  return static_cast<SkipList*>(h)->insert(k, kl, inv, v, vl);
}

int64_t tpulsm_skiplist_count(void* h) {
  return static_cast<SkipList*>(h)->count.load(std::memory_order_relaxed);
}

int64_t tpulsm_skiplist_memory(void* h) {
  // Handed-out bytes (content + node overhead), matching the trie rep's
  // accounting so flush cadence compares reps on equal footing.
  return (int64_t)static_cast<SkipList*>(h)->arena.handed.load(
      std::memory_order_relaxed);
}

void* tpulsm_skiplist_seek_ge(void* h, const uint8_t* k, uint32_t kl,
                              uint64_t inv) {
  return static_cast<SkipList*>(h)->seek_ge(k, kl, inv, nullptr);
}

void* tpulsm_skiplist_first(void* h) {
  return static_cast<SkipList*>(h)->head->nxt(0);
}

void* tpulsm_skiplist_next(void* node) {
  return static_cast<SLNode*>(node)->nxt(0);
}

// Last node strictly BEFORE the probe (nullptr if none) — the O(log n)
// backward step of the iterator protocol.
void* tpulsm_skiplist_seek_lt(void* h, const uint8_t* k, uint32_t kl,
                              uint64_t inv) {
  SkipList* sl = static_cast<SkipList*>(h);
  SLNode* prev[kMaxHeight];
  for (int i = 0; i < kMaxHeight; i++) prev[i] = sl->head;
  sl->seek_ge(k, kl, inv, prev);
  return prev[0] == sl->head ? nullptr : prev[0];
}

void* tpulsm_skiplist_last(void* h) {
  SkipList* sl = static_cast<SkipList*>(h);
  SLNode* x = sl->head;
  for (int level = sl->max_height.load(std::memory_order_acquire) - 1;
       level >= 0; level--) {
    while (x->nxt(level)) x = x->nxt(level);
  }
  return x == sl->head ? nullptr : x;
}

void tpulsm_skiplist_node(void* node, const uint8_t** k, uint32_t* kl,
                          uint64_t* inv, const uint8_t** v, uint32_t* vl) {
  SLNode* n = static_cast<SLNode*>(node);
  *k = n->key;
  *kl = n->key_len;
  *inv = n->inv_packed;
  const uint8_t* rec = n->val.load(std::memory_order_acquire);
  uint32_t len;
  std::memcpy(&len, rec, 4);
  *v = rec + 4;
  *vl = len;
}

// Batch insert: n entries from flat buffers, ONE ctypes crossing with the
// GIL released for the whole loop (registered on the CDLL handle). Safe to
// call from multiple threads concurrently (lock-free splice). Returns the
// number of FRESH inserts (duplicates replaced in place don't count).
int64_t tpulsm_skiplist_insert_batch(
    void* h, const uint8_t* keybuf, const int64_t* key_offs,
    const int32_t* key_lens, const uint64_t* invs, const uint8_t* valbuf,
    const int64_t* val_offs, const int32_t* val_lens, int64_t n) {
  SkipList* sl = static_cast<SkipList*>(h);
  int64_t fresh = 0;
  for (int64_t i = 0; i < n; i++) {
    fresh += sl->insert(keybuf + key_offs[i], (uint32_t)key_lens[i], invs[i],
                        valbuf + val_offs[i], (uint32_t)val_lens[i]);
  }
  return fresh;
}

// Bulk ordered export of the whole skiplist into flat columnar buffers —
// the memtable half of the columnar flush fast path (one GIL-released
// crossing instead of one Python iteration per entry; the role of
// RocksDB's FlushJob::WriteLevel0Table memtable scan).
// Keys are emitted as INTERNAL keys: user_key bytes followed by the 8-byte
// little-endian packed trailer ((seq<<8)|type == ~inv_packed), i.e. exactly
// the SST key encoding. seqs[i]/vtypes[i] receive the split trailer.
//
// Sizing call: key_buf == nullptr → fills out_sizes[3] = {key_bytes (incl.
// the 8B trailers), val_bytes, rows} and returns rows. Fill call: writes up
// to max_rows rows, bounded by the byte capacities the caller passes back
// in out_sizes[0]/[1] (the sizing results); returns rows written, or -1 on
// any overflow — row count OR byte budget — so a mutation between the two
// calls (contract violation: flush runs on an immutable memtable) can
// never write past the caller's buffers.
int64_t tpulsm_skiplist_export(
    void* h, uint8_t* key_buf, int64_t* key_offs, int32_t* key_lens,
    uint64_t* seqs, int32_t* vtypes, uint8_t* val_buf, int64_t* val_offs,
    int32_t* val_lens, int64_t max_rows, int64_t* out_sizes) {
  SkipList* sl = static_cast<SkipList*>(h);
  if (key_buf == nullptr) {
    int64_t kb = 0, vb = 0, rows = 0;
    for (SLNode* n = sl->head->nxt(0); n; n = n->nxt(0)) {
      const uint8_t* rec = n->val.load(std::memory_order_acquire);
      uint32_t vl;
      std::memcpy(&vl, rec, 4);
      kb += n->key_len + 8;
      vb += vl;
      rows++;
    }
    out_sizes[0] = kb;
    out_sizes[1] = vb;
    out_sizes[2] = rows;
    return rows;
  }
  const int64_t key_cap = out_sizes[0], val_cap = out_sizes[1];
  int64_t ko = 0, vo = 0, rows = 0;
  for (SLNode* n = sl->head->nxt(0); n; n = n->nxt(0)) {
    if (rows >= max_rows) return -1;
    const uint8_t* rec = n->val.load(std::memory_order_acquire);
    uint32_t vl;
    std::memcpy(&vl, rec, 4);
    if (ko + (int64_t)n->key_len + 8 > key_cap || vo + (int64_t)vl > val_cap)
      return -1;
    uint64_t packed = ~n->inv_packed;
    std::memcpy(key_buf + ko, n->key, n->key_len);
    for (int b = 0; b < 8; b++)
      key_buf[ko + n->key_len + b] = (uint8_t)(packed >> (8 * b));
    key_offs[rows] = ko;
    key_lens[rows] = (int32_t)(n->key_len + 8);
    seqs[rows] = packed >> 8;
    vtypes[rows] = (int32_t)(packed & 0xFF);
    std::memcpy(val_buf + vo, rec + 4, vl);
    val_offs[rows] = vo;
    val_lens[rows] = (int32_t)vl;
    ko += n->key_len + 8;
    vo += vl;
    rows++;
  }
  return rows;
}

// Insert every counted record of a WriteBatch WIRE IMAGE (db/write_batch.py
// format: fixed64 seq | fixed32 count | [type][varint klen][key]
// [varint vlen][value]...) into the skiplist — ONE GIL-free ctypes call
// per batch, no per-record Python or numpy. Parses in two passes: a
// validation scan first, so a batch this parser cannot take (non-default
// CF record, range deletion, corruption) is rejected with NOTHING
// inserted and the caller falls back to the Python path.
// Returns inserted count; out[0] = memtable byte delta (k+v+24 per
// record), out[1] = point-delete count. rc: -2 unsupported record,
// -4 corrupt. Concurrency-safe (lock-free splice per record).
// Shared WriteBatch wire-image parse/apply loop: validates the whole
// image on pass 0 (count header, varint bounds, supported record types),
// applies on pass 1 through the insert callback. Returns the record
// count, or -2 (unsupported record: Python path) / -4 (corrupt image).
extern "C++" {
template <typename InsertFn, typename CheckFn>
static int64_t wb_wire_apply_chk(const uint8_t* rep, int64_t len,
                                 uint64_t first_seq, int64_t* out,
                                 InsertFn&& ins, CheckFn&& chk) {
  static const uint8_t kValue = 0x1, kDelete = 0x0, kMerge = 0x2,
                       kSingleDelete = 0x7, kLogData = 0x3,
                       kWideEntity = 0x16;
  if (len < 12) return -4;
  const uint8_t* end = rep + len;
  uint32_t hdr_count = (uint32_t)rep[8] | ((uint32_t)rep[9] << 8) |
                       ((uint32_t)rep[10] << 16) | ((uint32_t)rep[11] << 24);
  for (int pass = 0; pass < 2; pass++) {
    const uint8_t* p = rep + 12;
    uint64_t seq = first_seq;
    int64_t count = 0, delta = 0, deletes = 0;
    while (p < end) {
      uint8_t t = *p++;
      if (t & 0x80) return -2;  // CF-prefixed record: Python path
      uint32_t klen, vlen = 0;
      p = get_varint32(p, end, &klen);
      if (!p || p + klen > end) return -4;
      const uint8_t* k = p;
      p += klen;
      const uint8_t* v = p;
      if (t == kValue || t == kMerge || t == kWideEntity) {
        p = get_varint32(p, end, &vlen);
        if (!p || p + vlen > end) return -4;
        v = p;
        p += vlen;
      } else if (t == kDelete || t == kSingleDelete) {
        // key only
      } else if (t == kLogData) {
        continue;  // not counted, not applied (klen was the blob)
      } else {
        return -2;  // RANGE_DELETION etc.: Python path
      }
      if (pass == 0) {
        // Validation pass: a failing check rejects the WHOLE batch with
        // nothing inserted (-5 - index of the offending record).
        if (!chk(count, t, k, klen, v, vlen)) return -5 - count;
      } else {
        uint64_t inv = ~((seq << 8) | (uint64_t)t);
        ins(k, klen, inv, v, vlen);
        delta += (int64_t)klen + vlen + 24;
        if (t == kDelete || t == kSingleDelete) deletes++;
      }
      seq++;
      count++;
    }
    if (pass == 0) {
      if ((uint32_t)count != hdr_count) return -4;
    } else {
      out[0] = delta;
      out[1] = deletes;
      return count;
    }
  }
  return -4;  // unreachable
}

template <typename InsertFn>
static int64_t wb_wire_apply(const uint8_t* rep, int64_t len,
                             uint64_t first_seq, int64_t* out,
                             InsertFn&& ins) {
  return wb_wire_apply_chk(
      rep, len, first_seq, out, static_cast<InsertFn&&>(ins),
      [](int64_t, uint8_t, const uint8_t*, uint32_t, const uint8_t*,
         uint32_t) { return true; });
}
}  // extern "C++"

int64_t tpulsm_skiplist_insert_wb(void* h, const uint8_t* rep, int64_t len,
                                  uint64_t first_seq, int64_t* out) {
  SkipList* sl = static_cast<SkipList*>(h);
  return wb_wire_apply(rep, len, first_seq, out,
                       [sl](const uint8_t* k, uint32_t kl, uint64_t inv,
                            const uint8_t* v, uint32_t vl) {
                         sl->insert(k, kl, inv, v, vl);
                       });
}

// ---------------------------------------------------------------------------
// Per-entry protection info (utils/protection.py): one native pass over a
// WriteBatch wire image computing every counted record's checksum — the
// write path's integrity hot loop (compute at batch build, re-verify at
// the batch->memtable handoff) without per-record Python. The hash MUST
// bit-match utils/protection.py: zlib crc32 per component, one
// multiply-xorshift lane mix, XOR of key/value/type/cf components.
// ---------------------------------------------------------------------------

extern "C++" {
namespace {

// zlib/IEEE crc32 (poly 0xEDB88320 reflected), slicing-by-8.
struct ZCrcTables {
  uint32_t t[8][256];
  ZCrcTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int j = 1; j < 8; j++)
        t[j][i] = (t[j - 1][i] >> 8) ^ t[0][t[j - 1][i] & 0xFF];
  }
};

static inline uint32_t zcrc32(const uint8_t* p, size_t n) {
  static const ZCrcTables T;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = T.t[7][lo & 0xFF] ^ T.t[6][(lo >> 8) & 0xFF] ^
        T.t[5][(lo >> 16) & 0xFF] ^ T.t[4][lo >> 24] ^
        T.t[3][hi & 0xFF] ^ T.t[2][(hi >> 8) & 0xFF] ^
        T.t[1][(hi >> 16) & 0xFF] ^ T.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = T.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

static inline uint64_t prot_mix(uint64_t x) {
  x *= 0xBF58476D1CE4E5B9ull;
  return x ^ (x >> 29);
}

}  // namespace
}  // extern "C++"

// Computes the truncated protection checksum of every counted record in
// `rep` (a WriteBatch wire image, header included) into out[0..count).
// `strip_cf` != 0 emits the CF-stripped (cf=0) memtable-carried form.
// Returns the record count, or -3 (out_cap too small) / -4 (corrupt).
int64_t tpulsm_wb_protect(const uint8_t* rep, int64_t len, int32_t pb,
                          int32_t strip_cf, uint64_t* out, int64_t out_cap) {
  static const uint8_t kValue = 0x1, kDelete = 0x0, kMerge = 0x2,
                       kSingleDelete = 0x7, kLogData = 0x3,
                       kRangeDel = 0xF, kWideEntity = 0x16;
  const uint64_t kKey = 0x9E3779B97F4A7C15ull, kVal = 0xC2B2AE3D27D4EB4Full,
                 kType = 0x165667B19E3779F9ull, kCf = 0x27D4EB2F165667C5ull;
  if (len < 12) return -4;
  const uint8_t* end = rep + len;
  const uint8_t* p = rep + 12;
  uint32_t hdr_count = (uint32_t)rep[8] | ((uint32_t)rep[9] << 8) |
                       ((uint32_t)rep[10] << 16) | ((uint32_t)rep[11] << 24);
  const uint64_t mask =
      (pb >= 8 || pb <= 0) ? ~0ull : ((1ull << (8 * pb)) - 1);
  const uint64_t empty_val_term = prot_mix(kVal ^ (uint64_t)zcrc32(p, 0));
  int64_t count = 0;
  while (p < end) {
    uint8_t t = *p++;
    uint32_t cf = 0;
    if ((t & 0x80) && t != kLogData) {
      t &= 0x7F;
      p = get_varint32(p, end, &cf);
      if (!p) return -4;
    }
    uint32_t klen;
    const uint8_t* kp = p = get_varint32(p, end, &klen);
    if (!p || p + klen > end) return -4;
    p += klen;
    if (t == kLogData) continue;  // not counted, not protected
    uint64_t vterm = empty_val_term;
    if (t == kValue || t == kMerge || t == kWideEntity || t == kRangeDel) {
      uint32_t vlen;
      const uint8_t* vp = p = get_varint32(p, end, &vlen);
      if (!p || p + vlen > end) return -4;
      p += vlen;
      vterm = prot_mix(kVal ^ (uint64_t)zcrc32(vp, vlen) ^
                       ((uint64_t)vlen << 32));
    } else if (t != kDelete && t != kSingleDelete) {
      return -4;  // unknown record type
    }
    if (count >= out_cap) return -3;
    uint64_t cs = prot_mix(kKey ^ (uint64_t)zcrc32(kp, klen) ^
                           ((uint64_t)klen << 32)) ^
                  vterm ^ prot_mix(kType ^ (uint64_t)t) ^
                  prot_mix(kCf ^ (uint64_t)((strip_cf ? 0 : cf) + 1));
    out[count++] = cs & mask;
  }
  if ((uint32_t)count != hdr_count) return -4;
  return count;
}

// XOR-aggregate protection over a columnar export (INTERNAL keys: user key
// + 8B packed trailer). Computes each entry's CF-0 truncated checksum —
// bit-identical to utils/protection.py protect_entry(t, uk, v) — and folds
// them into *xor_out. XOR is the right aggregate because the checksum is
// already XOR-composable per component: equality of (count, xor) against
// the memtable's carried side proves the flush export intact without a
// per-entry Python walk; on mismatch the caller re-walks per entry for the
// precise culprit. Returns n, or -4 on a malformed (short) internal key.
int64_t tpulsm_columnar_protect(const uint8_t* key_buf,
                                const int32_t* key_offs,
                                const int32_t* key_lens,
                                const uint8_t* val_buf,
                                const int32_t* val_offs,
                                const int32_t* val_lens,
                                const int32_t* vtypes, int64_t n, int32_t pb,
                                uint64_t* xor_out) {
  const uint64_t kKey = 0x9E3779B97F4A7C15ull, kVal = 0xC2B2AE3D27D4EB4Full,
                 kType = 0x165667B19E3779F9ull, kCf = 0x27D4EB2F165667C5ull;
  const uint64_t mask =
      (pb >= 8 || pb <= 0) ? ~0ull : ((1ull << (8 * pb)) - 1);
  const uint64_t cf_term = prot_mix(kCf ^ 1ull);
  uint64_t acc = 0;
  for (int64_t i = 0; i < n; i++) {
    if (key_lens[i] < 8) return -4;
    uint32_t uklen = (uint32_t)key_lens[i] - 8;
    uint32_t vlen = (uint32_t)val_lens[i];
    uint64_t cs =
        prot_mix(kKey ^ (uint64_t)zcrc32(key_buf + key_offs[i], uklen) ^
                 ((uint64_t)uklen << 32)) ^
        prot_mix(kVal ^ (uint64_t)zcrc32(val_buf + val_offs[i], vlen) ^
                 ((uint64_t)vlen << 32)) ^
        prot_mix(kType ^ (uint64_t)(uint8_t)vtypes[i]) ^ cf_term;
    acc ^= cs & mask;
  }
  *xor_out = acc;
  return n;
}

extern "C++" {
namespace {

// Pass-0 record check for the fused verify+insert wire apply: recomputes
// the CF-0 protection checksum of each counted record and compares it to
// the batch's carried vector. Default-CF only (wb_wire_apply already
// rejects CF-prefixed records with -2 before this runs).
struct ProtCheck {
  const uint64_t* prots;
  int64_t n;
  uint64_t mask;
  bool operator()(int64_t i, uint8_t t, const uint8_t* k, uint32_t kl,
                  const uint8_t* v, uint32_t vl) const {
    const uint64_t kKey = 0x9E3779B97F4A7C15ull, kVal = 0xC2B2AE3D27D4EB4Full,
                   kType = 0x165667B19E3779F9ull, kCf = 0x27D4EB2F165667C5ull;
    if (i >= n) return false;
    uint64_t cs = prot_mix(kKey ^ (uint64_t)zcrc32(k, kl) ^
                           ((uint64_t)kl << 32)) ^
                  prot_mix(kVal ^ (uint64_t)zcrc32(v, vl) ^
                           ((uint64_t)vl << 32)) ^
                  prot_mix(kType ^ (uint64_t)t) ^ prot_mix(kCf ^ 1ull);
    return (cs & mask) == prots[i];
  }
};

inline uint64_t prot_trunc_mask(int32_t pb) {
  return (pb >= 8 || pb <= 0) ? ~0ull : ((1ull << (8 * pb)) - 1);
}

}  // namespace
}  // extern "C++"

// Fused verify+insert: ONE call re-hashes every counted record against
// `prots` (validation pass — a mismatch rejects the whole batch with
// NOTHING inserted, rc = -5 - bad_index) then inserts (apply pass). This
// keeps the protected write path at one native crossing per batch instead
// of verify + insert as two (each re-parsing the wire image from Python).
int64_t tpulsm_skiplist_insert_wb_prot(void* h, const uint8_t* rep,
                                       int64_t len, uint64_t first_seq,
                                       const uint64_t* prots, int64_t n_prots,
                                       int32_t pb, int64_t* out) {
  SkipList* sl = static_cast<SkipList*>(h);
  int64_t rc = wb_wire_apply_chk(
      rep, len, first_seq, out,
      [sl](const uint8_t* k, uint32_t kl, uint64_t inv, const uint8_t* v,
           uint32_t vl) { sl->insert(k, kl, inv, v, vl); },
      ProtCheck{prots, n_prots, prot_trunc_mask(pb)});
  if (rc >= 0 && rc != n_prots) return -5 - rc;  // carried vector too long
  return rc;
}

// ---------------------------------------------------------------------------
// TrieRep: the CSPP-role memtable (copied from toplingdb_tpu's native
// library: the role of Topling's Crash-Safe Parallel Patricia trie memtable,
// the 45M ops/s headline
// component; main-tree seam include/rocksdb/memtablerep.h:309).
//
// Design is our own, NOT a port: an adaptive radix tree (4/16/48/256-way
// nodes with path compression) per FIRST-BYTE STRIPE — 257 independent
// roots (one per leading byte + one for the empty key), each under its
// own mutex, so concurrent writers on different key regions never
// contend, and in-stripe descent is mutex-simple rather than lock-free.
// A leaf holds one USER KEY and its version list sorted by inv
// ((~(seq<<8|type))) ascending == seqno descending — the memtable order.
// Versions carry a back-pointer to their leaf, so a position handle is
// just a Ver*, and the stateless successor re-descends from the root
// (O(key) — iteration is the cold path; inserts are the hot one).
// ---------------------------------------------------------------------------

extern "C++" {  // templates may not have C linkage
namespace {

struct TVer {
  uint64_t inv;
  std::atomic<const uint8_t*> val;  // [u32 len][bytes] arena record
  // Readers traverse version lists WITHOUT the stripe mutex (the tree
  // descent locks; the returned leaf's list does not), while writers
  // publish under it — so the links are release-published atomics like
  // the skiplist's next pointers.
  std::atomic<TVer*> next;          // next-older (inv ascending)
  struct TLeafHdr* leaf;
};

struct TLeafHdr {
  const uint8_t* key;  // FULL user key (arena copy)
  uint32_t key_len;
  std::atomic<TVer*> head;
};

struct TNode {
  uint16_t ntype;       // 4, 16, 48, 256
  uint16_t nkeys;
  uint32_t prefix_len;
  const uint8_t* prefix;
  TLeafHdr* leaf;       // key ending exactly after this node's prefix
  // N4/N16: keys[] + children[] parallel (sorted); N48: index[256] into
  // children; N256: children[256].
  uint8_t* keys;        // N4/N16: size ntype; N48: 256-byte index
  TNode** children;     // size ntype (N48: 48, N256: 256)
};

struct TrieStripe {
  std::mutex mu;
  Arena arena;
  TNode* root = nullptr;
};

struct TrieRep {
  TrieStripe stripes[257];  // [b] = keys starting with byte b; [256] = ""
  std::atomic<int64_t> count{0};

  int64_t memory() {
    // Handed-out bytes, not block caps: the flush/WBM charge tracks real
    // content + node overhead without penalizing half-filled blocks
    // (geometric growth bounds the cap/handed gap to <2x anyway).
    int64_t m = 0;
    for (auto& s : stripes)
      m += (int64_t)s.arena.handed.load(std::memory_order_relaxed);
    return m;
  }
};

TNode* tnode_new(Arena& a, uint16_t ntype, const uint8_t* prefix,
                 uint32_t plen) {
  TNode* n = (TNode*)a.alloc(sizeof(TNode));
  n->ntype = ntype;
  n->nkeys = 0;
  n->prefix_len = plen;
  if (plen) {
    uint8_t* p = a.alloc(plen);
    std::memcpy(p, prefix, plen);
    n->prefix = p;
  } else {
    n->prefix = nullptr;
  }
  n->leaf = nullptr;
  if (ntype == 4 || ntype == 16) {
    // LAZY arrays: tail nodes (one per unique key suffix) never gain a
    // child — not allocating keys/children until the first tnode_add
    // saves ~40B on the dominant node population.
    n->keys = nullptr;
    n->children = nullptr;
  } else if (ntype == 48) {
    n->keys = a.alloc(256);
    std::memset(n->keys, 0xFF, 256);
    n->children = (TNode**)a.alloc(sizeof(TNode*) * 48);
  } else {
    n->keys = nullptr;
    n->children = (TNode**)a.alloc(sizeof(TNode*) * 256);
    std::memset(n->children, 0, sizeof(TNode*) * 256);
  }
  return n;
}

TNode** tnode_find(TNode* n, uint8_t c) {
  if (n->ntype == 4 || n->ntype == 16) {
    for (uint16_t i = 0; i < n->nkeys; i++)
      if (n->keys[i] == c) return &n->children[i];
    return nullptr;
  }
  if (n->ntype == 48) {
    return n->keys[c] == 0xFF ? nullptr : &n->children[n->keys[c]];
  }
  return n->children[c] ? &n->children[c] : nullptr;
}

// Grow n to the next node size, copying children. Returns the new node
// (caller re-links the parent slot).
TNode* tnode_grow(Arena& a, TNode* n) {
  if (n->ntype == 4 || n->ntype == 16) {
    uint16_t nt = n->ntype == 4 ? 16 : 48;
    TNode* g = tnode_new(a, nt, n->prefix, n->prefix_len);
    g->leaf = n->leaf;
    if (nt == 16) {
      // tnode_new leaves N16 arrays lazy — materialize before copying.
      g->keys = a.alloc(16);
      g->children = (TNode**)a.alloc(sizeof(TNode*) * 16);
      std::memcpy(g->keys, n->keys, n->nkeys);
      std::memcpy(g->children, n->children, sizeof(TNode*) * n->nkeys);
      g->nkeys = n->nkeys;
    } else {
      for (uint16_t i = 0; i < n->nkeys; i++) {
        g->keys[n->keys[i]] = (uint8_t)i;
        g->children[i] = n->children[i];
      }
      g->nkeys = n->nkeys;
    }
    return g;
  }
  // 48 -> 256
  TNode* g = tnode_new(a, 256, n->prefix, n->prefix_len);
  g->leaf = n->leaf;
  for (int c = 0; c < 256; c++)
    if (n->keys[c] != 0xFF) g->children[c] = n->children[n->keys[c]];
  g->nkeys = n->nkeys;
  return g;
}

// Add child c to n (must not exist); may replace n via growth.
void tnode_add(Arena& a, TNode** slot, uint8_t c, TNode* child) {
  TNode* n = *slot;
  if ((n->ntype == 4 || n->ntype == 16 || n->ntype == 48) &&
      n->nkeys >= (n->ntype == 48 ? 48 : n->ntype)) {
    n = tnode_grow(a, n);
    *slot = n;
  }
  if (n->ntype == 4 || n->ntype == 16) {
    if (!n->keys) {  // lazily materialize (see tnode_new)
      n->keys = a.alloc(n->ntype);
      n->children = (TNode**)a.alloc(sizeof(TNode*) * n->ntype);
    }
    uint16_t i = n->nkeys;
    while (i > 0 && n->keys[i - 1] > c) {
      n->keys[i] = n->keys[i - 1];
      n->children[i] = n->children[i - 1];
      i--;
    }
    n->keys[i] = c;
    n->children[i] = child;
    n->nkeys++;
  } else if (n->ntype == 48) {
    n->keys[c] = (uint8_t)n->nkeys;
    n->children[n->nkeys] = child;
    n->nkeys++;
  } else {
    n->children[c] = child;
    n->nkeys++;
  }
}

void tleaf_set_val(Arena& a, TVer* v, const uint8_t* val, uint32_t vl) {
  uint8_t* rec = a.alloc(4 + vl);
  std::memcpy(rec, &vl, 4);
  if (vl) std::memcpy(rec + 4, val, vl);
  v->val.store(rec, std::memory_order_release);
}

// Insert a version into leaf's inv-ascending list; replace on exact dup.
// Returns 1 on fresh insert. Writer-side only (stripe mutex held); the
// new node is fully initialized before the release-publish, so lockless
// readers see either the old list or the complete new one.
int tleaf_add(Arena& a, TLeafHdr* lf, uint64_t inv, const uint8_t* val,
              uint32_t vl) {
  std::atomic<TVer*>* pp = &lf->head;
  TVer* cur = pp->load(std::memory_order_relaxed);
  while (cur && cur->inv < inv) {
    pp = &cur->next;
    cur = pp->load(std::memory_order_relaxed);
  }
  if (cur && cur->inv == inv) {
    tleaf_set_val(a, cur, val, vl);  // WAL-replay duplicate: replace
    return 0;
  }
  TVer* v = (TVer*)a.alloc(sizeof(TVer));
  v->inv = inv;
  v->next.store(cur, std::memory_order_relaxed);
  v->leaf = lf;
  tleaf_set_val(a, v, val, vl);
  pp->store(v, std::memory_order_release);
  return 1;
}

TLeafHdr* tleaf_new(Arena& a, const uint8_t* full_key, uint32_t kl) {
  TLeafHdr* lf = (TLeafHdr*)a.alloc(sizeof(TLeafHdr));
  uint8_t* kc = a.alloc(kl);
  if (kl) std::memcpy(kc, full_key, kl);
  lf->key = kc;
  lf->key_len = kl;
  lf->head.store(nullptr, std::memory_order_relaxed);
  return lf;
}

// Insert (full user key, inv, value) into one stripe (mutex held).
// `k`/`kl` exclude the stripe byte; `fk`/`fkl` are the full key.
int trie_insert_locked(TrieStripe& st, const uint8_t* k, uint32_t kl,
                       const uint8_t* fk, uint32_t fkl, uint64_t inv,
                       const uint8_t* val, uint32_t vl) {
  Arena& a = st.arena;
  if (!st.root) st.root = tnode_new(a, 4, nullptr, 0);
  TNode** slot = &st.root;
  uint32_t d = 0;
  while (true) {
    TNode* n = *slot;
    uint32_t m = 0;
    uint32_t rem = kl - d;
    while (m < n->prefix_len && m < rem && n->prefix[m] == k[d + m]) m++;
    if (m < n->prefix_len) {
      // Split: parent keeps prefix[0..m); old node trims to m+1..;
      // the new key either ends at the split (parent leaf) or branches.
      TNode* parent = tnode_new(a, 4, n->prefix, m);
      uint8_t old_c = n->prefix[m];
      // trim n's prefix in place
      n->prefix = n->prefix + m + 1;
      n->prefix_len -= m + 1;
      tnode_add(a, &parent, old_c, n);
      if (rem == m) {
        parent->leaf = tleaf_new(a, fk, fkl);
        *slot = parent;
        return tleaf_add(a, parent->leaf, inv, val, vl);
      }
      TNode* nb = tnode_new(a, 4, k + d + m + 1, rem - m - 1);
      nb->leaf = tleaf_new(a, fk, fkl);
      tnode_add(a, &parent, k[d + m], nb);
      *slot = parent;
      return tleaf_add(a, nb->leaf, inv, val, vl);
    }
    d += n->prefix_len;
    if (d == kl) {
      if (!n->leaf) n->leaf = tleaf_new(a, fk, fkl);
      return tleaf_add(a, n->leaf, inv, val, vl);
    }
    uint8_t c = k[d];
    TNode** child = tnode_find(n, c);
    if (!child) {
      TNode* nb = tnode_new(a, 4, k + d + 1, kl - d - 1);
      nb->leaf = tleaf_new(a, fk, fkl);
      tnode_add(a, slot, c, nb);
      return tleaf_add(a, nb->leaf, inv, val, vl);
    }
    slot = child;
    d++;
  }
}

int trie_insert(TrieRep* t, const uint8_t* k, uint32_t kl, uint64_t inv,
                const uint8_t* val, uint32_t vl) {
  int s = kl ? k[0] : 256;
  TrieStripe& st = t->stripes[s];
  std::lock_guard<std::mutex> g(st.mu);
  int fresh = trie_insert_locked(st, kl ? k + 1 : k, kl ? kl - 1 : 0,
                                 k, kl, inv, val, vl);
  if (fresh) t->count.fetch_add(1, std::memory_order_relaxed);
  return fresh;
}

// Smallest / largest leaf of a subtree (descending by child order).
TLeafHdr* tmin_leaf(TNode* n) {
  while (n) {
    if (n->leaf) return n->leaf;  // key-ends-here sorts before children
    if (n->ntype == 4 || n->ntype == 16) {
      n = n->nkeys ? n->children[0] : nullptr;
    } else if (n->ntype == 48) {
      TNode* nx = nullptr;
      for (int c = 0; c < 256 && !nx; c++)
        if (n->keys[c] != 0xFF) nx = n->children[n->keys[c]];
      n = nx;
    } else {
      TNode* nx = nullptr;
      for (int c = 0; c < 256 && !nx; c++)
        if (n->children[c]) nx = n->children[c];
      n = nx;
    }
  }
  return nullptr;
}

TLeafHdr* tmax_leaf(TNode* n) {
  TLeafHdr* best = nullptr;
  while (n) {
    TNode* nx = nullptr;
    if (n->ntype == 4 || n->ntype == 16) {
      nx = n->nkeys ? n->children[n->nkeys - 1] : nullptr;
    } else if (n->ntype == 48) {
      for (int c = 255; c >= 0 && !nx; c--)
        if (n->keys[c] != 0xFF) nx = n->children[n->keys[c]];
    } else {
      for (int c = 255; c >= 0 && !nx; c--)
        if (n->children[c]) nx = n->children[c];
    }
    if (!nx) return n->leaf ? n->leaf : best;
    if (n->leaf) best = n->leaf;  // deeper children are LARGER than leaf
    n = nx;
  }
  return best;
}

// First leaf with key >= probe within one stripe (nullptr if none).
TLeafHdr* trie_lower_bound(TNode* root, const uint8_t* k, uint32_t kl) {
  TNode* n = root;
  uint32_t d = 0;
  TLeafHdr* succ = nullptr;  // min leaf of the nearest greater subtree
  while (n) {
    uint32_t rem = kl - d;
    uint32_t m = 0;
    while (m < n->prefix_len && m < rem && n->prefix[m] == k[d + m]) m++;
    if (m < n->prefix_len) {
      if (m == rem || k[d + m] < n->prefix[m]) return tmin_leaf(n);
      return succ;  // whole subtree < probe
    }
    d += n->prefix_len;
    if (d == kl) return tmin_leaf(n);  // node's min is >= probe
    uint8_t c = k[d];
    // Successor candidate: smallest child byte > c.
    TNode* nx_gt = nullptr;
    if (n->ntype == 4 || n->ntype == 16) {
      for (uint16_t i = 0; i < n->nkeys; i++)
        if (n->keys[i] > c) { nx_gt = n->children[i]; break; }
    } else if (n->ntype == 48) {
      for (int b = c + 1; b < 256 && !nx_gt; b++)
        if (n->keys[b] != 0xFF) nx_gt = n->children[n->keys[b]];
    } else {
      for (int b = c + 1; b < 256 && !nx_gt; b++)
        if (n->children[b]) nx_gt = n->children[b];
    }
    if (nx_gt) {
      TLeafHdr* lm = tmin_leaf(nx_gt);
      if (lm) succ = lm;
    }
    TNode** child = tnode_find(n, c);
    if (!child) return succ;
    n = *child;
    d++;
  }
  return succ;
}

// Last leaf with key strictly < probe within one stripe.
TLeafHdr* trie_pred(TNode* root, const uint8_t* k, uint32_t kl) {
  TNode* n = root;
  uint32_t d = 0;
  TLeafHdr* pred = nullptr;
  while (n) {
    uint32_t rem = kl - d;
    uint32_t m = 0;
    while (m < n->prefix_len && m < rem && n->prefix[m] == k[d + m]) m++;
    if (m < n->prefix_len) {
      if (m == rem || k[d + m] < n->prefix[m]) return pred;
      return tmax_leaf(n);  // whole subtree < probe
    }
    d += n->prefix_len;
    if (d == kl) return pred;  // node min == probe's position
    if (n->leaf) pred = n->leaf;  // "ends here" < any longer key
    uint8_t c = k[d];
    TNode* nx_lt = nullptr;
    if (n->ntype == 4 || n->ntype == 16) {
      for (int i = (int)n->nkeys - 1; i >= 0; i--)
        if (n->keys[i] < c) { nx_lt = n->children[i]; break; }
    } else if (n->ntype == 48) {
      for (int b = c - 1; b >= 0 && !nx_lt; b--)
        if (n->keys[b] != 0xFF) nx_lt = n->children[n->keys[b]];
    } else {
      for (int b = c - 1; b >= 0 && !nx_lt; b--)
        if (n->children[b]) nx_lt = n->children[b];
    }
    if (nx_lt) {
      TLeafHdr* lm = tmax_leaf(nx_lt);
      if (lm) pred = lm;
    }
    TNode** child = tnode_find(n, c);
    if (!child) return pred;
    n = *child;
    d++;
  }
  return pred;
}

// Stripe-aware leaf lookups over the whole rep.
TLeafHdr* trie_leaf_ge(TrieRep* t, const uint8_t* k, uint32_t kl) {
  int s0 = kl ? k[0] : 256;
  if (s0 == 256) {  // empty probe: empty-key stripe first, then 0..255
    TrieStripe& se = t->stripes[256];
    {
      std::lock_guard<std::mutex> g(se.mu);
      if (se.root) {
        TLeafHdr* lf = tmin_leaf(se.root);
        if (lf) return lf;
      }
    }
    for (int s = 0; s < 256; s++) {
      std::lock_guard<std::mutex> g(t->stripes[s].mu);
      if (t->stripes[s].root) {
        TLeafHdr* lf = tmin_leaf(t->stripes[s].root);
        if (lf) return lf;
      }
    }
    return nullptr;
  }
  {
    TrieStripe& st = t->stripes[s0];
    std::lock_guard<std::mutex> g(st.mu);
    if (st.root) {
      TLeafHdr* lf = trie_lower_bound(st.root, k + 1, kl - 1);
      if (lf) return lf;
    }
  }
  for (int s = s0 + 1; s < 256; s++) {
    std::lock_guard<std::mutex> g(t->stripes[s].mu);
    if (t->stripes[s].root) {
      TLeafHdr* lf = tmin_leaf(t->stripes[s].root);
      if (lf) return lf;
    }
  }
  return nullptr;
}

TLeafHdr* trie_leaf_lt(TrieRep* t, const uint8_t* k, uint32_t kl) {
  int s0 = kl ? k[0] : 256;
  if (s0 != 256) {
    TrieStripe& st = t->stripes[s0];
    std::lock_guard<std::mutex> g(st.mu);
    if (st.root) {
      TLeafHdr* lf = trie_pred(st.root, k + 1, kl - 1);
      if (lf) return lf;
    }
  }
  int hi = s0 == 256 ? -1 : s0 - 1;  // empty key: nothing precedes
  for (int s = hi; s >= 0; s--) {
    std::lock_guard<std::mutex> g(t->stripes[s].mu);
    if (t->stripes[s].root) {
      TLeafHdr* lf = tmax_leaf(t->stripes[s].root);
      if (lf) return lf;
    }
  }
  if (s0 != 256) {  // empty-key stripe precedes every non-empty key
    TrieStripe& se = t->stripes[256];
    std::lock_guard<std::mutex> g(se.mu);
    if (se.root) {
      TLeafHdr* lf = tmax_leaf(se.root);
      if (lf) return lf;
    }
  }
  return nullptr;
}

// DFS export of one stripe (mutex held by caller), leaves in key order.
template <typename F>
void trie_walk(TNode* n, F&& fn) {
  if (!n) return;
  if (n->leaf) fn(n->leaf);
  if (n->ntype == 4 || n->ntype == 16) {
    for (uint16_t i = 0; i < n->nkeys; i++) trie_walk(n->children[i], fn);
  } else if (n->ntype == 48) {
    for (int c = 0; c < 256; c++)
      if (n->keys[c] != 0xFF) trie_walk(n->children[n->keys[c]], fn);
  } else {
    for (int c = 0; c < 256; c++)
      if (n->children[c]) trie_walk(n->children[c], fn);
  }
}

template <typename F>
void trie_walk_all(TrieRep* t, F&& fn) {
  {
    // The empty key sorts before every non-empty key.
    TrieStripe& se = t->stripes[256];
    std::lock_guard<std::mutex> g(se.mu);
    trie_walk(se.root, fn);
  }
  for (int s = 0; s < 256; s++) {
    TrieStripe& st = t->stripes[s];
    std::lock_guard<std::mutex> g(st.mu);
    trie_walk(st.root, fn);
  }
}

}  // namespace
}  // extern "C++"

void* tpulsm_trie_new() {
  TrieRep* t = new (std::nothrow) TrieRep();
  if (t) {
    // Per-stripe arenas start small (16KiB, doubling to 1MiB): most of
    // the 257 stripes see few keys.
    for (auto& s : t->stripes) s.arena.min_block = 16u << 10;
  }
  return t;
}
void tpulsm_trie_free(void* h) { delete static_cast<TrieRep*>(h); }

int32_t tpulsm_trie_insert(void* h, const uint8_t* k, uint32_t kl,
                           uint64_t inv, const uint8_t* v, uint32_t vl) {
  return trie_insert(static_cast<TrieRep*>(h), k, kl, inv, v, vl);
}

int64_t tpulsm_trie_count(void* h) {
  return static_cast<TrieRep*>(h)->count.load(std::memory_order_relaxed);
}

int64_t tpulsm_trie_memory(void* h) {
  return static_cast<TrieRep*>(h)->memory();
}

int64_t tpulsm_trie_insert_batch(
    void* h, const uint8_t* keybuf, const int64_t* key_offs,
    const int32_t* key_lens, const uint64_t* invs, const uint8_t* valbuf,
    const int64_t* val_offs, const int32_t* val_lens, int64_t n) {
  TrieRep* t = static_cast<TrieRep*>(h);
  int64_t fresh = 0;
  for (int64_t i = 0; i < n; i++) {
    fresh += trie_insert(t, keybuf + key_offs[i], (uint32_t)key_lens[i],
                         invs[i], valbuf + val_offs[i],
                         (uint32_t)val_lens[i]);
  }
  return fresh;
}

int64_t tpulsm_trie_insert_wb(void* h, const uint8_t* rep, int64_t len,
                              uint64_t first_seq, int64_t* out) {
  TrieRep* t = static_cast<TrieRep*>(h);
  return wb_wire_apply(rep, len, first_seq, out,
                       [t](const uint8_t* k, uint32_t kl, uint64_t inv,
                           const uint8_t* v, uint32_t vl) {
                         trie_insert(t, k, kl, inv, v, vl);
                       });
}

int64_t tpulsm_trie_insert_wb_prot(void* h, const uint8_t* rep, int64_t len,
                                   uint64_t first_seq, const uint64_t* prots,
                                   int64_t n_prots, int32_t pb, int64_t* out) {
  TrieRep* t = static_cast<TrieRep*>(h);
  int64_t rc = wb_wire_apply_chk(
      rep, len, first_seq, out,
      [t](const uint8_t* k, uint32_t kl, uint64_t inv, const uint8_t* v,
          uint32_t vl) { trie_insert(t, k, kl, inv, v, vl); },
      ProtCheck{prots, n_prots, prot_trunc_mask(pb)});
  if (rc >= 0 && rc != n_prots) return -5 - rc;  // carried vector too long
  return rc;
}

// Position protocol: a position is a TVer*. seek_ge finds the first
// (key, inv) pair >= probe; next follows the version list, then
// re-descends for the successor key (stateless).
void* tpulsm_trie_seek_ge(void* h, const uint8_t* k, uint32_t kl,
                          uint64_t inv) {
  TrieRep* t = static_cast<TrieRep*>(h);
  TLeafHdr* lf = trie_leaf_ge(t, k, kl);
  while (lf) {
    if ((lf->key_len == kl && kl && std::memcmp(lf->key, k, kl) == 0)
        || (lf->key_len == 0 && kl == 0)) {
      for (TVer* v = lf->head.load(std::memory_order_acquire); v;
           v = v->next.load(std::memory_order_acquire))
        if (v->inv >= inv) return v;
    } else {
      return lf->head.load(std::memory_order_acquire);  // greater key
    }
    // Same key exhausted below inv: successor key = first leaf > key.
    // Re-probe with key + 0x00 appended (smallest strict extension).
    std::string tmp((const char*)lf->key, lf->key_len);
    tmp.push_back('\0');
    TLeafHdr* nx = trie_leaf_ge(t, (const uint8_t*)tmp.data(),
                                (uint32_t)tmp.size());
    if (nx == lf) return nullptr;  // defensive; cannot match
    lf = nx;
    if (lf) return lf->head.load(std::memory_order_acquire);
    return nullptr;
  }
  return nullptr;
}

void* tpulsm_trie_first(void* h) {
  TrieRep* t = static_cast<TrieRep*>(h);
  TLeafHdr* lf = trie_leaf_ge(t, nullptr, 0);
  return lf ? lf->head.load(std::memory_order_acquire) : nullptr;
}

void* tpulsm_trie_last(void* h) {
  TrieRep* t = static_cast<TrieRep*>(h);
  for (int s = 255; s >= 0; s--) {
    std::lock_guard<std::mutex> g(t->stripes[s].mu);
    if (t->stripes[s].root) {
      TLeafHdr* lf = tmax_leaf(t->stripes[s].root);
      if (lf) {
        TVer* v = lf->head.load(std::memory_order_acquire);
        while (v) {
          TVer* nx = v->next.load(std::memory_order_acquire);
          if (!nx) break;
          v = nx;
        }
        return v;
      }
    }
  }
  {
    std::lock_guard<std::mutex> g(t->stripes[256].mu);
    if (t->stripes[256].root) {
      TLeafHdr* lf = tmax_leaf(t->stripes[256].root);
      if (lf) {
        TVer* v = lf->head.load(std::memory_order_acquire);
        while (v) {
          TVer* nx = v->next.load(std::memory_order_acquire);
          if (!nx) break;
          v = nx;
        }
        return v;
      }
    }
  }
  return nullptr;
}

void* tpulsm_trie_next(void* h, void* pos) {
  TVer* v = static_cast<TVer*>(pos);
  TVer* nv = v->next.load(std::memory_order_acquire);
  if (nv) return nv;
  TLeafHdr* lf = v->leaf;
  TrieRep* t = static_cast<TrieRep*>(h);
  std::string tmp((const char*)lf->key, lf->key_len);
  tmp.push_back('\0');
  TLeafHdr* nx = trie_leaf_ge(t, (const uint8_t*)tmp.data(),
                              (uint32_t)tmp.size());
  return nx ? nx->head.load(std::memory_order_acquire) : nullptr;
}

// Last (key, inv) strictly BEFORE the probe pair.
void* tpulsm_trie_seek_lt(void* h, const uint8_t* k, uint32_t kl,
                          uint64_t inv) {
  TrieRep* t = static_cast<TrieRep*>(h);
  // Same-key versions with v->inv < inv come first (they sort before).
  TLeafHdr* lf = nullptr;
  {
    int s0 = kl ? k[0] : 256;
    TrieStripe& st = t->stripes[s0];
    std::lock_guard<std::mutex> g(st.mu);
    if (st.root) {
      // exact-key leaf?
      TLeafHdr* cand =
          s0 == 256 ? (st.root->prefix_len == 0 ? st.root->leaf : nullptr)
                    : trie_lower_bound(st.root, k + 1, kl - 1);
      if (cand && cand->key_len == kl &&
          (kl == 0 || std::memcmp(cand->key, k, kl) == 0))
        lf = cand;
    }
  }
  if (lf) {
    TVer* best = nullptr;
    for (TVer* v = lf->head.load(std::memory_order_acquire);
         v && v->inv < inv; v = v->next.load(std::memory_order_acquire))
      best = v;
    if (best) return best;
  }
  TLeafHdr* pl = trie_leaf_lt(t, k, kl);
  if (!pl) return nullptr;
  TVer* v = pl->head.load(std::memory_order_acquire);
  while (v) {
    TVer* nx = v->next.load(std::memory_order_acquire);
    if (!nx) break;
    v = nx;
  }
  return v;
}

void tpulsm_trie_ver(void* pos, const uint8_t** k, uint32_t* kl,
                     uint64_t* inv, const uint8_t** v, uint32_t* vl) {
  TVer* ver = static_cast<TVer*>(pos);
  *k = ver->leaf->key;
  *kl = ver->leaf->key_len;
  *inv = ver->inv;
  const uint8_t* rec = ver->val.load(std::memory_order_acquire);
  uint32_t len;
  std::memcpy(&len, rec, 4);
  *v = rec + 4;
  *vl = len;
}

// Ordered whole-rep export — same contract as tpulsm_skiplist_export.
int64_t tpulsm_trie_export(
    void* h, uint8_t* key_buf, int64_t* key_offs, int32_t* key_lens,
    uint64_t* seqs, int32_t* vtypes, uint8_t* val_buf, int64_t* val_offs,
    int32_t* val_lens, int64_t max_rows, int64_t* out_sizes) {
  TrieRep* t = static_cast<TrieRep*>(h);
  if (key_buf == nullptr) {
    int64_t kb = 0, vb = 0, rows = 0;
    trie_walk_all(t, [&](TLeafHdr* lf) {
      for (TVer* v = lf->head.load(std::memory_order_acquire); v;
           v = v->next.load(std::memory_order_acquire)) {
        const uint8_t* rec = v->val.load(std::memory_order_acquire);
        uint32_t vl;
        std::memcpy(&vl, rec, 4);
        kb += lf->key_len + 8;
        vb += vl;
        rows++;
      }
    });
    out_sizes[0] = kb;
    out_sizes[1] = vb;
    out_sizes[2] = rows;
    return rows;
  }
  const int64_t key_cap = out_sizes[0], val_cap = out_sizes[1];
  int64_t ko = 0, vo = 0, rows = 0;
  bool overflow = false;
  trie_walk_all(t, [&](TLeafHdr* lf) {
    if (overflow) return;
    for (TVer* v = lf->head.load(std::memory_order_acquire); v;
         v = v->next.load(std::memory_order_acquire)) {
      if (rows >= max_rows) {
        overflow = true;
        return;
      }
      const uint8_t* rec = v->val.load(std::memory_order_acquire);
      uint32_t vl;
      std::memcpy(&vl, rec, 4);
      if (ko + (int64_t)lf->key_len + 8 > key_cap ||
          vo + (int64_t)vl > val_cap) {
        overflow = true;
        return;
      }
      uint64_t packed = ~v->inv;
      std::memcpy(key_buf + ko, lf->key, lf->key_len);
      for (int b = 0; b < 8; b++)
        key_buf[ko + lf->key_len + b] = (uint8_t)(packed >> (8 * b));
      key_offs[rows] = ko;
      key_lens[rows] = (int32_t)(lf->key_len + 8);
      seqs[rows] = packed >> 8;
      vtypes[rows] = (int32_t)(packed & 0xFF);
      std::memcpy(val_buf + vo, rec + 4, vl);
      val_offs[rows] = vo;
      val_lens[rows] = (int32_t)vl;
      ko += lf->key_len + 8;
      vo += vl;
      rows++;
    }
  });
  return overflow ? -1 : rows;
}


// Shared packed-entry representation of the <=8B-user-key fast path:
// tpulsm_sort_entries and tpulsm_merge_runs promise BIT-EXACT identical
// output, so the struct, comparator, and entry build live in ONE place.
extern "C++" {
struct PackedEntry {
  uint64_t kw;      // BE-packed user key, zero-padded
  uint64_t packed;  // (seq << 8) | type; DESCENDING
  uint32_t len;
  int32_t idx;
};

static inline bool packed_entry_less(const PackedEntry& a,
                                     const PackedEntry& b) {
  if (a.kw != b.kw) return a.kw < b.kw;
  if (a.len != b.len) return a.len < b.len;
  if (a.packed != b.packed) return a.packed > b.packed;  // newer seq first
  return a.idx < b.idx;
}

static inline PackedEntry packed_entry_of(const uint8_t* key_buf,
                                          const int64_t* offs,
                                          const int64_t* lens, int64_t i) {
  const uint8_t* k = key_buf + offs[i];
  const int64_t l = lens[i] - 8;
  // The 8-byte trailer always follows the user key, so an 8-byte load at
  // k is in-bounds for any l >= 0; mask off the trailer bytes that leak
  // into the word when l < 8. ~3x faster than the byte loops at 10M rows.
  uint64_t raw, p;
  std::memcpy(&raw, k, 8);
  std::memcpy(&p, k + l, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
  uint64_t kw_full = raw;
  p = __builtin_bswap64(p);
#else
  uint64_t kw_full = __builtin_bswap64(raw);
#endif
  uint64_t kw = l >= 8 ? kw_full
                       : (l ? (kw_full & (~0ull << (8 * (8 - l)))) : 0);
  return {kw, p, static_cast<uint32_t>(l), static_cast<int32_t>(i)};
}
}  // extern "C++"

// ---------------------------------------------------------------------------
// Internal-key sort: order entries by (user key bytes asc, key length asc,
// seqno desc) — the exact order the device sort realizes with zero-padded
// big-endian key words + length tie-break + inverted packed trailer. Also
// emits the adjacent new-user-key boundaries the GC mask needs.
// Returns 0 on success.
// ---------------------------------------------------------------------------
int32_t tpulsm_sort_entries(const uint8_t* key_buf, const int64_t* offs,
                            const int64_t* lens, int64_t n,
                            int32_t* order_out, uint8_t* new_key_out,
                            uint64_t* packed_out /* nullable */) {
  auto packed_of = [&](int32_t i) -> uint64_t {
    // 8 LE trailer bytes assembled with shifts: endian-independent.
    const uint8_t* t = key_buf + offs[i] + lens[i] - 8;
    uint64_t p = 0;
    for (int b = 0; b < 8; b++) p |= static_cast<uint64_t>(t[b]) << (8 * b);
    return p;  // (seq << 8) | type
  };
  int64_t max_uklen = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t l = lens[i] - 8;
    if (l > max_uklen) max_uklen = l;
  }
  if (max_uklen <= 8) {
    // Packed fast path: user keys fit one big-endian word, so the whole
    // comparator is three integer compares on a cache-friendly struct —
    // ~6x faster than the indirect memcmp form at multi-million entries.
    using E = PackedEntry;
    std::vector<E> es(n);
    for (int64_t i = 0; i < n; i++) {
      es[i] = packed_entry_of(key_buf, offs, lens, i);
      // Per-ORIGINAL-index trailers for the caller, decoded exactly once.
      if (packed_out) packed_out[i] = es[i].packed;
    }
    // idx as the final tiebreak makes the order STRICT and total, so an
    // unstable chunked parallel sort + merges yields exactly the sequence
    // stable_sort would — independent of thread count. The single-core
    // radix path below realises the same order (stable LSD over the same
    // composite), so every path emits identical bytes. The comparator is
    // the SHARED packed_entry_less — merge_runs must stay bit-identical.
    auto cmp = [](const E& a, const E& b) {
      return packed_entry_less(a, b);
    };
    size_t nthreads = effective_cpus();
    if (nthreads > 8) nthreads = 8;
    if (n < (1 << 16)) {
      std::sort(es.begin(), es.end(), cmp);
    } else if (nthreads < 4) {
      // Stable LSD radix, 16-bit digits, least-significant first over the
      // composite (kw, len, packed DESC): ~packed low..high, len, kw
      // low..high. Constant digits (shared key prefixes, small seqnos)
      // skip their scatter pass entirely. No exception may cross the
      // extern "C" boundary: failed scratch allocation degrades to a
      // comparison sort in place.
      std::vector<E> tmp;
      std::vector<int64_t> hist;
      try {
        tmp.resize(n);
        hist.resize(1 << 16);
      } catch (...) {
        std::sort(es.begin(), es.end(), cmp);
        tmp.clear();
      }
      std::vector<E>* src = &es;
      std::vector<E>* dst = &tmp;
      auto digit_of = [](const E& e, int d) -> uint32_t {
        if (d < 4) return (uint32_t)((~e.packed) >> (16 * d)) & 0xffff;
        if (d == 4) return e.len & 0xffff;
        return (uint32_t)(e.kw >> (16 * (d - 5))) & 0xffff;
      };
      for (int d = 0; d < 9 && !tmp.empty(); d++) {
        std::fill(hist.begin(), hist.end(), 0);
        const E* s = src->data();
        for (int64_t i = 0; i < n; i++) hist[digit_of(s[i], d)]++;
        uint32_t first = digit_of(s[0], d);
        if (hist[first] == n) continue;  // constant digit: order unchanged
        int64_t sum = 0;
        for (int64_t b = 0; b < (1 << 16); b++) {
          int64_t c = hist[b];
          hist[b] = sum;
          sum += c;
        }
        E* o = dst->data();
        for (int64_t i = 0; i < n; i++) o[hist[digit_of(s[i], d)]++] = s[i];
        std::swap(src, dst);
      }
      if (src != &es) es = std::move(*src);
    } else {
      // No exception may cross the extern "C" boundary: a failed thread
      // spawn (cgroup pid limit, transient EAGAIN) runs the task inline on
      // this thread instead, and a failed scratch allocation degrades to a
      // serial sort over the already-sorted chunks.
      auto spawn_or_inline = spawn_or_inline_th;
      std::vector<size_t> bounds(nthreads + 1);
      for (size_t t = 0; t <= nthreads; t++)
        bounds[t] = static_cast<size_t>(n) * t / nthreads;
      std::vector<std::thread> workers;
      for (size_t t = 1; t < nthreads; t++)
        spawn_or_inline(workers, [&es, &bounds, t, &cmp] {
          std::sort(es.begin() + bounds[t], es.begin() + bounds[t + 1], cmp);
        });
      std::sort(es.begin(), es.begin() + bounds[1], cmp);
      for (auto& w : workers) w.join();
      std::vector<E> tmp;
      try {
        tmp.resize(n);
      } catch (...) {
        tmp.clear();
      }
      if (tmp.empty()) {
        std::sort(es.begin(), es.end(), cmp);
      } else {
        // Bottom-up pairwise merges; pairs within a pass run concurrently.
        std::vector<E>* src = &es;
        std::vector<E>* dst = &tmp;
        while (bounds.size() > 2) {
          std::vector<size_t> nb;
          nb.push_back(0);
          std::vector<std::thread> mergers;
          for (size_t r = 0; r + 2 < bounds.size(); r += 2) {
            size_t lo = bounds[r], mid = bounds[r + 1], hi = bounds[r + 2];
            spawn_or_inline(mergers, [src, dst, lo, mid, hi, &cmp] {
              std::merge(src->begin() + lo, src->begin() + mid,
                         src->begin() + mid, src->begin() + hi,
                         dst->begin() + lo, cmp);
            });
            nb.push_back(hi);
          }
          if (bounds.size() % 2 == 0) {  // odd run count: copy the tail run
            size_t lo = bounds[bounds.size() - 2], hi = bounds.back();
            std::copy(src->begin() + lo, src->begin() + hi, dst->begin() + lo);
            nb.push_back(hi);
          }
          for (auto& w : mergers) w.join();
          std::swap(src, dst);
          bounds = std::move(nb);
        }
        if (src != &es) es = std::move(*src);
      }
    }
    for (int64_t i = 0; i < n; i++) {
      order_out[i] = es[i].idx;
      new_key_out[i] =
          (i == 0 || es[i].kw != es[i - 1].kw || es[i].len != es[i - 1].len)
              ? 1
              : 0;
    }
    return 0;
  }
  if (packed_out) {
    // Slow (>8B-key) path: emit per-ORIGINAL-index trailers here.
    for (int64_t i = 0; i < n; i++)
      packed_out[i] = packed_of(static_cast<int32_t>(i));
  }
  std::vector<int32_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  // stable: duplicate internal keys keep input order (the survivor choice
  // must be deterministic, matching the np.lexsort twin).
  std::stable_sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
    const uint8_t* ka = key_buf + offs[a];
    const uint8_t* kb = key_buf + offs[b];
    const size_t la = static_cast<size_t>(lens[a] - 8);
    const size_t lb = static_cast<size_t>(lens[b] - 8);
    const int c = std::memcmp(ka, kb, la < lb ? la : lb);
    if (c != 0) return c < 0;
    if (la != lb) return la < lb;
    return packed_of(a) > packed_of(b);  // newer seq first
  });
  std::memcpy(order_out, idx.data(), n * sizeof(int32_t));
  for (int64_t i = 0; i < n; i++) {
    if (i == 0) {
      new_key_out[i] = 1;
      continue;
    }
    const int32_t a = idx[i - 1], b = idx[i];
    const size_t la = static_cast<size_t>(lens[a] - 8);
    const size_t lb = static_cast<size_t>(lens[b] - 8);
    new_key_out[i] =
        (la != lb ||
         std::memcmp(key_buf + offs[a], key_buf + offs[b], la) != 0)
            ? 1
            : 0;
  }
  return 0;
}


// ---------------------------------------------------------------------------
// K-way merge of PRESORTED runs — the host twin of the device segmented
// merge (and the reference's heap merge, table/merging_iterator.cc:476):
// compaction inputs are already internal-key-sorted runs, so re-deriving
// the order with a full sort does O(N log N) work the structure already
// paid for. Each of T threads owns a splitter-bounded slice of EVERY run
// (binary-searched bounds → contiguous output range) and k-way merges its
// slices with a linear head scan. Output contract matches
// tpulsm_sort_entries exactly (same comparator incl. the idx tiebreak).
// Returns 0, or -1 when ineligible (user keys > 8B: caller falls back).
// ---------------------------------------------------------------------------
int32_t tpulsm_merge_runs(const uint8_t* key_buf, const int64_t* offs,
                          const int64_t* lens, int64_t n,
                          const int64_t* run_starts, int32_t n_runs,
                          int32_t* order_out, uint8_t* new_key_out,
                          uint64_t* packed_out /* nullable */) {
  if (n <= 0 || n_runs <= 0) return -1;
  for (int64_t i = 0; i < n; i++)
    if (lens[i] - 8 > 8) return -1;  // packed fast path only
  using E = PackedEntry;
  auto cmp = [](const E& a, const E& b) { return packed_entry_less(a, b); };
  size_t nthreads = effective_cpus();
  if (nthreads > 8) nthreads = 8;
  if (n < (1 << 16)) nthreads = 1;
  std::vector<E> es, out;
  std::vector<std::vector<int64_t>> lb;
  try {
    es.resize(n);
    out.resize(n);
    lb.assign(nthreads + 1, std::vector<int64_t>(n_runs));
  } catch (...) {
    return -1;  // no exception may cross the extern "C" boundary
  }
  auto spawn_or_inline = spawn_or_inline_th;
  {
    // Parallel entry build (+ packed_out per ORIGINAL index).
    auto build = [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; i++) {
        es[i] = packed_entry_of(key_buf, offs, lens, i);
        if (packed_out) packed_out[i] = es[i].packed;
      }
    };
    std::vector<std::thread> pool;
    for (size_t t = 1; t < nthreads; t++)
      spawn_or_inline(pool, [&, t] {
        build(n * (int64_t)t / (int64_t)nthreads,
              n * (int64_t)(t + 1) / (int64_t)nthreads);
      });
    build(0, n / (int64_t)nthreads);
    for (auto& w : pool) w.join();
  }
  // Splitters from the largest run; per-run bounds via lower_bound.
  int32_t big = 0;
  for (int32_t r = 1; r < n_runs; r++)
    if (run_starts[r + 1] - run_starts[r] >
        run_starts[big + 1] - run_starts[big])
      big = r;
  for (int32_t r = 0; r < n_runs; r++) {
    lb[0][r] = run_starts[r];
    lb[nthreads][r] = run_starts[r + 1];
  }
  for (size_t t = 1; t < nthreads; t++) {
    int64_t blo = run_starts[big], bhi = run_starts[big + 1];
    const E& sp = es[blo + (bhi - blo) * (int64_t)t / (int64_t)nthreads];
    for (int32_t r = 0; r < n_runs; r++) {
      int64_t lo = run_starts[r], hi = run_starts[r + 1];
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (cmp(es[mid], sp))
          lo = mid + 1;
        else
          hi = mid;
      }
      lb[t][r] = lo;
    }
  }
  // Per-thread k-way merge into its contiguous output range. head/end
  // scratch is preallocated HERE (a bad_alloc on a spawned thread would
  // std::terminate the process).
  std::vector<std::vector<int64_t>> heads, ends;
  try {
    heads.assign(nthreads, std::vector<int64_t>(n_runs));
    ends.assign(nthreads, std::vector<int64_t>(n_runs));
  } catch (...) {
    return -1;  // no exception may cross the extern "C" boundary
  }
  auto merge_slice = [&](size_t t) {
    int64_t pos = 0;
    for (int32_t r = 0; r < n_runs; r++) pos += lb[t][r] - run_starts[r];
    std::vector<int64_t>& head = heads[t];
    std::vector<int64_t>& end = ends[t];
    for (int32_t r = 0; r < n_runs; r++) {
      head[r] = lb[t][r];
      end[r] = lb[t + 1][r];
    }
    while (true) {
      int32_t best = -1;
      for (int32_t r = 0; r < n_runs; r++) {
        if (head[r] >= end[r]) continue;
        if (best < 0 || cmp(es[head[r]], es[head[best]])) best = r;
      }
      if (best < 0) break;
      out[pos++] = es[head[best]++];
    }
  };
  {
    std::vector<std::thread> pool;
    for (size_t t = 1; t < nthreads; t++)
      spawn_or_inline(pool, [&, t] { merge_slice(t); });
    merge_slice(0);
    for (auto& w : pool) w.join();
  }
  for (int64_t i = 0; i < n; i++) {
    order_out[i] = out[i].idx;
    new_key_out[i] =
        (i == 0 || out[i].kw != out[i - 1].kw ||
         out[i].len != out[i - 1].len)
            ? 1
            : 0;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Fused k-way run merge + MVCC GC (host twin of the fused device kernel,
// semantics of ops/compaction_kernels.host_gc_mask — RocksDB's
// CompactionIterator's snapshot-stripe dedup, db/compaction/
// compaction_iterator.cc role). ONE pass: merge presorted runs in internal-
// key order and emit only the surviving rows — no sorted scratch pass, no
// numpy mask passes. Complex user-key groups (MERGE / SINGLE_DELETION
// present) are emitted whole with cx=1 for the host state machine.
//   snaps:  sorted-ascending live-snapshot seqnos (may be null when none)
//   cover:  nullable per-ORIGINAL-row max covering range-tombstone seqno,
//           stripe-clamped by the caller
//   zero_out/cx_out: per SURVIVOR (parallel to the returned prefix of
//           order_out)
//   packed_out: per ORIGINAL row (seq<<8|type), like tpulsm_merge_runs
//   force_threads: 1..16 pins the merge's thread count, 0 = automatic
// Returns the survivor count, or -1 when ineligible (keys > 8B, bad runs).
// ---------------------------------------------------------------------------
int64_t tpulsm_merge_gc_runs(const uint8_t* key_buf, const int64_t* offs,
                             const int64_t* lens, int64_t n,
                             const int64_t* run_starts, int32_t n_runs,
                             const uint64_t* snaps, int32_t n_snaps,
                             const uint64_t* cover, int32_t bottommost,
                             int32_t* order_out, uint8_t* zero_out,
                             uint8_t* cx_out, uint64_t* packed_out,
                             int32_t* has_complex_out,
                             int32_t force_threads) {
  if (n <= 0 || n_runs <= 0) return -1;
  for (int64_t i = 0; i < n; i++)
    if (lens[i] - 8 > 8) return -1;  // packed fast path only
  using E = PackedEntry;
  auto cmp = [](const E& a, const E& b) { return packed_entry_less(a, b); };
  size_t nthreads = effective_cpus();
  if (nthreads > 8) nthreads = 8;
  if (n < (1 << 16)) nthreads = 1;
  // force_threads (1..16) pins the thread count: the group-aligned
  // splitter path only engages multi-core, so parity tests force it to
  // exercise that path on small boxes. 0 = automatic.
  if (force_threads >= 1 && force_threads <= 16)
    nthreads = (size_t)force_threads;
  std::vector<E> es;
  std::vector<std::vector<int64_t>> lb;
  std::vector<int64_t> tcount(nthreads, 0), tbase(nthreads, 0);
  std::vector<uint8_t> tcomplex(nthreads, 0);
  try {
    es.resize(n);
    lb.assign(nthreads + 1, std::vector<int64_t>(n_runs));
  } catch (...) {
    return -1;  // no exception may cross the extern "C" boundary
  }
  {
    auto build = [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; i++) {
        es[i] = packed_entry_of(key_buf, offs, lens, i);
        if (packed_out) packed_out[i] = es[i].packed;
      }
    };
    std::vector<std::thread> pool;
    for (size_t t = 1; t < nthreads; t++)
      spawn_or_inline_th(pool, [&, t] {
        build(n * (int64_t)t / (int64_t)nthreads,
              n * (int64_t)(t + 1) / (int64_t)nthreads);
      });
    build(0, n / (int64_t)nthreads);
    for (auto& w : pool) w.join();
  }
  // Group-ALIGNED splitters: a synthetic (kw, len, seq=+inf) key compares
  // before every real row of that user key, so lower_bound lands each
  // boundary at a group start and no user-key group spans two threads
  // (the per-group complex/stripe logic below needs whole groups).
  int32_t big = 0;
  for (int32_t r = 1; r < n_runs; r++)
    if (run_starts[r + 1] - run_starts[r] >
        run_starts[big + 1] - run_starts[big])
      big = r;
  for (int32_t r = 0; r < n_runs; r++) {
    lb[0][r] = run_starts[r];
    lb[nthreads][r] = run_starts[r + 1];
  }
  for (size_t t = 1; t < nthreads; t++) {
    int64_t blo = run_starts[big], bhi = run_starts[big + 1];
    E sp = es[blo + (bhi - blo) * (int64_t)t / (int64_t)nthreads];
    sp.packed = ~0ull;
    sp.idx = INT32_MIN;
    for (int32_t r = 0; r < n_runs; r++) {
      int64_t lo = run_starts[r], hi = run_starts[r + 1];
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (cmp(es[mid], sp))
          lo = mid + 1;
        else
          hi = mid;
      }
      lb[t][r] = lo;
    }
  }
  std::vector<std::vector<int64_t>> heads, ends;
  try {
    heads.assign(nthreads, std::vector<int64_t>(n_runs));
    ends.assign(nthreads, std::vector<int64_t>(n_runs));
  } catch (...) {
    return -1;
  }
  constexpr uint8_t kDeletion = 0x0, kValue = 0x1, kMerge = 0x2,
                    kSingleDel = 0x7;
  auto stripe_of = [&](uint64_t seq) -> int32_t {
    // count of snaps < seq (searchsorted left); n_snaps is usually 0.
    int32_t lo = 0, hi = n_snaps;
    while (lo < hi) {
      int32_t mid = (lo + hi) >> 1;
      if (snaps[mid] < seq)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  };
  // Per-thread merge with inline per-group GC. Survivors are written into
  // the thread's slice region of order_out/zero_out/cx_out (slice offsets
  // bound the survivor count from above), then compacted after the join.
  auto merge_slice = [&](size_t t) {
    int64_t base = 0;
    for (int32_t r = 0; r < n_runs; r++) base += lb[t][r] - run_starts[r];
    tbase[t] = base;
    int64_t pos = base;
    std::vector<int64_t>& head = heads[t];
    std::vector<int64_t>& end = ends[t];
    for (int32_t r = 0; r < n_runs; r++) {
      head[r] = lb[t][r];
      end[r] = lb[t + 1][r];
    }
    // Current user-key group buffer; emit decisions happen on group close.
    uint64_t gkw = 0;
    uint32_t glen = 0;
    bool gcomplex = false;
    int64_t gn = 0;             // rows buffered for this group
    std::vector<E> grp;
    auto flush_group = [&]() {
      if (!gn) return;
      if (gcomplex) {
        tcomplex[t] = 1;
        for (int64_t i = 0; i < gn; i++) {
          order_out[pos] = grp[i].idx;
          zero_out[pos] = 0;
          cx_out[pos] = 1;
          pos++;
        }
      } else {
        int32_t ps = -1;
        for (int64_t i = 0; i < gn; i++) {
          const E& e = grp[i];
          uint64_t seq = e.packed >> 8;
          uint8_t vt = (uint8_t)(e.packed & 0xFF);
          int32_t st = n_snaps ? stripe_of(seq) : 0;
          bool first_in_stripe = (i == 0) || (st != ps);
          ps = st;
          bool covered = cover && cover[e.idx] != 0 && cover[e.idx] > seq;
          bool keep = first_in_stripe && !covered;
          if (bottommost && st == 0 && vt == kDeletion) keep = false;
          if (!keep) continue;
          bool zero = bottommost && st == 0 && vt == kValue;
          order_out[pos] = e.idx;
          zero_out[pos] = zero ? 1 : 0;
          cx_out[pos] = 0;
          pos++;
        }
      }
      gn = 0;
      grp.clear();
    };
    while (true) {
      int32_t best = -1;
      for (int32_t r = 0; r < n_runs; r++) {
        if (head[r] >= end[r]) continue;
        if (best < 0 || cmp(es[head[r]], es[head[best]])) best = r;
      }
      if (best < 0) break;
      const E& e = es[head[best]++];
      if (gn == 0 || e.kw != gkw || e.len != glen) {
        flush_group();
        gkw = e.kw;
        glen = e.len;
        gcomplex = false;
      }
      uint8_t vt = (uint8_t)(e.packed & 0xFF);
      if (vt == kMerge || vt == kSingleDel) gcomplex = true;
      grp.push_back(e);
      gn++;
    }
    flush_group();
    tcount[t] = pos - base;
  };
  {
    std::vector<std::thread> pool;
    for (size_t t = 1; t < nthreads; t++)
      spawn_or_inline_th(pool, [&, t] { merge_slice(t); });
    merge_slice(0);
    for (auto& w : pool) w.join();
  }
  // Compact the per-thread survivor regions to a dense prefix.
  int64_t n_out = tcount[0];
  for (size_t t = 1; t < nthreads; t++) {
    if (tbase[t] != n_out && tcount[t]) {
      std::memmove(order_out + n_out, order_out + tbase[t],
                   tcount[t] * sizeof(int32_t));
      std::memmove(zero_out + n_out, zero_out + tbase[t], tcount[t]);
      std::memmove(cx_out + n_out, cx_out + tbase[t], tcount[t]);
    }
    n_out += tcount[t];
  }
  if (has_complex_out) {
    int32_t hc = 0;
    for (size_t t = 0; t < nthreads; t++) hc |= tcomplex[t];
    *has_complex_out = hc;
  }
  return n_out;
}


// ---------------------------------------------------------------------------
// Internal-key order of two encoded keys (user bytes asc, then the packed
// trailer desc): the point-read chain's comparator.
// ---------------------------------------------------------------------------

namespace {

inline int ikey_compare(const uint8_t* a, int32_t al, const uint8_t* b,
                        int32_t bl) {
  int32_t au = al - 8, bu = bl - 8;
  if (au < 0 || bu < 0) {  // not internal keys; caller gated wrong
    int m = al < bl ? al : bl;
    int c = std::memcmp(a, b, (size_t)m);
    if (c) return c;
    return al < bl ? -1 : (al > bl ? 1 : 0);
  }
  int m = au < bu ? au : bu;
  int c = std::memcmp(a, b, (size_t)m);
  if (c) return c;
  if (au != bu) return au < bu ? -1 : 1;
  uint64_t pa = 0, pb = 0;
  for (int i = 0; i < 8; i++) {
    pa |= (uint64_t)a[au + i] << (8 * i);
    pb |= (uint64_t)b[bu + i] << (8 * i);
  }
  if (pa != pb) return pa > pb ? -1 : 1;  // higher seqno sorts FIRST
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// Native point-read engine: the whole DBImpl::GetImpl hot chain in one
// GIL-released call (reference db/db_impl/db_impl.cc:2079 GetImpl →
// Version::Get → BlockBasedTable::Get, block_based_table_reader.cc:2095).
// Python registers per-table handles (dup'd fd + in-memory index/filter
// blocks + key bounds) and per-version handles (L0 list newest-first +
// sorted deeper levels); tpulsm_db_get then probes memtable skiplists and
// the SST chain with a shared decompressed-block LRU, returning the value
// or a FALLBACK code for anything the Python state machine must handle
// (merge operands, single-delete, blob indexes, range tombstones).
// ---------------------------------------------------------------------------

namespace {

struct NTable {
  int fd = -1;                 // dup'd; owned
  int64_t file_size = 0;       // bounds every BlockHandle before pread
  uint64_t number = 0;         // block-cache key namespace
  int32_t eligible = 0;        // 0 → chain walk returns FALLBACK on contact
  std::string index;           // uncompressed single-level index block
  std::string filter;          // whole-key bloom block ("" → no filter)
  int32_t filter_kind = 0;     // 0 = classic bloom, 1 = blocked bloom
  std::string smallest_uk, largest_uk;
  // Decoded index (built once per handle): flat arrays for a cache-
  // friendly binary search — probing the raw multi-MB index block paid
  // ~15 scattered cache misses per Get. idx_prefix holds the zero-padded
  // big-endian first 8 USER-KEY bytes (coarse order: ties fall back to a
  // full compare of the stored key). Empty when the block didn't decode
  // cleanly (the BCur path remains as fallback).
  std::vector<uint64_t> idx_prefix;
  std::vector<uint32_t> idx_koff, idx_klen;
  std::vector<uint64_t> idx_boff, idx_bsize;
  std::string idx_keys;
  // --- zip-table sections (kind == 1). BORROWED: the Python reader owns
  // the section buffers and keeps them alive until it frees the handle
  // (weakref.finalize closure), so no copies of the multi-MB blob. ---
  int32_t kind = 0;  // 0 = block SST, 1 = zip table
  int32_t zg = 0, zvg = 0;
  int64_t zn = 0;
  int32_t zmeta16 = 0, zlens32 = 0;
  const uint8_t* zkmeta = nullptr;
  const uint8_t* zksfx = nullptr;
  int64_t zksfx_len = 0;
  const uint8_t* zkgso = nullptr;
  int64_t zng = 0;  // key groups
  const uint8_t* zvlens = nullptr;
  const uint8_t* zvgo = nullptr;  // (znvg + 1) u32 payload offsets
  const uint8_t* zvflags = nullptr;
  int64_t zvflags_len = 0;
  const uint8_t* zvdict = nullptr;
  int64_t zvdict_len = 0;
  const uint8_t* zvblob = nullptr;
  int64_t zvblob_len = 0;
  int64_t znvg = 0;                   // value groups
  std::vector<uint64_t> zhead_pre;    // nuk_prefix of each group head
  ~NTable() {
    if (fd >= 0) ::close(fd);
  }
};

static inline uint32_t zload_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// (plen, slen) meta pair of zip entry i.
static inline void zmeta_pair(const NTable* t, int64_t i, uint32_t* pl,
                              uint32_t* sl) {
  if (t->zmeta16) {
    uint16_t a, b;
    std::memcpy(&a, t->zkmeta + 4 * i, 2);
    std::memcpy(&b, t->zkmeta + 4 * i + 2, 2);
    *pl = a;
    *sl = b;
  } else {
    *pl = t->zkmeta[2 * i];
    *sl = t->zkmeta[2 * i + 1];
  }
}

static inline uint64_t zvlen_at(const NTable* t, int64_t i) {
  if (t->zlens32) return zload_u32(t->zvlens + 4 * i);
  uint16_t v;
  std::memcpy(&v, t->zvlens + 2 * i, 2);
  return v;
}

// Zero-padded big-endian first-8-bytes of a user key: never orders two
// keys WRONGLY, only ties (equal prefixes) need a full compare.
static inline uint64_t nuk_prefix(const uint8_t* uk, int32_t ulen) {
  uint64_t w = 0;
  int32_t n = ulen < 8 ? ulen : 8;
  for (int32_t i = 0; i < n; i++) w |= (uint64_t)uk[i] << (8 * (7 - i));
  return w;
}

struct NVersion {
  std::vector<NTable*> l0;                   // newest first
  std::vector<std::vector<NTable*>> levels;  // levels 1.. sorted by key
};

// Sharded LRU of decompressed data blocks keyed by (table number, offset).
struct NBlockCache {
  struct Entry {
    std::shared_ptr<std::string> data;
    uint64_t number, off;  // full key: a mixed-hash collision must MISS
    std::list<std::pair<uint64_t, uint64_t>>::iterator lru_it;
  };
  struct Shard {
    std::mutex mu;
    std::unordered_map<uint64_t, Entry> map;
    std::list<std::pair<uint64_t, uint64_t>> lru;  // front = hottest
    size_t bytes = 0;
  };
  static const int kShards = 16;
  Shard shards[kShards];
  std::atomic<size_t> budget{256u << 20};
  std::atomic<uint64_t> hits{0}, misses{0};

  static uint64_t key_of(uint64_t number, uint64_t off) {
    // splitmix64 over the pair; the map stores the mixed key. A collision
    // would serve wrong bytes, so fold BOTH inputs through two rounds.
    uint64_t x = number * 0x9E3779B97F4A7C15ULL ^ (off + 0xBF58476D1CE4E5B9ULL);
    x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ULL;
    x ^= x >> 27; x *= 0x94D049BB133111EBULL;
    x ^= x >> 31;
    return x;
  }

  std::shared_ptr<std::string> lookup(uint64_t number, uint64_t off) {
    uint64_t k = key_of(number, off);
    Shard& s = shards[k % kShards];
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.map.find(k);
    if (it == s.map.end() || it->second.number != number ||
        it->second.off != off) {
      misses.fetch_add(1, std::memory_order_relaxed);
      return nullptr;
    }
    s.lru.splice(s.lru.begin(), s.lru, it->second.lru_it);
    hits.fetch_add(1, std::memory_order_relaxed);
    return it->second.data;
  }

  void insert(uint64_t number, uint64_t off,
              std::shared_ptr<std::string> data) {
    uint64_t k = key_of(number, off);
    Shard& s = shards[k % kShards];
    size_t per_shard = budget.load(std::memory_order_relaxed) / kShards;
    std::lock_guard<std::mutex> g(s.mu);
    if (s.map.count(k)) return;
    s.bytes += data->size();
    s.lru.emplace_front(k, (uint64_t)data->size());
    s.map[k] = Entry{std::move(data), number, off, s.lru.begin()};
    while (s.bytes > per_shard && !s.lru.empty()) {
      auto victim = s.lru.back();
      s.lru.pop_back();
      s.bytes -= victim.second;
      s.map.erase(victim.first);
    }
  }
};

NBlockCache& nblock_cache() {
  static NBlockCache c;
  return c;
}

// In-block cursor over the restart-compressed entry stream.
struct BCur {
  const uint8_t* data;
  const uint8_t* p;
  const uint8_t* limit;  // start of restart array
  uint8_t key[4096];
  uint32_t klen = 0;
  const uint8_t* val = nullptr;
  uint32_t vlen = 0;

  bool init(const uint8_t* d, int64_t len) {
    if (len < 8) return false;
    uint32_t nr;
    std::memcpy(&nr, d + len - 4, 4);
    int64_t restart_off = len - 4 - 4 * (int64_t)nr;
    if (nr == 0 || restart_off < 0) return false;
    data = d;
    p = d;
    limit = d + restart_off;
    klen = 0;
    return true;
  }

  bool at_end() const { return p >= limit; }

  // 1 = entry decoded, 0 = end of block, -1 = corrupt OR key too large
  // for the cursor buffer (callers must FALL BACK, not report a miss — a
  // legitimate >4KB stored key is not corruption).
  int next() {
    if (p >= limit) return 0;
    uint32_t shared, non_shared, v;
    p = get_varint32(p, limit, &shared);
    if (!p) return -1;
    p = get_varint32(p, limit, &non_shared);
    if (!p) return -1;
    p = get_varint32(p, limit, &v);
    if (!p) return -1;
    if (shared > klen || non_shared > sizeof(key) - shared) return -1;
    if (p + non_shared + v > limit) return -1;
    std::memcpy(key + shared, p, non_shared);
    klen = shared + non_shared;
    p += non_shared;
    val = p;
    vlen = v;
    p += v;
    return 1;
  }
};

// Decoded-entry comparator vs target, using the internal-key order helper
// defined in the block-seek section above.
inline int bcur_cmp(const BCur& c, const uint8_t* target, int32_t tlen) {
  return ikey_compare(c.key, (int32_t)c.klen, target, tlen);
}

// Position cursor at the first entry >= target (restart bsearch + scan).
// Returns 1 = cursor holds that entry, 0 = every key < target (or empty),
// -1 = corruption.
int bcur_seek(BCur& c, const uint8_t* d, int64_t len, const uint8_t* target,
              int32_t tlen) {
  if (len < 8) return -1;
  uint32_t nr;
  std::memcpy(&nr, d + len - 4, 4);
  int64_t restart_off = len - 4 - 4 * (int64_t)nr;
  if (nr == 0 || restart_off < 0) return -1;
  auto restart_point = [&](uint32_t i) -> uint32_t {
    uint32_t v;
    std::memcpy(&v, d + restart_off + 4 * (int64_t)i, 4);
    return v;
  };
  // Find the last restart whose key < target.
  uint32_t lo = 0, hi = nr - 1;
  while (lo < hi) {
    uint32_t mid = (lo + hi + 1) / 2;
    BCur probe;
    if (!probe.init(d, len)) return -1;
    probe.p = d + restart_point(mid);
    probe.klen = 0;
    if (probe.next() != 1) return -1;
    if (bcur_cmp(probe, target, tlen) < 0) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  if (!c.init(d, len)) return -1;
  c.p = d + restart_point(lo);
  c.klen = 0;
  int nr2;
  while ((nr2 = c.next()) == 1) {
    if (bcur_cmp(c, target, tlen) >= 0) return 1;
  }
  if (nr2 < 0) return -1;
  return 0;  // all keys < target
}

// Decode a single-level index block into NTable's flat arrays; leaves
// them empty (BCur fallback) on any irregularity.
void ntable_decode_index(NTable* t) {
  auto fail = [&] {
    t->idx_prefix.clear();
    t->idx_koff.clear();
    t->idx_klen.clear();
    t->idx_boff.clear();
    t->idx_bsize.clear();
    t->idx_keys.clear();
  };
  BCur c;
  if (t->index.empty() ||
      !c.init((const uint8_t*)t->index.data(), (int64_t)t->index.size()))
    return;
  size_t approx = t->index.size() / 24 + 8;
  t->idx_prefix.reserve(approx);
  t->idx_boff.reserve(approx);
  t->idx_bsize.reserve(approx);
  int r;
  while ((r = c.next()) == 1) {
    const uint8_t* vp = c.val;
    const uint8_t* vend = c.val + c.vlen;
    uint64_t boff = 0, bsize = 0;
    vp = get_varint64(vp, vend, &boff);
    if (vp) vp = get_varint64(vp, vend, &bsize);
    if (!vp || c.klen < 8 || t->idx_keys.size() > 0xFFFFFF00u) {
      fail();
      return;
    }
    t->idx_prefix.push_back(nuk_prefix(c.key, (int32_t)c.klen - 8));
    t->idx_koff.push_back((uint32_t)t->idx_keys.size());
    t->idx_klen.push_back(c.klen);
    t->idx_boff.push_back(boff);
    t->idx_bsize.push_back(bsize);
    t->idx_keys.append((const char*)c.key, c.klen);
  }
  if (r < 0) fail();
}

// First decoded-index entry whose key >= target (internal-key order).
int64_t nindex_lower_bound(NTable* t, const uint8_t* target, int32_t tlen) {
  uint64_t tp = nuk_prefix(target, tlen - 8);
  const uint64_t* pre = t->idx_prefix.data();
  const uint8_t* keys = (const uint8_t*)t->idx_keys.data();
  int64_t lo = 0, hi = (int64_t)t->idx_prefix.size();
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    bool less;
    if (pre[mid] != tp)
      less = pre[mid] < tp;
    else
      less = ikey_compare(keys + t->idx_koff[mid],
                          (int32_t)t->idx_klen[mid], target, tlen) < 0;
    if (less)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Whole-key bloom probe: layout varint32 num_bits | 1B k | bits.
// kind 1 = blocked bloom (varint32 num_lines | 1B k | 64B lines): ONE
// cache line touched per probe (table/filter.py BlockedBloomFilterPolicy).
bool nfilter_may_match(const std::string& f, int32_t kind,
                       const uint8_t* key, int32_t klen) {
  if (f.empty()) return true;
  const uint8_t* p = (const uint8_t*)f.data();
  const uint8_t* end = p + f.size();
  uint32_t hdr;
  p = get_varint32(p, end, &hdr);
  if (!p || p >= end) return true;
  uint32_t k = *p++;
  const uint8_t* bits = p;
  uint64_t h = tpulsm_xxh64(key, (size_t)klen, 0xA0761D64);
  uint64_t h2 = ((h >> 33) | (h << 31)) | 1;
  if (kind == 1) {
    uint64_t num_lines = hdr;
    if (num_lines == 0 || (size_t)(end - bits) < (size_t)num_lines * 64)
      return true;
    const uint8_t* line = bits + (h % num_lines) * 64;
    uint64_t x = h;
    for (uint32_t i = 0; i < k; i++) {
      x += h2;
      uint64_t b = x & 511;
      if (!((line[b >> 3] >> (b & 7)) & 1)) return false;
    }
    return true;
  }
  uint32_t num_bits = hdr;
  if (num_bits == 0 || (size_t)(end - bits) * 8 < num_bits) return true;
  for (uint32_t i = 0; i < k; i++) {
    uint64_t b = (h + (uint64_t)i * h2) % num_bits;
    if (!((bits[b >> 3] >> (b & 7)) & 1)) return false;
  }
  return true;
}

// Per-call read counters surfaced to PerfContext/Statistics (indexes
// documented at tpulsm_db_get).
enum {
  NC_MEMS = 0,
  NC_BLOOM_MISS = 1,
  NC_BLOOM_HIT = 2,
  NC_CACHE_HIT = 3,
  NC_CACHE_MISS = 4,
  NC_READ_BYTES = 5,
  NC_COUNT = 6,
};

// Fetch + decompress one data block through the shared LRU.
// nullptr → error (unsupported codec / IO / corruption).
std::shared_ptr<std::string> nfetch_block(NTable* t, uint64_t off,
                                          uint64_t size, int64_t* ctr) {
  // A corrupt index entry must become a Python-path fallback (which
  // surfaces Corruption), not an OOM abort or a wrapped-arithmetic OOB
  // read — bound the handle against the file with non-wrapping checks.
  if (t->file_size <= 0) return nullptr;
  uint64_t fsz = (uint64_t)t->file_size;
  if (size > fsz || 5 > fsz - size || off > fsz - size - 5)
    return nullptr;
  NBlockCache& cache = nblock_cache();
  auto hit = cache.lookup(t->number, off);
  if (hit) {
    ctr[NC_CACHE_HIT]++;
    return hit;
  }
  ctr[NC_CACHE_MISS]++;
  ctr[NC_READ_BYTES] += (int64_t)size + 5;
  std::string raw;
  raw.resize(size + 5);  // payload + type byte + masked crc32c
  ssize_t got = ::pread(t->fd, &raw[0], size + 5, (off_t)off);
  if (got != (ssize_t)(size + 5)) return nullptr;
  uint8_t type = (uint8_t)raw[size];
  // Verify the masked trailer crc (table/format.py framing) — the Python
  // read path verifies by default, so the fast path must not be laxer.
  uint32_t stored;
  std::memcpy(&stored, raw.data() + size + 1, 4);
  uint32_t rot = stored - 0xA282EAD8u;
  uint32_t unmasked = (rot >> 17) | (rot << 15);
  uint32_t actual =
      tpulsm_crc32c_extend(0, (const uint8_t*)raw.data(), size + 1);
  if (unmasked != actual) return nullptr;
  raw.resize(size + 1);
  auto out = std::make_shared<std::string>();
  const Codecs& c = codecs();
  if (type == 0) {
    raw.resize(size);
    *out = std::move(raw);
  } else if (type == 1) {
    if (!c.snappy_len || !c.snappy_unc) return nullptr;
    size_t ulen = 0;
    if (c.snappy_len(raw.data(), size, &ulen) != 0) return nullptr;
    out->resize(ulen);
    if (c.snappy_unc(raw.data(), size, &(*out)[0], &ulen) != 0)
      return nullptr;
    out->resize(ulen);
  } else if (type == 7) {
    if (!c.zstd_size || !c.zstd_dec) return nullptr;
    unsigned long long ulen = c.zstd_size(raw.data(), size);
    if (ulen == 0ULL || ulen + 1 == 0ULL || ulen > (1ull << 31))
      return nullptr;
    out->resize((size_t)ulen);
    size_t r = c.zstd_dec(&(*out)[0], (size_t)ulen, raw.data(), size);
    if (c.zstd_err && c.zstd_err(r)) return nullptr;
    out->resize(r);
  } else {
    return nullptr;  // dict-compressed or unknown: python path
  }
  cache.insert(t->number, off, out);
  return out;
}

// rc codes for the probe chain.
enum { NGET_NOTFOUND = 0, NGET_FOUND = 1, NGET_FALLBACK = 2, NGET_ERR = -1 };

// Get threads are long-lived, so a thread_local DCtx amortizes context
// setup across probes; the wrapper frees it at thread exit.
struct ZDctx {
  void* ctx = nullptr;
  ~ZDctx() {
    if (ctx) {
      const Codecs& c = codecs();
      if (c.zstd_dctx_free) c.zstd_dctx_free(ctx);
    }
  }
};

// Value bytes of zip entry i. Raw groups are served zero-copy from the
// borrowed blob; compressed groups decode once into the shared LRU keyed
// by (table number, group payload offset). false → fall back to Python.
bool nzvalue(NTable* t, int64_t i, const uint8_t** base, uint64_t* len,
             std::shared_ptr<std::string>* keep, int64_t* ctr) {
  int64_t gi = i / t->zvg;
  uint64_t off = 0;
  for (int64_t j = gi * (int64_t)t->zvg; j < i; j++) off += zvlen_at(t, j);
  *len = zvlen_at(t, i);
  uint64_t p0 = zload_u32(t->zvgo + 4 * gi);
  uint64_t p1 = zload_u32(t->zvgo + 4 * (gi + 1));
  if (!((t->zvflags[gi >> 3] >> (gi & 7)) & 1)) {
    if (off + *len > p1 - p0) return false;
    *base = t->zvblob + p0 + off;
    return true;
  }
  NBlockCache& cache = nblock_cache();
  auto hit = cache.lookup(t->number, p0);
  if (hit) {
    ctr[NC_CACHE_HIT]++;
  } else {
    ctr[NC_CACHE_MISS]++;
    ctr[NC_READ_BYTES] += (int64_t)(p1 - p0);
    const Codecs& c = codecs();
    if (!c.zstd_dec_dict || !c.zstd_dctx_new) return false;
    static thread_local ZDctx d;
    if (!d.ctx) d.ctx = c.zstd_dctx_new();
    if (!d.ctx) return false;
    uint64_t raw = 0;
    int64_t gend = (gi + 1) * (int64_t)t->zvg;
    if (gend > t->zn) gend = t->zn;
    for (int64_t j = gi * (int64_t)t->zvg; j < gend; j++)
      raw += zvlen_at(t, j);
    auto out = std::make_shared<std::string>();
    out->resize(raw);
    size_t got = c.zstd_dec_dict(
        d.ctx, raw ? &(*out)[0] : nullptr, (size_t)raw, t->zvblob + p0,
        (size_t)(p1 - p0), t->zvdict_len ? t->zvdict : nullptr,
        (size_t)t->zvdict_len);
    if ((c.zstd_err && c.zstd_err(got)) || got != raw) return false;
    cache.insert(t->number, p0, out);
    hit = std::move(out);
  }
  if (off + *len > hit->size()) return false;
  *base = (const uint8_t*)hit->data() + off;
  *keep = std::move(hit);
  return true;
}

// Sequential cursor over the front-coded zip key stream. The suffix blob
// is contiguous across group boundaries, so one running offset suffices.
struct ZCur {
  NTable* t = nullptr;
  int64_t i = -1;   // current entry index
  uint64_t so = 0;  // suffix offset of the NEXT entry
  uint8_t key[4096 + 16];
  uint32_t klen = 0;

  // 1 = positioned at group g's head, 0 = empty, -1 = corrupt.
  int seek_group(int64_t g) {
    if (g < 0 || g >= t->zng) return -1;
    so = zload_u32(t->zkgso + 4 * g);
    i = g * (int64_t)t->zg - 1;
    klen = 0;
    return next();
  }

  // 1 = entry decoded, 0 = end of table, -1 = corrupt.
  int next() {
    if (i + 1 >= t->zn) return 0;
    i++;
    uint32_t pl, sl;
    zmeta_pair(t, i, &pl, &sl);
    if (pl > klen || (uint64_t)pl + sl > sizeof(key)) return -1;
    if (so + sl > (uint64_t)t->zksfx_len) return -1;
    std::memcpy(key + pl, t->zksfx + so, sl);
    so += sl;
    klen = pl + sl;
    return klen >= 8 ? 1 : -1;
  }
};

// Zip-table probe: bsearch group-head prefixes for the last head <=
// target, then walk the front-coded stream with the same user-key /
// seqno dispatch as the block path below.
int nztable_get(NTable* t, const uint8_t* ukey, int32_t klen,
                const uint8_t* target, int32_t tlen, uint64_t snap_seq,
                uint8_t* val_out, int32_t val_cap, int32_t* val_len,
                int* decided, int64_t* ctr) {
  if (t->zn <= 0 || t->zng <= 0) return NGET_FALLBACK;
  uint64_t tp = nuk_prefix(target, tlen - 8);
  int64_t lo = 0, hi = t->zng;  // first head > target
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    bool gt;
    if (t->zhead_pre[(size_t)mid] != tp) {
      gt = t->zhead_pre[(size_t)mid] > tp;
    } else {
      uint32_t pl, sl;
      zmeta_pair(t, mid * (int64_t)t->zg, &pl, &sl);
      uint64_t hso = zload_u32(t->zkgso + 4 * mid);
      gt = ikey_compare(t->zksfx + hso, (int32_t)sl, target, tlen) > 0;
    }
    if (gt)
      hi = mid;
    else
      lo = mid + 1;
  }
  int64_t g = lo > 0 ? lo - 1 : 0;  // target < first key: walk from start
  ZCur c;
  c.t = t;
  int nr = c.seek_group(g);
  while (nr == 1) {
    if (c.klen < 8) return NGET_FALLBACK;
    int32_t cu = (int32_t)c.klen - 8;
    int m = cu < klen ? cu : klen;
    int cmp = std::memcmp(c.key, ukey, (size_t)m);
    if (cmp == 0 && cu != klen) cmp = cu < klen ? -1 : 1;
    if (cmp > 0) return NGET_NOTFOUND;  // walked past ukey: absent here
    if (cmp == 0) {
      uint64_t p2 = 0;
      for (int b = 0; b < 8; b++)
        p2 |= (uint64_t)c.key[cu + b] << (8 * b);
      uint64_t seq = p2 >> 8;
      uint8_t vt = (uint8_t)(p2 & 0xFF);
      if (seq <= snap_seq) {
        if (vt == 0x1) {  // VALUE
          *decided = 1;
          const uint8_t* vb = nullptr;
          uint64_t vl = 0;
          std::shared_ptr<std::string> keep;
          if (!nzvalue(t, c.i, &vb, &vl, &keep, ctr) || vl > 0x7FFFFFFF)
            return NGET_FALLBACK;
          if ((int32_t)vl > val_cap) {
            *val_len = (int32_t)vl;
            return NGET_ERR;  // caller re-sizes and retries
          }
          std::memcpy(val_out, vb, vl);
          *val_len = (int32_t)vl;
          return NGET_FOUND;
        }
        if (vt == 0x0) {  // DELETION → definitive miss
          *decided = 1;
          return NGET_NOTFOUND;
        }
        return NGET_FALLBACK;  // MERGE / SINGLE_DELETE / BLOB_INDEX...
      }
    }
    nr = c.next();
  }
  return nr < 0 ? NGET_FALLBACK : NGET_NOTFOUND;
}

// Probe one table for ukey at snap_seq. Decisive answers only; anything
// needing the Python state machine returns NGET_FALLBACK. NGET_NOTFOUND
// here means "not in this table — continue the chain".
int ntable_get(NTable* t, const uint8_t* ukey, int32_t klen,
               uint64_t snap_seq, uint8_t* val_out, int32_t val_cap,
               int32_t* val_len, int* decided, int64_t* ctr) {
  *decided = 0;
  if (!t || !t->eligible) return NGET_FALLBACK;
  if (!t->filter.empty()) {
    if (!nfilter_may_match(t->filter, t->filter_kind, ukey, klen)) {
      ctr[NC_BLOOM_MISS]++;
      return NGET_NOTFOUND;
    }
    ctr[NC_BLOOM_HIT]++;
  }
  // Seek target: (ukey, snap_seq, type 0x7F) — highest type sorts first.
  uint8_t target[4096 + 8];
  if (klen > 4096) return NGET_FALLBACK;
  std::memcpy(target, ukey, klen);
  uint64_t packed = (snap_seq << 8) | 0x7F;
  for (int i = 0; i < 8; i++) target[klen + i] = (uint8_t)(packed >> (8 * i));
  int32_t tlen = klen + 8;

  if (t->kind == 1)
    return nztable_get(t, ukey, klen, target, tlen, snap_seq, val_out,
                       val_cap, val_len, decided, ctr);

  // Candidate block via the decoded flat index (one cache-friendly
  // binary search) when available; raw-block cursor otherwise.
  bool use_arr = !t->idx_prefix.empty();
  BCur idx;
  int64_t ipos = 0;
  int64_t icount = (int64_t)t->idx_prefix.size();
  if (use_arr) {
    ipos = nindex_lower_bound(t, target, tlen);
    if (ipos >= icount) return NGET_NOTFOUND;  // past the last block
  } else {
    int sr = bcur_seek(idx, (const uint8_t*)t->index.data(),
                       (int64_t)t->index.size(), target, tlen);
    if (sr < 0) return NGET_FALLBACK;
    if (sr == 0) return NGET_NOTFOUND;  // past the last block
  }

  bool first_block = true;
  while (true) {
    uint64_t boff, bsize;
    if (use_arr) {
      boff = t->idx_boff[ipos];
      bsize = t->idx_bsize[ipos];
    } else {
      // idx cursor sits at the candidate block's index entry; its value
      // is the BlockHandle (varint64 offset, varint64 size).
      const uint8_t* vp = idx.val;
      const uint8_t* vend = idx.val + idx.vlen;
      vp = get_varint64(vp, vend, &boff);
      if (!vp) return NGET_FALLBACK;
      vp = get_varint64(vp, vend, &bsize);
      if (!vp) return NGET_FALLBACK;
    }
    auto block = nfetch_block(t, boff, bsize, ctr);
    if (!block) return NGET_FALLBACK;
    BCur c;
    const uint8_t* bd = (const uint8_t*)block->data();
    bool have = false;
    if (first_block) {
      int br = bcur_seek(c, bd, (int64_t)block->size(), target, tlen);
      if (br < 0) return NGET_FALLBACK;
      have = br == 1;  // br == 0: target past this block's keys — the run
      first_block = false;  // may continue in the next block
    } else {
      if (!c.init(bd, (int64_t)block->size())) return NGET_FALLBACK;
      int nr = c.next();  // scan continues from the block's first entry
      if (nr < 0) return NGET_FALLBACK;
      have = nr == 1;
    }
    while (have) {
      if (c.klen < 8) return NGET_FALLBACK;
      int32_t cu = (int32_t)c.klen - 8;
      int m = cu < klen ? cu : klen;
      int cmp = std::memcmp(c.key, ukey, (size_t)m);
      if (cmp == 0 && cu != klen) cmp = cu < klen ? -1 : 1;
      if (cmp > 0) return NGET_NOTFOUND;  // walked past ukey: absent here
      if (cmp == 0) {
        uint64_t p2 = 0;
        for (int i = 0; i < 8; i++)
          p2 |= (uint64_t)c.key[cu + i] << (8 * i);
        uint64_t seq = p2 >> 8;
        uint8_t vt = (uint8_t)(p2 & 0xFF);
        if (seq <= snap_seq) {
          if (vt == 0x1) {  // VALUE
            *decided = 1;
            if ((int32_t)c.vlen > val_cap) {
              *val_len = (int32_t)c.vlen;
              return NGET_ERR;  // caller re-sizes and retries
            }
            std::memcpy(val_out, c.val, c.vlen);
            *val_len = (int32_t)c.vlen;
            return NGET_FOUND;
          }
          if (vt == 0x0) {  // DELETION → definitive miss
            *decided = 1;
            return NGET_NOTFOUND;
          }
          return NGET_FALLBACK;  // MERGE / SINGLE_DELETE / BLOB_INDEX...
        }
      }
      {
        int nr = c.next();
        if (nr < 0) return NGET_FALLBACK;
        have = nr == 1;
      }
    }
    // Block exhausted without passing ukey: the version run may continue
    // in the next data block.
    if (use_arr) {
      if (++ipos >= icount) return NGET_NOTFOUND;  // no further blocks
    } else {
      int nr = idx.next();
      if (nr < 0) return NGET_FALLBACK;
      if (nr == 0) return NGET_NOTFOUND;  // no further blocks
    }
  }
}

int nversion_get(NVersion* v, const uint8_t* ukey, int32_t klen,
                 uint64_t snap_seq, uint8_t* val_out, int32_t val_cap,
                 int32_t* val_len, int32_t* src_out, int64_t* ctr) {
  int decided = 0;
  for (NTable* t : v->l0) {
    if (!t) return NGET_FALLBACK;
    if (!t->smallest_uk.empty() || !t->largest_uk.empty()) {
      if (std::string_view((const char*)ukey, (size_t)klen)
              < std::string_view(t->smallest_uk) ||
          std::string_view(t->largest_uk)
              < std::string_view((const char*)ukey, (size_t)klen))
        continue;
    }
    int rc = ntable_get(t, ukey, klen, snap_seq, val_out, val_cap, val_len,
                        &decided, ctr);
    if (rc == NGET_FOUND || rc == NGET_FALLBACK || rc == NGET_ERR ||
        (rc == NGET_NOTFOUND && decided)) {
      *src_out = 1;  // level 0 + 1
      return rc;
    }
  }
  for (size_t li = 0; li < v->levels.size(); li++) {
    auto& fl = v->levels[li];
    if (fl.empty()) continue;
    std::string_view uk((const char*)ukey, (size_t)klen);
    // Binary search: first file whose largest >= ukey.
    size_t lo = 0, hi = fl.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (!fl[mid]) return NGET_FALLBACK;  // conservatively bail
      if (std::string_view(fl[mid]->largest_uk) < uk)
        lo = mid + 1;
      else
        hi = mid;
    }
    // Mirror files_for_get: subsequent files whose smallest <= ukey are
    // also candidates (tombstone-widened bounds).
    for (size_t pick = lo; pick < fl.size(); pick++) {
      NTable* t = fl[pick];
      if (!t) return NGET_FALLBACK;
      if (uk < std::string_view(t->smallest_uk)) break;
      int rc = ntable_get(t, ukey, klen, snap_seq, val_out, val_cap,
                          val_len, &decided, ctr);
      if (rc == NGET_FOUND || rc == NGET_FALLBACK || rc == NGET_ERR ||
          (rc == NGET_NOTFOUND && decided)) {
        *src_out = (int32_t)li + 2;
        return rc;
      }
    }
  }
  *src_out = -1;
  return NGET_NOTFOUND;
}

}  // namespace

void* tpulsm_table_handle_new(int32_t fd, uint64_t number, int32_t eligible,
                              const uint8_t* index, int64_t index_len,
                              const uint8_t* filter, int64_t filter_len,
                              const uint8_t* smallest_uk, int32_t sl,
                              const uint8_t* largest_uk, int32_t ll) {
  NTable* t = new (std::nothrow) NTable();
  if (!t) return nullptr;
  // eligible is a FLAG WORD: bit0 = eligible, bit1 = blocked-bloom filter
  // layout (old callers pass 0/1, which decodes identically).
  t->filter_kind = (eligible >> 1) & 1;
  eligible = eligible & 1;
  if (eligible && fd >= 0) {
    t->fd = ::dup(fd);
    if (t->fd < 0) {
      delete t;
      return nullptr;
    }
    off_t end = ::lseek(t->fd, 0, SEEK_END);
    t->file_size = end > 0 ? (int64_t)end : 0;
  }
  t->number = number;
  t->eligible = eligible && t->fd >= 0;
  if (index_len > 0) t->index.assign((const char*)index, (size_t)index_len);
  if (t->eligible) {
    ntable_decode_index(t);
    if (!t->idx_prefix.empty())
      std::string().swap(t->index);  // decoded copy supersedes the raw block
  }
  if (filter_len > 0)
    t->filter.assign((const char*)filter, (size_t)filter_len);
  if (sl > 0) t->smallest_uk.assign((const char*)smallest_uk, (size_t)sl);
  if (ll > 0) t->largest_uk.assign((const char*)largest_uk, (size_t)ll);
  return t;
}

void tpulsm_table_handle_free(void* t) { delete static_cast<NTable*>(t); }

// Zip-table Get handle. Section buffers are BORROWED — the Python reader
// keeps them alive until tpulsm_table_handle_free. flags: bit0 eligible,
// bit1 blocked-bloom filter layout. Every section is validated ONCE here
// (one O(n) pass) so the per-Get walk can trust offsets; any violation
// demotes the handle to eligible=0 (Python fallback) instead of failing,
// keeping the version chain intact.
void* tpulsm_zip_table_handle_new(
    uint64_t number, int32_t flags, int32_t group, int32_t vgroup,
    int64_t n, int32_t meta16, int32_t lens32, const uint8_t* kmeta,
    int64_t kmeta_len, const uint8_t* ksfx, int64_t ksfx_len,
    const uint8_t* kgso, int64_t kgso_len, const uint8_t* vlens,
    int64_t vlens_len, const uint8_t* vgo, int64_t vgo_len,
    const uint8_t* vflags, int64_t vflags_len, const uint8_t* vdict,
    int64_t vdict_len, const uint8_t* vblob, int64_t vblob_len,
    const uint8_t* filter, int64_t filter_len, const uint8_t* smallest_uk,
    int32_t sl, const uint8_t* largest_uk, int32_t ll) {
  NTable* t = new (std::nothrow) NTable();
  if (!t) return nullptr;
  t->kind = 1;
  t->number = number;
  t->filter_kind = (flags >> 1) & 1;
  if (filter_len > 0)
    t->filter.assign((const char*)filter, (size_t)filter_len);
  if (sl > 0) t->smallest_uk.assign((const char*)smallest_uk, (size_t)sl);
  if (ll > 0) t->largest_uk.assign((const char*)largest_uk, (size_t)ll);
  t->eligible = 0;
  if (!(flags & 1) || group <= 0 || vgroup <= 0 || n <= 0 || !kmeta ||
      !ksfx || !kgso || !vlens || !vgo || !vflags || !vblob)
    return t;
  int64_t ng = (n + group - 1) / group;
  int64_t ngv = (n + vgroup - 1) / vgroup;
  int64_t msz = meta16 ? 4 : 2, lsz = lens32 ? 4 : 2;
  if (kmeta_len < n * msz || kgso_len < 4 * ng || vlens_len < n * lsz ||
      vgo_len < 4 * (ngv + 1) || vflags_len < (ngv + 7) / 8)
    return t;
  t->zg = group;
  t->zvg = vgroup;
  t->zn = n;
  t->zmeta16 = meta16;
  t->zlens32 = lens32;
  t->zkmeta = kmeta;
  t->zksfx = ksfx;
  t->zksfx_len = ksfx_len;
  t->zkgso = kgso;
  t->zng = ng;
  t->zvlens = vlens;
  t->zvgo = vgo;
  t->zvflags = vflags;
  t->zvflags_len = vflags_len;
  t->zvdict = vdict;
  t->zvdict_len = vdict_len;
  t->zvblob = vblob;
  t->zvblob_len = vblob_len;
  t->znvg = ngv;
  // Key-section walk: meta pairs must reconstruct, suffix offsets must
  // agree with the per-group directory and consume the blob exactly.
  t->zhead_pre.reserve((size_t)ng);
  uint64_t so = 0;
  uint32_t prev_klen = 0;
  for (int64_t i = 0; i < n; i++) {
    uint32_t pl, sl2;
    zmeta_pair(t, i, &pl, &sl2);
    uint64_t klen = (uint64_t)pl + sl2;
    if (i % group == 0) {
      if (pl != 0 || so != zload_u32(kgso + 4 * (i / group))) return t;
      if (klen < 8) return t;
      t->zhead_pre.push_back(nuk_prefix(ksfx + so, (int32_t)klen - 8));
    }
    if (pl > prev_klen || klen < 8 || klen > 4096 + 8) return t;
    if (so + sl2 > (uint64_t)ksfx_len) return t;
    so += sl2;
    prev_klen = (uint32_t)klen;
  }
  if (so != (uint64_t)ksfx_len) return t;
  // Value directory: monotone payload offsets covering the blob; raw
  // groups' payloads must equal the sum of their entry lengths.
  uint64_t prev_off = zload_u32(vgo);
  if (prev_off != 0) return t;
  for (int64_t gi = 0; gi < ngv; gi++) {
    uint64_t p0 = zload_u32(vgo + 4 * gi);
    uint64_t p1 = zload_u32(vgo + 4 * (gi + 1));
    if (p1 < p0 || p1 > (uint64_t)vblob_len) return t;
    int64_t e1 = (gi + 1) * (int64_t)vgroup;
    if (e1 > n) e1 = n;
    uint64_t raw = 0;
    for (int64_t j = gi * (int64_t)vgroup; j < e1; j++)
      raw += zvlen_at(t, j);
    bool flagged = (vflags[gi >> 3] >> (gi & 7)) & 1;
    if (!flagged && p1 - p0 != raw) return t;
    if (flagged && (p1 == p0 || (vdict_len > 0 && !vdict))) return t;
  }
  t->eligible = 1;
  return t;
}

// tables: L0 handles (newest first) then levels 1.. concatenated;
// level_offs[i]..level_offs[i+1] indexes level i+1's slice, with
// level_offs[0] == n_l0. A null handle marks a python-only table (chain
// walk returns FALLBACK on contact).
void* tpulsm_version_handle_new(void** tables, int32_t n_l0,
                                const int32_t* level_offs,
                                int32_t n_deeper_levels) {
  NVersion* v = new (std::nothrow) NVersion();
  if (!v) return nullptr;
  for (int32_t i = 0; i < n_l0; i++)
    v->l0.push_back(static_cast<NTable*>(tables[i]));
  for (int32_t li = 0; li < n_deeper_levels; li++) {
    v->levels.emplace_back();
    for (int32_t i = level_offs[li]; i < level_offs[li + 1]; i++)
      v->levels.back().push_back(static_cast<NTable*>(tables[i]));
  }
  return v;
}

void tpulsm_version_handle_free(void* v) { delete static_cast<NVersion*>(v); }

void tpulsm_block_cache_config(int64_t bytes, int64_t* out_stats) {
  NBlockCache& c = nblock_cache();
  if (bytes > 0) c.budget.store((size_t)bytes, std::memory_order_relaxed);
  if (out_stats) {
    out_stats[0] = (int64_t)c.hits.load(std::memory_order_relaxed);
    out_stats[1] = (int64_t)c.misses.load(std::memory_order_relaxed);
  }
}

// Persistent get context: binds (memtables, version, out buffers) once so
// the per-call ctypes surface shrinks to (ctx, key, klen, seq) — arg
// marshaling was ~40% of the measured per-get cost. Results land in
// ctx-owned memory the caller maps once: out[0]=val_len, out[1]=src,
// out[2..7]=counters (NC_* order).
struct NGetCtx {
  std::vector<void*> mems;
  std::vector<int32_t> kinds;  // 0 = skiplist, 1 = trie
  void* version = nullptr;
  int64_t out[8];
  std::vector<uint8_t> val;
};

void* tpulsm_getctx_new(void** mem_handles, int32_t n_mems, void* version,
                        int64_t val_cap) {
  NGetCtx* c = new (std::nothrow) NGetCtx();
  if (!c) return nullptr;
  for (int32_t i = 0; i < n_mems; i++) c->mems.push_back(mem_handles[i]);
  c->kinds.assign((size_t)n_mems, 0);
  c->version = version;
  c->val.resize((size_t)(val_cap > 0 ? val_cap : 4096));
  std::memset(c->out, 0, sizeof(c->out));
  return c;
}

// Mark memtable i as a trie-rep handle (layout differs from the skiplist).
void tpulsm_getctx_set_mem_kind(void* ctx, int32_t i, int32_t kind) {
  NGetCtx* c = static_cast<NGetCtx*>(ctx);
  if (i >= 0 && (size_t)i < c->kinds.size()) c->kinds[i] = kind;
}

void tpulsm_getctx_free(void* ctx) { delete static_cast<NGetCtx*>(ctx); }

int64_t* tpulsm_getctx_out(void* ctx) {
  return static_cast<NGetCtx*>(ctx)->out;
}

uint8_t* tpulsm_getctx_val(void* ctx) {
  return static_cast<NGetCtx*>(ctx)->val.data();
}

// Forward decls (definitions below keep the original entry points).
int32_t tpulsm_db_get(void** mem_handles, int32_t n_mems, void* version,
                      const uint8_t* ukey, int32_t klen, uint64_t snap_seq,
                      uint8_t* val_out, int32_t val_cap, int32_t* val_len,
                      int32_t* src_out, int64_t* counters);
int32_t tpulsm_db_get_kinds(void** mem_handles, const int32_t* mem_kinds,
                            int32_t n_mems, void* version,
                            const uint8_t* ukey, int32_t klen,
                            uint64_t snap_seq, uint8_t* val_out,
                            int32_t val_cap, int32_t* val_len,
                            int32_t* src_out, int64_t* counters);

int32_t tpulsm_getctx_get(void* ctx, const uint8_t* ukey, int32_t klen,
                          uint64_t snap_seq) {
  NGetCtx* c = static_cast<NGetCtx*>(ctx);
  int32_t vlen = 0, src = -1;
  int32_t rc = tpulsm_db_get_kinds(
      c->mems.data(), c->kinds.data(), (int32_t)c->mems.size(), c->version,
      ukey, klen, snap_seq, c->val.data(), (int32_t)c->val.size(), &vlen,
      &src, c->out + 2);
  if (rc == -1 && vlen > (int32_t)c->val.size()) {
    // Value outgrew the buffer: grow and retry — the caller detects
    // out[0] > its mapped capacity and re-maps tpulsm_getctx_val().
    c->val.resize((size_t)vlen + 1024);
    rc = tpulsm_db_get_kinds(
        c->mems.data(), c->kinds.data(), (int32_t)c->mems.size(), c->version,
        ukey, klen, snap_seq, c->val.data(), (int32_t)c->val.size(), &vlen,
        &src, c->out + 2);
  }
  c->out[0] = vlen;
  c->out[1] = src;
  return rc;
}

// Batched lookups against a get context — the reference's MultiGet role
// (db_impl.cc:3026-3227): one GIL-released call for the whole batch, each
// key running the full chain. status_out[i]: 1 found, 0 not found,
// 2 fallback-to-python (resolve that key on the Python path). Values pack
// into val_arena at val_offs_out/val_lens_out. Returns 0 ok, -2 arena too
// small (caller grows + retries). Counters accumulate across keys.
int32_t tpulsm_getctx_multiget(void* ctx, const uint8_t* keybuf,
                               const int64_t* key_offs,
                               const int32_t* key_lens, int64_t n,
                               uint64_t snap_seq, int8_t* status_out,
                               int64_t* val_offs_out, int64_t* val_lens_out,
                               uint8_t* val_arena, int64_t arena_cap,
                               int64_t* arena_used, int64_t* counters) {
  NGetCtx* c = static_cast<NGetCtx*>(ctx);
  for (int i = 0; i < NC_COUNT; i++) counters[i] = 0;

  // One key's chain walk (writing into [lo, hi) of the arena). Returns
  // bytes consumed, or -1 on arena-slice overflow.
  auto walk = [&](int64_t i, int64_t lo, int64_t hi,
                  int64_t* ctr) -> int64_t {
    const uint8_t* k = keybuf + key_offs[i];
    int32_t kl = key_lens[i];
    int32_t vlen = 0, src = -1;
    int64_t tmp_ctr[NC_COUNT];
    int32_t rc = tpulsm_db_get_kinds(
        c->mems.data(), c->kinds.data(), (int32_t)c->mems.size(), c->version,
        k, kl, snap_seq, val_arena + lo,
        (int32_t)std::min<int64_t>(hi - lo, (1u << 31) - 1),
        &vlen, &src, tmp_ctr);
    for (int t = 0; t < NC_COUNT; t++) ctr[t] += tmp_ctr[t];
    if (rc == -1) return -1;
    if (rc == 1) {
      status_out[i] = 1;
      val_offs_out[i] = lo;
      val_lens_out[i] = vlen;
      return vlen;
    }
    status_out[i] = rc == 0 ? 0 : 2;
    val_offs_out[i] = 0;
    val_lens_out[i] = 0;
    return 0;
  };

  // Parallel chain walks for big batches — the fiber/io_uring MultiGet
  // role (reference db_impl.cc:3026-3227): every structure on the path
  // is read-safe (mutex-sharded block cache, atomic skiplist/trie links,
  // pread), so keys fan out across threads, each with its own contiguous
  // arena slice (value offsets stay global; no post-join copying).
  size_t want = effective_cpus();
  size_t nthreads = std::min<size_t>(std::min<size_t>(want, 8),
                                     (size_t)(n / 64));
  if (nthreads >= 2) {
    std::vector<std::thread> pool;
    std::vector<int64_t> used_per(nthreads, 0);
    std::vector<std::array<int64_t, NC_COUNT>> ctrs(nthreads);
    std::atomic<int> overflow{0};
    bool spawn_fail = false;
    int64_t slice = arena_cap / (int64_t)nthreads;
    auto work = [&](size_t t) {
      int64_t lo = slice * (int64_t)t;
      int64_t hi = t + 1 == nthreads ? arena_cap : lo + slice;
      int64_t pos = lo;
      ctrs[t].fill(0);
      int64_t i0 = n * (int64_t)t / (int64_t)nthreads;
      int64_t i1 = n * (int64_t)(t + 1) / (int64_t)nthreads;
      for (int64_t i = i0; i < i1; i++) {
        int64_t got = walk(i, pos, hi, ctrs[t].data());
        if (got < 0) {
          overflow.store(1, std::memory_order_relaxed);
          return;
        }
        pos += got;
      }
      used_per[t] = pos - lo;
    };
    for (size_t t = 1; t < nthreads; t++) {
      try {
        pool.emplace_back(work, t);
      } catch (...) {
        spawn_fail = true;  // resource exhaustion: sequential fallback
        break;
      }
    }
    if (!spawn_fail) {
      work(0);
      for (auto& th : pool) th.join();
      for (size_t t = 0; t < nthreads; t++)
        for (int x = 0; x < NC_COUNT; x++) counters[x] += ctrs[t][x];
      if (overflow.load()) return -2;  // caller grows + retries
      *arena_used =
          slice * (int64_t)(nthreads - 1) + used_per[nthreads - 1];
      return 0;
    }
    // Thread spawn failed: join what started, then run everything
    // sequentially below (statuses/offsets are simply overwritten);
    // returning -2 here would make the caller grow the arena forever.
    for (auto& th : pool) th.join();
    for (int x = 0; x < NC_COUNT; x++) counters[x] = 0;
  }

  int64_t used = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t got = walk(i, used, arena_cap, counters);
    if (got < 0) return -2;  // arena exhausted: grow + retry whole batch
    used += got;
  }
  *arena_used = used;
  return 0;
}

// The full read chain: memtable skiplists (newest first), then the SST
// version. Returns 1 found (value in val_out, *val_len set), 0 not found,
// 2 fallback-to-python, -1 val_cap too small (*val_len = needed size).
// src_out: 0 = memtable, 1 = L0, n>=2 = level n-1, -1 = nothing.
// counters: int64[6] = {memtables probed, bloom useful (filtered out),
// bloom consulted-and-passed, block-cache hits, block-cache misses (device
// preads), bytes read from disk}. Always written.
int32_t tpulsm_db_get(void** mem_handles, int32_t n_mems, void* version,
                      const uint8_t* ukey, int32_t klen, uint64_t snap_seq,
                      uint8_t* val_out, int32_t val_cap, int32_t* val_len,
                      int32_t* src_out, int64_t* counters) {
  return tpulsm_db_get_kinds(mem_handles, nullptr, n_mems, version, ukey,
                             klen, snap_seq, val_out, val_cap, val_len,
                             src_out, counters);
}

int32_t tpulsm_db_get_kinds(void** mem_handles, const int32_t* mem_kinds,
                            int32_t n_mems, void* version,
                            const uint8_t* ukey, int32_t klen,
                            uint64_t snap_seq, uint8_t* val_out,
                            int32_t val_cap, int32_t* val_len,
                            int32_t* src_out, int64_t* counters) {
  *src_out = -1;
  for (int i = 0; i < NC_COUNT; i++) counters[i] = 0;
  if (klen > 4096) return NGET_FALLBACK;
  uint64_t packed = (snap_seq << 8) | 0x7F;
  uint64_t inv = ~packed;
  for (int32_t m = 0; m < n_mems; m++) {
    counters[NC_MEMS]++;
    uint64_t p2;
    const uint8_t* rec;
    if (mem_kinds && mem_kinds[m] == 1) {
      // Trie rep: newest visible version of exactly this key.
      TVer* v = static_cast<TVer*>(
          tpulsm_trie_seek_ge(mem_handles[m], ukey, (uint32_t)klen, inv));
      if (!v || v->leaf->key_len != (uint32_t)klen ||
          (klen && std::memcmp(v->leaf->key, ukey, (size_t)klen) != 0))
        continue;
      p2 = ~v->inv;
      rec = v->val.load(std::memory_order_acquire);
    } else {
      SkipList* sl = static_cast<SkipList*>(mem_handles[m]);
      SLNode* n = sl->seek_ge(ukey, (uint32_t)klen, inv, nullptr);
      if (!n || n->key_len != (uint32_t)klen ||
          std::memcmp(n->key, ukey, (size_t)klen) != 0)
        continue;
      p2 = ~n->inv_packed;
      rec = n->val.load(std::memory_order_acquire);
    }
    uint8_t vt = (uint8_t)(p2 & 0xFF);
    *src_out = 0;
    if (vt == 0x1) {
      uint32_t vl;
      std::memcpy(&vl, rec, 4);
      if ((int32_t)vl > val_cap) {
        *val_len = (int32_t)vl;
        return -1;
      }
      std::memcpy(val_out, rec + 4, vl);
      *val_len = (int32_t)vl;
      return NGET_FOUND;
    }
    if (vt == 0x0 || vt == 0x7) return NGET_NOTFOUND;  // (single-)delete
    return NGET_FALLBACK;  // merge / blob / anything else
  }
  if (!version) return NGET_NOTFOUND;
  return nversion_get(static_cast<NVersion*>(version), ukey, klen, snap_seq,
                      val_out, val_cap, val_len, src_out, counters);
}


// ---------------------------------------------------------------------------
// Fused group-commit write plane (db/db.py write path). ONE call per write
// group: pass 0 validates every member batch's wire image (supported record
// types, per-batch header counts, optional protection re-hash against the
// carried vectors); then mode bit 0 frames the MERGED WAL record
// gather-style — the 12-byte re-sequenced header plus each member's body
// stream straight into log-format fragments, byte-identical to db/log.py
// LogWriter.add_record, with no merged-batch copy on the Python side — and
// mode bit 1 applies every counted record to the target memtable rep with
// consecutive seqnos. A batch this parser cannot take (CF-prefixed records,
// range deletes, corruption) rejects the WHOLE group with NOTHING framed or
// inserted, and the caller falls back to the Python interiors.
// ---------------------------------------------------------------------------

extern "C++" {
namespace {

// Persistent worker pool for the group-apply phase: per-group
// std::thread spawns cost ~30-50us — more than the insert work of a
// typical group — so the write plane keeps a small lazily-grown pool
// alive for the process. One job runs at a time (run_mu): the caller
// publishes a shared closure, k workers plus the caller execute it, the
// caller waits for all k. Workers idle on a condvar between groups.
struct ApplyPool {
  std::mutex run_mu;  // serializes whole jobs
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  const std::function<void()>* fn = nullptr;
  uint64_t gen = 0;
  int want = 0, started = 0, done_count = 0;
  bool shutdown = false;
  std::vector<std::thread> ths;

  ~ApplyPool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
    }
    cv_work.notify_all();
    for (auto& t : ths) t.join();
  }

  void worker() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv_work.wait(lk, [&] {
        return shutdown || (gen != seen && started < want);
      });
      if (shutdown) return;
      seen = gen;
      if (started >= want) continue;
      started++;
      const std::function<void()>* f = fn;
      lk.unlock();
      (*f)();
      lk.lock();
      if (++done_count == want) cv_done.notify_all();
    }
  }

  // Runs f on min(k, pool) workers concurrently with the caller.
  void run(const std::function<void()>& f, int k) {
    std::lock_guard<std::mutex> job(run_mu);
    std::unique_lock<std::mutex> lk(mu);
    while ((int)ths.size() < k) {
      try {
        ths.emplace_back([this] { worker(); });
      } catch (...) {
        break;  // pid limits: run with what we have
      }
    }
    if ((int)ths.size() < k) k = (int)ths.size();
    if (k <= 0) {
      lk.unlock();
      f();
      return;
    }
    fn = &f;
    want = k;
    started = 0;
    done_count = 0;
    gen++;
    cv_work.notify_all();
    lk.unlock();
    f();  // caller participates
    lk.lock();
    cv_done.wait(lk, [&] { return done_count == want; });
  }
};

static ApplyPool& apply_pool() {
  static ApplyPool p;
  return p;
}

struct GcPiece {
  const uint8_t* p;
  int64_t n;
};

// Gather cursor over the virtual concatenation [header | body0 | body1 ...]:
// copies fragment bytes into the framed output while extending the record
// CRC, so the merged WAL image is never materialized contiguously.
struct GcCursor {
  const GcPiece* pieces;
  int64_t n;
  int64_t pi = 0;
  int64_t off = 0;
  void copy(uint8_t* dst, int64_t m, uint32_t* crc) {
    while (m > 0) {
      int64_t avail = pieces[pi].n - off;
      if (avail <= 0) {
        pi++;
        off = 0;
        continue;
      }
      int64_t take = avail < m ? avail : m;
      std::memcpy(dst, pieces[pi].p + off, (size_t)take);
      *crc = tpulsm_crc32c_extend(*crc, dst, (size_t)take);
      dst += take;
      off += take;
      m -= take;
    }
  }
};

// Frame one logical record of total_len bytes (read through cur) into the
// 32KiB-block log format, starting at block_offset. log_number >= 0 selects
// the recyclable record types stamped with that number. Byte-identical to
// LogWriter.add_record / _emit (db/log.py). Returns framed bytes written,
// or -3 when out_cap is too small.
static int64_t gc_frame_merged(GcCursor& cur, int64_t total_len,
                               int64_t block_offset, int64_t log_number,
                               uint8_t* out, int64_t cap,
                               int64_t* new_block_offset) {
  const int64_t kBlock = 32768;
  const bool recycled = log_number >= 0;
  const int64_t hdr = recycled ? 11 : 7;
  int64_t used = 0, left = total_len;
  bool begin = true;
  while (true) {
    int64_t leftover = kBlock - block_offset;
    if (leftover < hdr) {
      if (leftover > 0) {
        if (used + leftover > cap) return -3;
        std::memset(out + used, 0, (size_t)leftover);
        used += leftover;
      }
      block_offset = 0;
      leftover = kBlock;
    }
    int64_t avail = leftover - hdr;
    int64_t frag = left < avail ? left : avail;
    bool end = (left == frag);
    uint8_t t = begin && end ? 1 : (begin ? 2 : (end ? 4 : 3));
    if (recycled) t = (uint8_t)(t + 4);
    if (used + hdr + frag > cap) return -3;
    uint8_t* h = out + used;
    uint32_t crc = tpulsm_crc32c_extend(0, &t, 1);
    if (recycled) {
      uint32_t ln = (uint32_t)log_number;
      std::memcpy(h + 7, &ln, 4);
      crc = tpulsm_crc32c_extend(crc, h + 7, 4);
    }
    cur.copy(h + hdr, frag, &crc);
    uint32_t masked = ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
    std::memcpy(h, &masked, 4);
    h[4] = (uint8_t)(frag & 0xFF);
    h[5] = (uint8_t)((frag >> 8) & 0xFF);
    h[6] = t;
    used += hdr + frag;
    block_offset += hdr + frag;
    left -= frag;
    begin = false;
    if (left == 0) break;
  }
  *new_block_offset = block_offset;
  return used;
}

}  // namespace
}  // extern "C++"

// mem/mem_kind: target rep (0 = SkipList*, 1 = TrieRep*); may be null when
//   mode bit 1 is clear.
// reps/lens/n_batches: member batch wire images, group order.
// prots/n_prots/pb: concatenated per-record protection vectors in group
//   order, or null (unprotected).
// mode: bit 0 (1) = frame WAL, bit 1 (2) = insert into the memtable,
//   bit 2 (4) = skip the validation pass — ONLY legal when a prior call on
//   the SAME buffers (the leader's frame call, microseconds earlier under
//   the commit mutex) already validated them; protection was checked there.
//   bit 3 (8) = protection FILL: prots is an OUT buffer of capacity
//   n_prots — the validation pass writes each counted record's truncated
//   checksum instead of comparing (fusing tpulsm_wb_protect into the WAL
//   frame walk: the protected write path hashes each record ONCE).
// block_offset/log_number: the LogWriter's framing state (log_number >= 0
//   selects the recyclable format stamped with that number; -1 = classic).
// out[0]=framed bytes, out[1]=new block offset, out[2]=memtable byte delta,
// out[3]=point-delete count, out[4]=merged (unframed) record length,
// out[5..7]=interior phase timings in ns (validate / WAL frame / memtable
// insert) for the telemetry plane — the caller must size out >= 8.
// Returns total counted records, or -2 (unsupported record: Python path),
// -3 (wal_cap too small), -4 (corrupt image), -5 - i (protection mismatch
// at group record index i).
int64_t tpulsm_wb_group_commit(void* mem, int32_t mem_kind,
                               const uint8_t* const* reps,
                               const int64_t* lens,
                               int64_t n_batches, uint64_t first_seq,
                               uint64_t* prots, int64_t n_prots,
                               int32_t pb, int32_t mode, int64_t block_offset,
                               int64_t log_number, uint8_t* wal_out,
                               int64_t wal_cap, int64_t* out) {
  const uint64_t kKey = 0x9E3779B97F4A7C15ull, kVal = 0xC2B2AE3D27D4EB4Full,
                 kType = 0x165667B19E3779F9ull, kCf = 0x27D4EB2F165667C5ull;
  const uint64_t mask = prot_trunc_mask(pb);
  auto gc_now_ns = []() -> int64_t {
    return (int64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  const int64_t t_entry_ns = gc_now_ns();
  int64_t total = 0;
  if (mode & 4) {
    // Caller vouches (see above): counts come from the batch headers.
    for (int64_t b = 0; b < n_batches; b++) {
      const uint8_t* rep = (const uint8_t*)reps[b];
      total += (uint32_t)rep[8] | ((uint32_t)rep[9] << 8) |
               ((uint32_t)rep[10] << 16) | ((uint32_t)rep[11] << 24);
    }
  }
  // Pass 0: validate every batch — nothing is framed or inserted unless the
  // WHOLE group parses and (when protected) every record re-hashes clean.
  for (int64_t b = 0; (mode & 4) == 0 && b < n_batches; b++) {
    const uint8_t* rep = (const uint8_t*)reps[b];
    int64_t len = lens[b];
    if (len < 12) return -4;
    const uint8_t* end = rep + len;
    const uint8_t* p = rep + 12;
    uint32_t hdr_count = (uint32_t)rep[8] | ((uint32_t)rep[9] << 8) |
                         ((uint32_t)rep[10] << 16) | ((uint32_t)rep[11] << 24);
    int64_t count = 0;
    while (p < end) {
      uint8_t t = *p++;
      if (t & 0x80) return -2;  // CF-prefixed record: Python path
      uint32_t klen, vlen = 0;
      p = get_varint32(p, end, &klen);
      if (!p || p + klen > end) return -4;
      const uint8_t* k = p;
      p += klen;
      const uint8_t* v = p;
      if (t == 0x1 || t == 0x2 || t == 0x16) {  // VALUE / MERGE / WIDE
        p = get_varint32(p, end, &vlen);
        if (!p || p + vlen > end) return -4;
        v = p;
        p += vlen;
      } else if (t == 0x0 || t == 0x7) {  // (SINGLE_)DELETION: key only
      } else if (t == 0x3) {              // LOG_DATA: klen was the blob
        continue;
      } else {
        return -2;  // RANGE_DELETION etc.: Python path
      }
      if (prots) {
        int64_t gi = total + count;
        if (gi >= n_prots) return (mode & 8) ? -3 : -5 - gi;
        uint64_t cs = prot_mix(kKey ^ (uint64_t)zcrc32(k, klen) ^
                               ((uint64_t)klen << 32)) ^
                      prot_mix(kVal ^ (uint64_t)zcrc32(v, vlen) ^
                               ((uint64_t)vlen << 32)) ^
                      prot_mix(kType ^ (uint64_t)t) ^ prot_mix(kCf ^ 1ull);
        if (mode & 8)
          prots[gi] = cs & mask;
        else if ((cs & mask) != prots[gi])
          return -5 - gi;
      }
      count++;
    }
    if ((uint32_t)count != hdr_count) return -4;
    total += count;
  }
  if ((mode & 4) == 0 && prots && (mode & 8) == 0 && total != n_prots)
    return -5 - total;
  const int64_t t_validated_ns = gc_now_ns();
  int64_t merged_len = 12;
  for (int64_t b = 0; b < n_batches; b++) merged_len += lens[b] - 12;
  int64_t wal_len = 0, new_bo = block_offset;
  if (mode & 1) {
    uint8_t hdr12[12];
    for (int i = 0; i < 8; i++) hdr12[i] = (uint8_t)(first_seq >> (8 * i));
    uint32_t tc = (uint32_t)total;
    for (int i = 0; i < 4; i++) hdr12[8 + i] = (uint8_t)(tc >> (8 * i));
    std::vector<GcPiece> pieces;
    pieces.reserve((size_t)n_batches + 1);
    pieces.push_back({hdr12, 12});
    for (int64_t b = 0; b < n_batches; b++)
      if (lens[b] > 12)
        pieces.push_back({(const uint8_t*)reps[b] + 12, lens[b] - 12});
    GcCursor cur{pieces.data(), (int64_t)pieces.size()};
    wal_len = gc_frame_merged(cur, merged_len, block_offset, log_number,
                              wal_out, wal_cap, &new_bo);
    if (wal_len < 0) return wal_len;
  }
  const int64_t t_framed_ns = gc_now_ns();
  int64_t delta = 0, deletes = 0;
  if (mode & 2) {
    SkipList* sl = mem_kind == 0 ? static_cast<SkipList*>(mem) : nullptr;
    TrieRep* tr = mem_kind == 1 ? static_cast<TrieRep*>(mem) : nullptr;
    if (!sl && !tr) return -2;
    // Work units: contiguous record ranges with a known start seq — one
    // per small batch, plus INTRA-batch splits for large batches (a quick
    // varint walk, ~10x cheaper than the inserts it parallelizes), so
    // even a single-batch group fans out across the ApplyPool. Both
    // native reps take concurrent inserts (CAS splice / per-stripe
    // mutexes) and records are order-independent (distinct seqnos), so
    // unit order does not matter.
    struct GcUnit {
      const uint8_t* p;
      const uint8_t* end;
      uint64_t seq;
    };
    size_t nt_max = std::min(effective_cpus(), (size_t)8);
    int64_t S = total / (int64_t)(2 * nt_max);
    if (S < 256) S = 256;
    std::vector<GcUnit> units;
    units.reserve((size_t)(total / S + n_batches + 1));
    {
      uint64_t seq = first_seq;
      for (int64_t b = 0; b < n_batches; b++) {
        const uint8_t* rep = (const uint8_t*)reps[b];
        const uint8_t* end = rep + lens[b];
        uint32_t cnt = (uint32_t)rep[8] | ((uint32_t)rep[9] << 8) |
                       ((uint32_t)rep[10] << 16) | ((uint32_t)rep[11] << 24);
        if ((int64_t)cnt <= S) {
          units.push_back({rep + 12, end, seq});
          seq += cnt;
          continue;
        }
        const uint8_t* p = rep + 12;
        const uint8_t* ustart = p;
        uint64_t useq = seq;
        int64_t in_unit = 0;
        while (p < end) {
          uint8_t t = *p++;
          uint32_t klen, vlen;
          p = get_varint32(p, end, &klen);
          if (!p) break;  // validated earlier; defensive
          p += klen;
          if (t == 0x1 || t == 0x2 || t == 0x16) {
            p = get_varint32(p, end, &vlen);
            if (!p) break;
            p += vlen;
          } else if (t == 0x3) {
            continue;
          }
          in_unit++;
          seq++;
          if (in_unit >= S) {
            units.push_back({ustart, p, useq});
            ustart = p;
            useq = seq;
            in_unit = 0;
          }
        }
        if (p > ustart) units.push_back({ustart, p, useq});
      }
    }
    std::atomic<int64_t> a_delta{0}, a_deletes{0};
    std::atomic<size_t> next_unit{0};
    size_t n_units = units.size();
    auto apply = [&]() {
      int64_t d = 0, dl = 0;
      for (;;) {
        size_t u = next_unit.fetch_add(1, std::memory_order_relaxed);
        if (u >= n_units) break;
        const uint8_t* p = units[u].p;
        const uint8_t* end = units[u].end;
        uint64_t seq = units[u].seq;
        while (p < end) {
          uint8_t t = *p++;
          uint32_t klen, vlen = 0;
          p = get_varint32(p, end, &klen);
          if (!p) break;  // validated earlier; defensive
          const uint8_t* k = p;
          p += klen;
          const uint8_t* v = p;
          if (t == 0x1 || t == 0x2 || t == 0x16) {
            p = get_varint32(p, end, &vlen);
            if (!p) break;
            v = p;
            p += vlen;
          } else if (t == 0x3) {
            continue;
          }
          uint64_t inv = ~((seq << 8) | (uint64_t)t);
          if (sl)
            sl->insert(k, klen, inv, v, vlen);
          else
            trie_insert(tr, k, klen, inv, v, vlen);
          d += (int64_t)klen + vlen + 24;
          if (t == 0x0 || t == 0x7) dl++;
          seq++;
        }
      }
      a_delta.fetch_add(d, std::memory_order_relaxed);
      a_deletes.fetch_add(dl, std::memory_order_relaxed);
    };
    size_t nt = 1;
    if (n_units > 1 && total >= 512) nt = std::min(nt_max, n_units);
    if (nt > 1) {
      apply_pool().run(apply, (int)nt - 1);
    } else {
      apply();
    }
    delta = a_delta.load();
    deletes = a_deletes.load();
  }
  out[0] = wal_len;
  out[1] = new_bo;
  out[2] = delta;
  out[3] = deletes;
  out[4] = merged_len;
  out[5] = t_validated_ns - t_entry_ns;
  out[6] = t_framed_ns - t_validated_ns;
  out[7] = gc_now_ns() - t_framed_ns;
  return total;
}

}  // extern "C"
