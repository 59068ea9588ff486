// Native C++ host core of toplingdb_tpu_torch: the SST codec the device
// compaction data plane runs on the host. This is the port's own copy of the
// routines it calls from toplingdb_tpu/native/tpulsm_native.cc, trimmed to
// them: CRC32C, xxhash64, block decode/encode, data-section and index-block
// builds (uncompressed, and snappy / zstd compressed), bloom fills, the
// whole-file columnar scans (inflating snappy / zstd blocks inline), the
// bulk block inflate, the zip-table plane (key front-coding, value-group
// encode with ZSTD dictionaries, key and value-group decode), and the
// skiplist memtable with its WriteBatch wire-image insert. The codec
// libraries are dlopen'd at run time, so the build needs none of their
// headers.
//
// Build:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -o lib.so tpulsm_native.cc -ldl
#include <algorithm>
#include <atomic>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
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
#define TPULSM_ABI_VERSION 4

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
template <typename InsertFn>
static int64_t wb_wire_apply(const uint8_t* rep, int64_t len,
                             uint64_t first_seq, int64_t* out,
                             InsertFn&& ins) {
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
      if (pass == 1) {
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


}  // extern "C"
