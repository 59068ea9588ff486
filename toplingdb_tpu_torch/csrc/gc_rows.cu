// gc_rows: the per-row MVCC GC core of the device compaction data plane,
// written for Hopper (sm_90a).
//
// Replaces: toplingdb_tpu/ops/pallas_kernels.py::_gc_rows_kernel (entry
// gc_rows). For every row of a shard in internal-key order it computes
//   stripe   the number of live snapshots strictly below the row's seqno,
//   fis      first-in-stripe: a new user key, or a stripe that differs from
//            the previous row's (row 0's previous row is the LAST row, the
//            wrap of the reference's roll),
//   covered  a range tombstone exists, is newer than the row, and lies in
//            the row's stripe,
//   cx       the row is a MERGE (2) or SINGLE_DELETION (7).
// Seqnos travel as (hi, lo) u32 word pairs, compared unsigned.
//
// What bounds it: memory. Per row it reads 13 bytes (seq words, new-key
// flag, vtype; 21 with tombstone words) and writes 7, so at the main path's
// 2^20 rows it moves ~20 MB — about 6 us at 3.35 TB/s. The arithmetic is a
// few compares per row.
//
// Design:
// - A persistent grid (8 blocks of 256 threads per SM, grid-stride loop).
//   Each block stages the sorted snapshot list once, packed as u64
//   (hi << 32 | lo), so each step of the stripe's binary search is one
//   compare. The list is padded with the 2^56 sentinel, which no seqno
//   reaches, so the lower bound equals the Pallas kernel's linear count.
// - Each thread takes kVec = 4 consecutive rows: one 16-byte load each for
//   the seq words, vtype and tombstone words, one 4-byte load of new_key
//   flags; the stripes leave as one 16-byte store, the three flags as one
//   4-byte store each. A warp's span of 128 rows is contiguous.
// - The previous row's stripe comes from the thread's own previous row or,
//   for its first row, from the lane below (__shfl_up_sync); only lane 0
//   searches for its predecessor (row n-1 for row 0).
// - A scalar path inside the same loop takes the last, short group and
//   pointers that are not aligned for the vector accesses (offset slices).
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 4;
constexpr int kMaxSnapshots = 1024;
constexpr int kMaxDevices = 64;

// Count of snapshots strictly below x in the sorted list.
__device__ __forceinline__ int stripe_of(const uint64_t* snaps, int s,
                                         uint64_t x) {
  int first = 0;
  int len = s;
  while (len > 0) {
    const int half = len >> 1;
    const bool lt = snaps[first + half] < x;
    first = lt ? first + half + 1 : first;
    len = lt ? len - half - 1 : half;
  }
  return first;
}

__device__ __forceinline__ uint64_t word_pair(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

struct Args {
  const uint32_t* seq_hi;
  const uint32_t* seq_lo;
  const uint8_t* new_key;
  const uint32_t* tomb_hi;  // null: no range tombstones
  const uint32_t* tomb_lo;
  const int32_t* vtype;
  const uint32_t* snap_hi;
  const uint32_t* snap_lo;
  int s;
  int64_t n;
  int vec_ok;  // every pointer is aligned for the vector accesses
  int32_t* stripe;
  uint8_t* fis;
  uint8_t* covered;
  uint8_t* cx;
};

__global__ void __launch_bounds__(kThreads) gc_rows_kernel(Args a) {
  __shared__ uint64_t snaps[kMaxSnapshots];
  for (int k = threadIdx.x; k < a.s; k += kThreads) {
    snaps[k] = word_pair(a.snap_hi[k], a.snap_lo[k]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t n_groups = (a.n + kVec - 1) / kVec;
  const int64_t warp_first =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane);
  const int64_t grid_threads = static_cast<int64_t>(gridDim.x) * kThreads;
  const bool tombs = a.tomb_hi != nullptr;
  // g0 is warp-uniform, so every lane reaches the shuffle.
  for (int64_t g0 = warp_first; g0 < n_groups; g0 += grid_threads) {
    const int64_t g = g0 + lane;
    const int64_t base = g * kVec;
    const int64_t left = a.n - base;
    const int cnt = g < n_groups ? (left < kVec ? static_cast<int>(left) : kVec)
                                 : 0;
    uint32_t h[kVec], l[kVec], th[kVec], tl[kVec];
    int32_t vt[kVec];
    uint8_t nk[kVec];
    // Lane 0 reads its predecessor's seqno (row n-1 for row 0) with its own
    // rows, so that load does not wait behind them.
    uint32_t ph = 0;
    uint32_t pl = 0;
    if (lane == 0 && cnt > 0) {
      const int64_t pr = base == 0 ? a.n - 1 : base - 1;
      ph = a.seq_hi[pr];
      pl = a.seq_lo[pr];
    }
    if (cnt == kVec && a.vec_ok) {
      const uint4 vh = *reinterpret_cast<const uint4*>(a.seq_hi + base);
      const uint4 vl = *reinterpret_cast<const uint4*>(a.seq_lo + base);
      const int4 vv = *reinterpret_cast<const int4*>(a.vtype + base);
      const uchar4 vk = *reinterpret_cast<const uchar4*>(a.new_key + base);
      h[0] = vh.x; h[1] = vh.y; h[2] = vh.z; h[3] = vh.w;
      l[0] = vl.x; l[1] = vl.y; l[2] = vl.z; l[3] = vl.w;
      vt[0] = vv.x; vt[1] = vv.y; vt[2] = vv.z; vt[3] = vv.w;
      nk[0] = vk.x; nk[1] = vk.y; nk[2] = vk.z; nk[3] = vk.w;
      if (tombs) {
        const uint4 wh = *reinterpret_cast<const uint4*>(a.tomb_hi + base);
        const uint4 wl = *reinterpret_cast<const uint4*>(a.tomb_lo + base);
        th[0] = wh.x; th[1] = wh.y; th[2] = wh.z; th[3] = wh.w;
        tl[0] = wl.x; tl[1] = wl.y; tl[2] = wl.z; tl[3] = wl.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const bool in = q < cnt;
        h[q] = in ? a.seq_hi[base + q] : 0;
        l[q] = in ? a.seq_lo[base + q] : 0;
        vt[q] = in ? a.vtype[base + q] : 0;
        nk[q] = in ? a.new_key[base + q] : 0;
        th[q] = in && tombs ? a.tomb_hi[base + q] : 0;
        tl[q] = in && tombs ? a.tomb_lo[base + q] : 0;
      }
    }
    int st[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      st[q] = stripe_of(snaps, a.s, word_pair(h[q], l[q]));
    }
    // The row before `base`: the lane below's last row (its group is full,
    // since only the final group is short), or for lane 0 a search.
    int prev = __shfl_up_sync(0xffffffffu, st[kVec - 1], 1);
    if (lane == 0 && cnt > 0) prev = stripe_of(snaps, a.s, word_pair(ph, pl));
    int32_t so[kVec];
    uint8_t fo[kVec], co[kVec], xo[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int ps = q == 0 ? prev : st[q - 1];
      so[q] = st[q];
      fo[q] = (nk[q] != 0 || st[q] != ps) ? 1 : 0;
      bool cov = false;
      if (tombs) {
        const uint64_t t = word_pair(th[q], tl[q]);
        cov = t != 0 && word_pair(h[q], l[q]) < t &&
              stripe_of(snaps, a.s, t) == st[q];
      }
      co[q] = cov ? 1 : 0;
      xo[q] = (vt[q] == 2 || vt[q] == 7) ? 1 : 0;
    }
    if (cnt == kVec && a.vec_ok) {
      *reinterpret_cast<int4*>(a.stripe + base) =
          make_int4(so[0], so[1], so[2], so[3]);
      *reinterpret_cast<uchar4*>(a.fis + base) =
          make_uchar4(fo[0], fo[1], fo[2], fo[3]);
      *reinterpret_cast<uchar4*>(a.covered + base) =
          make_uchar4(co[0], co[1], co[2], co[3]);
      *reinterpret_cast<uchar4*>(a.cx + base) =
          make_uchar4(xo[0], xo[1], xo[2], xo[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        if (q < cnt) {
          a.stripe[base + q] = so[q];
          a.fis[base + q] = fo[q];
          a.covered[base + q] = co[q];
          a.cx[base + q] = xo[q];
        }
      }
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

// SM count of the current device, read from the runtime once per device
// and process (0 in the cache: not read yet).
cudaError_t sm_count(int* sms) {
  static std::atomic<int> cache[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices) {
    *sms = cache[device].load(std::memory_order_relaxed);
    if (*sms > 0) return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    cache[device].store(*sms, std::memory_order_relaxed);
  return err;
}

}  // namespace

// C entry point for ctypes. tomb_hi/tomb_lo may both be null (no range
// tombstones). Pointers need no alignment: unaligned ones take the scalar
// path. Returns cudaGetLastError() after the launch.
extern "C" int tpt_gc_rows(const void* seq_hi, const void* seq_lo,
                           const void* new_key, const void* tomb_hi,
                           const void* tomb_lo, const void* vtype,
                           const void* snap_hi, const void* snap_lo, int s,
                           int64_t n, void* stripe_out, void* fis_out,
                           void* covered_out, void* cx_out, void* stream) {
  if (n <= 0) return 0;
  if (s < 0 || s > kMaxSnapshots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.seq_hi = static_cast<const uint32_t*>(seq_hi);
  a.seq_lo = static_cast<const uint32_t*>(seq_lo);
  a.new_key = static_cast<const uint8_t*>(new_key);
  a.tomb_hi = static_cast<const uint32_t*>(tomb_hi);
  a.tomb_lo = static_cast<const uint32_t*>(tomb_lo);
  a.vtype = static_cast<const int32_t*>(vtype);
  a.snap_hi = static_cast<const uint32_t*>(snap_hi);
  a.snap_lo = static_cast<const uint32_t*>(snap_lo);
  a.s = s;
  a.n = n;
  a.stripe = static_cast<int32_t*>(stripe_out);
  a.fis = static_cast<uint8_t*>(fis_out);
  a.covered = static_cast<uint8_t*>(covered_out);
  a.cx = static_cast<uint8_t*>(cx_out);
  const uintptr_t w = sizeof(uint32_t) * kVec;
  a.vec_ok = aligned(seq_hi, w) && aligned(seq_lo, w) && aligned(vtype, w) &&
             aligned(stripe_out, w) && aligned(tomb_hi, w) &&
             aligned(tomb_lo, w) && aligned(new_key, kVec) &&
             aligned(fis_out, kVec) && aligned(covered_out, kVec) &&
             aligned(cx_out, kVec);
  const int64_t groups = (n + kVec - 1) / kVec;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > resident) blocks = resident;
  gc_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
