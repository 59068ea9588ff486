// merge_runs: one pairwise round of the segmented merge of presorted runs,
// written for Hopper (sm_90a).
//
// Replaces: toplingdb_tpu/ops/pallas_kernels.py::_bitonic_merge_kernel
// (entries bitonic_merge_pair / bitonic_merge_runs), whose function the
// reference's main path computes with the XLA program _merge_runs_perm in
// toplingdb_tpu/ops/compaction_kernels.py. Input: R presorted runs bounded
// by run_starts ([R+1] int32, R a power of two, S[0] = 0, S[R] = p, empty
// runs allowed), keyed lexicographically over C int32 columns (u32 words in
// sign-flipped order). A round with step 2^r merges run pair (A, B) =
// ([S[2m*step], S[(2m+1)*step]), [S[(2m+1)*step], S[(2m+2)*step])) for
// every m; log2(R) rounds give the permutation new row -> old row. Ties keep
// A's rows first, so the merge is stable and equals both reference merges.
//
// What bounds it: memory. The least traffic for the whole merge is one read
// of the columns and one write of the permutation, 24 B/row with 5 columns
// (about 7.5 us at 2^20 rows and 3.35 TB/s). This pairwise design streams
// the C key columns and the origin row in and out once per round for the
// rows whose pair really interleaves, and leaves the other rows in place.
//
// Design (tiled merge path, one launch per round):
// - Carry the keys with the rows. A merged pair writes, in output order, its
//   key columns and origin rows into this round's [C+1, p] buffer, so the
//   next round streams its input instead of gathering through a
//   permutation; the last round writes only the origin rows, which are the
//   permutation.
// - Leave concatenations where they are. A pair with an empty partner, or
//   whose A ends at or before B's start, is a concatenation: its rows are
//   already in output order at their output positions. If both halves
//   still lie in the caller's columns (origin = row), nothing is written.
//   A per-run flag, written by the round for the next one, says whether a
//   run still lies in the caller's columns or in the previous round's
//   buffer; every other row lies in that one buffer, so a round never
//   writes rows that it or a later block of it reads. On the main path the
//   pad run and the empty runs never move, and the last round only writes
//   the permutation.
// - One block per output tile of T rows of one pair (tiles start at each
//   pair's start, so no block merges two pieces in turn; T from C, so that
//   the staged tile fits the shared-memory budget: 2048 rows at the main
//   path's 5 columns). The block finds the tile's co-rank at both ends
//   once, in global memory: warps 0 and 1 each probe 32 candidates per
//   step, and a compare loads two columns at once, so a step costs one
//   memory latency for keys that differ in their first two words (4 steps
//   at 2^20 rows, 5 at 2^22).
// - The tile's A and B slices are staged in shared memory with cp.async
//   (4-byte copies, since run slices start at arbitrary rows); each thread
//   finds its own co-rank there by binary search, merges T/256 outputs and
//   records which staged row each output takes; the tile is then written
//   column by column, coalesced.
//
// The boundary co-rank uses exactly the in-tile predicate (the smallest i
// with B[k-i-1] < A[i]), so no row is lost or repeated at a tile edge.
#include <atomic>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinTile = kThreads;
constexpr int kMaxTile = 2048;  // output rows per block; idx fits uint16
constexpr int kSmemBudget = 100 * 1024;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kMaxDevices = 64;

struct Round {
  const int32_t* cols;    // [C, p] the caller's key columns (origin = row)
  const int32_t* in;      // [C+1, p] the previous round's buffer, or null
  int32_t* out;           // [C, p] this round's key columns, or null (last)
  int32_t* out_org;       // [p] this round's origin rows
  const int32_t* starts;  // [n_runs + 1] run starts
  const int32_t* flag_in;  // per run: 1 = still in cols; null: all are
  int32_t* flag_out;       // the same for the next round, or null (last)
  int n_cols;
  int p;
  int n_runs;
  int step;
  int tile;
};

// Where one half of a pair lies: key column c at keys + c * p, origin row
// at org[x] (org null: the row itself).
struct Half {
  const int32_t* keys;
  const int32_t* org;
};

__device__ __forceinline__ Half half_at(const Round& r, bool in_cols) {
  if (in_cols) return Half{r.cols, nullptr};
  return Half{r.in, r.in + static_cast<int64_t>(r.n_cols) * r.p};
}

// Lexicographic a < b over rows of the staged, column-major tile.
__device__ __forceinline__ bool tile_less(const int32_t* sm, int n_cols,
                                          int tile, int a, int b) {
  for (int c = 0; c < n_cols; ++c) {
    const int32_t x = sm[c * tile + a];
    const int32_t y = sm[c * tile + b];
    if (x != y) return x < y;
  }
  return false;
}

// Lexicographic X[a] < Y[b] over rows of column-major [n_cols, p] keys in
// global memory. Columns are loaded two at a time, both at once.
__device__ __forceinline__ bool row_less(const Round& r, const int32_t* x,
                                         int a, const int32_t* y, int b) {
  constexpr int kChunk = 2;
  const int64_t p = r.p;
  for (int c0 = 0; c0 < r.n_cols; c0 += kChunk) {
    int32_t u[kChunk], v[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const bool in = c0 + q < r.n_cols;
      u[q] = in ? x[(c0 + q) * p + a] : 0;
      v[q] = in ? y[(c0 + q) * p + b] : 0;
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (u[q] != v[q]) return u[q] < v[q];
    }
  }
  return false;
}

// Co-rank of output k of the pair A = rows [a0, a0+la) of ha, B = rows
// [b0, b0+lb) of hb: the smallest i in [max(0, k-lb), min(k, la)] with
// B[k-i-1] < A[i] (the upper end if none), i.e. how many of the first k
// outputs come from A when A wins ties. Called by all 32 lanes of a warp,
// which probe 32 evenly spaced candidates per step; every lane returns the
// result.
__device__ int warp_corank(const Round& r, Half ha, int a0, int la, Half hb,
                           int b0, int lb, int k) {
  const int lane = threadIdx.x & 31;
  int lo = k - lb > 0 ? k - lb : 0;
  int hi = k < la ? k : la;
  while (lo < hi) {
    const int stride = (hi - lo + 31) >> 5;
    const int i = lo + (lane + 1) * stride - 1;
    // Candidates at or past hi count as true: the answer is at most hi.
    const bool pred =
        i >= hi || row_less(r, hb.keys, b0 + (k - i - 1), ha.keys, a0 + i);
    const unsigned ball = __ballot_sync(0xffffffffu, pred);
    if (ball == 0) {
      lo = hi;
    } else {
      const int f = __ffs(ball) - 1;
      const int top = lo + (f + 1) * stride - 1;
      lo += f * stride;
      hi = top < hi ? top : hi;
    }
  }
  return lo;
}

// Rows [s0, s1) of h written unmoved into this round's output. Column by
// column, each thread loads kCopy rows before it stores any, so its loads
// are in flight together.
__device__ void copy_rows(const Round& r, Half h, int s0, int s1) {
  constexpr int kCopy = 8;
  const int64_t p = r.p;
  for (int c = r.out != nullptr ? 0 : r.n_cols; c <= r.n_cols; ++c) {
    const int32_t* __restrict__ src = c < r.n_cols ? h.keys + c * p : h.org;
    int32_t* __restrict__ dst = c < r.n_cols ? r.out + c * p : r.out_org;
    for (int x0 = s0 + threadIdx.x; x0 < s1; x0 += kThreads * kCopy) {
      int32_t v[kCopy];
#pragma unroll
      for (int q = 0; q < kCopy; ++q) {
        const int x = x0 + q * kThreads;
        v[q] = x >= s1 ? 0 : src != nullptr ? src[x] : x;
      }
#pragma unroll
      for (int q = 0; q < kCopy; ++q) {
        const int x = x0 + q * kThreads;
        if (x < s1) dst[x] = v[q];
      }
    }
  }
}

// The tile of pair m that this block merges: warp 0 counts the pairs'
// tiles, 32 pairs at a time, and finds the pair whose tiles hold
// blockIdx.x. Returns {m, tile within the pair}, m = -1 past the last.
__device__ int2 block_tile(const Round& r, int n_pairs, int pstride) {
  __shared__ int2 s_tile;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int b = blockIdx.x;
    int2 found = make_int2(-1, 0);
    int base = 0;
    for (int m0 = 0; m0 < n_pairs; m0 += 32) {
      const int m = m0 + lane;
      int nt = 0;
      if (m < n_pairs) {
        const int len = r.starts[(m + 1) * pstride] - r.starts[m * pstride];
        nt = (len + r.tile - 1) / r.tile;
      }
      int inc = nt;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += v;
      }
      const int first = base + inc - nt;
      const unsigned ball =
          __ballot_sync(0xffffffffu, b >= first && b < first + nt);
      if (ball != 0) {
        const int src = __ffs(ball) - 1;
        found = make_int2(m0 + src, b - __shfl_sync(0xffffffffu, first, src));
        break;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) s_tile = found;
  }
  __syncthreads();
  return s_tile;
}

__global__ void __launch_bounds__(kThreads) merge_tile_kernel(Round r) {
  extern __shared__ int32_t sm[];  // [n_cols + 1][tile], then idx[tile]
  __shared__ int s_corank[2];
  const int tile = r.tile;
  const int n_cols = r.n_cols;
  const int64_t p = r.p;
  uint16_t* idx = reinterpret_cast<uint16_t*>(sm + (n_cols + 1) * tile);
  int32_t* org = sm + n_cols * tile;
  const int n_pairs = r.n_runs / (2 * r.step);
  const int pstride = 2 * r.step;
  if (blockIdx.x == 0 && r.flag_out != nullptr) {
    // Empty pairs have no tile; their flag is never read for rows.
    for (int m = threadIdx.x; m < n_pairs; m += kThreads) {
      if (r.starts[m * pstride] == r.starts[(m + 1) * pstride]) {
        r.flag_out[m * pstride] = 1;
      }
    }
  }
  const int2 mt = block_tile(r, n_pairs, pstride);
  const int m = mt.x;
  if (m < 0) return;
  const int pa = r.starts[m * pstride];
  const int pb = r.starts[m * pstride + r.step];
  const int pe = r.starts[(m + 1) * pstride];
  const int s0 = pa + mt.y * tile;
  const int s1 = s0 + tile < pe ? s0 + tile : pe;
  const int la = pb - pa;
  const int lb = pe - pb;
  const bool a_cols =
      la == 0 || r.flag_in == nullptr || r.flag_in[m * pstride] != 0;
  const bool b_cols = lb == 0 || r.flag_in == nullptr ||
                      r.flag_in[m * pstride + r.step] != 0;
  const Half ha = half_at(r, a_cols);
  const Half hb = half_at(r, b_cols);
  // A concatenation (A wins ties): its input rows are its outputs.
  const bool concat =
      la == 0 || lb == 0 || !row_less(r, hb.keys, pb, ha.keys, pb - 1);
  // Rows stay in the caller's columns only while no round moved them.
  const bool stays = concat && a_cols && b_cols && r.out != nullptr;
  if (mt.y == 0 && r.flag_out != nullptr && threadIdx.x == 0) {
    r.flag_out[m * pstride] = stays ? 1 : 0;
  }
  if (concat) {
    if (!stays) {
      copy_rows(r, ha, s0, s1 < pb ? s1 : pb);
      copy_rows(r, hb, s0 > pb ? s0 : pb, s1);
    }
    return;
  }
  if (threadIdx.x < 64) {
    const int w = threadIdx.x >> 5;
    const int i = warp_corank(r, ha, pa, la, hb, pb, lb,
                              (w == 0 ? s0 : s1) - pa);
    if ((threadIdx.x & 31) == 0) s_corank[w] = i;
  }
  __syncthreads();
  const int i0 = s_corank[0];
  const int i1 = s_corank[1];
  const int j0 = (s0 - pa) - i0;
  const int j1 = (s1 - pa) - i1;
  const int na = i1 - i0;
  const int nb = j1 - j0;
  const int n = na + nb;
  // Stage A[i0, i1) at rows [0, na) and B[j0, j1) at rows [na, n), key
  // columns and origin rows.
  for (int c = 0; c <= n_cols; ++c) {
    const int32_t* sa = c < n_cols ? ha.keys + c * p : ha.org;
    const int32_t* sb = c < n_cols ? hb.keys + c * p : hb.org;
    int32_t* dst = sm + c * tile;
    for (int x = threadIdx.x; x < n; x += kThreads) {
      const bool from_a = x < na;
      const int row = from_a ? pa + i0 + x : pb + j0 + (x - na);
      const int32_t* src = from_a ? sa : sb;
      if (src != nullptr) {
        __pipeline_memcpy_async(dst + x, src + row, sizeof(int32_t));
      } else {
        dst[x] = row;
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // Each thread merges outputs [k, k + per) of the tile.
  const int per = tile / kThreads;
  const int k = threadIdx.x * per;
  if (k < n) {
    int lo = k - nb > 0 ? k - nb : 0;
    int hi = k < na ? k : na;
    while (lo < hi) {
      const int i = (lo + hi) >> 1;
      if (tile_less(sm, n_cols, tile, na + (k - i - 1), i)) {
        hi = i;
      } else {
        lo = i + 1;
      }
    }
    int i = lo;
    int j = k - lo;
    const int end = k + per < n ? k + per : n;
    for (int q = k; q < end; ++q) {
      const bool take_a =
          i < na && (j >= nb || !tile_less(sm, n_cols, tile, na + j, i));
      idx[q] = static_cast<uint16_t>(take_a ? i++ : na + j++);
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < n; x += kThreads) {
    const int row = idx[x];
    if (r.out != nullptr) {
      for (int c = 0; c < n_cols; ++c) {
        r.out[c * p + s0 + x] = sm[c * tile + row];
      }
    }
    r.out_org[s0 + x] = org[row];
  }
}

// Lets merge_tile_kernel take `smem` bytes of dynamic shared memory on the
// current device. The attribute is set through the runtime only when smem
// exceeds what was set before on that device in this process, so the calls
// after the first of a shape make no runtime call besides cudaGetDevice.
cudaError_t allow_smem(int smem) {
  static std::atomic<int> allowed[kMaxDevices];  // 0: the default
  if (smem <= kSmemDefault) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && allowed[device].load(std::memory_order_relaxed) >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(merge_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cached) {
    int prev = allowed[device].load(std::memory_order_relaxed);
    while (prev < smem && !allowed[device].compare_exchange_weak(prev, smem)) {
    }
  }
  return cudaSuccess;
}

int smem_bytes(int n_cols, int tile) {
  return (n_cols + 1) * tile * static_cast<int>(sizeof(int32_t)) +
         tile * static_cast<int>(sizeof(uint16_t));
}

// Output rows per block for n_cols key columns: the largest power of two in
// [256, 2048] whose staged tile fits 100 KB of shared memory (at the main
// path's 5 columns, 2048). 0 when even 256 rows exceed the 227 KB a block
// may use.
int tile_rows(int n_cols) {
  int tile = kMaxTile;
  while (tile > kMinTile && smem_bytes(n_cols, tile) > kSmemBudget) tile >>= 1;
  return smem_bytes(n_cols, tile) <= kSmemLimit ? tile : 0;
}

}  // namespace

// C entry point for ctypes: one merge round with the given step (2^round).
// cols: [n_cols, p] int32, the caller's key columns, column-major; in:
// [n_cols + 1, p] the previous round's buffer (keys, then origin rows), null
// in the first round; out: [n_cols, p] this round's keys, null in the last
// round; out_org: [p] this round's origin rows (the permutation in the last
// round); flag_in / flag_out: [n_runs] int32 run flags from the previous
// round / for the next one (null in the first / last round); run_starts:
// [n_runs + 1] int32. Returns cudaErrorInvalidValue for arguments it does
// not take (among them more key columns than a tile can stage, over 225),
// else cudaGetLastError() after the launch.
extern "C" int tpt_merge_round(const void* cols, const void* in, void* out,
                               void* out_org, const void* flag_in,
                               void* flag_out, int n_cols, int64_t p,
                               const void* run_starts, int n_runs, int step,
                               void* stream) {
  if (p <= 0) return 0;
  const int tile = n_cols > 0 ? tile_rows(n_cols) : 0;
  if (tile == 0 || p > INT32_MAX || n_runs <= 0 || step <= 0 ||
      n_runs % (2 * step) != 0 || out_org == nullptr ||
      (in == nullptr) != (flag_in == nullptr) ||
      (out == nullptr) != (flag_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(n_cols, tile);
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Round r;
  r.cols = static_cast<const int32_t*>(cols);
  r.in = static_cast<const int32_t*>(in);
  r.out = static_cast<int32_t*>(out);
  r.out_org = static_cast<int32_t*>(out_org);
  r.starts = static_cast<const int32_t*>(run_starts);
  r.flag_in = static_cast<const int32_t*>(flag_in);
  r.flag_out = static_cast<int32_t*>(flag_out);
  r.n_cols = n_cols;
  r.p = static_cast<int>(p);
  r.n_runs = n_runs;
  r.step = step;
  r.tile = tile;
  // Tiles start at every pair's start: at most one more than p / tile per
  // pair; blocks past the last tile return at once.
  const int64_t blocks = (p + tile - 1) / tile + n_runs / (2 * step);
  merge_tile_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(r);
  return static_cast<int>(cudaGetLastError());
}
