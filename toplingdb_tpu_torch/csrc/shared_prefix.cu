// shared_prefix: per-row shared-prefix lengths between consecutive sorted
// keys, written for Hopper (sm_90a).
//
// Replaces: toplingdb_tpu/ops/pallas_kernels.py::_prefix_kernel (entry
// shared_prefix_lengths), whose function the reference's block-assembly
// program computes inline (toplingdb_tpu/ops/block_assembly.py, the lcp of
// _assemble_blocks_impl). For row i of a [n, k] uint8 key matrix (k <= 128)
// it writes the index of the first byte that differs from row i-1; row 0
// gives 0, and a row equal to its predecessor gives 128 (the Pallas
// kernel's lane count: lanes past k are zero in both rows and compare
// equal). With lens, the result is clamped to min(lens[i], lens[i-1]).
//
// What bounds it: memory. Each row is read once for itself (its
// predecessor's bytes are the neighbour thread's own, served from L1/L2),
// plus 4 bytes of lens when given, and 4 bytes are written: at the
// block-assembly route's 2^22 rows of 16 bytes that is ~84 MB, about
// 25 us at 3.35 TB/s. The compare is a few integer ops per 8 bytes.
//
// Design: one thread per row, 256 rows per block. The Pallas kernel held
// every byte in its own int32 lane of a [1024, 128] tile (the TPU's
// tiling); here keys stay uint8, so a row costs k bytes of traffic, not
// 512. When k is a multiple of 8 and the buffer is 8-byte aligned, rows
// are compared in 8-byte words and the first differing byte of the first
// differing little-endian word is (ffsll(a ^ b) - 1) >> 3; otherwise byte
// by byte. No row-count alignment is required.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
shared_prefix_kernel(const uint8_t* __restrict__ keys,
                     const int32_t* __restrict__ lens, int k, int64_t n,
                     int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (i == 0) {
    out[0] = 0;
    return;
  }
  const uint8_t* a = keys + i * k;
  const uint8_t* b = a - k;
  int lcp = kLanes;
  if (kWords) {
    const uint64_t* aw = reinterpret_cast<const uint64_t*>(a);
    const uint64_t* bw = reinterpret_cast<const uint64_t*>(b);
    for (int w = 0; w < (k >> 3); ++w) {
      const uint64_t x = aw[w] ^ bw[w];
      if (x != 0) {
        lcp = (w << 3) + ((__ffsll(static_cast<long long>(x)) - 1) >> 3);
        break;
      }
    }
  } else {
    for (int j = 0; j < k; ++j) {
      if (a[j] != b[j]) {
        lcp = j;
        break;
      }
    }
  }
  if (lens != nullptr) {
    lcp = min(lcp, min(lens[i], lens[i - 1]));
  }
  out[i] = lcp;
}

}  // namespace

// C entry point for ctypes. lens may be null. Returns cudaGetLastError()
// after the launch.
extern "C" int tpt_shared_prefix(const void* keys, const void* lens, int k,
                                 int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kLanes) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const bool words =
      (k & 7) == 0 && (reinterpret_cast<uintptr_t>(keys) & 7) == 0;
  const auto* kp = static_cast<const uint8_t*>(keys);
  const auto* lp = static_cast<const int32_t*>(lens);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (words) {
    shared_prefix_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(kp, lp, k, n, op);
  } else {
    shared_prefix_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  s>>>(kp, lp, k, n, op);
  }
  return static_cast<int>(cudaGetLastError());
}
