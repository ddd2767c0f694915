// Masked bucket histogram of the hash screen, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/seq_hist/seq_hist.py
// (_hist_kernel, launched by hist): out[b] += 1 for every element k with
// mask[k] and h[k] == b, for an int32 table of n_buckets entries.  Elements
// whose id lies outside [0, n_buckets) are dropped.
//
// Bound: the read of the mask (1 byte per element), of h where the mask is
// set (4 bytes per counted element: a warp whose lanes are all masked loads
// no h), and one write of the table.  The TPU has no vector scatter, so the
// JAX kernel compared every id against a tile of bucket ids (O(N * B) work,
// capped at 2^14 buckets).  Hopper has atomics, so this kernel does O(N)
// work for any table size, on one of two paths that the caller picks:
//   * shared: tables of up to 2^15 buckets (128 KB) get a private copy per
//     block in shared memory; a grid of a few blocks per SM walks the input
//     with a grid-stride loop, adds with shared-memory atomics, and flushes
//     only its non-zero entries to the global table with global atomics;
//   * global: larger tables (up to 2^24 and beyond) add straight into the
//     global table, which then lives in the 50 MB L2 cache.
// Atomics land in a different order on each run, but integer sums are
// exact, so the table is byte-identical to the plain scatter-add.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSharedBuckets = 1 << 15;
constexpr int kBlocksPerSm = 2;

__global__ void hist_shared(const int* __restrict__ h,
                            const uint8_t* __restrict__ mask, long long n,
                            int* __restrict__ out, int n_buckets) {
  extern __shared__ int table[];
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) table[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < n; k += stride) {
    if (mask[k]) {
      const int v = h[k];
      if (static_cast<unsigned>(v) < static_cast<unsigned>(n_buckets))
        atomicAdd(&table[v], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) {
    const int c = table[b];
    if (c) atomicAdd(&out[b], c);
  }
}

__global__ void hist_global(const int* __restrict__ h,
                            const uint8_t* __restrict__ mask, long long n,
                            int* __restrict__ out, int n_buckets) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < n; k += stride) {
    if (mask[k]) {
      const int v = h[k];
      if (static_cast<unsigned>(v) < static_cast<unsigned>(n_buckets))
        atomicAdd(&out[v], 1);
    }
  }
}

}  // namespace

// Adds into `out`, which the caller zeroes.  The caller guarantees n >= 1,
// n_buckets >= 1, contiguous int32 / uint8 inputs, and n_buckets <= 2^15
// when `shared` is set; the launch is asynchronous on `stream`.
extern "C" int seq_hist(const void* h, const void* mask, long long n, void* out,
                        int n_buckets, int shared, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared && n_buckets > kMaxSharedBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto hp = static_cast<const int*>(h);
  const auto mp = static_cast<const uint8_t*>(mask);
  const auto op = static_cast<int*>(out);
  if (shared) {
    const int smem = n_buckets * static_cast<int>(sizeof(int));
    err = cudaFuncSetAttribute(hist_shared,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
    const int blocks = static_cast<int>(want < cap ? want : cap);
    hist_shared<<<blocks, kThreads, smem, s>>>(hp, mp, n, op, n_buckets);
  } else {
    const long long cap = static_cast<long long>(sms) * 16;
    const int blocks = static_cast<int>(want < cap ? want : cap);
    hist_global<<<blocks, kThreads, 0, s>>>(hp, mp, n, op, n_buckets);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* seq_hist_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
