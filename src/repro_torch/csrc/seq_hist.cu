// Masked bucket histogram of the hash screen, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/seq_hist/seq_hist.py
// (_hist_kernel, launched by hist): out[b] += 1 for every element k with
// mask[k] and h[k] == b, for an int32 table of n_buckets entries.  Elements
// whose id lies outside [0, n_buckets) are dropped.
//
// Bound: the read of the mask (1 byte per element), of h where the mask is
// set (4 bytes per counted element), and one write of the table.  The TPU
// has no vector scatter, so the JAX kernel compared every id against a
// tile of bucket ids (O(N * B) work, capped at 2^14 buckets).  Here the
// wrapper picks one of three routes (kernels/seq_hist/ops.py route):
//   * shared: up to 2^15 buckets, a private table in each block's shared
//     memory (bucket_count.cuh's small case);
//   * partitioned: larger tables over many elements, bucket_count.cuh's
//     two stages, no counted id a global atomic;
//   * global: larger tables over few elements, a global atomic a counted
//     id, one launch where the partitioned route needs four.
// The shared and partitioned routes walk the input in steps of 16 elements
// a thread: the mask as one 16-byte load, h as 16-byte loads of the groups
// of four whose mask bytes are not all zero (scalar loads where h or the
// mask is not 16-byte aligned, and in a ragged last step).
#include "bucket_count.cuh"

namespace {

using namespace bucket_count;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kStep = kThreads * kPerThread;   // elements a block takes a step
constexpr int kStageSmem = stage_bytes(kWarps);
constexpr int kGlobalThreads = 512;
constexpr int kRouteShared = 0, kRouteGlobal = 1, kRoutePartitioned = 2;   // ops.ROUTES

// Calls f(keep, v) for the 16 elements [k0, k0 + 16) of this thread, keep
// where the mask is set and 0 <= v < n_buckets.  Every lane calls f 16
// times, so f may be warp-collective: `vec` (16-byte loads) must be the
// same for the whole block, so the caller clears it for a ragged last step.
template <class F>
__device__ __forceinline__ void visit16(const int* __restrict__ h,
                                        const uint8_t* __restrict__ mask, long long n,
                                        long long k0, long long n_buckets, bool vec, F f) {
  if (vec) {
    const uint4 m = *reinterpret_cast<const uint4*>(mask + k0);
    const uint32_t words[4] = {m.x, m.y, m.z, m.w};
    int4 hv[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      hv[g] = words[g] ? *reinterpret_cast<const int4*>(h + k0 + 4 * g) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int vals[4] = {hv[g].x, hv[g].y, hv[g].z, hv[g].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = vals[e];
        const bool set = (words[g] >> (8 * e)) & 0xFFu;
        f(set && v >= 0 && v < n_buckets, static_cast<uint32_t>(v));
      }
    }
  } else {
    for (int e = 0; e < kPerThread; ++e) {
      const long long k = k0 + e;
      int v = -1;
      if (k < n && mask[k]) v = h[k];
      f(v >= 0 && v < n_buckets, static_cast<uint32_t>(v));
    }
  }
}

// n_buckets <= 2^15: a private table per block in shared memory.
__global__ void __launch_bounds__(kThreads)
hist_private(const int* __restrict__ h, const uint8_t* __restrict__ mask, long long n,
             int* __restrict__ out, int n_buckets, bool vec) {
  extern __shared__ int table[];
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) table[b] = 0;
  __syncthreads();
  for (long long base = static_cast<long long>(blockIdx.x) * kStep; base < n;
       base += static_cast<long long>(gridDim.x) * kStep)
    visit16(h, mask, n, base + threadIdx.x * kPerThread, n_buckets,
            vec && base + kStep <= n,
            [&](bool keep, uint32_t v) { if (keep) atomicAdd(&table[v], 1); });
  __syncthreads();
  table_flush(table, n_buckets, out, true);
}

// Stage (a), pass 1: offs[p * G + block] = the block's ids in partition
// lo + p (shared atomics on the block's counts).
__global__ void __launch_bounds__(kThreads)
hist_count_pass(const int* __restrict__ h, const uint8_t* __restrict__ mask, long long n,
                long long n_buckets, int lo, int np, unsigned* __restrict__ offs, bool vec) {
  extern __shared__ int cnt[];
  for (int p = threadIdx.x; p < np; p += blockDim.x) cnt[p] = 0;
  __syncthreads();
  for (long long base = static_cast<long long>(blockIdx.x) * kStep; base < n;
       base += static_cast<long long>(gridDim.x) * kStep)
    visit16(h, mask, n, base + threadIdx.x * kPerThread, n_buckets,
            vec && base + kStep <= n, [&](bool keep, uint32_t v) {
              if (keep && in_group(v, lo, np))
                atomicAdd(&cnt[static_cast<int>(v >> kPartLog2) - lo], 1);
            });
  __syncthreads();
  for (int p = threadIdx.x; p < np; p += blockDim.x)
    offs[static_cast<size_t>(p) * gridDim.x + blockIdx.x] = static_cast<unsigned>(cnt[p]);
}

// Stage (a): each warp bins its lanes' ids and flushes its bins to the
// scratch whenever another push could overflow one.  The same steps as the
// counting pass, block for block.
__global__ void __launch_bounds__(kThreads)
hist_stage(const int* __restrict__ h, const uint8_t* __restrict__ mask, long long n,
           long long n_buckets, int lo, int np, const unsigned* __restrict__ offs,
           uint16_t* __restrict__ ids, bool vec) {
  extern __shared__ __align__(16) unsigned char stage_mem[];
  stage_begin(stage_mem, offs, gridDim.x, np);
  const WarpBins w = warp_bins_at(stage_mem, threadIdx.x >> 5);
  unsigned* base_offs = stage_base(stage_mem);
  const int C = kWarpBinIds / np;
  for (long long base = static_cast<long long>(blockIdx.x) * kStep; base < n;
       base += static_cast<long long>(gridDim.x) * kStep)
    visit16(h, mask, n, base + threadIdx.x * kPerThread, n_buckets,
            vec && base + kStep <= n, [&](bool keep, uint32_t v) {
              if (warp_bin(w, C, keep && in_group(v, lo, np), v, lo))
                warp_flush(w, C, np, base_offs, ids);
            });
  warp_flush(w, C, np, base_offs, ids);
}

// Route "global", for inputs below the partitioned pipeline's crossover
// (kernels/seq_hist/ops.py GLOBAL_MAX_ELEMENTS): the kernel this file
// shipped before the partitioned design, one mask byte a thread an
// iteration and a global atomic a counted id, 512 threads a block.  Its
// one launch beats the pipeline's four where the input is small.
__global__ void hist_global(const int* __restrict__ h, const uint8_t* __restrict__ mask,
                            long long n, int* __restrict__ out, int n_buckets) {
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

#ifdef COUNT_PROBES
// The shared-table kernel this file shipped before the partitioned design
// (one byte of mask a thread an iteration), kept for chip_smoke.py's
// before/after reading at a small table.
__global__ void hist_shared_old(const int* __restrict__ h, const uint8_t* __restrict__ mask,
                                long long n, int* __restrict__ out, int n_buckets) {
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

int device_sms(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(err);
}
#endif

}  // namespace

// Adds the counts into `out` (n_buckets int32, zeroed by the caller) on
// `stream`, asynchronously, by `route` (ops.ROUTES: 0 shared, at most 2^15
// buckets; 1 global; 2 partitioned, above 2^15 buckets).  `grid` blocks
// walk the input (the wrapper's count_plan); on the partitioned route
// `part_blocks` blocks count each partition and `scratch` holds
// bucket_count::scratch_bytes(n, parts, grid) bytes (16-byte aligned).
// The caller guarantees n >= 1, 1 <= n_buckets <= 2^31 - 1, n < 2^32 and
// contiguous int32 / uint8 inputs.
extern "C" int seq_hist(const void* h, const void* mask, long long n, void* out,
                        long long n_buckets, void* scratch, long long scratch_len, int grid,
                        int part_blocks, int route, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto hp = static_cast<const int*>(h);
  const auto mp = static_cast<const uint8_t*>(mask);
  const auto op = static_cast<int*>(out);
  const bool vec = reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  if (n < 1 || n_buckets < 1 || grid < 1 || part_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (route == kRouteShared) {
    if (n_buckets > kPartBuckets) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>(n_buckets) * static_cast<int>(sizeof(int));
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(hist_private, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)) != cudaSuccess)
      return static_cast<int>(err);
    hist_private<<<grid, kThreads, smem, s>>>(hp, mp, n, op, static_cast<int>(n_buckets), vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (route == kRouteGlobal) {
    if (n_buckets >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    hist_global<<<grid, kGlobalThreads, 0, s>>>(hp, mp, n, op, static_cast<int>(n_buckets));
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kRoutePartitioned || n_buckets <= kPartBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long parts = n_parts(n_buckets);
  if (scratch == nullptr || scratch_len < scratch_bytes(n, parts, grid) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ids = static_cast<uint16_t*>(scratch);
  auto* offs = reinterpret_cast<unsigned*>(static_cast<unsigned char*>(scratch) +
                                           ((2 * n + 15) / 16) * 16);
  err = cudaFuncSetAttribute(hist_stage, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStageSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(count_segments, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPartBuckets * static_cast<int>(sizeof(int)));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long lo = 0; lo < parts; lo += kGroupParts) {
    const int np = static_cast<int>(parts - lo < kGroupParts ? parts - lo : kGroupParts);
    const int l = static_cast<int>(lo);
    hist_count_pass<<<grid, kThreads, np * sizeof(int), s>>>(hp, mp, n, n_buckets, l, np,
                                                             offs, vec);
    scan_offsets<<<1, kScanThreads, 0, s>>>(offs, np * grid);
    hist_stage<<<grid, kThreads, kStageSmem, s>>>(hp, mp, n, n_buckets, l, np, offs, ids, vec);
    count_segments<<<np * part_blocks, kCountThreads, kPartBuckets * sizeof(int), s>>>(
        ids, offs, grid, l, part_blocks, op, n_buckets);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* seq_hist_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

#ifdef COUNT_PROBES
// The shared-table kernel before the partitioned design, as it was
// launched (n_buckets <= 2^15, 2 blocks an SM of 512 threads).
extern "C" int seq_hist_old_shared(const void* h, const void* mask, long long n, void* out,
                                   int n_buckets, void* stream) {
  int sms = 0;
  if (int rc = device_sms(&sms)) return rc;
  if (n_buckets > kPartBuckets) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = n_buckets * static_cast<int>(sizeof(int));
  cudaError_t err =
      cudaFuncSetAttribute(hist_shared_old, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + kGlobalThreads - 1) / kGlobalThreads;
  const long long cap = static_cast<long long>(sms) * 2;
  hist_shared_old<<<static_cast<int>(want < cap ? want : cap), kGlobalThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(h),
                                                         static_cast<const uint8_t*>(mask), n,
                                                         static_cast<int*>(out), n_buckets);
  return static_cast<int>(cudaGetLastError());
}
#endif
