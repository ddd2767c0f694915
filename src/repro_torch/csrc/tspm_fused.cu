// Corpus-free fused mine+screen bucket counting, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tspm_fused/fused.py
// (_fused_kernel, launched by fused_table).  For every patient p and every
// pair i < j < nevents[p] that is the patient's first occurrence of its
// value pair, it adds one at hash_bucket(pack(x_i, x_j)) of an int32 table
// of 2^H buckets, which the caller zeroes.  No pair is ever written: the
// table equals sparsity.local_bucket_counts over mining.mine_dense.
//
// Dedup without the row sort: with prev[k] the last position before k that
// holds x_k (-1 when there is none), pair (i, j) counts iff prev[i] < 0 (i
// is the first occurrence of x_i) and prev[j] <= i (no x_j strictly between
// i and j).  That keeps exactly one pair per distinct (x_i, x_j) of the
// row, x_i == x_j included.
//
// Bound: the input is read once (P*E*4 + P*4 bytes) and the table written
// once (4*2^H bytes), a few MB; the work is one hash and one atomic add per
// counted pair, and the atomics set the pace.  The TPU kernel had limits
// this card does not share, so the design differs:
//   * ids: it evaluated the hash in 13-bit int32 limbs (Mosaic lacks int64
//     vectors); here the id is formed on uint64 (bit: s << 24 | e, paper:
//     s * 10^7 + e), multiplied by 0x9E3779B97F4A7C15 with defined
//     wraparound, and the top H bits taken, the bits of hash_bucket;
//   * lookbacks: it recomputed them for every (i, j) tile and bucket tile;
//     here one block owns one patient row at a time, holds the row in
//     shared memory and computes prev[] once per row (an O(n^2) scan);
//   * histogram: the TPU had no scatter and compared against bucket tiles,
//     capped at 2^14 buckets.  Here, as in seq_hist.cu, tables of up to
//     2^15 buckets get a private copy per block in shared memory (a
//     persistent grid loops over patients, zeroes the copy once and flushes
//     its non-zero entries with global atomics); larger tables take global
//     atomics straight into the table, which lives in L2.
// Integer sums are exact in any order, so the table is byte-identical to
// the plain versions however the atomics interleave.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBitShift = 24;
constexpr uint64_t kPaperShift = 10000000ULL;
constexpr uint64_t kHashMult = 0x9E3779B97F4A7C15ULL;
constexpr int kMaxSharedBuckets = 1 << 15;
constexpr int kMaxSmemPerBlock = 227 * 1024;

template <bool kSharedTable>
__global__ void fused_kernel(const int* __restrict__ phenx,
                             const int* __restrict__ nevents,
                             int* __restrict__ out, int P, int E, int codec,
                             int H) {
  extern __shared__ int smem[];
  const int n_buckets = 1 << H;
  int* table = smem;                                  // kSharedTable only
  int* row = smem + (kSharedTable ? n_buckets : 0);   // [E] codes of the row
  int* prev = row + E;                                // [E] lookbacks
  if (kSharedTable)
    for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) table[b] = 0;
  const int shift = 64 - H;
  const uint64_t bucket_mask = static_cast<uint64_t>(n_buckets - 1);

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const int n = min(max(nevents[p], 0), E);
    if (n < 2) continue;                 // the same n for the whole block
    __syncthreads();                     // the previous row is done with
    const long long base = static_cast<long long>(p) * E;
    for (int k = threadIdx.x; k < n; k += blockDim.x) row[k] = phenx[base + k];
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int v = row[k];
      int q = k - 1;
      while (q >= 0 && row[q] != v) --q;
      prev[k] = q;
    }
    __syncthreads();
    const int nn = n * n;
    for (int t = threadIdx.x; t < nn; t += blockDim.x) {
      const int i = t / n;
      const int j = t - i * n;
      if (i < j && prev[i] < 0 && prev[j] <= i) {
        const uint64_t a = static_cast<uint64_t>(static_cast<long long>(row[i]));
        const uint64_t b = static_cast<uint64_t>(static_cast<long long>(row[j]));
        const uint64_t id = codec == 0 ? (a << kBitShift) | b : a * kPaperShift + b;
        const int h = static_cast<int>(((id * kHashMult) >> shift) & bucket_mask);
        if (kSharedTable)
          atomicAdd(&table[h], 1);
        else
          atomicAdd(&out[h], 1);
      }
    }
  }
  if (kSharedTable) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) {
      const int c = table[b];
      if (c) atomicAdd(&out[b], c);
    }
  }
}

}  // namespace

// Adds into `out` (2^H int32, zeroed by the caller).  codec: 0 = bit,
// 1 = paper.  The caller guarantees P >= 1, 1 <= E, E * E < 2^31,
// 1 <= H <= 30, H <= 15 when `shared` is set, and contiguous int32 inputs;
// `threads` and `blocks_per_sm` are the launch shape of the plan
// (analysis/roofline.mining_tile_plan).  The launch is asynchronous on
// `stream`.
extern "C" int tspm_fused(const void* phenx, const void* nevents, void* out,
                          int P, int E, int codec, int H, int shared,
                          int threads, int blocks_per_sm, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H < 1 || H > 30 || (shared && (1 << H) > kMaxSharedBuckets) ||
      threads < 32 || threads > 1024 || blocks_per_sm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem_ll =
      (static_cast<long long>(shared ? (1 << H) : 0) + 2LL * E) * sizeof(int);
  if (smem_ll > kMaxSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_ll);
  const long long cap = static_cast<long long>(sms) * blocks_per_sm;
  const int blocks = static_cast<int>(P < cap ? P : cap);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const int*>(phenx);
  const auto np = static_cast<const int*>(nevents);
  const auto op = static_cast<int*>(out);
  if (shared) {
    err = cudaFuncSetAttribute(fused_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_kernel<true><<<blocks, threads, smem, s>>>(xp, np, op, P, E, codec, H);
  } else {
    err = cudaFuncSetAttribute(fused_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_kernel<false><<<blocks, threads, smem, s>>>(xp, np, op, P, E, codec, H);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tspm_fused_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
