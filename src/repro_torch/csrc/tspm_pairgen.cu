// Dense transitive pair generation, the tSPM+ hot loop, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tspm_pairgen/pairgen.py
// (_pairgen_kernel, launched by pairgen_planes) together with the int64
// packing that its wrapper ops.pairgen ran as a separate XLA pass.  For each
// patient p and each position pair (i, j) of its padded row it writes
//
//   seq[p,i,j]  int64  pack(phenx[p,i], phenx[p,j]) (bit or paper codec),
//                      optionally duration-fused, or SENTINEL when invalid
//   dur[p,i,j]  int32  date[p,j] - date[p,i], or 0 when invalid
//   mask[p,i,j] bool   i < j < nevents[p]
//
// byte for byte what core/mining.mine_dense computes.
//
// Bound: the store.  Each pair writes 13 bytes and reads nothing new (the
// two event rows stay in L1/L2), so the kernel is bound by device-memory
// write bandwidth: P*E*E*13 bytes.  Design: one thread per output element,
// so neighbouring threads write neighbouring addresses and every store is
// coalesced; blockIdx.x walks the E*E plane of one patient, blockIdx.y
// walks patients.  The TPU kernel emitted two int32 planes because Mosaic
// lacks int64 vectors; here the int64 id is formed in registers and stored
// once, which removes the planes' 8 extra bytes per pair and the wrapper's
// second pass.  No padding to 128-lane tiles: the ragged edge is masked
// here.  All id arithmetic runs on uint64, whose wraparound is defined and
// gives the same bits as the reference's two's-complement int64.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBitShift = 24;
constexpr uint64_t kPaperShift = 10000000ULL;
constexpr int kDurBits = 15;
constexpr int kDurMask = (1 << kDurBits) - 1;
constexpr long long kSentinel = 0x7fffffffffffffffLL;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// floor division, as the reference's `//` (C++ `/` truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void pairgen_kernel(const int* __restrict__ phenx,
                               const int* __restrict__ date,
                               const int* __restrict__ nevents,
                               long long* __restrict__ seq,
                               int* __restrict__ dur,
                               uint8_t* __restrict__ mask, int P, int E,
                               int codec, int fuse, int bucket_days) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;  // i * E + j
  if (r >= E * E) return;
  const int i = r / E;
  const int j = r - i * E;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    const long long row = static_cast<long long>(p) * E;
    const long long out = row * E + r;
    const bool valid = i < j && j < nevents[p];
    long long s = kSentinel;
    int d = 0;
    if (valid) {
      const uint64_t a = static_cast<uint64_t>(static_cast<long long>(phenx[row + i]));
      const uint64_t b = static_cast<uint64_t>(static_cast<long long>(phenx[row + j]));
      d = date[row + j] - date[row + i];
      uint64_t id = codec == 0 ? (a << kBitShift) | b : a * kPaperShift + b;
      if (fuse) {
        const int bucket = min(max(floor_div(d, bucket_days), 0), kDurMask);
        id = (id << kDurBits) | static_cast<uint64_t>(bucket);
      }
      s = static_cast<long long>(id);
    }
    seq[out] = s;
    dur[out] = d;
    mask[out] = valid;
  }
}

}  // namespace

// codec: 0 = bit, 1 = paper.  The caller guarantees P >= 1, 1 <= E,
// E * E < 2^31, bucket_days >= 1 and contiguous tensors of the documented
// types; the launch is asynchronous on `stream`.
extern "C" int tspm_pairgen(const void* phenx, const void* date,
                            const void* nevents, void* seq, void* dur,
                            void* mask, int P, int E, int codec, int fuse,
                            int bucket_days, void* stream) {
  const dim3 grid((E * E + kThreads - 1) / kThreads, P < kMaxGridY ? P : kMaxGridY);
  pairgen_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(phenx), static_cast<const int*>(date),
      static_cast<const int*>(nevents), static_cast<long long*>(seq),
      static_cast<int*>(dur), static_cast<uint8_t*>(mask), P, E, codec, fuse,
      bucket_days);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tspm_pairgen_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
