// Delta pair generation for streaming tSPM+, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tspm_delta/delta.py
// (_delta_kernel, launched by delta_planes) together with the int64 packing
// that its wrapper ops.delta_pairgen ran as a separate XLA pass.  When a
// patient's history grows by d events, only the pairs that end in a new
// event are new.  For each patient p of a tick's wave, each stored event
// position i of the updated history planes (the delta already appended at
// n_old[p] .. n_old[p] + n_new[p]) and each delta position j it writes
//
//   seq[p,i,j]  int64  pack(max(phenx[p,i], 0), max(new_phenx[p,j], 0))
//                      (bit or paper codec), optionally duration-fused,
//                      or SENTINEL when invalid
//   dur[p,i,j]  int32  new_date[p,j] - date[p,i], or 0 when invalid
//   mask[p,i,j] bool   i < n_old[p] + j  and  j < n_new[p]
//
// byte for byte what stream/delta.delta_mine_torch computes.  The union of
// these slabs over all ticks is the batch pair set.
//
// Bound: the store.  Each slot writes 13 bytes (8 id + 4 duration + 1 mask)
// and reads two rows that stay in L1/L2, so the kernel is bound by
// device-memory write bandwidth: P*E*D*13 bytes at 3.35 TB/s (the largest
// slab of the 4,985-patient cohort, 16 x 512 x 512, is 54.5 MB, ~16 us).
// Design: one thread per output slot, so neighbouring threads write
// neighbouring addresses and every store is coalesced; blockIdx.x walks the
// E*D plane of one patient, blockIdx.y walks patients.  The TPU kernel
// emitted int32 start/end planes because Mosaic lacks int64 vectors and
// padded E and D to 128-lane tiles; here the int64 id is formed in
// registers and stored once, and the ragged edge is masked, so no padding
// is written.  All id arithmetic runs on uint64, whose wraparound is
// defined and gives the same bits as the reference's two's-complement
// int64.  The packing constants repeat tspm_pairgen.cu's (each source is
// its own library, built from that file alone).
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

__global__ void delta_kernel(const int* __restrict__ phenx,
                             const int* __restrict__ date,
                             const int* __restrict__ n_old,
                             const int* __restrict__ n_new,
                             const int* __restrict__ new_phenx,
                             const int* __restrict__ new_date,
                             long long* __restrict__ seq,
                             int* __restrict__ dur,
                             uint8_t* __restrict__ mask, int P, int E, int D,
                             int codec, int fuse, int bucket_days) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;  // i * D + j
  if (r >= E * D) return;
  const int i = r / D;
  const int j = r - i * D;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    const long long out = static_cast<long long>(p) * E * D + r;
    const bool valid = i < n_old[p] + j && j < n_new[p];
    long long s = kSentinel;
    int d = 0;
    if (valid) {
      const long long row = static_cast<long long>(p) * E;
      const long long col = static_cast<long long>(p) * D;
      const uint64_t a = static_cast<uint64_t>(static_cast<long long>(max(phenx[row + i], 0)));
      const uint64_t b = static_cast<uint64_t>(static_cast<long long>(max(new_phenx[col + j], 0)));
      d = new_date[col + j] - date[row + i];
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

// codec: 0 = bit, 1 = paper.  The caller guarantees P, E, D >= 1,
// E * D < 2^31, bucket_days >= 1 and contiguous tensors of the documented
// types ([P, E] history planes, [P] cursors, [P, D] delta planes, [P, E, D]
// outputs); the launch is asynchronous on `stream`.
extern "C" int tspm_delta(const void* phenx, const void* date,
                          const void* n_old, const void* n_new,
                          const void* new_phenx, const void* new_date,
                          void* seq, void* dur, void* mask, int P, int E,
                          int D, int codec, int fuse, int bucket_days,
                          void* stream) {
  const dim3 grid((E * D + kThreads - 1) / kThreads, P < kMaxGridY ? P : kMaxGridY);
  delta_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(phenx), static_cast<const int*>(date),
      static_cast<const int*>(n_old), static_cast<const int*>(n_new),
      static_cast<const int*>(new_phenx), static_cast<const int*>(new_date),
      static_cast<long long*>(seq), static_cast<int*>(dur),
      static_cast<uint8_t*>(mask), P, E, D, codec, fuse, bucket_days);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tspm_delta_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
