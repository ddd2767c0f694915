// Blocked online-softmax attention (flash) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash.py
// (_flash_kernel, launched by flash_attention).  For q [B, Hq, Sq, D] and
// k, v [B, Hkv, Skv, D] (contiguous, float32 or bfloat16) it writes
// o [B, Hq, Sq, D] in q's type:
//
//   s[i, j] = (q[i] . k[j]) * scale
//   s       = softcap * tanh(s / softcap)        (when a softcap is given)
//   visible = (!causal || i >= j) && (!window || i - j < window)
//   o[i]    = sum_j p[i, j] v[j] / max(sum_j p[i, j], 1e-30),
//             p = visible ? exp(s - max_j s) : 0, masked s = -1e30
//
// with both indices starting at 0 (top-left alignment when Sq != Skv), so
// a row with no visible key gives 0.  Query head h reads kv head
// h / (Hq / Hkv) (GQA).  Everything after the load is float32: products,
// sums, the online softmax state and the accumulator.
//
// Bound: operations.  Each visible (query, key) pair costs 2*D FMAs
// (scores and the weighted sum of values); q, k, v and o are read or
// written once, far below the bytes the FMAs need at these head widths.
// This first kernel keeps float32 on FFMA (TF32 tensor cores would miss
// the reference's 2e-5 float32 tolerance) and bfloat16 on FFMA as well.
//
// Design: one block of 256 threads per (batch x query head, 64-row query
// tile).  The query tile and, in turn, each 64-key tile of K and V are
// staged in shared memory in their input type (rows padded by one 32-bit
// word, so the threads of a warp that read one column of sixteen rows hit
// sixteen banks); the 64 x 64 score tile is computed 4 x 4 per thread in
// registers, the row max and row sum are reduced across the sixteen
// threads of a row with shuffles, p goes through shared memory to the
// value product, and each thread keeps 4 rows x D/16 columns of the
// accumulator and the rows' (m, l) in registers.  Key tiles wholly masked
// by causality or the window are skipped (on such a tile the reference
// leaves m, l and the accumulator unchanged); ragged query rows and key
// columns are masked.  Blocks walk query tiles from the last, so the
// longest causal rows start first.  Shared memory: (64 + 2*64) padded rows
// plus the 64 x 65 float p tile, 214,016 bytes at float32 and D = 256,
// set as dynamic shared memory above the 48 KB default.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // keys of a tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kPStride = kBK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
struct Tile {
  static constexpr int kWords = D * static_cast<int>(sizeof(T)) / 4;  // 32-bit words a row
  static constexpr int kRowWords = kWords + 1;                        // padded row
  static constexpr int kStride = kRowWords * 4 / static_cast<int>(sizeof(T));  // elements
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kBQ + 2 * kBK) * kRowWords * 4 + static_cast<size_t>(kBQ) * kPStride * 4;
};

// rows [row0, row0 + kRows) of a [n_rows, D] matrix into padded shared rows,
// 32 bits at a time (coalesced); rows at or past n_rows are zero
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_rows(uint32_t* dst, const T* src, int row0, int n_rows) {
  constexpr int W = Tile<T, D>::kWords;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
    const int r = e / W;
    const int c = e - r * W;
    dst[r * Tile<T, D>::kRowWords + c] =
        row0 + r < n_rows ? s[static_cast<size_t>(row0 + r) * W + c] : 0u;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int BH, int Hq, int Hkv, int Sq, int Skv, float scale,
             int causal, int use_window, int window, int use_softcap, float softcap) {
  constexpr int S = Tile<T, D>::kStride;
  constexpr int kCols = D / 16;  // accumulator columns of a thread
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qw = smem;
  uint32_t* kw = qw + kBQ * Tile<T, D>::kRowWords;
  uint32_t* vw = kw + kBK * Tile<T, D>::kRowWords;
  float* ps = reinterpret_cast<float*>(vw + kBK * Tile<T, D>::kRowWords);
  const T* qs = reinterpret_cast<const T*>(qw);
  const T* ks = reinterpret_cast<const T*>(kw);
  const T* vs = reinterpret_cast<const T*>(vw);

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / BH)) * kBQ;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const T* qg = q + static_cast<size_t>(bh) * Sq * D;
  const T* kg = k + static_cast<size_t>(kvh) * Skv * D;
  const T* vg = v + static_cast<size_t>(kvh) * Skv * D;
  T* og = o + static_cast<size_t>(bh) * Sq * D;

  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = threadIdx.x % 16;  // key columns / value columns tx + 16*c

  load_rows<T, D, kBQ>(qw, qg, q0, Sq);

  // the keys any row of this tile can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  long long k_end = Skv;
  if (causal) k_end = min(k_end, static_cast<long long>(q_last) + 1);
  long long k_begin = 0;
  if (use_window) k_begin = max(0LL, static_cast<long long>(q0) - window + 1);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (long long kt = k_begin; kt < k_end; kt += kBK) {
    const int k0 = static_cast<int>(kt);
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D, kBK>(kw, kg, k0, Skv);
    load_rows<T, D, kBK>(vw, vg, k0, Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = to_f32(qs[(ty * 4 + r) * S + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = to_f32(ks[(tx + 16 * c) * S + d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
        if (use_softcap) x = softcap * tanhf(x / softcap);
        ok[c] = kj < Skv && (!causal || qi >= kj) &&
                (!use_window || static_cast<long long>(qi) - kj < window);
        s[r][c] = ok[c] ? x : kNegInf;
        mt = fmaxf(mt, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        ps[(ty * 4 + r) * kPStride + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // p is complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(ty * 4 + r) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = to_f32(vs[j * S + tx + 16 * c]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      og[static_cast<size_t>(qi) * D + tx + 16 * c] = from_f32<T>(acc[r][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                   int Hkv, int Sq, int Skv, float scale, int causal, int use_window,
                   int window, int use_softcap, float softcap, cudaStream_t stream) {
  constexpr size_t bytes = Tile<T, D>::kSmemBytes;
  static_assert(bytes <= 232448, "tile exceeds a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int BH = B * Hq;
  const unsigned blocks = static_cast<unsigned>(BH) * ((Sq + kBQ - 1) / kBQ);
  flash_kernel<T, D><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), BH, Hq, Hkv, Sq, Skv, scale, causal, use_window, window,
      use_softcap, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o, int B,
                     int Hq, int Hkv, int Sq, int Skv, float scale, int causal,
                     int use_window, int window, int use_softcap, float softcap,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, use_window,
                           window, use_softcap, softcap, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, use_window,
                           window, use_softcap, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, use_window,
                           window, use_softcap, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, use_window,
                            window, use_softcap, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, use_window,
                            window, use_softcap, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  The caller
// guarantees D in {16, 32, 64, 128, 256}, B*Hq*Sq >= 1, Skv >= 1, Hq a
// multiple of Hkv, B*Hq*ceil(Sq/64) < 2^31, contiguous tensors whose data
// start on a 4-byte boundary; the launch is asynchronous on `stream`.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int Hq, int Hkv, int Sq, int Skv, int D, int dtype,
                               float scale, int causal, int use_window, int window,
                               int use_softcap, float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal,
                                   use_window, window, use_softcap, softcap, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, scale,
                                             causal, use_window, window, use_softcap,
                                             softcap, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
