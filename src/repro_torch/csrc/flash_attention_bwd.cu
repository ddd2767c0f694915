// The backward of blocked attention (flash_attention.cu) for Hopper (sm_90a), on FFMA.
//
// Replaces no TPU kernel: the reference's Pallas kernel
// (src/repro/kernels/flash_attention/flash.py, _flash_kernel) has no
// backward, and jax.grad through it fails; the reference trains through
// its plain blocked softmax.  The port trains on the card through
// flash_attention.cu's routes, so their gradient is this kernel.  For the
// forward's q [B, Hq, Sq, D], k, v [B, Hkv, Skv, D], its output o and the
// output's gradient do [B, Hq, Sq, D] (contiguous, one type) it writes dq,
// dk and dv in the inputs' type:
//
//   p[i, j]  = visible ? exp(s[i, j] - lse[i]) : 0   (s after scale, softcap)
//   dv[j]    = sum_i p[i, j] do[i]
//   dp[i, j] = do[i] . v[j]
//   ds[i, j] = p[i, j] (dp[i, j] - delta[i]) * (1 - tanh^2(s_raw / cap)),
//              delta[i] = do[i] . o[i]       (the factor only with a softcap)
//   dq[i]    = scale * sum_j ds[i, j] k[j]
//   dk[j]    = scale * sum_i ds[i, j] q[i]   (over every query head of k's group)
//
// with the forward's mask (causal, window, Sq != Skv top-left aligned); a
// row that sees no key has p = 0 and gives and gets no gradient.  The plain
// version is kernels/flash_attention/ref.py::attention_bwd_ref.
//
// Bound: operations.  A visible (query, key) pair needs 10*D flops (s, dp,
// dv, dq, dk at 2*D each) and the pre-pass recomputes s once more (2*D);
// the bytes read and written (q, k, v, o, do, dq, dk, dv) are far below
// what those need at these head widths.
//
// Design: three launches on one stream, no atomics, so a gradient repeats
// bit for bit.  Every product is float32 FFMA on inputs converted from
// their type at the load; results are rounded to the inputs' type once.
//   (a) prepass_kernel: one block of 256 threads a (batch x query head,
//       64-row query tile).  It recomputes each row's log-sum-exp over the
//       keys it sees (the forward's online max and sum over 64-key tiles;
//       the forward routes do not emit it) and delta = rowsum(do * o), into
//       float32 scratch [2, B*Hq, Sq] that the wrapper allocates.  A row
//       with no visible key gets lse = +inf.
//   (b) dq_kernel: query-major, one block a (batch x query head, 64-row
//       query tile).  Q and dO tiles stay in shared memory; per key tile
//       (K and V in shared memory) each thread computes 4 x BK/16 of S and
//       of dP, forms dS, writes it to a shared tile, and adds dS K into its
//       4 rows x D/16 columns of dQ, kept in registers.
//   (c) dkv_kernel: key-major, one block a (batch x KV head, BK-key tile).
//       K and V tiles stay in shared memory; it walks the group's query
//       heads in order and, in each, the query tiles that can see its keys
//       in order (a fixed order, so the sums repeat), computing S^T and
//       dP^T (keys x queries), P^T and dS^T into shared tiles, and adding
//       P^T dO and dS^T Q into dV and dK in registers.
// Shared tiles hold rows in their input type padded by one 32-bit word, so
// the sixteen threads that read one column of sixteen rows hit sixteen
// banks (as flash_attention.cu's ffma route).  BK = 64 keys, 32 at D = 256
// (in float32 the dq kernel's Q, dO, K and V tiles of 64 keys would need
// 263 KB of shared memory; in both types the dkv kernel's dK and dV would
// take 2 x 64 registers a thread).  Largest shared memory: the dkv kernel
// at float32 D = 256, 214,528 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBQ = 64;        // query rows of a tile
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

template <int D>
constexpr int kKeyBlock = D == 256 ? 32 : 64;  // keys of a key tile

// a [rows, D] tile in shared memory, each row padded by one 32-bit word
template <typename T, int D>
struct Rows {
  static constexpr int kWords = D * static_cast<int>(sizeof(T)) / 4;
  static constexpr int kRowWords = kWords + 1;
  static constexpr int kStride = kRowWords * 4 / static_cast<int>(sizeof(T));  // elements
  static constexpr size_t bytes(int rows) { return static_cast<size_t>(rows) * kRowWords * 4; }
};

struct Mask {
  int Sq, Skv;
  float scale;
  int causal, use_window, window, use_softcap;
  float softcap;

  __device__ __forceinline__ bool visible(int i, int j) const {
    return i < Sq && j < Skv && (!causal || i >= j) &&
           (!use_window || static_cast<long long>(i) - j < window);
  }
  // the score after scale and softcap; *dcap = its derivative in the raw score
  __device__ __forceinline__ float score(float raw, float* dcap) const {
    const float x = raw * scale;
    if (!use_softcap) {
      *dcap = 1.f;
      return x;
    }
    const float t = tanhf(x / softcap);
    *dcap = 1.f - t * t;
    return softcap * t;
  }
};

// rows [row0, row0 + n) of a [n_rows, D] matrix into padded shared rows, 32
// bits at a time; rows at or past n_rows are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(uint32_t* dst, const T* src, int row0, int n,
                                          int n_rows) {
  constexpr int W = Rows<T, D>::kWords;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  for (int e = threadIdx.x; e < n * W; e += kThreads) {
    const int r = e / W;
    const int c = e - r * W;
    dst[r * Rows<T, D>::kRowWords + c] =
        row0 + r < n_rows ? s[static_cast<size_t>(row0 + r) * W + c] : 0u;
  }
}

// acc[r][c] = sum_d a[ty*R + r][d] * b[tx + 16c][d]
template <typename T, int D, int R, int C>
__device__ __forceinline__ void dot_tile(float (&acc)[R][C], const T* a, const T* b, int ty,
                                         int tx) {
  constexpr int S = Rows<T, D>::kStride;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[R], bv[C];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = to_f32(a[(ty * R + r) * S + d]);
#pragma unroll
    for (int c = 0; c < C; ++c) bv[c] = to_f32(b[(tx + 16 * c) * S + d]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// acc[r][c] += sum_{j < J} p[ty*R + r][j] * x[j][tx + 16c]   (p float, row stride P)
template <typename T, int D, int R, int J, int P>
__device__ __forceinline__ void add_product(float (&acc)[R][D / 16], const float* p, const T* x,
                                            int ty, int tx) {
  constexpr int S = Rows<T, D>::kStride;
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
    float pv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pv[r] = p[(ty * R + r) * P + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float xv = to_f32(x[j * S + tx + 16 * c]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][c] = fmaf(pv[r], xv, acc[r][c]);
    }
  }
}

// the keys [begin, end) that any row of the query tile at q0 can see
__device__ __forceinline__ void key_range(const Mask& mk, int q0, long long* begin,
                                          long long* end) {
  const int q_last = min(q0 + kBQ, mk.Sq) - 1;
  *end = mk.Skv;
  if (mk.causal) *end = min(*end, static_cast<long long>(q_last) + 1);
  *begin = 0;
  if (mk.use_window) *begin = max(0LL, static_cast<long long>(q0) - mk.window + 1);
}

// ---------------------------------------------------------------- (a) pre-pass
template <typename T, int D>
constexpr size_t prepass_smem() { return 2 * Rows<T, D>::bytes(kBQ); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prepass_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
               const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
               int BH, int Hq, int Hkv, Mask mk) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qw = smem;
  uint32_t* kw = qw + kBQ * Rows<T, D>::kRowWords;
  const T* qs = reinterpret_cast<const T*>(qw);
  const T* ks = reinterpret_cast<const T*>(kw);

  const int n_qt = (mk.Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / BH)) * kBQ;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const size_t row_base = static_cast<size_t>(bh) * mk.Sq;
  const T* kg = k + static_cast<size_t>(kvh) * mk.Skv * D;

  // delta: one warp a row, lanes over D, a fixed tree of shuffles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBQ && q0 + r < mk.Sq; r += kThreads / 32) {
    const size_t off = (row_base + q0 + r) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(dout[off + d]), to_f32(o[off + d]), acc);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) delta[row_base + q0 + r] = acc;
  }

  load_rows<T, D>(qw, q + row_base * D, q0, kBQ, mk.Sq);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  long long k_begin, k_end;
  key_range(mk, q0, &k_begin, &k_end);
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  for (long long kt = k_begin; kt < k_end; kt += 64) {
    const int k0 = static_cast<int>(kt);
    __syncthreads();
    load_rows<T, D>(kw, kg, k0, 64, mk.Skv);
    __syncthreads();
    float s[4][4];
    dot_tile<T, D, 4, 4>(s, qs, ks, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float dcap;
        const float x = mk.score(s[r][c], &dcap);
        ok[c] = mk.visible(qi, k0 + tx + 16 * c);
        s[r][c] = ok[c] ? x : kNegInf;
        mt = fmaxf(mt, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += ok[c] ? expf(s[r][c] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = expf(m[r] - m_new) * l[r] + sum;
      m[r] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
      if (qi < mk.Sq) lse[row_base + qi] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    }
  }
}

// ---------------------------------------------------------------- (b) dq
template <typename T, int D>
constexpr size_t dq_smem() {
  constexpr int BK = kKeyBlock<D>;
  return 2 * Rows<T, D>::bytes(kBQ) + 2 * Rows<T, D>::bytes(BK) +
         static_cast<size_t>(kBQ) * (BK + 1) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int BH, int Hq, int Hkv, Mask mk) {
  constexpr int BK = kKeyBlock<D>;
  constexpr int CK = BK / 16;
  constexpr int RW = Rows<T, D>::kRowWords;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qw = smem;
  uint32_t* dow = qw + kBQ * RW;
  uint32_t* kw = dow + kBQ * RW;
  uint32_t* vw = kw + BK * RW;
  float* ds_s = reinterpret_cast<float*>(vw + BK * RW);
  const T* qs = reinterpret_cast<const T*>(qw);
  const T* dos = reinterpret_cast<const T*>(dow);
  const T* ks = reinterpret_cast<const T*>(kw);
  const T* vs = reinterpret_cast<const T*>(vw);

  const int n_qt = (mk.Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / BH)) * kBQ;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const size_t row_base = static_cast<size_t>(bh) * mk.Sq;
  const T* kg = k + static_cast<size_t>(kvh) * mk.Skv * D;
  const T* vg = v + static_cast<size_t>(kvh) * mk.Skv * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<T, D>(qw, q + row_base * D, q0, kBQ, mk.Sq);
  load_rows<T, D>(dow, dout + row_base * D, q0, kBQ, mk.Sq);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    row_lse[r] = qi < mk.Sq ? lse[row_base + qi] : INFINITY;
    row_delta[r] = qi < mk.Sq ? delta[row_base + qi] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;

  long long k_begin, k_end;
  key_range(mk, q0, &k_begin, &k_end);
  k_begin = k_begin / BK * BK;
  for (long long kt = k_begin; kt < k_end; kt += BK) {
    const int k0 = static_cast<int>(kt);
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(kw, kg, k0, BK, mk.Skv);
    load_rows<T, D>(vw, vg, k0, BK, mk.Skv);
    __syncthreads();
    float s[4][CK], dp[4][CK];
    dot_tile<T, D, 4, CK>(s, qs, ks, ty, tx);
    dot_tile<T, D, 4, CK>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kj = k0 + tx + 16 * c;
        float dcap;
        const float x = mk.score(s[r][c], &dcap);
        const float p = mk.visible(qi, kj) ? expf(x - row_lse[r]) : 0.f;
        ds_s[(ty * 4 + r) * (BK + 1) + tx + 16 * c] = p * (dp[r][c] - row_delta[r]) * dcap;
      }
    }
    __syncthreads();  // dS is complete
    add_product<T, D, 4, BK, BK + 1>(acc, ds_s, ks, ty, tx);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= mk.Sq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      dq[(row_base + qi) * D + tx + 16 * c] = from_f32<T>(acc[r][c] * mk.scale);
  }
}

// ---------------------------------------------------------------- (c) dk, dv
template <typename T, int D>
constexpr size_t dkv_smem() {
  constexpr int BK = kKeyBlock<D>;
  return 2 * Rows<T, D>::bytes(BK) + 2 * Rows<T, D>::bytes(kBQ) +
         2 * static_cast<size_t>(BK) * (kBQ + 1) * 4 + 2 * kBQ * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int BHkv,
           int Hq, int Hkv, Mask mk) {
  constexpr int BK = kKeyBlock<D>;
  constexpr int R = BK / 16;  // key rows of a thread
  constexpr int RW = Rows<T, D>::kRowWords;
  constexpr int PS = kBQ + 1;  // row stride of the P^T and dS^T tiles
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* kw = smem;
  uint32_t* vw = kw + BK * RW;
  uint32_t* qw = vw + BK * RW;
  uint32_t* dow = qw + kBQ * RW;
  float* p_s = reinterpret_cast<float*>(dow + kBQ * RW);
  float* ds_s = p_s + BK * PS;
  float* lse_s = ds_s + BK * PS;
  float* delta_s = lse_s + kBQ;
  const T* ks = reinterpret_cast<const T*>(kw);
  const T* vs = reinterpret_cast<const T*>(vw);
  const T* qs = reinterpret_cast<const T*>(qw);
  const T* dos = reinterpret_cast<const T*>(dow);

  const int bkv = blockIdx.x % BHkv;  // b * Hkv + kv head
  const int k0 = static_cast<int>(blockIdx.x / BHkv) * BK;
  const int G = Hq / Hkv;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const size_t kv_base = static_cast<size_t>(bkv) * mk.Skv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<T, D>(kw, k + kv_base * D, k0, BK, mk.Skv);
  load_rows<T, D>(vw, v + kv_base * D, k0, BK, mk.Skv);
  float acc_k[R][D / 16], acc_v[R][D / 16];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  // the query tiles that can see keys [k0, k0 + BK)
  const int k_last = min(k0 + BK, mk.Skv) - 1;
  const int q_begin = mk.causal ? k0 / kBQ * kBQ : 0;
  long long q_end = mk.Sq;
  if (mk.use_window) q_end = min(q_end, static_cast<long long>(k_last) + mk.window);

  for (int g = 0; g < G; ++g) {
    const size_t row_base = (static_cast<size_t>(b) * Hq + kvh * G + g) * mk.Sq;
    for (long long qt = q_begin; qt < q_end; qt += kBQ) {
      const int q0 = static_cast<int>(qt);
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, D>(qw, q + row_base * D, q0, kBQ, mk.Sq);
      load_rows<T, D>(dow, dout + row_base * D, q0, kBQ, mk.Sq);
      if (threadIdx.x < kBQ) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < mk.Sq ? lse[row_base + qi] : INFINITY;
        delta_s[threadIdx.x] = qi < mk.Sq ? delta[row_base + qi] : 0.f;
      }
      __syncthreads();
      float st[R][4], dpt[R][4];
      dot_tile<T, D, R, 4>(st, ks, qs, ty, tx);
      dot_tile<T, D, R, 4>(dpt, vs, dos, ty, tx);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int kj = k0 + ty * R + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          float dcap;
          const float x = mk.score(st[r][c], &dcap);
          const float p = mk.visible(q0 + col, kj) ? expf(x - lse_s[col]) : 0.f;
          p_s[(ty * R + r) * PS + col] = p;
          ds_s[(ty * R + r) * PS + col] = p * (dpt[r][c] - delta_s[col]) * dcap;
        }
      }
      __syncthreads();  // P^T and dS^T are complete
      add_product<T, D, R, kBQ, PS>(acc_v, p_s, dos, ty, tx);
      add_product<T, D, R, kBQ, PS>(acc_k, ds_s, qs, ty, tx);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = k0 + ty * R + r;
    if (kj >= mk.Skv) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const size_t off = (kv_base + kj) * D + tx + 16 * c;
      dk[off] = from_f32<T>(acc_k[r][c] * mk.scale);
      dv[off] = from_f32<T>(acc_v[r][c]);
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, float* scratch, int B, int Hq, int Hkv,
                   const Mask& mk, cudaStream_t stream) {
  constexpr size_t a = prepass_smem<T, D>(), b = dq_smem<T, D>(), c = dkv_smem<T, D>();
  static_assert(a <= 232448 && b <= 232448 && c <= 232448,
                "tiles exceed a block's shared memory");
  cudaError_t err;
  if ((err = allow_smem(prepass_kernel<T, D>, a)) != cudaSuccess) return err;
  if ((err = allow_smem(dq_kernel<T, D>, b)) != cudaSuccess) return err;
  if ((err = allow_smem(dkv_kernel<T, D>, c)) != cudaSuccess) return err;
  const int BH = B * Hq, BHkv = B * Hkv;
  const size_t rows = static_cast<size_t>(BH) * mk.Sq;
  float* lse = scratch;
  float* delta = scratch + rows;
  const unsigned q_blocks = static_cast<unsigned>(BH) * ((mk.Sq + kBQ - 1) / kBQ);
  const unsigned k_blocks =
      static_cast<unsigned>(BHkv) * ((mk.Skv + kKeyBlock<D> - 1) / kKeyBlock<D>);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  prepass_kernel<T, D><<<q_blocks, kThreads, a, stream>>>(qt, kt, static_cast<const T*>(o), dot,
                                                          lse, delta, BH, Hq, Hkv, mk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<T, D><<<q_blocks, kThreads, b, stream>>>(qt, kt, vt, dot, lse, delta,
                                                     static_cast<T*>(dq), BH, Hq, Hkv, mk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<T, D><<<k_blocks, kThreads, c, stream>>>(qt, kt, vt, dot, lse, delta,
                                                      static_cast<T*>(dk), static_cast<T*>(dv),
                                                      BHkv, Hq, Hkv, mk);
  return cudaGetLastError();
}

// registers, local (spill) bytes and dynamic shared memory of kernel `which`
// (0 pre-pass, 1 dq, 2 dkv), and the key rows of its tile
template <typename T, int D>
cudaError_t info(int which, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = which == 0   ? cudaFuncGetAttributes(&attr, prepass_kernel<T, D>)
                    : which == 1 ? cudaFuncGetAttributes(&attr, dq_kernel<T, D>)
                                 : cudaFuncGetAttributes(&attr, dkv_kernel<T, D>);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(which == 0   ? prepass_smem<T, D>()
                            : which == 1 ? dq_smem<T, D>()
                                         : dkv_smem<T, D>());
  out[3] = which == 0 ? 64 : kKeyBlock<D>;
  return cudaSuccess;
}

template <typename T, typename F>
cudaError_t by_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
  }
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t by_type(int dtype, int D, F&& f) {
  if (dtype == 0) return by_dim<float>(D, [&](auto d) { return f(float{}, d); });
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, [&](auto d) { return f(__nv_bfloat16{}, d); });
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv alike); D in
// {16, 32, 64, 128, 256}.  `scratch` holds 2*B*Hq*Sq floats on the device.
// The caller guarantees B*Hq*Sq >= 1, Skv >= 1, Hq a multiple of Hkv,
// B*Hq*ceil(Sq/64) and B*Hkv*ceil(Skv/32) below 2^31, contiguous tensors
// whose data start on a 4-byte boundary; the three launches are
// asynchronous on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* scratch,
                                   int B, int Hq, int Hkv, int Sq, int Skv, int D, int dtype,
                                   float scale, int causal, int use_window, int window,
                                   int use_softcap, float softcap, void* stream) {
  const Mask mk{Sq, Skv, scale, causal, use_window, window, use_softcap, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_type(dtype, D, [&](auto t, auto d) {
    using T = decltype(t);
    return launch<T, decltype(d)::value>(q, k, v, o, dout, dq, dk, dv,
                                         static_cast<float*>(scratch), B, Hq, Hkv, mk, s);
  }));
}

// out[0..3]: registers a thread, local (spill) bytes, dynamic shared memory
// and key rows of a tile of kernel `which` (0 pre-pass, 1 dq, 2 dkv) at
// (dtype, D)
extern "C" int flash_attention_bwd_info(int dtype, int D, int which, int* out) {
  return static_cast<int>(by_type(dtype, D, [&](auto t, auto d) {
    using T = decltype(t);
    return info<T, decltype(d)::value>(which, out);
  }));
}

extern "C" const char* flash_attention_bwd_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
