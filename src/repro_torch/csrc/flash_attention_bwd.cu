// The backward of blocked attention (flash_attention.cu) for Hopper (sm_90a), two routes.
//
// Replaces no TPU kernel: the reference's Pallas kernel
// (src/repro/kernels/flash_attention/flash.py, _flash_kernel) has no
// backward, and jax.grad through it fails; the reference trains through
// its plain blocked softmax.  The port trains on the card through
// flash_attention.cu's routes, so their gradient is this file.  For the
// forward's q [B, Hq, Sq, D], k, v [B, Hkv, Skv, D], its output o, its
// log-sum-exp lse [B, Hq, Sq] (float32, natural log, +inf for a row that
// sees no key; every forward route writes it when asked) and the output's
// gradient do [B, Hq, Sq, D] (contiguous, one type) it writes dq, dk and
// dv in the inputs' type:
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
// version is kernels/flash_attention/ref.py::attention_bwd_ref.  Which
// route runs follows (dtype, D) alone (ops.bwd_route); neither falls back
// to the other, and neither uses atomics, so a gradient repeats bit for bit.
//
// Bound: operations.  A visible (query, key) pair needs 10*D flops (s, dp,
// dv, dq, dk at 2*D each); the bytes read and written (q, k, v, o, do,
// lse, dq, dk, dv) are far below what those need at these head widths.
//
// Both routes first run prepass_kernel (one warp a row): delta =
// rowsum(do * o) into float32 scratch the wrapper allocates (bytes only).
//
// ---- Route "ffma" (flash_attention_bwd): float32 at every D, bfloat16 at D 16, 32
//
// Every product is float32 FFMA on inputs converted from their type at the
// load; results are rounded to the inputs' type once.  Two launches after
// the pre-pass, which read the forward's lse as it is:
//   dq_kernel: query-major, one block of 256 threads a (batch x query head,
//     64-row query tile).  Q and dO tiles stay in shared memory; per key
//     tile (K and V in shared memory) each thread computes 4 x BK/16 of S
//     and of dP, forms dS, writes it to a shared tile, and adds dS K into
//     its 4 rows x D/16 columns of dQ, kept in registers.
//   dkv_kernel: key-major, one block a (batch x KV head, BK-key tile).  K
//     and V tiles stay in shared memory; it walks the group's query heads
//     in order and, in each, the query tiles that can see its keys in
//     order (a fixed order, so the sums repeat), computing S^T and dP^T
//     (keys x queries), P^T and dS^T into shared tiles, and adding P^T dO
//     and dS^T Q into dV and dK in registers.
// Shared tiles hold rows in their input type padded by one 32-bit word, so
// the sixteen threads that read one column of sixteen rows hit sixteen
// banks (as flash_attention.cu's ffma route).  BK = 64 keys, 32 at D = 256
// (in float32 the dq kernel's Q, dO, K and V tiles of 64 keys would need
// 263 KB of shared memory; the dkv kernel's dK and dV would take 2 x 64
// registers a thread).  At float32 D = 160 BK stays 64: the dq kernel's
// tiles take 181,504 bytes, the dkv kernel's 198,656, and dK and dV 2 x 40
// registers a thread.  Largest shared memory: the dkv kernel at float32
// D = 256, 214,528 bytes.
//
// ---- Route "wgmma" (flash_attention_bwd_wgmma): bfloat16 at D 64, 128, 160, 256
//
// Its bound is the bf16 tensor-core rate (989 TFLOP/s dense on an H100
// SXM).  The forward's skeleton (flash_attention.cu, run_cta) with other
// operands: one launch of 384-thread CTAs, each a producer warpgroup whose
// one thread issues every copy and two consumer warpgroups of 64 resident
// rows (setmaxnreg 24 / 240).  A CTA keeps a 128-row resident tile of two
// matrices R1, R2 in shared memory and streams BN-row tiles of two more,
// T1 and T2, through a TMA ring of STAGES stages (a T1-full, a T2-full and
// an empty mbarrier each).  Per streamed tile whose rows its rows can see,
// a consumer
//   1. issues X = R1 T1^T and Y = R2 T2^T (SS wgmmas, both K-major, fp32
//      accumulators of BN columns),
//   2. forms, in the accumulator layout, p = ex2(x' - lse2), x' the score
//      after scale and softcap in log2 units (the forward's), masked on
//      tiles that cut a boundary only, and F = p (y - delta) dcap (or F =
//      p),
//   3. splits F into bf16 hi + lo A-fragments in registers (the hazard
//      below) and issues acc += F_hi T + F_lo T, T read MN-major (as the
//      forward reads V), then releases the stage.
// The grid holds three passes, heaviest first, each CTA one of them:
//   dK: resident K, V of 128 keys of a kv head; streams Q, dO of each query
//       head of its group in order and of each query tile that sees its
//       keys in order, with those rows' lse2 and delta (1-D bulk copies on
//       the T1 barrier); X = S^T, Y = dP^T, F = dS^T, T = Q.
//   dV: the same, without V and Y; F = P^T, T = dO.
//   dQ: resident Q, dO of 128 queries of a head; streams K, V of the keys
//       its rows see; X = S, Y = dP, F = dS, T = K; lse2 and delta of its
//       two rows in registers.
// Seven products a pair (S and dP twice, S^T once more for dV, and dQ, dK,
// dV) plus the three lo terms: 22*D flops a visible pair against the
// bound's 10*D.
// Hazards, and what the design does about each:
//  1. The register budget at D = 256.  dK and dV of 64 keys x 256 columns
//     in fp32 would be 256 registers a thread; the key-major work is two
//     passes (dK, dV) of one accumulator each, D/2 registers (128 at D =
//     256) beside X, Y (BN/2 each) and the fragments.
//  2. F in bf16.  One bf16 rounding of P^T, dS or dS^T costs 2^-9 relative
//     a term and breaks ref.attention_bwd_limit (16 x the float32 plain
//     version's error + 2^-8 |want|) by 30-100x at gemma2-2b's shape
//     (tests/test_torch_flash.py emulates it); hi = bf16(f), lo = bf16(f -
//     hi) holds it.  Q, K, V and dO are bf16 inputs and enter exactly.
//  3. The log-sum-exp.  The pre-pass writes lse2 = lse * log2(e) beside
//     delta in rows padded to a multiple of 64 (+inf and 0 past Sq), so a
//     streamed tile's scalars are one aligned bulk copy each; a row that
//     sees no key has lse2 = +inf and p = 0 without a mask.
//  4. Shared memory.  At D = 256 the resident tiles take 128 KB, so the
//     stream tile is BN = 32 rows (3 stages of 32 KB: 231,248 bytes with
//     the scalars, barriers and alignment slack); BN = 64 at D <= 128.
//     At D = 160 (hazard 7) rows are 192 columns in shared memory: the
//     resident tiles take 96 KB, and BN = 64 at 3 stages (144 KB more)
//     would not fit.  BN = 32 at 3 stages (72 KB; 173,904 bytes in all)
//     is D = 256's ring, the one proven at the widest rows; BN = 64 at 2
//     stages (~197 KB) would leave the producer one tile ahead and put X,
//     Y and F's fragments (32 registers each) beside the accumulator's 96.
//     Resident tiles are loaded as 128/BN boxes of BN rows (one map a
//     tensor, box BN rows x 128 B); with 1024-aligned boxes the swizzle is
//     that of one 128-row box.
//  5. Ragged lengths: the 3-D maps zero-fill rows past Sq or Skv; masks
//     still cover those columns, and rows past them are never stored.
//  6. As the forward (its hazard 6): no __trap() (ptxas would hold the
//     consumers to the entry's 168 registers and spill), barrier waits do
//     not time out, tanhf (not tanh.approx) for the softcap and its
//     derivative, ex2.approx for the exponent.
//  7. D = 160 (zamba2-2.7b's shared attention), as the forward's hazard 7:
//     D / 64 = 2 boxes would drop columns 128-159, so a row takes three
//     64-column boxes (BwdLayout::kPadD = 192), the third copied from
//     column 128 with the map's OOB fill zeroing columns 160-191 (a box's
//     transaction bytes count the fill, so kResBytes and kTileBytes are
//     whole boxes).  X and Y run D/16 = 10 k-steps and never read the
//     zeros.  acc += F T runs at N = 192 (m64n192k16, T MN-major across
//     three whole boxes, LBO one box, as at D = 128 and 256): the
//     accumulator is 96 floats a consumer thread, beside X, Y and F's
//     fragments of 16 each at BN = 32; its columns 160-191 are products
//     with zeros and are never stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBQ = 64;        // query rows of a tile

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

// the score after scale and softcap; *dcap = its derivative in the raw score
__device__ __forceinline__ float softcapped(const Mask& mk, float raw, float* dcap) {
  const float x = raw * mk.scale;
  if (!mk.use_softcap) {
    *dcap = 1.f;
    return x;
  }
  const float t = tanhf(x / mk.softcap);
  *dcap = 1.f - t * t;
  return mk.softcap * t;
}

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

// ---------------------------------------------------------------- pre-pass

constexpr int kPrepassWarps = 8;

// One warp a row r of each of the BH planes, rows 0 .. ld - 1: delta[plane
// * ld + r] = do[r] . o[r] (lanes over D, a fixed tree of shuffles) and,
// given lse_out, lse_out[plane * ld + r] = lse[plane * Sq + r] * lse_scale;
// rows r >= Sq get delta 0 and lse_out +inf.
template <typename T, int D>
__global__ void __launch_bounds__(kPrepassWarps * 32)
prepass_kernel(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ lse_out, float* __restrict__ delta, int BH, int Sq, int ld,
               float lse_scale) {
  const long long row = static_cast<long long>(blockIdx.x) * kPrepassWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long plane = row / ld;
  const int r = static_cast<int>(row - plane * ld);
  if (plane >= BH) return;
  float acc = 0.f;
  if (r < Sq) {
    const size_t off = (static_cast<size_t>(plane) * Sq + r) * D;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(dout[off + d]), to_f32(o[off + d]), acc);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    delta[row] = acc;
    if (lse_out != nullptr)
      lse_out[row] = r < Sq ? lse[static_cast<size_t>(plane) * Sq + r] * lse_scale : INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch_prepass(const void* o, const void* dout, const float* lse, float* lse_out,
                           float* delta, int BH, int Sq, int ld, float lse_scale,
                           cudaStream_t stream) {
  const long long rows = static_cast<long long>(BH) * ld;
  const unsigned blocks = static_cast<unsigned>((rows + kPrepassWarps - 1) / kPrepassWarps);
  prepass_kernel<T, D><<<blocks, kPrepassWarps * 32, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, lse_out, delta, BH, Sq, ld,
      lse_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- (b) dq
template <typename T, int D>
constexpr size_t dq_smem() {
  constexpr int BK = kKeyBlock<D>;
  return 2 * Rows<T, D>::bytes(kBQ) + 2 * Rows<T, D>::bytes(BK) +
         static_cast<size_t>(kBQ) * (BK + 1) * 4;
}

// blocks an SM the dq kernel's registers are sized for: two (128
// registers a thread, what ptxas chose unasked) up to D 128; one from D
// 160, where 128 registers spilled 16 bytes (float32 D 160 and 256) and
// the tiles' shared memory leaves room for one block anyway
template <int D>
constexpr int kDqMinBlocks = D >= 160 ? 1 : 2;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kDqMinBlocks<D>)
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

  const KeyBand band = key_band(mk, q0, min(q0 + kBQ, mk.Sq) - 1);
  const long long k_begin = band.begin / BK * BK, k_end = band.end;
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
        const float x = softcapped(mk, s[r][c], &dcap);
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
          const float x = softcapped(mk, st[r][c], &dcap);
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

// ---------------------------------------------------------------- ffma launch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_ffma(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, void* dq, void* dk, void* dv,
                        float* delta, int B, int Hq, int Hkv, const Mask& mk,
                        cudaStream_t stream) {
  constexpr size_t b = dq_smem<T, D>(), c = dkv_smem<T, D>();
  static_assert(b <= 232448 && c <= 232448, "tiles exceed a block's shared memory");
  cudaError_t err;
  if ((err = allow_smem(dq_kernel<T, D>, b)) != cudaSuccess) return err;
  if ((err = allow_smem(dkv_kernel<T, D>, c)) != cudaSuccess) return err;
  const int BH = B * Hq, BHkv = B * Hkv;
  if ((err = launch_prepass<T, D>(o, dout, lse, nullptr, delta, BH, mk.Sq, mk.Sq, 1.f,
                                  stream)) != cudaSuccess)
    return err;
  const unsigned q_blocks = static_cast<unsigned>(BH) * ((mk.Sq + kBQ - 1) / kBQ);
  const unsigned k_blocks =
      static_cast<unsigned>(BHkv) * ((mk.Skv + kKeyBlock<D> - 1) / kKeyBlock<D>);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  dq_kernel<T, D><<<q_blocks, kThreads, b, stream>>>(qt, kt, vt, dot, lse, delta,
                                                     static_cast<T*>(dq), BH, Hq, Hkv, mk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<T, D><<<k_blocks, kThreads, c, stream>>>(qt, kt, vt, dot, lse, delta,
                                                      static_cast<T*>(dk), static_cast<T*>(dv),
                                                      BHkv, Hq, Hkv, mk);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma route

constexpr int kWgRows = 128;     // resident rows of a CTA: two consumer warpgroups x 64
constexpr int kWgThreads = 384;  // warpgroups 0, 1 compute; warpgroup 2 loads
constexpr int kLseRows = 64;     // the scratch's rows are padded to a multiple of this

// the three passes of the grid, in launch order (heaviest first)
enum Pass : int { kDK = 0, kDV = 1, kDQ = 2 };

// Shared memory of a CTA, from a 1024-byte aligned base: R1 and R2 (kBoxes
// boxes of 128 rows x 128 B each), then STAGES x (T1, T2) (kBoxes boxes of BN
// rows x 128 B each), then STAGES x (lse2, delta) of BN floats each, then
// the barriers.
template <int D>
struct BwdLayout {
  static constexpr int BN = D > 128 ? 32 : 64;  // rows of a streamed tile (hazard 4)
  static constexpr int STAGES = 3;
  static constexpr int kPadD = (D + 63) / 64 * 64;  // D in whole 64-column boxes (hazard 7)
  static constexpr int kBoxes = kPadD / 64;
  static constexpr uint32_t kResBytes = kWgRows * kPadD * 2;
  static constexpr uint32_t kTileBytes = BN * kPadD * 2;
  static constexpr uint32_t kScalBytes = 2 * BN * 4;
  static constexpr uint32_t kR1 = 0;
  static constexpr uint32_t kR2 = kResBytes;
  static constexpr uint32_t kT = 2 * kResBytes;  // stage s: T1 at kT + 2 s kTileBytes, T2 next
  static constexpr uint32_t kScal = kT + STAGES * 2 * kTileBytes;
  static constexpr uint32_t kBar = kScal + STAGES * kScalBytes;
  static constexpr size_t kSmemBytes = kBar + Ring<STAGES>::kBytes + 1024;  // + alignment slack
};

struct BwdArgs {
  const float* lse2;    // [B*Hq, ld]: lse * log2(e), +inf past Sq
  const float* delta;   // [B*Hq, ld]: rowsum(do * o), 0 past Sq
  __nv_bfloat16 *dq, *dk, *dv;
  int BH, BHkv, Hq, Hkv, ld;
  int key_ctas;         // CTAs of the dK pass, and of the dV pass
};

// One CTA of pass PASS (its index `cta` within the pass); `base` and `smem`
// are the aligned shared memory as an address and a pointer.
template <int D, int PASS>
__device__ __forceinline__ void run_bwd(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                        const CUtensorMap* map_v, const CUtensorMap* map_do,
                                        const BwdArgs& a, const Mask& mk, int cta,
                                        uint32_t base, const uint8_t* smem) {
  using L = BwdLayout<D>;
  constexpr int BN = L::BN, STAGES = L::STAGES;
  constexpr bool kKeyMajor = PASS != kDQ;  // resident keys, streamed queries
  constexpr bool kHasY = PASS != kDV;      // Y = R2 T2^T (dP or dP^T) and R2 itself
  const Ring<STAGES> ring{base + L::kBar};
  const int G = a.Hq / a.Hkv;
  const CUtensorMap* r1_map = kKeyMajor ? map_k : map_q;
  const CUtensorMap* r2_map = kKeyMajor ? map_v : map_do;
  const CUtensorMap* t1_map = kKeyMajor ? map_q : map_k;
  const CUtensorMap* t2_map = kKeyMajor ? map_do : map_v;

  // the resident tile: rows res0 .. res0 + 127 of plane res_plane (n_res
  // rows); the stream: tiles of BN rows from sb up to se in each of
  // n_planes planes from plane0
  int res_plane, res0, n_res, plane0, n_planes;
  long long sb, se;
  if (kKeyMajor) {
    res_plane = cta % a.BHkv;
    res0 = (cta / a.BHkv) * kWgRows;
    n_res = mk.Skv;
    plane0 = (res_plane / a.Hkv) * a.Hq + (res_plane % a.Hkv) * G;
    n_planes = G;
    sb = mk.causal ? res0 : 0;
    se = mk.Sq;
    if (mk.use_window)
      se = min(se, static_cast<long long>(min(res0 + kWgRows, mk.Skv) - 1) + mk.window);
  } else {
    const int n_qt = (mk.Sq + kWgRows - 1) / kWgRows;
    res_plane = cta % a.BH;
    res0 = (n_qt - 1 - cta / a.BH) * kWgRows;  // the longest causal rows first
    n_res = mk.Sq;
    plane0 = (res_plane / a.Hq) * a.Hkv + (res_plane % a.Hq) / G;
    n_planes = 1;
    const KeyBand kb = key_band(mk, res0, min(res0 + kWgRows, mk.Sq) - 1);
    sb = kb.begin;
    se = kb.end;
  }
  const int per_plane = se > sb ? static_cast<int>((se - sb + BN - 1) / BN) : 0;
  const int n_tiles = n_planes * per_plane;
  // tile t: plane, first row
  auto tile = [&](int t, int* plane, int* row0) {
    *plane = plane0 + t / per_plane;
    *row0 = static_cast<int>(sb + static_cast<long long>(t % per_plane) * BN);
  };

  if (threadIdx.x >= 2 * 128) {
    // ---- producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128 && n_tiles > 0) {
      mbar_expect_tx(ring.q, (kHasY ? 2 : 1) * L::kResBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        for (int r = 0; r < kWgRows / BN; ++r) {
          const uint32_t at = c * kWgRows * 128 + r * BN * 128;
          tma_load_3d(base + L::kR1 + at, r1_map, ring.q, 64 * c, res0 + r * BN, res_plane);
          if (kHasY)
            tma_load_3d(base + L::kR2 + at, r2_map, ring.q, 64 * c, res0 + r * BN, res_plane);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int round = t / STAGES;
        if (round > 0) mbar_wait(ring.empty(s), (round - 1) & 1);
        int plane, row0;
        tile(t, &plane, &row0);
        const uint32_t t1 = base + L::kT + s * 2 * L::kTileBytes;
        mbar_expect_tx(ring.k_full(s), L::kTileBytes + (kKeyMajor ? L::kScalBytes : 0));
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_3d(t1 + c * BN * 128, t1_map, ring.k_full(s), 64 * c, row0, plane);
        if (kKeyMajor) {
          const size_t at = static_cast<size_t>(plane) * a.ld + row0;
          const uint32_t sc = base + L::kScal + s * L::kScalBytes;
          bulk_load(sc, a.lse2 + at, BN * 4, ring.k_full(s));
          bulk_load(sc + BN * 4, a.delta + at, BN * 4, ring.k_full(s));
        }
        mbar_expect_tx(ring.v_full(s), L::kTileBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_3d(t1 + L::kTileBytes + c * BN * 128, t2_map, ring.v_full(s), 64 * c, row0,
                      plane);
      }
    }
    return;
  }

  // ---- consumer warpgroup cw: resident rows w0 .. w0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int w0 = res0 + 64 * cw;
  const int w_last = min(w0 + 63, n_res - 1);
  const int r0 = w0 + 16 * (tid / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;
  const int c2 = 2 * (lane % 4);                     // and columns c2, c2 + 1 of each 8
  // the streamed rows that this warpgroup's rows can see: [cb, ce)
  long long cb, ce;
  if (kKeyMajor) {
    cb = mk.causal ? w0 : 0;
    ce = mk.Sq;
    if (mk.use_window) ce = min(ce, static_cast<long long>(w_last) + mk.window);
  } else {
    const KeyBand kb = key_band(mk, w0, w_last);
    cb = kb.begin;
    ce = kb.end;
  }
  // dQ: the two rows' lse2 and delta (key-major passes read theirs per tile)
  float lse_r0 = INFINITY, lse_r1 = INFINITY, dl_r0 = 0.f, dl_r1 = 0.f;
  if (!kKeyMajor) {
    const size_t row = static_cast<size_t>(res_plane) * a.ld;
    if (r0 < mk.Sq) {
      lse_r0 = a.lse2[row + r0];
      dl_r0 = a.delta[row + r0];
    }
    if (r1 < mk.Sq) {
      lse_r1 = a.lse2[row + r1];
      dl_r1 = a.delta[row + r1];
    }
  }
  // scores in log2 units, as the forward's: s * scale * log2(e), or, with
  // a softcap, softcap * log2(e) * tanh(s * scale / softcap)
  const float pre = mk.use_softcap ? mk.scale / mk.softcap : mk.scale * kLog2e;
  const float post = mk.softcap * kLog2e;
  const uint32_t r1_tile = base + L::kR1 + cw * 64 * 128;  // this warpgroup's 64 rows
  const uint32_t r2_tile = base + L::kR2 + cw * 64 * 128;

  constexpr int DA = L::kPadD;  // the accumulator's columns: D in whole boxes
  float acc[DA / 2];
#pragma unroll
  for (int i = 0; i < DA / 2; ++i) acc[i] = 0.f;

  if (n_tiles > 0) mbar_wait(ring.q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    int plane, row0;
    tile(t, &plane, &row0);
    const uint32_t t1 = base + L::kT + s * 2 * L::kTileBytes;
    const uint32_t t2 = t1 + L::kTileBytes;
    mbar_wait(ring.k_full(s), parity);
    const bool active = w0 <= w_last && row0 < ce && row0 + BN > cb;
    if (active) {
      float x[BN / 2], y[kHasY ? BN / 2 : 1];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<BN>(x, desc_sw128(r1_tile + (kk / 4) * kWgRows * 128 + off, 16, 1024),
                     desc_sw128(t1 + (kk / 4) * BN * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      mbar_wait(ring.v_full(s), parity);
      if constexpr (kHasY) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss<BN>(y, desc_sw128(r2_tile + (kk / 4) * kWgRows * 128 + off, 16, 1024),
                       desc_sw128(t2 + (kk / 4) * BN * 128 + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
      }
      wgmma_wait_all();
      fence_regs(x);
      if constexpr (kHasY) fence_regs(y);

      // does any (row, streamed row) of this tile fall outside the visible band?
      const bool edge =
          kKeyMajor ? row0 + BN > mk.Sq || (mk.causal && row0 < w_last) ||
                          (mk.use_window &&
                           static_cast<long long>(row0) + BN - 1 - w0 >= mk.window)
                    : row0 + BN > mk.Skv || (mk.causal && row0 + BN - 1 > w0) ||
                          (mk.use_window && static_cast<long long>(w_last) - row0 >= mk.window);
      const float* scal = reinterpret_cast<const float*>(smem + L::kScal + s * L::kScalBytes);
#pragma unroll
      for (int g = 0; g < BN / 8; ++g) {
        float2 lcol = make_float2(0.f, 0.f), dcol = make_float2(0.f, 0.f);
        if (kKeyMajor) {
          lcol = *reinterpret_cast<const float2*>(scal + 8 * g + c2);
          dcol = *reinterpret_cast<const float2*>(scal + BN + 8 * g + c2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * g + e;
          const int row = (e & 2) ? r1 : r0;
          const int col = row0 + 8 * g + c2 + (e & 1);
          const float l2 = kKeyMajor ? ((e & 1) ? lcol.y : lcol.x) : ((e & 2) ? lse_r1 : lse_r0);
          float u = x[i] * pre, dcap = 1.f;
          if (mk.use_softcap) {
            const float th = tanhf(u);
            u = post * th;
            dcap = 1.f - th * th;
          }
          float p = exp2_approx(u - l2);
          if (edge && !(kKeyMajor ? mk.visible(col, row) : mk.visible(row, col))) p = 0.f;
          if constexpr (kHasY) {
            const float dl = kKeyMajor ? ((e & 1) ? dcol.y : dcol.x) : ((e & 2) ? dl_r1 : dl_r0);
            x[i] = p * (y[i] - dl) * dcap;
          } else {
            x[i] = p;
          }
        }
      }
      // F as bf16 hi + lo A-fragments: fragment kk covers streamed rows
      // 16kk .. 16kk + 15 (hazard 2)
      uint32_t f_hi[BN / 16][4], f_lo[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u = x[8 * kk + 2 * e], w = x[8 * kk + 2 * e + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(u, w);
          f_hi[kk][e] = bf16x2_bits(hi);
          f_lo[kk][e] = bf16x2_bits(__floats2bfloat162_rn(u - __low2float(hi),
                                                          w - __high2float(hi)));
        }
      const uint32_t bt = PASS == kDV ? t2 : t1;  // T, read MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<DA>(acc, f_hi[kk], desc_sw128(bt + kk * 16 * 128, BN * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<DA>(acc, f_lo[kk], desc_sw128(bt + kk * 16 * 128, BN * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    } else {
      mbar_wait(ring.v_full(s), parity);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(s));
  }

  // dQ and dK take the scale; rows past the matrix's end and columns past
  // D (hazard 7) are not stored
  const float f = PASS == kDV ? 1.f : mk.scale;
  __nv_bfloat16* out =
      (PASS == kDQ ? a.dq : PASS == kDK ? a.dk : a.dv) + static_cast<size_t>(res_plane) * n_res * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + c2;
    if (r0 < n_res)
      store_pair(out + static_cast<size_t>(r0) * D + col, acc[4 * j] * f, acc[4 * j + 1] * f);
    if (r1 < n_res)
      store_pair(out + static_cast<size_t>(r1) * D + col, acc[4 * j + 2] * f,
                 acc[4 * j + 3] * f);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const BwdArgs a, const Mask mk) {
  using L = BwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const Ring<L::STAGES> ring{base + L::kBar};
  if (threadIdx.x == 0) {
    mbar_init(ring.q, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(ring.k_full(s), 1);
      mbar_init(ring.v_full(s), 1);
      mbar_init(ring.empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int cta = static_cast<int>(blockIdx.x);
  if (cta < a.key_ctas)
    run_bwd<D, kDK>(&tq, &tk, &tv, &tdo, a, mk, cta, base, smem);
  else if (cta < 2 * a.key_ctas)
    run_bwd<D, kDV>(&tq, &tk, &tv, &tdo, a, mk, cta - a.key_ctas, base, smem);
  else
    run_bwd<D, kDQ>(&tq, &tk, &tv, &tdo, a, mk, cta - 2 * a.key_ctas, base, smem);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, void* dq, void* dk, void* dv,
                         float* scratch, int B, int Hq, int Hkv, const Mask& mk,
                         cudaStream_t stream) {
  using L = BwdLayout<D>;
  constexpr size_t bytes = L::kSmemBytes;
  static_assert(bytes <= 232448, "tiles exceed a block's shared memory");
  const int BH = B * Hq, BHkv = B * Hkv;
  const int ld = (mk.Sq + kLseRows - 1) / kLseRows * kLseRows;
  float* lse2 = scratch;
  float* delta = scratch + static_cast<size_t>(BH) * ld;
  cudaError_t err = launch_prepass<__nv_bfloat16, D>(o, dout, lse, lse2, delta, BH, mk.Sq, ld,
                                                     kLog2e, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  err = make_map(&tq, q, BH, mk.Sq, D, L::BN);
  if (err == cudaSuccess) err = make_map(&tdo, dout, BH, mk.Sq, D, L::BN);
  if (err == cudaSuccess) err = make_map(&tk, k, BHkv, mk.Skv, D, L::BN);
  if (err == cudaSuccess) err = make_map(&tv, v, BHkv, mk.Skv, D, L::BN);
  if (err == cudaSuccess) err = allow_smem(bwd_wgmma_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  const int key_ctas = BHkv * ((mk.Skv + kWgRows - 1) / kWgRows);
  const int q_ctas = BH * ((mk.Sq + kWgRows - 1) / kWgRows);
  const BwdArgs args{lse2, delta, static_cast<__nv_bfloat16*>(dq),
                     static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                     BH, BHkv, Hq, Hkv, ld, key_ctas};
  bwd_wgmma_kernel<D><<<static_cast<unsigned>(2 * key_ctas + q_ctas), kWgThreads, bytes,
                        stream>>>(tq, tk, tv, tdo, args, mk);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- dispatch

// f(T{}, integral_constant<D>) for the ffma route's (dtype, D)
template <typename T, typename F>
cudaError_t ffma_dims(int D, F&& f) {
  switch (D) {
    case 16: return f(T{}, std::integral_constant<int, 16>{});
    case 32: return f(T{}, std::integral_constant<int, 32>{});
  }
  if constexpr (std::is_same_v<T, float>) {  // bfloat16 at D >= 64 is the wgmma route's
    switch (D) {
      case 64: return f(T{}, std::integral_constant<int, 64>{});
      case 128: return f(T{}, std::integral_constant<int, 128>{});
      case 160: return f(T{}, std::integral_constant<int, 160>{});
      case 256: return f(T{}, std::integral_constant<int, 256>{});
    }
  }
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t ffma_types(int dtype, int D, F&& f) {
  if (dtype == 0) return ffma_dims<float>(D, f);
  if (dtype == 1) return ffma_dims<__nv_bfloat16>(D, f);
  return cudaErrorInvalidValue;
}

// f(integral_constant<D>) for the wgmma route's D
template <typename F>
cudaError_t wgmma_dims(int D, F&& f) {
  switch (D) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 160: return f(std::integral_constant<int, 160>{});
    case 256: return f(std::integral_constant<int, 256>{});
  }
  return cudaErrorInvalidValue;
}

void fill_info(const cudaFuncAttributes& attr, size_t smem, int rows, int* out) {
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = rows;
}

}  // namespace

// The ffma route.  dtype: 0 = float32 (D in {16, 32, 64, 128, 160, 256}), 1 =
// bfloat16 (D in {16, 32}), q, k, v, o, do, dq, dk, dv alike; lse is the
// forward's float32 [B, Hq, Sq]; `scratch` holds B*Hq*Sq floats (delta) on
// the device.  The caller guarantees B*Hq*Sq >= 1, Skv >= 1, Hq a multiple
// of Hkv, B*Hq*ceil(Sq/64) and B*Hkv*ceil(Skv/32) below 2^31, contiguous
// tensors whose data start on a 4-byte boundary; the three launches are
// asynchronous on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, void* dq, void* dk,
                                   void* dv, void* scratch, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, int dtype, float scale, int causal,
                                   int use_window, int window, int use_softcap, float softcap,
                                   void* stream) {
  const Mask mk{Sq, Skv, scale, causal, use_window, window, use_softcap, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(ffma_types(dtype, D, [&](auto t, auto d) {
    using T = decltype(t);
    return launch_ffma<T, decltype(d)::value>(q, k, v, o, dout, lse, dq, dk, dv,
                                              static_cast<float*>(scratch), B, Hq, Hkv, mk, s);
  }));
}

// The wgmma route: bfloat16 q, k, v, o, do, dq, dk, dv at D in {64, 128,
// 160, 256}; lse is the forward's float32 [B, Hq, Sq]; `scratch` holds 2*B*Hq*ld
// floats on the device, ld = Sq rounded up to 64 (lse in log2 units, then
// delta).  The caller guarantees B*Hq*Sq >= 1, Skv >= 1, Hq a multiple of
// Hkv, B*Hq*ceil(Sq/128) + 2*B*Hkv*ceil(Skv/128) below 2^31, contiguous
// tensors whose data start on a 16-byte boundary; the two launches are
// asynchronous on `stream`.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         void* dq, void* dk, void* dv, void* scratch, int B,
                                         int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                                         int causal, int use_window, int window,
                                         int use_softcap, float softcap, void* stream) {
  const Mask mk{Sq, Skv, scale, causal, use_window, window, use_softcap, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(wgmma_dims(D, [&](auto d) {
    return launch_wgmma<decltype(d)::value>(q, k, v, o, dout, lse, dq, dk, dv,
                                            static_cast<float*>(scratch), B, Hq, Hkv, mk, s);
  }));
}

// out[0..3]: registers a thread, local (spill) bytes, dynamic shared memory
// and rows of a streamed tile (0 for the pre-pass) of kernel `which` of the
// route that takes (dtype, D): wgmma (bfloat16 at D >= 64) 0 pre-pass, 1
// bwd_wgmma_kernel; ffma 0 pre-pass, 1 dq, 2 dkv
extern "C" int flash_attention_bwd_info(int dtype, int D, int which, int* out) {
  cudaFuncAttributes attr;
  if (dtype == 1 && D >= 64) {
    return static_cast<int>(wgmma_dims(D, [&](auto d) {
      constexpr int DD = decltype(d)::value;
      const cudaError_t err =
          which == 0 ? cudaFuncGetAttributes(&attr, prepass_kernel<__nv_bfloat16, DD>)
                     : cudaFuncGetAttributes(&attr, bwd_wgmma_kernel<DD>);
      if (err == cudaSuccess)
        fill_info(attr, which == 0 ? 0 : BwdLayout<DD>::kSmemBytes,
                  which == 0 ? 0 : BwdLayout<DD>::BN, out);
      return err;
    }));
  }
  return static_cast<int>(ffma_types(dtype, D, [&](auto t, auto d) {
    using T = decltype(t);
    constexpr int DD = decltype(d)::value;
    const cudaError_t err = which == 0   ? cudaFuncGetAttributes(&attr, prepass_kernel<T, DD>)
                            : which == 1 ? cudaFuncGetAttributes(&attr, dq_kernel<T, DD>)
                                         : cudaFuncGetAttributes(&attr, dkv_kernel<T, DD>);
    if (err == cudaSuccess)
      fill_info(attr, which == 0 ? 0 : which == 1 ? dq_smem<T, DD>() : dkv_smem<T, DD>(),
                which == 0 ? 0 : kKeyBlock<DD>, out);
    return err;
  }));
}

extern "C" const char* flash_attention_bwd_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
