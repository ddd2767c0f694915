// Blocked online-softmax attention (flash) for Hopper (sm_90a), three routes.
//
// All replace the TPU kernel src/repro/kernels/flash_attention/flash.py
// (_flash_kernel, launched by flash_attention).  For q [B, Hq, Sq, D] and
// k, v [B, Hkv, Skv, D] (contiguous, one type) they write o [B, Hq, Sq, D]
// in q's type:
//
//   s[i, j] = (q[i] . k[j]) * scale
//   s       = softcap * tanh(s / softcap)        (when a softcap is given)
//   visible = (!causal || i >= j) && (!window || i - j < window)
//   o[i]    = sum_j p[i, j] v[j] / max(sum_j p[i, j], 1e-30),
//             p = visible ? exp(s - max_j s) : 0, masked s = -1e30
//
// with both indices starting at 0 (top-left alignment when Sq != Skv), so
// a row with no visible key gives 0.  Query head h reads kv head
// h / (Hq / Hkv) (GQA).  Any Sq >= 1 and Skv >= 1.  Which route runs
// follows (dtype, D) alone and is chosen by the caller
// (kernels/flash_attention/ops.py, ``route``); none falls back to another.
//
// Bound: operations.  Each visible (query, key) pair costs 2*D
// multiply-adds for the score and 2*D for the weighted sum of values; q,
// k, v and o are read or written once, far below the bytes those need at
// these head widths.
//
// ---- Route "ffma" (flash_attention): float32 at D 16, 32, 128, 256, bfloat16 at D 16, 32
//
// Everything after the load is float32 on FFMA: products, sums, the online
// softmax state and the accumulator (one TF32 product would miss the
// reference's 2e-5 float32 tolerance).  Its bound is the FFMA rate.  The
// entry still takes float32 at D = 64, which card_probe.py and the smoke
// time beside the tf32x3 route.  One
// block of 256 threads per (batch x query head, 64-row query tile).  The
// query tile and, in turn, each 64-key tile of K and V are staged in
// shared memory in their input type (rows padded by one 32-bit word, so
// the threads of a warp that read one column of sixteen rows hit sixteen
// banks); the 64 x 64 score tile is computed 4 x 4 per thread in
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
//
// ---- Route "wgmma" (flash_attention_wgmma): bfloat16 at D 64, 128, 256
//
// Its bound is the bf16 tensor-core rate (989 TFLOP/s dense on an H100
// SXM), 1.5x the work with P split in two (hazard 1).  One CTA of 384
// threads per (batch x query head, 128-row query tile): two consumer
// warpgroups of 64 query rows each and one producer warpgroup, of which
// one thread issues every copy.  The producer loads the query tile once
// and keeps K and V tiles of BK keys in flight with TMA
// (cp.async.bulk.tensor) into a ring of STAGES stages, each stage with a
// K-full, a V-full and an empty mbarrier.  Per K/V tile each consumer
//   1. issues wgmma S = Q K^T (D/16 k-steps, S in fp32 registers),
//   2. scales, softcaps and masks S in registers,
//   3. runs the online softmax: row max and row sum over the four threads
//      that share a row in the accumulator layout,
//   4. turns P into bf16 A-fragments in registers (the accumulator's
//      layout is the A operand's, so P never touches shared memory),
//   5. issues wgmma O += P V, with V the B operand in MN-major form,
//   6. releases the stage (one arrival per warp).
// The two consumers share the SM's tensor cores: one's softmax overlaps
// the other's products (nothing orders them; a consumer's own softmax
// does not overlap its next QK^T).  A 384-thread CTA starts at 168
// registers a thread; setmaxnreg gives each consumer thread 240 (O is D/2
// of them, 128 at D = 256) and leaves the producer 24.
// Kept from the ffma route: the loop over only the keys a tile can see,
// wholly masked tiles skipped (per consumer), query tiles walked
// longest-first, the GQA head map.  Masks are evaluated only on tiles
// that cut a boundary (Skv's end, the diagonal, the window's edge).
// Tiles: BK = 64 keys and 2 stages at D = 256 (Q 64 KB + 2 x (K + V)
// 64 KB = 192 KB of shared memory; BK = 128 would need 64 more registers
// a thread for S and P).  BK = 128 at D <= 128 (3 stages at D = 64, 2 at
// 128), not tuned: only D = 256 is on a served model's path.
//
// Hazards, and what the design does about each:
//  1. P in bf16.  Rounding p to bf16 costs 2^-9 relative on each term;
//     over thousands of keys (a 4,096 window) that breaks the bf16 limit
//     2e-5 + 2^-6 |want| where |want| is small.  P is split into
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi), and two PV wgmmas add
//     both into O (about 16 bits of p, 1.5x the MMA work).  The row sum l
//     is taken from the fp32 p.  QK^T from bf16 inputs is exact per
//     product with fp32 accumulation and is not split.  The template's
//     PTERMS = 1 (single bf16 P) is built only with -DFLASH_PROBES, for
//     card_probe.py's measurement.
//  2. The softcap's tanh.  tanh.approx.f32 (~2^-11 relative) would move s
//     by ~0.025 at softcap 50, p by ~2.5%; tanhf is kept.  The order is
//     the reference's: scale, softcap, mask, with scale / softcap folded
//     into one multiply before tanhf and softcap * log2(e) into one after
//     (scale * log2(e) without a softcap); ex2.approx (2^-22 relative)
//     takes the exponent.
//  3. TMA and ragged lengths.  The maps are 3-D, (D, S, B*H), so a box
//     past S is zero-filled instead of reading the next head's rows; the
//     key mask still runs (a zero key scores 0, not -1e30).  A 128-byte
//     swizzle caps a box at 64 bf16 columns, so a tile is D/64 boxes wide
//     and the wgmma descriptors use the same swizzle (K-major: SBO 1024 B;
//     V MN-major: LBO = one box, SBO 1024 B).  Global strides are
//     multiples of 16 B at every D here, and the wrapper starts every
//     tensor on a 16-B boundary.
//  4. The driver API.  cuTensorMapEncodeTiled lives in libcuda; the
//     library links only cudart, so the entry point is fetched once with
//     cudaGetDriverEntryPoint(ByVersion).  The maps are encoded on the
//     host for each call and passed as __grid_constant__ parameters.
//  5. The rebuild hash covers this file alone, and the kernel includes no
//     local header.
//  6. Launch.  Dynamic shared memory is set above 48 KB with
//     cudaFuncSetAttribute; cudaGetLastError() is returned after the
//     launch; the wrapper keeps B*Hq*ceil(Sq/128) < 2^31.  Barrier waits
//     do not time out: a __trap() anywhere in the kernel made ptxas (CUDA
//     12.9) hold the consumers to the entry's 168 registers, spilling O
//     and serializing the wgmmas.
//
// ---- Route "tf32x3" (flash_attention_tf32x3): float32 at D 64
//
// float32 on tensor cores.  One TF32 product keeps ~11 bits of each operand
// and misses the float32 limit (2e-5 + 2e-5 |want|); 3xTF32 keeps ~22: each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna.tf32.f32, nearest, ties away) and a product is a_hi b_hi +
// a_hi b_lo + a_lo b_hi (lo * lo, ~2^-22 relative, is dropped).  Its bound
// is the TF32 tensor-core rate (495 TFLOP/s dense), 3x the work: at
// tspm-mlho's shape 0.0599 ms against FFMA's 0.1474.
//   * A pre-pass (tf32x3_split_kernel, one launch) writes k and v's
//     operands into scratch that the wrapper allocates: k as hi planes
//     then lo planes ([2*B*Hkv, Skv, 64]), and V transposed, keys
//     contiguous, as [2*B*Hkv, 64, Skv8] (Skv8 = Skv rounded up to 8, zero
//     past Skv).  Each K/V tile is read by every query tile of its heads,
//     so it is split once here; each query tile is read once, so the main
//     kernel splits q in shared memory (a fence.proxy.async and a
//     warpgroup barrier order those stores before wgmma's reads).
//   * The main kernel (flash_tf32x3_kernel) runs the wgmma route's
//     skeleton (run_cta; the two kernels differ only in their loads, their
//     products and the q split):
//     one 384-thread CTA per (batch x head, 128-row query tile), a producer
//     warpgroup whose one thread loads the query tile once and keeps K hi + lo
//     and V^T hi + lo tiles of 64 keys in a 2-stage TMA ring, two consumer
//     warpgroups of 64 query rows, setmaxnreg 24/240, query tiles walked
//     longest-first, wholly masked tiles skipped per consumer, masks only
//     on boundary tiles.  Per tile each consumer issues
//     S = Q_hi K_lo^T + Q_lo K_hi^T + Q_hi K_hi^T (wgmma m64n64k8 .tf32,
//     both operands K-major in shared memory), the online softmax in fp32
//     registers (ex2.approx, tanhf for the softcap, the reference's order
//     scale, softcap, mask), splits P into TF32 hi + lo A-fragments in
//     registers, and issues O += P_hi V_lo + P_lo V_hi + P_hi V_hi with A
//     from registers.  The row sum l is taken from the fp32 P.
//   * Shared memory: Q hi + lo 64 KB, 2 stages x (K 32 KB + V^T 32 KB),
//     193 KB in all.  D = 128 would need 128 KB of Q and 128 KB a stage,
//     and Q in registers 128 more a thread: it stays on the ffma route.
// Hazards, and what the design does about each:
//  1. TF32 wgmma has no transpose: both shared-memory operands are
//     K-major.  For P V the contraction runs over keys, so V is stored
//     transposed (keys contiguous) by the pre-pass; its boxes are 32 keys
//     (128 B) x 64 rows, like a K box, with the same descriptors.
//  2. The accumulator's columns are not the A fragment's k-order.  A thread
//     holds S columns 2t, 2t + 1 of each 8 (t = lane % 4) but A k-indices
//     t, t + 4 (CUTLASS's SM90 64x8 TF32 A layout).  The pre-pass permutes
//     V^T's keys inside each group of 8 instead of shuffling P: position c
//     holds key 2c (c < 4) or 2c - 7 (vt_key; ref.value_key_order is its
//     plain twin), so A k-index t + 4e meets key 2t + e.  Key tiles start
//     on a multiple of 64 (the window's first tile is rounded down; the
//     window mask covers the extra keys) so groups of 8 never straddle.
//  3. Boxes.  A 128-byte swizzle caps a box at 32 float32 columns: D = 64 is
//     two boxes.  The maps are 3-D, so a box past S (or past Skv8) is
//     zero-filled inside its plane; the key mask still runs.
//  4. Registers: S 32, P hi + lo 64, this tile's P V 32 and O 32 floats a
//     consumer thread, under setmaxnreg's 240; ptxas -v shows no spill.
//  5. Precision.  A long chain of tensor-core accumulations loses more
//     than FFMA's rounding to nearest: with the three terms of each k-step
//     chained into one accumulator and P V chained into O across every
//     tile, the route held the kernel's limit (2e-5 + 2e-5 |want|) with a
//     max |diff| of 5.3e-6, but tspm-mlho's logits drifted 1.4e-3 from the
//     CPU's, past the smoke's 1e-3 (ffma: 1.4e-4; chip_smoke.py on an
//     H100).  So each product adds its small terms (hi * lo, lo * hi)
//     before the hi * hi term, and each tile's P V lands in a fresh
//     accumulator that FFMA adds to O (O = alpha O + P V, one rounding to
//     nearest a tile): max |diff| 1.9e-6, logits 1.5e-4.  ex2.approx
//     (2^-22 relative) takes the exponent; tanhf is kept for the softcap.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
  }
  if constexpr (std::is_same_v<T, float>) {  // bfloat16 at D >= 64 is the wgmma route's
    switch (D) {
      case 64:
        return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, use_window,
                             window, use_softcap, softcap, stream);
      case 128:
        return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, use_window,
                              window, use_softcap, softcap, stream);
      case 256:
        return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, use_window,
                              window, use_softcap, softcap, stream);
    }
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- wgmma route

constexpr int kWgBQ = 128;          // query rows of a CTA (two consumers x 64)
constexpr int kWgThreads = 384;     // warpgroups 0, 1 compute; warpgroup 2 loads
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// box (c0 = column, c1 = row, c2 = plane) of a 3-D map into shared memory
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (byte offsets)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// 2^x, 2^-22 relative (MUFU.EX2); 0 for the masked scores' -1e30
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of wgmma registers across the
// asynchronous issue and the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---- wgmma instructions (m64nNk16, bf16 inputs, fp32 accumulators)

// d[0..32) (+)= A[64x16] B[16x64], A and B K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..64) (+)= A[64x16] B[16x128], A and B K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..32) += A[64x16] B[16x64], A (bf16 pairs) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..64) += A[64x16] B[16x128], A (bf16 pairs) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..128) += A[64x16] B[16x256], A (bf16 pairs) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc);
  else wgmma_ss_n128(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// ---- the skeleton both tensor-core routes (wgmma, tf32x3) share
//
// One CTA of kWgThreads per (batch x query head, kWgBQ-row query tile): a
// producer warpgroup whose one thread loads the query tile once and keeps K
// and V tiles in a TMA ring of STAGES stages, and two consumer warpgroups of
// 64 query rows that run the mask, the online softmax, the row sums and the
// store.  A route gives its tile loads, its S = Q K^T, its O update from P
// and (tf32x3) its work on the query tile as lambdas to run_cta.

// the mask and scale of a call, as the entries take them
struct Mask {
  int Sq, Skv;
  float scale;
  int causal, use_window, window, use_softcap;
  float softcap;
};

// the keys that query rows row0 .. row_last can see: [begin, end)
struct KeyBand {
  long long begin, end;
};

__device__ __forceinline__ KeyBand key_band(const Mask& mk, int row0, int row_last) {
  KeyBand b{0, mk.Skv};
  if (mk.causal) b.end = min(b.end, static_cast<long long>(row_last) + 1);
  if (mk.use_window) b.begin = max(0LL, static_cast<long long>(row0) - mk.window + 1);
  return b;
}

// this CTA's query tile: batch x query head bh, rows q0 .. q0 + kWgBQ - 1
// (walked from the last tile, so the longest causal rows start first), and
// the kv head it reads (GQA)
struct CtaTile {
  int bh, q0, kvh;
};

__device__ __forceinline__ CtaTile cta_tile(int BH, int Hq, int Hkv, int Sq) {
  const int n_qt = (Sq + kWgBQ - 1) / kWgBQ;
  const int bh = blockIdx.x % BH;
  return {bh, (n_qt - 1 - static_cast<int>(blockIdx.x / BH)) * kWgBQ,
          (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv)};
}

// the ring's barriers, 8 bytes each from q: q, k_full[STAGES], v_full[STAGES], empty[STAGES]
template <int STAGES>
struct Ring {
  static constexpr uint32_t kBytes = 8 * (1 + 3 * STAGES);
  uint32_t q;
  __device__ __forceinline__ uint32_t k_full(int s) const { return q + 8u * (1 + s); }
  __device__ __forceinline__ uint32_t v_full(int s) const { return q + 8u * (1 + STAGES + s); }
  __device__ __forceinline__ uint32_t empty(int s) const { return q + 8u * (1 + 2 * STAGES + s); }
};

__device__ __forceinline__ void store_pair(__nv_bfloat16* at, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* at, float a, float b) {
  *reinterpret_cast<float2*>(at) = make_float2(a, b);
}

// One CTA of a tensor-core route.  The producer's thread issues load_q(bar)
// (q_bytes), then for key tile t (keys from k0 = band.begin + t*BK, the
// band's first key rounded down to a multiple of ALIGN) load_k(s, k0, bar)
// and load_v(s, k0, bar) into stage s = t % STAGES (kv_bytes each), once
// the eight consumer warps have released the stage.  Each consumer runs
// on_q() once the query tile has landed, then per tile whose keys its rows
// can see:
//   scores(s, sc)   S = Q K^T of its 64 rows into sc (fp32, the m64nBK
//                   accumulator layout: rows qi0, qi1, columns c2, c2 + 1
//                   of each 8),
//   here            scale, softcap and mask in log2 units (the mask on
//                   boundary tiles only), the online softmax; sc becomes P,
//   values(s, v_bar, parity, sc, alpha0, alpha1, acc)
//                   waits for V on (v_bar, parity) and adds P V to the
//                   accumulator acc rescaled by alpha (row qi0, qi1);
// then releases the stage, and last stores o = acc / max(l, 1e-30) in T.
template <int D, int BK, int STAGES, int ALIGN, typename T, typename LoadQ, typename LoadK,
          typename LoadV, typename OnQ, typename Scores, typename Values>
__device__ __forceinline__ void run_cta(const Ring<STAGES> ring, const Mask& mk, const CtaTile& ct,
                                        uint32_t q_bytes, uint32_t kv_bytes, T* __restrict__ o,
                                        LoadQ load_q, LoadK load_k, LoadV load_v, OnQ on_q,
                                        Scores scores, Values values) {
  KeyBand band = key_band(mk, ct.q0, min(ct.q0 + kWgBQ, mk.Sq) - 1);
  band.begin = band.begin / ALIGN * ALIGN;
  const int n_tiles =
      band.end > band.begin ? static_cast<int>((band.end - band.begin + BK - 1) / BK) : 0;

  if (threadIdx.x == 0) {
    mbar_init(ring.q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.k_full(s), 1);
      mbar_init(ring.v_full(s), 1);
      mbar_init(ring.empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ---- producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128 && n_tiles > 0) {
      mbar_expect_tx(ring.q, q_bytes);
      load_q(ring.q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int round = t / STAGES;
        if (round > 0) mbar_wait(ring.empty(s), (round - 1) & 1);
        const int k0 = static_cast<int>(band.begin + static_cast<long long>(t) * BK);
        mbar_expect_tx(ring.k_full(s), kv_bytes);
        load_k(s, k0, ring.k_full(s));
        mbar_expect_tx(ring.v_full(s), kv_bytes);
        load_v(s, k0, ring.v_full(s));
      }
    }
    return;
  }

  // ---- consumer warpgroup cw: query rows q0 + 64*cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int wq0 = ct.q0 + 64 * cw;
  const int wq_last = min(wq0 + 63, mk.Sq - 1);
  const int qi0 = wq0 + 16 * (tid / 32) + lane / 4;  // this thread's rows qi0, qi0 + 8
  const int qi1 = qi0 + 8;
  const int c2 = 2 * (lane % 4);                       // and columns c2, c2 + 1 of each 8
  const KeyBand wk = key_band(mk, wq0, wq_last);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this thread's share
  // scores in log2 units: s * scale * log2(e), or, with a softcap,
  // softcap * log2(e) * tanh(s * scale / softcap)
  const float pre = mk.use_softcap ? mk.scale / mk.softcap : mk.scale * kLog2e;
  const float post = mk.softcap * kLog2e;

  if (n_tiles > 0) {
    mbar_wait(ring.q, 0);
    on_q();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const int k0 = static_cast<int>(band.begin + static_cast<long long>(t) * BK);
    mbar_wait(ring.k_full(s), parity);
    const bool active = wq0 <= wq_last && k0 < wk.end && k0 + BK > wk.begin;
    if (active) {
      float sc[BK / 2];
      scores(s, sc);

      // does any (row, key) of this tile fall outside the visible band?
      const bool edge = k0 + BK > mk.Skv || (mk.causal && k0 + BK - 1 > wq0) ||
                        (mk.use_window && static_cast<long long>(wq_last) - k0 >= mk.window);
      auto visible = [&](int qi, int kj) {
        return kj < mk.Skv && (!mk.causal || qi >= kj) &&
               (!mk.use_window || static_cast<long long>(qi) - kj < mk.window);
      };
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = sc[i] * pre;
        if (mk.use_softcap) x = post * tanhf(x);
        if (edge && !visible((i & 2) ? qi1 : qi0, k0 + 8 * (i / 4) + c2 + (i & 1))) x = kNegInf;
        sc[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float alpha0 = exp2_approx(m0 - n0), alpha1 = exp2_approx(m1 - n1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float p = exp2_approx(sc[i] - ((i & 2) ? n1 : n0));
        if (edge && !visible((i & 2) ? qi1 : qi0, k0 + 8 * (i / 4) + c2 + (i & 1))) p = 0.f;
        sc[i] = p;
        if (i & 2) sum1 += p;
        else sum0 += p;
      }
      l0 = alpha0 * l0 + sum0;
      l1 = alpha1 * l1 + sum1;
      values(s, ring.v_full(s), parity, sc, alpha0, alpha1, acc);
    } else {
      mbar_wait(ring.v_full(s), parity);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(s));
  }

  // the row sums over the four threads of a row; o = acc / max(l, 1e-30)
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  T* og = o + static_cast<size_t>(ct.bh) * mk.Sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + c2;
    if (qi0 < mk.Sq)
      store_pair(og + static_cast<size_t>(qi0) * D + col, acc[4 * j] / d0, acc[4 * j + 1] / d0);
    if (qi1 < mk.Sq)
      store_pair(og + static_cast<size_t>(qi1) * D + col, acc[4 * j + 2] / d1,
                 acc[4 * j + 3] / d1);
  }
}

// ---- the wgmma route's CTA

// Shared memory of a CTA, from a 1024-byte aligned base: the query tile
// (D/64 boxes of 128 rows x 128 B), then STAGES K tiles and STAGES V tiles
// (D/64 boxes of BK rows x 128 B each), then the barriers.
template <int D, int BK, int STAGES>
struct WgLayout {
  static constexpr int kBoxes = D / 64;
  static constexpr uint32_t kQBytes = kWgBQ * D * 2;
  static constexpr uint32_t kKVBytes = BK * D * 2;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + STAGES * kKVBytes;
  static constexpr uint32_t kBar = kV + STAGES * kKVBytes;
  static constexpr size_t kSmemBytes = kBar + Ring<STAGES>::kBytes + 1024;  // + alignment slack
};

// PTERMS = 2 is the route; 1 adds P as one bf16 term (hazard 1)
template <int D, int BK, int STAGES, int PTERMS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   int BH, int Hq, int Hkv, const Mask mk) {
  using L = WgLayout<D, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const CtaTile ct = cta_tile(BH, Hq, Hkv, mk.Sq);
  const uint32_t q_tile = base + (threadIdx.x / 128) * 64 * 128;  // a consumer's 64 rows
  const CUtensorMap *map_q = &tq, *map_k = &tk, *map_v = &tv;

  auto load_q = [&](uint32_t bar) {
    for (int b = 0; b < L::kBoxes; ++b)
      tma_load_3d(base + b * kWgBQ * 128, map_q, bar, 64 * b, ct.q0, ct.bh);
  };
  auto load_k = [&](int s, int k0, uint32_t bar) {
    for (int b = 0; b < L::kBoxes; ++b)
      tma_load_3d(base + L::kK + s * L::kKVBytes + b * BK * 128, map_k, bar, 64 * b, k0, ct.kvh);
  };
  auto load_v = [&](int s, int k0, uint32_t bar) {
    for (int b = 0; b < L::kBoxes; ++b)
      tma_load_3d(base + L::kV + s * L::kKVBytes + b * BK * 128, map_v, bar, 64 * b, k0, ct.kvh);
  };
  auto scores = [&](int s, float (&sc)[BK / 2]) {
    const uint32_t k_tile = base + L::kK + s * L::kKVBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<BK>(sc, desc_sw128(q_tile + (kk / 4) * kWgBQ * 128 + off, 16, 1024),
                   desc_sw128(k_tile + (kk / 4) * BK * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
  };
  auto values = [&](int s, uint32_t v_bar, uint32_t parity, float (&p)[BK / 2], float alpha0,
                    float alpha1, float (&acc)[D / 2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;
    // P as bf16 A-fragments: fragment kk covers keys 16kk .. 16kk + 15
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = p[8 * kk + 2 * e], b = p[8 * kk + 2 * e + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        p_hi[kk][e] = bf16x2_bits(hi);
        if (PTERMS == 2)
          p_lo[kk][e] = bf16x2_bits(__floats2bfloat162_rn(a - __low2float(hi),
                                                          b - __high2float(hi)));
      }
    const uint32_t v_tile = base + L::kV + s * L::kKVBytes;
    mbar_wait(v_bar, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(acc, p_hi[kk], desc_sw128(v_tile + kk * 16 * 128, BK * 128, 1024));
    if (PTERMS == 2) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, p_lo[kk], desc_sw128(v_tile + kk * 16 * 128, BK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  };
  run_cta<D, BK, STAGES, 1>(Ring<STAGES>{base + L::kBar}, mk, ct, L::kQBytes, L::kKVBytes, o,
                            load_q, load_k, load_v, [] {}, scores, values);
}

// --------------------------------------------------------------- tf32x3 route

constexpr int kTfD = 64;            // the route's head width
constexpr int kTfBK = 64;           // keys of a tile
constexpr int kTfStages = 2;
constexpr int kSplitThreads = 256;

// x rounded to TF32 (10 explicit mantissa bits; nearest, ties away), as
// float bits with the low 13 bits clear
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// hi = tf32(x), lo = tf32(x - hi), four at a time
__device__ __forceinline__ void split4(const float4 x, float4& h, float4& l) {
  h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  l = make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z),
                  tf32_rna(x.w - h.w));
}

// the key that position kp of the transposed V holds (hazard 2): inside
// each group of 8, position c holds key 2c (c < 4) or 2c - 7 (c >= 4)
__device__ __forceinline__ int vt_key(int kp) {
  const int c = kp & 7;
  return (kp & ~7) | (c < 4 ? 2 * c : 2 * c - 7);
}

// The pre-pass.  Blocks [0, vt_blocks) transpose one 64-key tile of one
// kv head of v each (through shared memory, so reads and writes are both
// coalesced) into vts = [V^T hi planes; V^T lo planes], keys permuted by
// vt_key and zero past Skv; the other blocks split k four floats a thread
// into ks = [k hi; k lo].  (q is split by the main kernel, which reads
// each query tile once.)
__global__ void __launch_bounds__(kSplitThreads)
tf32x3_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    float* __restrict__ ks, float* __restrict__ vts, long long nk, int BHkv,
                    int Skv, int Skv8, int vt_blocks) {
  __shared__ float tile[64][kTfD + 1];
  if (static_cast<int>(blockIdx.x) < vt_blocks) {
    const int tiles = (Skv8 + 63) / 64;
    const int plane = blockIdx.x / tiles;
    const int k0 = (blockIdx.x % tiles) * 64;
    const float* vp = v + static_cast<size_t>(plane) * Skv * kTfD;
    for (int e = threadIdx.x; e < 64 * kTfD; e += kSplitThreads) {
      const int r = e / kTfD, d = e % kTfD;
      tile[r][d] = k0 + r < Skv ? vp[static_cast<size_t>(k0 + r) * kTfD + d] : 0.f;
    }
    __syncthreads();
    float* hi = vts + static_cast<size_t>(plane) * kTfD * Skv8;
    float* lo = hi + static_cast<size_t>(BHkv) * kTfD * Skv8;
    for (int e = threadIdx.x; e < 64 * kTfD; e += kSplitThreads) {
      const int d = e / 64, kp = e % 64;
      if (k0 + kp >= Skv8) continue;
      const float x = tile[vt_key(kp)][d];
      const float h = tf32_rna(x);
      const size_t at = static_cast<size_t>(d) * Skv8 + k0 + kp;
      hi[at] = h;
      lo[at] = tf32_rna(x - h);
    }
    return;
  }
  const long long n4 = nk / 4;
  const long long stride = static_cast<long long>(gridDim.x - vt_blocks) * kSplitThreads;
  for (long long i = static_cast<long long>(blockIdx.x - vt_blocks) * kSplitThreads + threadIdx.x;
       i < n4; i += stride) {
    float4 h, l;
    split4(reinterpret_cast<const float4*>(k)[i], h, l);
    reinterpret_cast<float4*>(ks)[i] = h;
    reinterpret_cast<float4*>(ks)[n4 + i] = l;
  }
}

// ---- wgmma instructions (m64n64k8, tf32 inputs, fp32 accumulators)

// d[0..32) (+)= A[64x8] B[8x64], A and B K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..32) (+)= A[64x8] B[8x64], A (tf32 bits) in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Shared memory of a tf32x3 CTA, from a 1024-byte aligned base: Q hi then
// Q lo (each 2 boxes of 128 rows x 128 B; the copy lands q itself in the
// hi half, which each consumer splits in place), then for each stage K hi, K lo
// (each 2 boxes of 64 keys x 128 B) and V^T hi, V^T lo (each 2 boxes of
// 32 keys x 64 rows), then the barriers.
struct TfLayout {
  static constexpr uint32_t kBox = 64 * 128;               // a K or V^T box
  static constexpr uint32_t kQHalf = 2 * kWgBQ * 128;      // Q hi or Q lo
  static constexpr uint32_t kQBytes = 2 * kQHalf;
  static constexpr uint32_t kHalf = 2 * kBox;              // K hi, K lo, V^T hi or V^T lo
  static constexpr uint32_t kKVBytes = 2 * kHalf;          // hi + lo of K, or of V^T
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kTfStages * kKVBytes;
  static constexpr uint32_t kBar = kV + kTfStages * kKVBytes;
  static constexpr size_t kSmemBytes = kBar + Ring<kTfStages>::kBytes + 1024;
};

// PV_TERMS = 3 is the route; 1 adds P_hi V_hi alone (a measurement of the
// lo terms' cost, built with FLASH_PROBES only)
template <int PV_TERMS>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_tf32x3_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int BH,
                    int Hq, int BHkv, int Hkv, const Mask mk) {
  using L = TfLayout;
  constexpr int BK = kTfBK, D = kTfD;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const CtaTile ct = cta_tile(BH, Hq, Hkv, mk.Sq);
  const int cw = threadIdx.x / 128;
  const uint32_t q_hi = base + cw * 64 * 128;  // a consumer's 64 rows
  const uint32_t q_lo = q_hi + L::kQHalf;
  const CUtensorMap *map_q = &tq, *map_k = &tk, *map_v = &tv;

  auto load_q = [&](uint32_t bar) {
    for (int b = 0; b < 2; ++b)
      tma_load_3d(base + b * kWgBQ * 128, map_q, bar, 32 * b, ct.q0, ct.bh);
  };
  auto load_k = [&](int s, int k0, uint32_t bar) {
    for (int half = 0; half < 2; ++half)
      for (int b = 0; b < 2; ++b)
        tma_load_3d(base + L::kK + s * L::kKVBytes + half * L::kHalf + b * L::kBox, map_k, bar,
                    32 * b, k0, ct.kvh + half * BHkv);
  };
  auto load_v = [&](int s, int k0, uint32_t bar) {
    for (int half = 0; half < 2; ++half)
      for (int b = 0; b < 2; ++b)
        tma_load_3d(base + L::kV + s * L::kKVBytes + half * L::kHalf + b * L::kBox, map_v, bar,
                    k0 + 32 * b, 0, ct.kvh + half * BHkv);
  };
  // split this warpgroup's 64 rows of q in place: hi over q, lo at the same
  // offset of the lo half (elementwise, so the swizzle does not matter);
  // then make the generic stores visible to wgmma's reads
  auto split_q = [&] {
    uint8_t* q_rows = smem_raw + (q_hi - smem_u32(smem_raw));
#pragma unroll
    for (int i = threadIdx.x % 128; i < 2 * 64 * 128 / 16; i += 128) {
      float4* at = reinterpret_cast<float4*>(q_rows + (i / 512) * kWgBQ * 128 + (i % 512) * 16);
      float4 h, l;
      split4(*at, h, l);
      *at = h;
      *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(at) + L::kQHalf) = l;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  };
  // S = Q_hi K_lo^T + Q_lo K_hi^T + Q_hi K_hi^T, the small terms first
  // (hazard 5): k-step kk covers columns 8kk .. 8kk + 7 of q and k (32 B of
  // a 128-B swizzled row)
  auto scores = [&](int s, float (&sc)[BK / 2]) {
    const uint32_t k_hi = base + L::kK + s * L::kKVBytes, k_lo = k_hi + L::kHalf;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = (kk / 4) * kWgBQ * 128 + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * L::kBox + (kk % 4) * 32;
      wgmma_tf32_ss(sc, desc_sw128(q_hi + qo, 16, 1024), desc_sw128(k_lo + ko, 16, 1024), kk > 0);
      wgmma_tf32_ss(sc, desc_sw128(q_lo + qo, 16, 1024), desc_sw128(k_hi + ko, 16, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = (kk / 4) * kWgBQ * 128 + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * L::kBox + (kk % 4) * 32;
      wgmma_tf32_ss(sc, desc_sw128(q_hi + qo, 16, 1024), desc_sw128(k_hi + ko, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
  };
  auto values = [&](int s, uint32_t v_bar, uint32_t parity, float (&p)[BK / 2], float alpha0,
                    float alpha1, float (&acc)[D / 2]) {
    // P as TF32 hi + lo A-fragments: k-step kk covers keys 8kk .. 8kk + 7;
    // register e holds row (e & 1 ? qi1 : qi0) at k-index t + 4 (e >> 1),
    // where V^T's permutation puts key c2 + (e >> 1) (hazard 2)
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = p[4 * kk + ((e & 1) << 1) + (e >> 1)];
        const float h = tf32_rna(x);
        p_hi[kk][e] = __float_as_uint(h);
        p_lo[kk][e] = __float_as_uint(tf32_rna(x - h));
      }
    // this tile's P V = P_hi V_lo + P_lo V_hi + P_hi V_hi, small terms
    // first, into a fresh accumulator; O = alpha O + P V in FFMA (round to
    // nearest) (hazard 5)
    const uint32_t v_hi = base + L::kV + s * L::kKVBytes, v_lo = v_hi + L::kHalf;
    float pv[D / 2];
    mbar_wait(v_bar, parity);
    wgmma_fence();
    if (PV_TERMS == 3) {
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t vo = (kk / 4) * L::kBox + (kk % 4) * 32;
        wgmma_tf32_rs(pv, p_hi[kk], desc_sw128(v_lo + vo, 16, 1024), kk > 0);
        wgmma_tf32_rs(pv, p_lo[kk], desc_sw128(v_hi + vo, 16, 1024), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t vo = (kk / 4) * L::kBox + (kk % 4) * 32;
      wgmma_tf32_rs(pv, p_hi[kk], desc_sw128(v_hi + vo, 16, 1024), PV_TERMS == 3 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(acc[i], (i & 2) ? alpha1 : alpha0, pv[i]);
  };
  // key tiles start on a multiple of BK, so V^T's groups of 8 never straddle one (hazard 2)
  run_cta<D, BK, kTfStages, BK>(Ring<kTfStages>{base + L::kBar}, mk, ct, L::kQHalf, L::kKVBytes,
                                o, load_q, load_k, load_v, split_q, scores, values);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once through the runtime
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a map over a [planes, rows, cols] bfloat16 (or float32) tensor in boxes
// of box_rows x 128 bytes, 128-byte swizzle; boxes past `rows` or `cols`
// are zero-filled
cudaError_t make_map(CUtensorMap* map, const void* ptr, int planes, int rows, int cols,
                     int box_rows, bool f32 = false) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * elem,
                                 static_cast<cuuint64_t>(rows) * cols * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            3, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int BK, int STAGES, int PTERMS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                         int Hkv, const Mask& mk, cudaStream_t stream) {
  constexpr size_t bytes = WgLayout<D, BK, STAGES>::kSmemBytes;
  static_assert(bytes <= 232448, "tiles exceed a block's shared memory");
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B * Hq, mk.Sq, D, kWgBQ);
  if (err == cudaSuccess) err = make_map(&tk, k, B * Hkv, mk.Skv, D, BK);
  if (err == cudaSuccess) err = make_map(&tv, v, B * Hkv, mk.Skv, D, BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_wgmma_kernel<D, BK, STAGES, PTERMS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int BH = B * Hq;
  const unsigned blocks = static_cast<unsigned>(BH) * ((mk.Sq + kWgBQ - 1) / kWgBQ);
  flash_wgmma_kernel<D, BK, STAGES, PTERMS><<<blocks, kWgThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), BH, Hq, Hkv, mk);
  return cudaGetLastError();
}

template <int PTERMS>
cudaError_t dispatch_wgmma(int D, const void* q, const void* k, const void* v, void* o, int B,
                           int Hq, int Hkv, const Mask& mk, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_wgmma<64, 128, 3, PTERMS>(q, k, v, o, B, Hq, Hkv, mk, stream);
    case 128:
      return launch_wgmma<128, 128, 2, PTERMS>(q, k, v, o, B, Hq, Hkv, mk, stream);
    case 256:
      return launch_wgmma<256, 64, 2, PTERMS>(q, k, v, o, B, Hq, Hkv, mk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int PV_TERMS>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* o, void* scratch,
                          int B, int Hq, int Hkv, const Mask& mk, cudaStream_t stream) {
  constexpr size_t bytes = TfLayout::kSmemBytes;
  static_assert(bytes <= 232448, "tiles exceed a block's shared memory");
  const int BH = B * Hq, BHkv = B * Hkv, Skv = mk.Skv;
  const int Skv8 = (Skv + 7) / 8 * 8;
  const long long nk = static_cast<long long>(BHkv) * Skv * kTfD;
  float* ks = static_cast<float*>(scratch);
  float* vts = ks + 2 * nk;
  const int vt_blocks = BHkv * ((Skv8 + 63) / 64);
  const long long want = (nk / 4 + kSplitThreads - 1) / kSplitThreads;
  const int row_blocks = static_cast<int>(want < 4096 ? want : 4096);
  tf32x3_split_kernel<<<vt_blocks + row_blocks, kSplitThreads, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), ks, vts, nk, BHkv, Skv, Skv8,
      vt_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  err = make_map(&tq, q, BH, mk.Sq, kTfD, kWgBQ, true);
  if (err == cudaSuccess) err = make_map(&tk, ks, 2 * BHkv, Skv, kTfD, kTfBK, true);
  if (err == cudaSuccess) err = make_map(&tv, vts, 2 * BHkv, kTfD, Skv8, kTfD, true);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_tf32x3_kernel<PV_TERMS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(BH) * ((mk.Sq + kWgBQ - 1) / kWgBQ);
  flash_tf32x3_kernel<PV_TERMS><<<blocks, kWgThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<float*>(o), BH, Hq, BHkv, Hkv, mk);
  return cudaGetLastError();
}

}  // namespace

// The ffma route.  dtype: 0 = float32 (D in {16, 32, 64, 128, 256}), 1 =
// bfloat16 (D in {16, 32}), q, k, v and o alike.  The caller guarantees
// B*Hq*Sq >= 1, Skv >= 1, Hq a multiple of Hkv, B*Hq*ceil(Sq/64) < 2^31,
// contiguous tensors whose data start on a 4-byte boundary; the launch is
// asynchronous on `stream`.
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

// The wgmma route: bfloat16 q, k, v and o, D in {64, 128, 256}.  The
// caller guarantees B*Hq*Sq >= 1, Skv >= 1, Hq a multiple of Hkv,
// B*Hq*ceil(Sq/128) < 2^31, contiguous tensors whose data start on a
// 16-byte boundary; the launch is asynchronous on `stream`.
extern "C" int flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                     int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                     float scale, int causal, int use_window, int window,
                                     int use_softcap, float softcap, void* stream) {
  const Mask mk{Sq, Skv, scale, causal, use_window, window, use_softcap, softcap};
  return static_cast<int>(
      dispatch_wgmma<2>(D, q, k, v, o, B, Hq, Hkv, mk, static_cast<cudaStream_t>(stream)));
}

// The tf32x3 route: float32 q, k, v and o at D = 64, with `scratch` of
// 2*64*B*Hkv*(Skv + Skv8) floats on the device, Skv8 = Skv rounded up to
// 8: [k hi; k lo], [V^T hi; V^T lo], the pre-pass's output, which the main
// kernel reads.  The caller guarantees B*Hq*Sq >= 1, Skv >= 1, Hq a
// multiple of Hkv, B*Hq*ceil(Sq/128) < 2^31, contiguous tensors whose data
// start on a 16-byte boundary; the launches are asynchronous on `stream`.
extern "C" int flash_attention_tf32x3(const void* q, const void* k, const void* v, void* o,
                                      int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                      void* scratch, float scale, int causal, int use_window,
                                      int window, int use_softcap, float softcap, void* stream) {
  if (D != kTfD) return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{Sq, Skv, scale, causal, use_window, window, use_softcap, softcap};
  return static_cast<int>(launch_tf32x3<3>(q, k, v, o, scratch, B, Hq, Hkv, mk,
                                           static_cast<cudaStream_t>(stream)));
}

#ifdef FLASH_PROBES
// Measurement variants, compiled only with -DFLASH_PROBES (card_probe.py
// builds them into a library of their own; the port's library has
// neither).  Both give results the limits refuse, by design: the wgmma
// route with P as one bf16 term, and the tf32x3 route with P V as P_hi
// V_hi alone.  Arguments as the entries above.
extern "C" int flash_attention_wgmma_p_bf16(const void* q, const void* k, const void* v,
                                            void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                                            int D, float scale, int causal, int use_window,
                                            int window, int use_softcap, float softcap,
                                            void* stream) {
  const Mask mk{Sq, Skv, scale, causal, use_window, window, use_softcap, softcap};
  return static_cast<int>(
      dispatch_wgmma<1>(D, q, k, v, o, B, Hq, Hkv, mk, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_tf32x3_pv_hi(const void* q, const void* k, const void* v,
                                            void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                                            int D, void* scratch, float scale, int causal,
                                            int use_window, int window, int use_softcap,
                                            float softcap, void* stream) {
  if (D != kTfD) return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{Sq, Skv, scale, causal, use_window, window, use_softcap, softcap};
  return static_cast<int>(launch_tf32x3<1>(q, k, v, o, scratch, B, Hq, Hkv, mk,
                                           static_cast<cudaStream_t>(stream)));
}
#endif

extern "C" const char* flash_attention_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
