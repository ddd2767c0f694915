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
// once (4*2^H bytes), a few MB; the work is one hash and one count per
// counted pair.  The TPU kernel had limits this card does not share, so the
// design differs:
//   * ids: it evaluated the hash in 13-bit int32 limbs (Mosaic lacks int64
//     vectors); here the id is formed on uint64 (bit: s << 24 | e, paper:
//     s * 10^7 + e), multiplied by 0x9E3779B97F4A7C15 with defined
//     wraparound, and the top H bits taken, the bits of hash_bucket;
//   * lookbacks: it recomputed them for every (i, j) tile and bucket tile;
//     here one block owns one patient row at a time and holds it in shared
//     memory; an open-address set of its codes finds whether it repeats
//     one (a first-occurrence-filtered cohort never does), and only then
//     is prev[] computed (an O(n^2) scan, a warp a position).  A row too
//     long for that beside the table or the stage (the "compact" layout,
//     E above ~9,000 at H = 20) reads its codes from global memory and
//     keeps only prev[] in shared memory, computed for every row;
//   * pairs: a warp takes one i with prev[i] < 0 and its lanes take j > i,
//     32 at a time, so no slot with j <= i or a dead i is visited and no
//     index is divided; the id's part from x_i is formed once an i;
//   * histogram: the TPU had no scatter and compared against bucket tiles,
//     capped at 2^14 buckets.  Here the count is bucket_count.cuh's: a
//     private shared table up to 2^15 buckets, partitions binned through
//     scratch above that (a counting pass enumerates the pairs once more).
//     The wrapper runs the cohort in rounds of patients whose pairs fit the
//     scratch, each round adding into the one table.
// Integer sums are exact in any order, so the table is byte-identical to
// the plain versions however the atomics interleave.
#include "bucket_count.cuh"

namespace {

using namespace bucket_count;

constexpr int kBitShift = 24;
constexpr uint64_t kPaperShift = 10000000ULL;
constexpr uint64_t kHashMult = 0x9E3779B97F4A7C15ULL;
constexpr int kMaxSmemPerBlock = 227 * 1024;

// The part of a pair's id that x_i gives: x_i << 24 (bit) or x_i * 10^7
// (paper); the id is then lead | x_j (bit) or lead + x_j (paper), on
// uint64 with x_j sign-extended, as the reference packs it.
__device__ __forceinline__ uint64_t lead_id(int xi, bool bit) {
  const uint64_t a = static_cast<uint64_t>(static_cast<long long>(xi));
  return bit ? a << kBitShift : a * kPaperShift;
}

__device__ __forceinline__ uint32_t pair_bucket(uint64_t lead, int xj, bool bit, int shift) {
  const uint64_t b = static_cast<uint64_t>(static_cast<long long>(xj));
  return static_cast<uint32_t>(((bit ? lead | b : lead + b) * kHashMult) >> shift);
}

// One patient row.  The full layout copies its codes into shared memory,
// x[E], followed by an open-address set of positions (cap >= 2E slots)
// that finds whether the row repeats a code; only then are the lookbacks
// computed, over the set.  The compact layout, for a row too long for that
// beside the table or the stage, reads the codes from global memory and
// keeps only the lookbacks, prev[E], in shared memory, computed for every
// row.
struct Row {
  const int* x;       // [E] the codes: the shared copy, or the row in global memory
  int* copy;          // [E] the shared copy (compact: none)
  int* set;           // [cap] position + 1, 0 = empty (compact: none)
  int* prev;          // [E] over the set
  int cap_log2;
  bool distinct;      // no code repeats: every prev is -1
};

__host__ __device__ constexpr int set_log2(int E) {
  int c = 2;
  while ((1 << c) < 2 * E) ++c;
  return c;
}

// Shared memory of a row of E events (a multiple of 16 bytes); the
// wrapper's mirror is analysis/roofline.py row_bytes.
__host__ __device__ constexpr long long row_bytes(int E, bool compact) {
  return (4LL * E + (compact ? 0LL : 4LL << set_log2(E)) + 15) / 16 * 16;
}

__device__ inline Row row_at(unsigned char* mem, int E, bool compact) {
  Row r;
  r.copy = compact ? nullptr : reinterpret_cast<int*>(mem);
  r.set = compact ? nullptr : r.copy + E;
  r.prev = compact ? reinterpret_cast<int*>(mem) : r.set;
  r.x = r.copy;
  r.cap_log2 = set_log2(E);
  r.distinct = false;
  return r;
}

// Block-wide: prev[k] for k < n, a warp a position k, its lanes testing 32
// earlier positions at a time, nearest first.
__device__ inline void lookbacks(Row& r, int n) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < n; k += nw) {
    const int v = r.x[k];
    int found = -1;
    for (int top = k - 1; top >= 0 && found < 0; top -= 32) {
      const int q = top - lane;
      const unsigned hit = __ballot_sync(0xffffffffu, q >= 0 && r.x[q] == v);
      if (hit) found = top - (__ffs(hit) - 1);
    }
    if (lane == 0) r.prev[k] = found;
  }
  __syncthreads();
}

// Block-wide: loads row p (n events, from `row` in global memory).  In the
// full layout each position enters the set; a code found there already
// marks the row as repeating, and only then are the lookbacks computed.
__device__ inline void load_row(const int* __restrict__ row, int n, Row& r) {
  __syncthreads();                         // the previous row is done with
  if (r.copy == nullptr) {
    r.x = row;
    r.distinct = false;
    lookbacks(r, n);
    return;
  }
  const int cap = 1 << r.cap_log2;
  for (int q = threadIdx.x; q < cap; q += blockDim.x) r.set[q] = 0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) r.copy[k] = row[k];
  __syncthreads();
  bool repeat = false;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int v = r.x[k];
    unsigned slot = (static_cast<unsigned>(v) * 0x9E3779B9u) >> (32 - r.cap_log2);
    for (;;) {
      const int held = atomicCAS(&r.set[slot], 0, k + 1);
      if (held == 0) break;
      if (r.x[held - 1] == v) {
        repeat = true;
        break;
      }
      slot = (slot + 1) & (cap - 1);
    }
  }
  r.distinct = !__syncthreads_or(repeat);  // the set is done with
  if (!r.distinct) lookbacks(r, n);
}

// Calls emit(keep, bucket) for the counted pairs of a row: warp w takes the
// i = w, w + nw, ... with prev[i] < 0, its lanes the j > i, 32 at a time;
// every lane of the warp calls emit, so emit may be warp-collective.
template <class Emit>
__device__ void row_pairs(const Row& r, int n, int codec, int H, Emit emit) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int shift = 64 - H;
  const bool bit = codec == 0;
  for (int i = threadIdx.x >> 5; i < n - 1; i += nw) {
    if (!r.distinct && r.prev[i] >= 0) continue;
    const uint64_t lead = lead_id(r.x[i], bit);
    for (int j0 = i + 1; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool keep = j < n && (r.distinct || r.prev[j] <= i);
      emit(keep, keep ? pair_bucket(lead, r.x[j], bit, shift) : 0u);
    }
  }
}

__device__ __forceinline__ int row_events(const int* nevents, int p, int E) {
  return min(max(nevents[p], 0), E);
}

// H <= 15: a private table per block in shared memory, after the row.
__global__ void fused_private(const int* __restrict__ phenx, const int* __restrict__ nevents,
                              int* __restrict__ out, int P, int E, int codec, int H,
                              bool compact) {
  extern __shared__ __align__(16) unsigned char smem[];
  Row r = row_at(smem, E, compact);
  int* table = reinterpret_cast<int*>(smem + row_bytes(E, compact));
  const int n_buckets = 1 << H;
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) table[b] = 0;
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const int n = row_events(nevents, p, E);
    if (n < 2) continue;                   // the same n for the whole block
    load_row(phenx + static_cast<long long>(p) * E, n, r);
    row_pairs(r, n, codec, H, [&](bool keep, uint32_t v) { if (keep) atomicAdd(&table[v], 1); });
  }
  __syncthreads();
  table_flush(table, n_buckets, out, true);
}

// Stage (a), pass 1: offs[q * G + block] = the block's pairs in partition
// lo + q (shared atomics on the block's counts).
__global__ void fused_count_pass(const int* __restrict__ phenx,
                                 const int* __restrict__ nevents, int P, int E, int codec,
                                 int H, int lo, int np, unsigned* __restrict__ offs,
                                 bool compact) {
  extern __shared__ __align__(16) unsigned char smem[];
  Row r = row_at(smem, E, compact);
  int* cnt = reinterpret_cast<int*>(smem + row_bytes(E, compact));
  for (int q = threadIdx.x; q < np; q += blockDim.x) cnt[q] = 0;
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const int n = row_events(nevents, p, E);
    if (n < 2) continue;
    load_row(phenx + static_cast<long long>(p) * E, n, r);
    row_pairs(r, n, codec, H, [&](bool keep, uint32_t v) {
      if (keep && in_group(v, lo, np)) atomicAdd(&cnt[static_cast<int>(v >> kPartLog2) - lo], 1);
    });
  }
  __syncthreads();
  for (int q = threadIdx.x; q < np; q += blockDim.x)
    offs[static_cast<size_t>(q) * gridDim.x + blockIdx.x] = static_cast<unsigned>(cnt[q]);
}

// Stage (a): each warp bins its pairs and flushes its bins to the scratch
// whenever another push could overflow one.  The same rows as the counting
// pass, block for block.
__global__ void fused_stage(const int* __restrict__ phenx, const int* __restrict__ nevents,
                            int P, int E, int codec, int H, int lo, int np,
                            const unsigned* __restrict__ offs, uint16_t* __restrict__ ids,
                            bool compact) {
  extern __shared__ __align__(16) unsigned char smem[];
  Row r = row_at(smem, E, compact);
  unsigned char* stage = smem + row_bytes(E, compact);
  stage_begin(stage, offs, gridDim.x, np);
  const WarpBins w = warp_bins_at(stage, threadIdx.x >> 5);
  unsigned* base = stage_base(stage);
  const int C = kWarpBinIds / np;
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const int n = row_events(nevents, p, E);
    if (n < 2) continue;
    load_row(phenx + static_cast<long long>(p) * E, n, r);
    row_pairs(r, n, codec, H, [&](bool keep, uint32_t v) {
      if (warp_bin(w, C, keep && in_group(v, lo, np), v, lo)) warp_flush(w, C, np, base, ids);
    });
  }
  warp_flush(w, C, np, base, ids);
}

#ifdef COUNT_PROBES
// The kernel this file shipped before the partitioned design (every slot
// of the n^2 square, a division each; global atomics above 2^15 buckets),
// kept for card_probe.py count and chip_smoke.py's before/after reading.
template <bool kSharedTable>
__global__ void fused_kernel_old(const int* __restrict__ phenx,
                                 const int* __restrict__ nevents,
                                 int* __restrict__ out, int P, int E, int codec, int H) {
  extern __shared__ int old_smem[];
  const int n_buckets = 1 << H;
  int* table = old_smem;
  int* row = old_smem + (kSharedTable ? n_buckets : 0);
  int* prev = row + E;
  if (kSharedTable)
    for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) table[b] = 0;
  const int shift = 64 - H;
  const uint64_t bucket_mask = static_cast<uint64_t>(n_buckets - 1);
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const int n = min(max(nevents[p], 0), E);
    if (n < 2) continue;
    __syncthreads();
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
#endif

template <class K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes > kMaxSmemPerBlock) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Adds one round's counts into `out` (2^H int32, zeroed by the caller
// before the first round) on `stream`, asynchronously.  phenx [P, E] and
// nevents [P] are the round's patients; codec: 0 = bit, 1 = paper.
// `grid` blocks of `threads` walk the rows (the wrapper's plan); above
// 2^15 buckets `part_blocks` blocks count each partition and `scratch`
// holds bucket_count::scratch_bytes(cap_ids, 2^(H-15), grid) bytes, where
// cap_ids bounds the round's counted pairs (the wrapper's sum of n(n-1)/2).
// A row takes the full layout where it fits beside the table (H <= 15) or
// the stage, else the compact one; where neither fits the call fails.
// The caller guarantees P >= 1, 1 <= E, 1 <= H <= 30, contiguous int32
// inputs and threads a multiple of 32 in [64, 512].
extern "C" int tspm_fused(const void* phenx, const void* nevents, void* out, int P, int E,
                          int codec, int H, void* scratch, long long scratch_len,
                          long long cap_ids, int grid, int part_blocks, int threads,
                          void* stream) {
  if (P < 1 || E < 1 || H < 1 || H > 30 || grid < 1 || part_blocks < 1 || threads < 64 ||
      threads > 512 || threads % 32 != 0 || cap_ids < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const int*>(phenx);
  const auto np_ = static_cast<const int*>(nevents);
  const auto op = static_cast<int*>(out);
  const long long beside = H <= kPartLog2 ? (4LL << H) : stage_bytes(threads / 32);
  const bool compact = row_bytes(E, false) + beside > kMaxSmemPerBlock;
  const long long rows = row_bytes(E, compact);
  cudaError_t err;
  if (H <= kPartLog2) {
    if ((err = allow_smem(fused_private, rows + beside)) != cudaSuccess)
      return static_cast<int>(err);
    fused_private<<<grid, threads, rows + beside, s>>>(xp, np_, op, P, E, codec, H, compact);
    return static_cast<int>(cudaGetLastError());
  }
  const long long parts = 1LL << (H - kPartLog2);
  if (scratch == nullptr || scratch_len < scratch_bytes(cap_ids, parts, grid) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ids = static_cast<uint16_t*>(scratch);
  auto* offs = reinterpret_cast<unsigned*>(static_cast<unsigned char*>(scratch) +
                                           ((2 * cap_ids + 15) / 16) * 16);
  const int np_max = static_cast<int>(parts < kGroupParts ? parts : kGroupParts);
  if ((err = allow_smem(fused_count_pass, rows + np_max * 4LL)) != cudaSuccess ||
      (err = allow_smem(fused_stage, rows + beside)) != cudaSuccess ||
      (err = allow_smem(count_segments, kPartBuckets * 4LL)) != cudaSuccess)
    return static_cast<int>(err);
  for (long long lo = 0; lo < parts; lo += kGroupParts) {
    const int np = static_cast<int>(parts - lo < kGroupParts ? parts - lo : kGroupParts);
    const int l = static_cast<int>(lo);
    // twice the stage's threads: the same rows a block, more warps to hide
    // the enumeration's latency (the pass holds a row and np counts only)
    fused_count_pass<<<grid, 2 * threads, rows + np * 4LL, s>>>(xp, np_, P, E, codec, H, l,
                                                                 np, offs, compact);
    scan_offsets<<<1, kScanThreads, 0, s>>>(offs, np * grid);
    fused_stage<<<grid, threads, rows + beside, s>>>(xp, np_, P, E, codec, H, l, np, offs, ids,
                                                     compact);
    count_segments<<<np * part_blocks, kCountThreads, kPartBuckets * sizeof(int), s>>>(
        ids, offs, grid, l, part_blocks, op, 1LL << H);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* tspm_fused_error(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

#ifdef COUNT_PROBES
// The kernel before the partitioned design, as it was launched: a
// persistent grid of `blocks_per_sm` blocks an SM over the whole cohort.
extern "C" int tspm_fused_old(const void* phenx, const void* nevents, void* out, int P, int E,
                              int codec, int H, int shared, int threads, int blocks_per_sm,
                              void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H < 1 || H > 30 || (shared && H > kPartLog2)) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = (static_cast<long long>(shared ? (1 << H) : 0) + 2LL * E) * sizeof(int);
  const long long cap = static_cast<long long>(sms) * blocks_per_sm;
  const int blocks = static_cast<int>(P < cap ? P : cap);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const int*>(phenx);
  const auto np_ = static_cast<const int*>(nevents);
  const auto op = static_cast<int*>(out);
  if (shared) {
    if ((err = allow_smem(fused_kernel_old<true>, smem)) != cudaSuccess) return static_cast<int>(err);
    fused_kernel_old<true><<<blocks, threads, smem, s>>>(xp, np_, op, P, E, codec, H);
  } else {
    if ((err = allow_smem(fused_kernel_old<false>, smem)) != cudaSuccess) return static_cast<int>(err);
    fused_kernel_old<false><<<blocks, threads, smem, s>>>(xp, np_, op, P, E, codec, H);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif
