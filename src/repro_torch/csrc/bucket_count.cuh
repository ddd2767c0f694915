// Shared-memory counting of bucket ids into an int32 table, for Hopper
// (sm_90a): the one design of seq_hist.cu and tspm_fused.cu.
//
// Both kernels turn a stream of counted ids (a masked histogram input, or
// the hashed pairs of patient rows) into `out[b] += 1` for each id `b` of a
// table of n_buckets entries.  Global atomics into a 4 MB table (H = 20)
// run at ~75-86 G adds/s from L2; shared-memory atomics are far faster but
// a block holds at most 2^15 int32 buckets (128 KB).  So:
//
//   * n_buckets <= 2^15: each block keeps a private copy of the table in
//     shared memory and flushes its non-zero entries with global atomics
//     (2^15 adds a block at most, not one per id);
//   * larger tables are cut into partitions of 2^15 buckets (the high bits
//     of the id name the partition, the low 15 its local bucket), and the
//     count runs in two stages:
//       (a) bin: every counted id goes to its warp's bin of its partition
//           in shared memory (a shared atomic on the warp's count of that
//           partition) as a uint16 local bucket; before a bin could
//           overflow, the warp writes each bin to its partition's scratch
//           segment as one run, 2 B an id.  Warps bin and flush on their
//           own, with no block barrier;
//       (b) count: the blocks of a partition count its segment into a
//           2^15-bucket shared table with shared atomics and add the table
//           to their slice of `out` (plain adds when one block owns the
//           partition, global atomics of the non-zero entries when a few
//           blocks share it so that all SMs work).
//     No counted id is a global atomic.  Segments are sized from counts,
//     never from an even share, so one bucket that collects every id fits.
//
// How (a) finds its offsets: a counting pass writes each block's count per
// partition, a one-block scan turns those counts into offsets
// (partition-major, so each partition's segment is contiguous), and the
// binning pass writes each flushed bin at the block's running offset of its
// partition (a shared atomic a partition a flush).  The input is read (or
// its pairs enumerated) twice.
//
// A table of more than kGroupParts partitions (H > 21) is counted one
// group of kGroupParts partitions at a time, each group a full pipeline
// over the input, so the shared arrays stay small.  Integer sums are exact
// in any order, so the table is byte-identical to the plain scatter-add.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bucket_count {

constexpr int kPartLog2 = 15;
constexpr int kPartBuckets = 1 << kPartLog2;   // one partition: 128 KB of int32
constexpr int kGroupParts = 64;                // partitions one pipeline pass takes
constexpr int kWarpBinIds = 4096;              // a warp's bins, all partitions together
constexpr int kCountThreads = 1024;            // stage (b)
constexpr int kScanThreads = 1024;

// Stage (a) of one warp, in the block's dynamic shared memory after the
// block's offsets: a bin of C = kWarpBinIds / np local buckets
// for each partition of the group.  A pushed id takes the next slot of its
// partition's bin (a shared atomic on the warp's count); before a push
// could overflow a bin, the warp writes every bin out as one run each, with
// no block barrier: warps bin and flush on their own.
struct WarpBins {
  uint16_t* bin;      // [kWarpBinIds] np bins of C slots
  int* cnt;           // [kGroupParts] ids in each bin
};

constexpr int kBaseBytes = kGroupParts * 4;
constexpr int kWarpBinBytes = kWarpBinIds * 2 + kGroupParts * 4;

// Shared memory of stage (a) for a block of `warps` warps.
__host__ __device__ constexpr int stage_bytes(int warps) {
  return kBaseBytes + warps * kWarpBinBytes;
}

__device__ inline unsigned* stage_base(unsigned char* mem) {
  return reinterpret_cast<unsigned*>(mem);
}

__device__ inline WarpBins warp_bins_at(unsigned char* mem, int warp) {
  WarpBins w;
  w.bin = reinterpret_cast<uint16_t*>(mem + kBaseBytes + warp * kWarpBinBytes);
  w.cnt = reinterpret_cast<int*>(w.bin + kWarpBinIds);
  return w;
}

// Whether id `v` lies in the partitions [lo, lo + np) of the current group.
__device__ __forceinline__ bool in_group(uint32_t v, int lo, int np) {
  return static_cast<unsigned>(static_cast<int>(v >> kPartLog2) - lo) <
         static_cast<unsigned>(np);
}

// Puts `v` in its partition's bin where `keep` (an id of the group); bins
// hold C slots.  Returns, the same in every lane, whether a bin holds more
// than C - 32 ids, so that the next push could overflow it: every lane of
// the warp calls it, and flushes when it returns true.
__device__ __forceinline__ bool warp_bin(const WarpBins& w, int C, bool keep, uint32_t v,
                                         int lo) {
  bool full = false;
  if (keep) {
    const int p = static_cast<int>(v >> kPartLog2) - lo;
    const int pos = atomicAdd(&w.cnt[p], 1);
    w.bin[p * C + pos] = static_cast<uint16_t>(v & (kPartBuckets - 1));
    full = pos >= C - 32;
  }
  return __any_sync(0xffffffffu, full);
}

// The calling warp writes each bin's ids (np <= kGroupParts <= 64: lane l
// holds partitions l and l + 32) to `ids` as one run, partition p's at the
// block's running offset base[p] (a shared atomic), and empties the bins.
__device__ inline void warp_flush(const WarpBins& w, int C, int np, unsigned* base,
                                  uint16_t* ids) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  const int c0 = lane < np ? w.cnt[lane] : 0;
  const int c1 = lane + 32 < np ? w.cnt[lane + 32] : 0;
  unsigned g0 = 0, g1 = 0;
  if (c0) g0 = atomicAdd(&base[lane], static_cast<unsigned>(c0));
  if (c1) g1 = atomicAdd(&base[lane + 32], static_cast<unsigned>(c1));
  for (int p = 0; p < np; ++p) {
    const int c = __shfl_sync(0xffffffffu, p < 32 ? c0 : c1, p & 31);
    const unsigned g = __shfl_sync(0xffffffffu, p < 32 ? g0 : g1, p & 31);
    for (int k = lane; k < c; k += 32) ids[g + k] = w.bin[p * C + k];
  }
  __syncwarp();
  if (lane < np) w.cnt[lane] = 0;
  if (lane + 32 < np) w.cnt[lane + 32] = 0;
  __syncwarp();
}

// Block-wide: loads the block's offsets and empties every warp's bins.
__device__ inline void stage_begin(unsigned char* mem, const unsigned* offs, int G, int np) {
  for (int p = threadIdx.x; p < np; p += blockDim.x)
    stage_base(mem)[p] = offs[static_cast<size_t>(p) * G + blockIdx.x];
  const int warps = blockDim.x >> 5;
  for (int q = threadIdx.x; q < warps * kGroupParts; q += blockDim.x)
    warp_bins_at(mem, q / kGroupParts).cnt[q % kGroupParts] = 0;
  __syncthreads();
}

// Exclusive prefix sum of offs[0, m) in place, offs[m] = the total: one
// block of kScanThreads, over chunks of kScanChunk words loaded and stored
// coalesced through shared memory, each thread scanning kScanPer of them
// and the warps' sums scanned by shuffles.
constexpr int kScanPer = 8;
constexpr int kScanChunk = kScanThreads * kScanPer;

__device__ __forceinline__ unsigned warp_inclusive(unsigned x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kScanThreads) scan_offsets(unsigned* offs, int m) {
  __shared__ unsigned tile[kScanChunk + kScanChunk / 32];   // one pad word each 32
  __shared__ unsigned warp_sums[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  auto at = [](int q) { return q + q / 32; };
  unsigned carry = 0;
  for (int c0 = 0; c0 < m; c0 += kScanChunk) {
    for (int q = t; q < kScanChunk; q += kScanThreads)
      tile[at(q)] = c0 + q < m ? offs[c0 + q] : 0u;
    __syncthreads();
    unsigned own = 0;
#pragma unroll
    for (int e = 0; e < kScanPer; ++e) own += tile[at(t * kScanPer + e)];
    const unsigned incl = warp_inclusive(own);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_inclusive(warp_sums[lane]);
    __syncthreads();
    unsigned run = carry + (warp ? warp_sums[warp - 1] : 0u) + incl - own;
#pragma unroll
    for (int e = 0; e < kScanPer; ++e) {
      const unsigned v = tile[at(t * kScanPer + e)];
      tile[at(t * kScanPer + e)] = run;
      run += v;
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
    for (int q = t; q < kScanChunk && c0 + q < m; q += kScanThreads) offs[c0 + q] = tile[at(q)];
    __syncthreads();
  }
  if (t == 0) offs[m] = carry;
}

// Adds a block's shared table of `width` buckets to out[0, width): plain
// adds when the block owns that slice, global atomics of the non-zero
// entries when blocks share it.
__device__ inline void table_flush(const int* table, int width, int* out, bool shared_slice) {
  for (int b = threadIdx.x; b < width; b += blockDim.x) {
    const int c = table[b];
    if (!c) continue;
    if (shared_slice)
      atomicAdd(&out[b], c);
    else
      out[b] += c;
  }
}

// Stage (b) setup of block blockIdx.x: partition p of the group (k blocks
// a partition, this one the s-th), its table zeroed; returns the width.
__device__ inline int count_begin(int* table, int lo, int k, long long n_buckets, int* p_out,
                                  int* s_out) {
  const int p = blockIdx.x / k;
  *p_out = p;
  *s_out = blockIdx.x - p * k;
  const long long first = static_cast<long long>(lo + p) << kPartLog2;
  const int width = static_cast<int>(min(static_cast<long long>(kPartBuckets),
                                         n_buckets - first));
  for (int b = threadIdx.x; b < width; b += blockDim.x) table[b] = 0;
  __syncthreads();
  return width;
}

// Counts ids[a, b) into `table` with shared atomics, 8 ids (16 B) a load
// in the aligned middle.
__device__ inline void count_range(const uint16_t* ids, unsigned long long a,
                                   unsigned long long b, int* table) {
  const unsigned long long mid_a = min(b, (a + 7ull) & ~7ull);
  const unsigned long long mid_b = mid_a + ((b - mid_a) & ~7ull);
  for (unsigned long long q = a + threadIdx.x; q < mid_a; q += blockDim.x)
    atomicAdd(&table[ids[q]], 1);
  const uint4* v = reinterpret_cast<const uint4*>(ids + mid_a);
  const unsigned long long words = (mid_b - mid_a) / 8;
  for (unsigned long long q = threadIdx.x; q < words; q += blockDim.x) {
    const uint4 w = v[q];
    const uint32_t parts[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      atomicAdd(&table[parts[e] & 0xFFFFu], 1);
      atomicAdd(&table[parts[e] >> 16], 1);
    }
  }
  for (unsigned long long q = mid_b + threadIdx.x; q < b; q += blockDim.x)
    atomicAdd(&table[ids[q]], 1);
}

// Stage (b): offs[p * G] .. offs[(p + 1) * G] is partition p's
// contiguous segment; its k blocks take an eighth-aligned share each.
__global__ void __launch_bounds__(kCountThreads)
count_segments(const uint16_t* __restrict__ ids, const unsigned* __restrict__ offs, int G,
               int lo, int k, int* __restrict__ out, long long n_buckets) {
  extern __shared__ int table[];
  int p, s;
  const int width = count_begin(table, lo, k, n_buckets, &p, &s);
  const unsigned long long seg_a = offs[static_cast<size_t>(p) * G];
  const unsigned long long len = offs[static_cast<size_t>(p + 1) * G] - seg_a;
  const unsigned long long per = ((len + k - 1) / k + 7ull) & ~7ull;
  const unsigned long long a = seg_a + min(len, per * s), b = seg_a + min(len, per * (s + 1));
  count_range(ids, a, b, table);
  __syncthreads();
  table_flush(table, width, out + (static_cast<long long>(lo + p) << kPartLog2), k > 1);
}


// Scratch: [align16(2 * cap_ids) bytes of uint16 ids][offsets:
// (min(P, kGroupParts) * G + 1) uint32].  The wrappers reckon the same
// bytes (kernels/bucket_count.py).
inline long long scratch_bytes(long long cap_ids, long long parts, int G) {
  const long long np = parts < kGroupParts ? parts : kGroupParts;
  return ((2 * cap_ids + 15) / 16) * 16 + 4 * (np * G + 1);
}

inline long long n_parts(long long n_buckets) {
  return (n_buckets + kPartBuckets - 1) / kPartBuckets;
}

}  // namespace bucket_count
