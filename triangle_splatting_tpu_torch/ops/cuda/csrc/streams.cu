// Streaming pair-buffer kernels of the tile pipeline, for Hopper (sm_90a).
//
// B3  relayout_pairs        replaces triangle_splatting_tpu/ops/pallas/streams.py
//                           relayout_pairs (:100, kernel _relayout_kernel :67)
// B4  segment_reduce_pairs  replaces triangle_splatting_tpu/ops/pallas/streams.py
//                           segment_reduce_pairs (:221, kernel
//                           _segment_reduce_kernel :186)
// B5  segment_reduce_stats  replaces triangle_splatting_tpu/ops/pallas/streams.py
//                           segment_reduce_stats (:356, kernel
//                           _segment_stats_kernel :314)
//
// All three are pure data movement with a handful of integer or float
// operations per element, so on the H100 they are bound by device-memory
// bytes (3.35 TB/s).
//
// The Pallas kernels work around the TPU's lack of a vector gather (a
// windowed DMA plus lane rotates for B3, a one-hot MXU matmul with a
// three-term bf16 split for B4), and the JAX package sorts the per-pair
// gradient columns by owning triangle before B4 for the same reason: two
// MA-wide sorts a step (the pack backward's and the statistics'). A Hopper
// thread gathers and scatters, so the stage is designed around one map:
//  - B3: one thread per SORTED pair s. Its tile is sorted_key[s] >> dbits
//    (the unbinned tail carries the sentinel tile num_tiles), its aligned
//    slot astarts[tile] + s - raw_starts[tile]: no search. It writes
//    pair_tri[slot] = tri[sorted_raw[s]] (the owner gather of binning,
//    fused) and pack_perm[sorted_raw[s]] = slot, the owner-order map: raw
//    pairs are triangle-major, so triangle t's pairs are map entries
//    [tri_offsets[t], tri_offsets[t+1]). Raw pairs past num_pairs map to
//    the empty slots after the last tile, one each. One warp per tile
//    writes the tile's pad slots (< align of them) and a grid-stride loop
//    the slots past the last tile, so every slot is written once, in one
//    launch. Bytes: 12 read and 4 + 4 written per raw pair, 4 per slot.
//  - B4: one thread per segment (triangle), summing its rows in float32
//    registers in segment order; with the map, position pos of the segment
//    is column pack_perm[pos] of B2's (16, MA) output, read in place, so
//    nothing is sorted or copied first. (A thread per segment and row was
//    4% faster at 800^2 and twice as slow at the city's 992k triangles,
//    where each row re-read the segment bounds.) Within a triangle the raw order is
//    ascending tile, which is the ascending-slot order the owner sort gave,
//    so every sum is added in the same order as before, bit for bit. The
//    gathered reads use 4 B of each 32 B sector; B2's output was just
//    written and much of it is still in the 50 MB L2. With a null map the
//    columns are already owner-sorted (the JAX contract). Positions at or
//    past nvalid are cut off the segment before any load, so NaN in the
//    unused tail cannot leak into a sum.
//  - B5: the per-triangle sum of the first row of B1's (2, MA) stream and
//    max of the second (contributions are >= 0, so the identity is 0 and
//    an empty segment gives 0 for both), read through B3's map as B4 reads
//    B2's rows: position pos of a segment is column pack_perm[pos], so the
//    stream is neither sorted nor gathered first (the null-map form takes
//    owner-sorted columns, the JAX contract). Segments are short (2.7 pairs
//    a triangle at 800^2 / 100k) but ragged, so a warp takes 32
//    consecutive triangles, whose positions are one span [lo, hi): it reads
//    the span's map entries coalesced and gathers both rows, 8 loads of
//    each a lane in flight, into shared memory, 256 positions a round;
//    then each lane adds its own triangle's values from shared memory in
//    ascending position, carrying its sum across rounds. That is the
//    order of the one-thread-per-segment loop on gathered columns, so
//    every sum is that route's bit for bit; no atomics. The same nvalid
//    cut: positions at or past it are never read. Bytes: 4 for the map
//    entry and 8 for the two values a binned pair, the bounds, the (2, P)
//    output.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 16;
constexpr int kThreads = 256;
// blocks of the grid-stride loop over the slots past the last tile
constexpr int kTailBlocks = 4 * 132;
// B5: positions a warp stages in shared memory per round
constexpr int kStatsChunk = 256;

// Block roles by blockIdx.x: [0, pair_blocks) one thread per sorted pair,
// then pad_blocks with one warp per tile, then the tail's blocks.
__global__ void relayout_pairs_kernel(const int* __restrict__ tri,
                                      const int* __restrict__ sorted_raw,
                                      const int* __restrict__ sorted_key,
                                      const int* __restrict__ raw_starts,
                                      const int* __restrict__ astarts,
                                      int num_tiles, int dbits, int n, int ma,
                                      int pair_blocks, int pad_blocks,
                                      int* __restrict__ pair_tri,
                                      int* __restrict__ pack_perm) {
  const int b = blockIdx.x;
  if (b < pair_blocks) {
    const int s = b * kThreads + threadIdx.x;
    if (s >= n) return;
    const int tile = min((int)((unsigned)sorted_key[s] >> dbits), num_tiles);
    const int slot = astarts[tile] + (s - raw_starts[tile]);
    const int r = sorted_raw[s];
    pack_perm[r] = slot;
    if (tile < num_tiles) pair_tri[slot] = tri[r];
    return;
  }
  if (b < pair_blocks + pad_blocks) {
    const int t = ((b - pair_blocks) * kThreads + threadIdx.x) >> 5;
    if (t >= num_tiles) return;
    const int end = astarts[t + 1];
    for (int slot = astarts[t] + (raw_starts[t + 1] - raw_starts[t]) + (threadIdx.x & 31);
         slot < end; slot += 32)
      pair_tri[slot] = -1;
    return;
  }
  const int stride = (gridDim.x - pair_blocks - pad_blocks) * kThreads;
  for (int slot = astarts[num_tiles] + (b - pair_blocks - pad_blocks) * kThreads + threadIdx.x;
       slot < ma; slot += stride)
    pair_tri[slot] = -1;
}

// kMapped: position pos of a segment is column perm[pos] of cols (B2's
// output read in place); otherwise column pos (owner-sorted columns).
template <bool kMapped>
__global__ void segment_reduce_pairs_kernel(const float* __restrict__ cols,
                                            int nrows, int m,
                                            const int* __restrict__ perm, int nperm,
                                            const int* __restrict__ starts,
                                            const int* __restrict__ ends,
                                            const int* __restrict__ nvalid_ptr,
                                            int p, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p) return;
  // Positions at or past nvalid count as zero: clipping the segment end
  // skips them entirely, so their (possibly NaN) values are never read.
  const int nvalid = min(*nvalid_ptr, kMapped ? nperm : m);
  const int e = min(ends[t], nvalid);
  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.0f;
  for (int pos = starts[t]; pos < e; ++pos) {
    const size_t col = kMapped ? (size_t)perm[pos] : (size_t)pos;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < nrows) acc[r] += cols[(size_t)r * m + col];
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) out[(size_t)r * p + t] = r < nrows ? acc[r] : 0.0f;
}

// kMapped: position pos of a segment is column perm[pos] of both rows
// (B1's stream read in place); otherwise column pos (owner-sorted
// columns). Blocks of kThreads: a warp per 32 consecutive segments.
template <bool kMapped>
__global__ void __launch_bounds__(kThreads) segment_reduce_stats_kernel(
    const float* __restrict__ sum_col, const float* __restrict__ max_col, int m,
    const int* __restrict__ perm, int nperm, const int* __restrict__ starts,
    const int* __restrict__ ends, const int* __restrict__ nvalid_ptr, int p,
    float* __restrict__ sums, float* __restrict__ maxes) {
  constexpr int kLoads = kStatsChunk / 32;
  __shared__ float s_sum[kThreads / 32][kStatsChunk];
  __shared__ float s_max[kThreads / 32][kStatsChunk];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int nvalid = min(*nvalid_ptr, kMapped ? nperm : m);
  // this lane's segment cut at nvalid (empty past p), and the warp's span
  int s = 0, e = 0;
  if (t < p) {
    s = starts[t];
    e = min(ends[t], nvalid);
  }
  int lo = s < e ? s : INT_MAX, hi = s < e ? e : INT_MIN;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  float acc = 0.0f, mx = 0.0f;
  for (int c0 = lo; c0 < hi; c0 += kStatsChunk) {
    const int n = min(kStatsChunk, hi - c0);
    int col[kLoads];
    float vs[kLoads], vm[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = j * 32 + lane;
      col[j] = i < n ? (kMapped ? perm[c0 + i] : c0 + i) : 0;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (j * 32 + lane < n) {
        vs[j] = sum_col[col[j]];
        vm[j] = max_col[col[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      if (j * 32 + lane < n) {
        s_sum[w][j * 32 + lane] = vs[j];
        s_max[w][j * 32 + lane] = vm[j];
      }
    }
    __syncwarp();
    const int b = min(e, c0 + n);
    for (int pos = max(s, c0); pos < b; ++pos) {
      acc += s_sum[w][pos - c0];
      mx = fmaxf(mx, s_max[w][pos - c0]);
    }
    __syncwarp();   // every value read before the next round writes
  }
  if (t < p) {
    sums[t] = acc;
    maxes[t] = mx;
  }
}

}  // namespace

extern "C" int ts_relayout_pairs(const int* tri, const int* sorted_raw,
                                 const int* sorted_key, const int* raw_starts,
                                 const int* astarts, int num_tiles, int dbits,
                                 int n, int* pair_tri, int* pack_perm, int ma,
                                 cudaStream_t stream) {
  if (num_tiles < 0 || dbits < 0 || dbits > 30) return (int)cudaErrorInvalidValue;
  const int pair_blocks = (n + kThreads - 1) / kThreads;
  const int pad_blocks = (num_tiles * 32 + kThreads - 1) / kThreads;
  const int ma_blocks = (ma + kThreads - 1) / kThreads;
  const int tail_blocks = ma_blocks < kTailBlocks ? ma_blocks : kTailBlocks;
  const int blocks = pair_blocks + pad_blocks + tail_blocks;
  if (blocks > 0) {
    relayout_pairs_kernel<<<blocks, kThreads, 0, stream>>>(
        tri, sorted_raw, sorted_key, raw_starts, astarts, num_tiles, dbits, n,
        ma, pair_blocks, pad_blocks, pair_tri, pack_perm);
  }
  return (int)cudaGetLastError();
}

// perm == nullptr: the owner-sorted form (cols already in segment order).
extern "C" int ts_segment_reduce_pairs(const float* cols, int nrows, int m,
                                       const int* perm, int nperm,
                                       const int* starts, const int* ends,
                                       const int* nvalid, int p, float* out,
                                       cudaStream_t stream) {
  if (nrows < 0 || nrows > kMaxRows) return (int)cudaErrorInvalidValue;
  if (p > 0) {
    const int blocks = (p + kThreads - 1) / kThreads;
    if (perm != nullptr) {
      segment_reduce_pairs_kernel<true><<<blocks, kThreads, 0, stream>>>(
          cols, nrows, m, perm, nperm, starts, ends, nvalid, p, out);
    } else {
      segment_reduce_pairs_kernel<false><<<blocks, kThreads, 0, stream>>>(
          cols, nrows, m, perm, nperm, starts, ends, nvalid, p, out);
    }
  }
  return (int)cudaGetLastError();
}

// perm == nullptr: the owner-sorted form (columns already in segment order).
extern "C" int ts_segment_reduce_stats(const float* sum_col, const float* max_col, int m,
                                       const int* perm, int nperm, const int* starts,
                                       const int* ends, const int* nvalid, int p,
                                       float* sums, float* maxes, cudaStream_t stream) {
  if (p > 0) {
    const int blocks = (p + kThreads - 1) / kThreads;
    if (perm != nullptr) {
      segment_reduce_stats_kernel<true><<<blocks, kThreads, 0, stream>>>(
          sum_col, max_col, m, perm, nperm, starts, ends, nvalid, p, sums, maxes);
    } else {
      segment_reduce_stats_kernel<false><<<blocks, kThreads, 0, stream>>>(
          sum_col, max_col, m, perm, nperm, starts, ends, nvalid, p, sums, maxes);
    }
  }
  return (int)cudaGetLastError();
}
