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
// bytes (3.35 TB/s): B3 moves one int32 in and one out per slot, B4 reads
// the sorted gradient columns once and writes one column per triangle, B5
// reads the two sorted contribution columns once and writes two values per
// triangle.
//
// The Pallas kernels work around the TPU's lack of a vector gather (a
// windowed DMA plus lane rotates for B3, a one-hot MXU matmul with a
// three-term bf16 split for B4). Hopper gathers per thread, so the designs
// here are direct:
//  - B3: one thread per output slot; a binary search over the aligned tile
//    starts finds the slot's tile, then the thread copies one source entry
//    or writes -1. Neighbouring threads read neighbouring source entries,
//    so loads and stores coalesce.
//  - B4: one thread per segment (triangle), summing its contiguous columns
//    in float32 registers. Segments average a few pairs, so neighbouring
//    threads read neighbouring columns; the (R, P) output store is
//    coalesced. Columns at or past `nvalid` are cut off the segment before
//    any load, so NaN in the unused tail cannot leak into a sum.
//  - B5: B4's design on two columns: one thread per segment sums the first
//    column in float32 and maxes the second (contributions are >= 0, so the
//    identity is 0 and an empty segment gives 0 for both), with the same
//    nvalid cut and the same launch plumbing. The Pallas kernel's one-hot
//    MXU products become a plain loop; no atomics, so the order of each sum
//    is fixed.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 16;

__global__ void relayout_pairs_kernel(const int* __restrict__ sorted_tri,
                                      const int* __restrict__ raw_starts,
                                      const int* __restrict__ astarts,
                                      const int* __restrict__ tile_counts,
                                      int num_tiles, int* __restrict__ out,
                                      int ma) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ma) return;
  // Last t in [0, num_tiles] with astarts[t] <= i (astarts[0] == 0). Empty
  // tiles share their start with the next tile; taking the last such t
  // picks the tile that owns the slot.
  int lo = 0, hi = num_tiles;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (astarts[mid] <= i) lo = mid; else hi = mid - 1;
  }
  int v = -1;
  if (lo < num_tiles) {
    const int j = i - astarts[lo];
    if (j < tile_counts[lo]) v = sorted_tri[raw_starts[lo] + j];
  }
  out[i] = v;
}

__global__ void segment_reduce_pairs_kernel(const float* __restrict__ cols,
                                            int nrows, int m,
                                            const int* __restrict__ starts,
                                            const int* __restrict__ ends,
                                            const int* __restrict__ nvalid_ptr,
                                            int p, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p) return;
  // Columns at or past nvalid count as zero: clipping the segment end
  // skips them entirely, so their (possibly NaN) values are never read.
  const int nvalid = min(*nvalid_ptr, m);
  const int s = starts[t];
  const int e = min(ends[t], nvalid);
  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.0f;
  for (int pos = s; pos < e; ++pos) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < nrows) acc[r] += cols[(size_t)r * m + pos];
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) out[(size_t)r * p + t] = r < nrows ? acc[r] : 0.0f;
}

__global__ void segment_reduce_stats_kernel(const float* __restrict__ sum_col,
                                            const float* __restrict__ max_col,
                                            int m, const int* __restrict__ starts,
                                            const int* __restrict__ ends,
                                            const int* __restrict__ nvalid_ptr,
                                            int p, float* __restrict__ sums,
                                            float* __restrict__ maxes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p) return;
  const int nvalid = min(*nvalid_ptr, m);
  const int s = starts[t];
  const int e = min(ends[t], nvalid);
  float acc = 0.0f, mx = 0.0f;
  for (int pos = s; pos < e; ++pos) {
    acc += sum_col[pos];
    mx = fmaxf(mx, max_col[pos]);
  }
  sums[t] = acc;
  maxes[t] = mx;
}

}  // namespace

extern "C" int ts_relayout_pairs(const int* sorted_tri, const int* raw_starts,
                                 const int* astarts, const int* tile_counts,
                                 int num_tiles, int* out, int ma,
                                 cudaStream_t stream) {
  if (ma > 0) {
    const int threads = 256;
    const int blocks = (ma + threads - 1) / threads;
    relayout_pairs_kernel<<<blocks, threads, 0, stream>>>(
        sorted_tri, raw_starts, astarts, tile_counts, num_tiles, out, ma);
  }
  return (int)cudaGetLastError();
}

extern "C" int ts_segment_reduce_pairs(const float* cols, int nrows, int m,
                                       const int* starts, const int* ends,
                                       const int* nvalid, int p, float* out,
                                       cudaStream_t stream) {
  if (nrows < 0 || nrows > kMaxRows) return (int)cudaErrorInvalidValue;
  if (p > 0) {
    const int threads = 256;
    const int blocks = (p + threads - 1) / threads;
    segment_reduce_pairs_kernel<<<blocks, threads, 0, stream>>>(
        cols, nrows, m, starts, ends, nvalid, p, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int ts_segment_reduce_stats(const float* sum_col, const float* max_col,
                                       int m, const int* starts, const int* ends,
                                       const int* nvalid, int p, float* sums,
                                       float* maxes, cudaStream_t stream) {
  if (p > 0) {
    const int threads = 256;
    const int blocks = (p + threads - 1) / threads;
    segment_reduce_stats_kernel<<<blocks, threads, 0, stream>>>(
        sum_col, max_col, m, starts, ends, nvalid, p, sums, maxes);
  }
  return (int)cudaGetLastError();
}
