// Pieces of the tile blend kernels B1 (blend_forward) and B2
// (blend_backward) shared by blend.cu and blend_gs.cu: the lane -> pixel
// map, the transposed warp sum (and max) of per-lane rows, the shared-memory
// layouts of a block and the asynchronous staging of a batch of pair
// fields. blend.cu's head says what bounds B1 and B2 and how they are laid
// out.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace tiles {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 32;                  // warps of a 1024-pixel tile

// Pixel (lx, ly) of thread `lane` inside a tile_w x tile_h tile. Where the
// tile divides into 8x4 blocks each warp covers one (a compact footprint
// meets fewer pairs than a 32-pixel row), else the warps cover rows.
__device__ __forceinline__ void tile_pixel(int lane, int tile_w, int tile_h, int& lx, int& ly) {
  if (tile_w % 8 == 0 && tile_h % 4 == 0) {
    const int warp = lane >> 5, wl = lane & 31, per_row = tile_w >> 3;
    lx = (warp % per_row) * 8 + (wl & 7);
    ly = (warp / per_row) * 4 + (wl >> 3);
  } else {
    lx = lane % tile_w;
    ly = lane / tile_w;
  }
}

// One level of the transposed sum (kMax: max): each lane keeps the half of
// its N partial rows that its `bit` of the lane index selects and sends the
// other half to the lane across that bit, combining what it receives.
template <bool kMax, int N>
__device__ __forceinline__ void fold(const float (&in)[N], float (&out)[N / 2], int wl, int bit) {
  const bool upper = (wl & bit) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? in[i] : in[i + N / 2];
    const float keep = upper ? in[i + N / 2] : in[i];
    const float got = __shfl_xor_sync(kFullMask, send, bit);
    if constexpr (kMax) {
      out[i] = fmaxf(keep, got);
    } else {
      out[i] = keep + got;
    }
  }
}

// The sums (kMax: maxes) over the warp's 32 lanes of each of R <= 16
// per-lane rows, as a reduce-scatter: lanes 2r and 2r + 1 return row r's
// (rows from R to 15 reduce zeros). 8 + 4 + 2 + 1 + 1 = 16 shuffles for all
// rows, where a tree per row takes 5 each. A fixed order: the result does
// not change from run to run.
template <bool kMax, int R>
__device__ __forceinline__ float warp_rows(const float (&g)[R], int wl) {
  static_assert(R <= 16, "at most 16 rows");
  float r16[16], r8[8], r4[4], r2[2], r1[1];
#pragma unroll
  for (int i = 0; i < R; ++i) r16[i] = g[i];
#pragma unroll
  for (int i = R; i < 16; ++i) r16[i] = 0.0f;
  fold<kMax>(r16, r8, wl, 16);
  fold<kMax>(r8, r4, wl, 8);
  fold<kMax>(r4, r2, wl, 4);
  fold<kMax>(r2, r1, wl, 2);
  const float got = __shfl_xor_sync(kFullMask, r1[0], 1);
  if constexpr (kMax) {
    return fmaxf(r1[0], got);
  } else {
    return r1[0] + got;
  }
}

template <int R>
__device__ __forceinline__ float warp_sum_rows(const float (&g)[R], int wl) {
  return warp_rows<false>(g, wl);
}

template <int R>
__device__ __forceinline__ float warp_max_rows(const float (&g)[R], int wl) {
  return warp_rows<true>(g, wl);
}

// Shared memory of a B2 block: per gradient row, per staged entry, one
// partial sum per warp (+1 pad: the warps' writes of one entry and the
// cross-warp pass's reads of consecutive entries fall in distinct banks),
// then two buffers of the staged fields.
template <int kRows, int kFields, int kBatch>
struct BwdLayout {
  static constexpr int kEntry = kWarps + 1;              // floats per entry
  static constexpr int kRowStride = kBatch * kEntry + 1; // floats per row
  static constexpr int kPartFloats = kRows * kRowStride;
  static constexpr int kBufFloats = kFields * kBatch;
  static constexpr size_t kBytes = sizeof(float) * (kPartFloats + 2 * kBufFloats);
};

// Hit entries a B1 warp keeps before it sums their contributions (stats).
constexpr int kPend = 16;

// Shared memory of a B1 block, in floats from its start: two buffers of the
// staged fields; per staged entry its skip bound; with the stream (kStats)
// per staged entry and warp the warp's sum and max (+1 pad, as B2's), and
// per warp the contributions of up to kPend entries, one row of 32 lanes
// each, that it has not summed yet.
template <int kFields, int kBatch, bool kStats>
struct FwdLayout {
  static constexpr int kEntry = kWarps + 1;
  static constexpr int kBufFloats = kFields * kBatch;
  static constexpr int kBound = 2 * kBufFloats;
  static constexpr int kSum = kBound + kBatch;
  static constexpr int kMax = kSum + (kStats ? kBatch * kEntry : 0);
  static constexpr int kPending = kMax + (kStats ? kBatch * kEntry : 0);
  static constexpr int kFloats = kPending + (kStats ? kWarps * kPend * 32 : 0);
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// A B1 warp's pending rows (``npend`` <= kPend rows of 32 lanes at
// ``pend``; lane r holds row r's entry in ``pidx``) summed and maxed over
// the warp's lanes by the transposed reduction, each into the warp's slot of
// its entry in ``psum`` / ``pmax`` (kEntry floats per entry). Rows from
// npend on hold stale values: each row's result depends on that row alone,
// and theirs are not written.
template <int kEntry>
__device__ __forceinline__ void flush_pending(const float* pend, int pidx, int npend, int wl,
                                              int warp, float* psum, float* pmax) {
  __syncwarp();
  float g[kPend];
#pragma unroll
  for (int r = 0; r < kPend; ++r) g[r] = pend[r * 32 + wl];
  const float s = warp_sum_rows(g, wl);
  const float m = warp_max_rows(g, wl);
  const int r = wl >> 1;
  const int j = __shfl_sync(kFullMask, pidx, r);
  if ((wl & 1) == 0 && r < npend) {
    psum[j * kEntry + warp] = s;
    pmax[j * kEntry + warp] = m;
  }
  __syncwarp();
}

// Copy fields [0, kFields) of the tile's entries [base, base + nb) into
// buf (field-major, stride kBatch) without waiting: the copies land while
// the block computes the batch before; __pipeline_wait_prior(0) and a
// barrier make them visible.
template <int kFields, int kBatch>
__device__ __forceinline__ void stage_async(float* buf, const float* __restrict__ pairs, int mp,
                                            int base, int nb) {
  for (int i = threadIdx.x; i < kFields * kBatch; i += blockDim.x) {
    const int f = i / kBatch, j = i % kBatch;
    if (j < nb) __pipeline_memcpy_async(buf + i, pairs + (size_t)f * mp + base + j, sizeof(float));
  }
  __pipeline_commit();
}

}  // namespace tiles
