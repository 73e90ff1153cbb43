// Pieces of B2 (blend_backward) shared by blend.cu and blend_gs.cu: the
// lane -> pixel map, the transposed warp sum of a pair's gradient rows, the
// shared-memory layout of a block and the asynchronous staging of a batch
// of pair fields. blend.cu's head says what bounds B2 and how it is laid out.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace bwd {

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

// One level of the transposed sum: each lane keeps the half of its N
// partial rows that its `bit` of the lane index selects and sends the other
// half to the lane across that bit, adding what it receives.
template <int N>
__device__ __forceinline__ void fold(const float (&in)[N], float (&out)[N / 2], int wl, int bit) {
  const bool upper = (wl & bit) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? in[i] : in[i + N / 2];
    const float keep = upper ? in[i + N / 2] : in[i];
    out[i] = keep + __shfl_xor_sync(kFullMask, send, bit);
  }
}

// The sums over the warp's 32 lanes of each of R <= 16 per-lane rows, as a
// reduce-scatter: lanes 2r and 2r + 1 return the sum of row r (rows from R
// to 15 sum zeros). 8 + 4 + 2 + 1 + 1 = 16 shuffles for all rows, where a
// tree per row takes 5 each. A fixed order: the result does not change from
// run to run.
template <int R>
__device__ __forceinline__ float warp_sum_rows(const float (&g)[R], int wl) {
  static_assert(R <= 16, "at most 16 rows");
  float r16[16], r8[8], r4[4], r2[2], r1[1];
#pragma unroll
  for (int i = 0; i < R; ++i) r16[i] = g[i];
#pragma unroll
  for (int i = R; i < 16; ++i) r16[i] = 0.0f;
  fold(r16, r8, wl, 16);
  fold(r8, r4, wl, 8);
  fold(r4, r2, wl, 4);
  fold(r2, r1, wl, 2);
  return r1[0] + __shfl_xor_sync(kFullMask, r1[0], 1);
}

// Shared memory of a B2 block: per gradient row, per staged entry, one
// partial sum per warp (+1 pad: the warps' writes of one entry and the
// cross-warp pass's reads of consecutive entries fall in distinct banks),
// then two buffers of the staged fields.
template <int kRows, int kFields, int kBatch>
struct Layout {
  static constexpr int kEntry = kWarps + 1;              // floats per entry
  static constexpr int kRowStride = kBatch * kEntry + 1; // floats per row
  static constexpr int kPartFloats = kRows * kRowStride;
  static constexpr int kBufFloats = kFields * kBatch;
  static constexpr size_t kBytes = sizeof(float) * (kPartFloats + 2 * kBufFloats);
};

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

}  // namespace bwd
