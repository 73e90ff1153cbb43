// Tile alpha-blend kernels of the triangle rasterizers, for Hopper (sm_90a).
//
// B1  blend_forward   replaces triangle_splatting_tpu/ops/pallas/blend.py
//                     blend_forward (:514, kernel _fwd_kernel :290)
// B2  blend_backward  replaces triangle_splatting_tpu/ops/pallas/blend.py
//                     blend_backward (:956, kernel _bwd_kernel :606)
//
// Two variants, each with rich info off, as template instantiations of the
// same kernels (Variant<k3D> below):
//   "2D" (photo training): 0..2 a1 = f0 + f1*px + f2*py, 3..5 a2 likewise,
//        6 opacity, 7..9 rgb;
//   "3D" (mesh training, perspective correct): 0..2 D = f0 + f1*px + f2*py,
//        3..5 A1, 6..8 A2 likewise, a1 = A1 / D, a2 = A2 / D (the ray-plane
//        barycentrics as ratios of three affine forms), 9 opacity,
//        10..12 rgb.
// The forward has a second template switch, kStats: the per-pair
// contribution stream of the ADC statistic window (Pallas blend.py
// :441-452, :475-493), (2, MP) float32 with row 0 = sum and row 1 = max
// over the tile's pixels of contrib = alive ? alpha * T_excl : 0. With
// kStats false the kernel is the stats-off kernel unchanged.
//
// What bounds them on the H100. Per (pair, pixel) evaluation the forward
// does ~30 float32 operations including one exp ("3D": ~40 and one
// division), the backward ~75 with one division ("3D": ~100 and two), and
// both read the pair fields from shared memory as broadcasts. Their inputs
// and outputs are a few tens of MB, so the device-memory bound is ~10-60 us
// while the float32 bound of the evaluations a frame needs (67 TFLOP/s
// without tensor cores) is tens to hundreds of us: both kernels are bound
// by operations, and in practice by the latency of one sequential loop per
// pixel.
//
// Design:
//  - one block per tile, one thread per pixel (tile_h * tile_w <= 1024
//    threads), so the per-pixel front-to-back loop of the reference CUDA
//    rasterizer is kept as it is and nothing is carried between blocks;
//  - the tile's pairs are staged into shared memory in batches; the forward
//    block leaves early once every pixel's transmittance is at or below
//    T_EPS (__syncthreads_count), as the Pallas while_loop does per slab;
//  - the backward walks each tile back to front from the forward's
//    n_contrib / final_T, rebuilding T by division as the reference
//    backward does. Each pair's gradient is summed over the tile's pixels
//    deterministically: a fixed warp-shuffle tree, then a fixed-order sum
//    over the warps in shared memory. There are no float atomics, and each
//    output slot belongs to exactly one tile, so blocks never collide;
//  - the per-(pair, pixel) arithmetic is written with explicitly rounded
//    intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn, ...) in the order the
//    plain PyTorch version evaluates it, so no multiply-add contraction
//    changes a rounding: the alpha mask, the transmittance and hence
//    n_contrib match the plain version bit for bit, and only the order of
//    sums differs. The build has no --use_fast_math;
//  - the stats form reduces each pair's contributions over the tile's
//    pixels as B2 reduces its gradients: a fixed warp-shuffle tree for the
//    sum and one for the max, then a fixed-order pass over the warps in
//    shared memory. No float atomics, so the sums that rank triangles for
//    pruning do not change from run to run. Its warps loop while any lane
//    is live (__any_sync): a finished pixel contributes 0 and skips every
//    state update, so color, final_T and n_contrib are those of the
//    stats-off form bit for bit. It stages 128 pairs per batch, so the
//    per-warp partials (128 x 33 x 2 floats) and the fields fit the 48 KB
//    of static shared memory. Every slot of the (2, MP) stream is written:
//    slots a tile never reached (early exit, alignment padding) and the
//    buffer's tail past the last tile get zeros from the blocks.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr float kTEps = (float)1e-4;             // blend.py T_EPS
constexpr float kAlphaMin = (float)(1.0 / 255.0);  // blend.py ALPHA_MIN
constexpr float kAlphaMax = (float)0.99;         // blend.py ALPHA_MAX
constexpr float kEccMax = 10.0f;                 // blend.py ECC_MAX
constexpr float kMinAbsD = (float)1e-8;          // |ray . n| guard ("3D")
constexpr int kNumFields = 16;
constexpr int kFwdBatch = 256;                   // pairs staged per batch
constexpr int kStatsBatch = 128;                 // ... in the stats form
constexpr int kMaxWarps = 32;

// Per variant: fields the kernels read, live gradient rows
// (LIVE_GRAD_ROWS[(variant, False)]), the opacity and first rgb field, and
// the backward's batch (its per-warp partial sums must fit the 48 KB of
// static shared memory: 24 x 13 x 33 floats for "3D").
template <bool k3D> struct Variant;
template <> struct Variant<false> {
  static constexpr int kFields = 10, kLive = 10, kOpac = 6, kRgb = 7, kBwdBatch = 32;
};
template <> struct Variant<true> {
  static constexpr int kFields = 13, kLive = 13, kOpac = 9, kRgb = 10, kBwdBatch = 24;
};

struct AlphaTerms {
  float a1, a2, a3, eccs, expp, alpha_un, alpha, invD;
  bool ok;
};

__device__ __forceinline__ float affine(float c0, float cx, float cy, float px, float py) {
  return __fadd_rn(__fadd_rn(c0, __fmul_rn(cx, px)), __fmul_rn(cy, py));
}

// blend.py _alpha_terms (:177-219) from the barycentrics on: the ecc
// falloff and the alpha masks, same evaluation order as the plain version,
// no contraction. ``ok_d`` is the "3D" plane guard (true for "2D").
__device__ __forceinline__ AlphaTerms alpha_tail(const float a1, const float a2,
                                                 const float invD, const bool ok_d,
                                                 const float opac, float gamma) {
  AlphaTerms r;
  r.a1 = a1;
  r.a2 = a2;
  r.invD = invD;
  r.a3 = __fsub_rn(__fsub_rn(1.0f, r.a1), r.a2);
  const float mn = fminf(fminf(r.a1, r.a2), r.a3);
  const float ecc = __fsub_rn(1.0f, __fmul_rn(3.0f, mn));
  bool ok = (ecc >= 0.0f) && (ecc <= kEccMax) && ok_d;
  r.eccs = fmaxf(ecc, 0.0f);
  float powed;
  if (gamma == 1.0f) {
    powed = __fmul_rn(r.eccs, r.eccs);
  } else {
    const float lg = __fmul_rn(__fmul_rn(2.0f, gamma), logf(r.eccs));
    powed = expf(fminf(fmaxf(lg, -87.0f), 44.0f));
  }
  r.expp = expf(__fmul_rn(-0.5f, powed));
  r.alpha_un = __fmul_rn(opac, r.expp);
  const float alpha = fminf(kAlphaMax, r.alpha_un);
  ok = ok && (alpha >= kAlphaMin);
  r.alpha = ok ? alpha : 0.0f;
  r.ok = ok;
  return r;
}

// "2D": the barycentrics are affine in the pixel.
__device__ __forceinline__ AlphaTerms alpha_terms_2d(
    const float f0, const float f1, const float f2, const float f3, const float f4,
    const float f5, const float opac, float px, float py, float gamma) {
  return alpha_tail(affine(f0, f1, f2, px, py), affine(f3, f4, f5, px, py), 1.0f,
                    true, opac, gamma);
}

// "3D": a1 = A1 / D and a2 = A2 / D, with the |D| >= 1e-8 guard and a
// correctly rounded reciprocal, as the plain version's 1 / where(ok, D, 1).
__device__ __forceinline__ AlphaTerms alpha_terms_3d(
    const float f0, const float f1, const float f2, const float f3, const float f4,
    const float f5, const float f6, const float f7, const float f8, const float opac,
    float px, float py, float gamma) {
  const float D = affine(f0, f1, f2, px, py);
  const bool ok_d = fabsf(D) >= kMinAbsD;
  const float invD = __fdiv_rn(1.0f, ok_d ? D : 1.0f);
  return alpha_tail(__fmul_rn(affine(f3, f4, f5, px, py), invD),
                    __fmul_rn(affine(f6, f7, f8, px, py), invD), invD, ok_d, opac,
                    gamma);
}

// The alpha terms of entry j of the staged batch.
template <bool k3D, int N, int B>
__device__ __forceinline__ AlphaTerms alpha_terms(const float (&sf)[N][B], int j,
                                                  float px, float py, float gamma) {
  if constexpr (k3D) {
    return alpha_terms_3d(sf[0][j], sf[1][j], sf[2][j], sf[3][j], sf[4][j], sf[5][j],
                          sf[6][j], sf[7][j], sf[8][j], sf[9][j], px, py, gamma);
  } else {
    return alpha_terms_2d(sf[0][j], sf[1][j], sf[2][j], sf[3][j], sf[4][j], sf[5][j],
                          sf[6][j], px, py, gamma);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <bool k3D, bool kStats>
__global__ void __launch_bounds__(1024) blend_forward_kernel(
    const float* __restrict__ pairs, int mp,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const float* __restrict__ params, int width, int height, int tile_w,
    int tile_h, int grid_w, float* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ normal,
    float* __restrict__ final_T, int* __restrict__ n_contrib,
    float* __restrict__ pair_contrib) {
  using V = Variant<k3D>;
  constexpr int kBatch = kStats ? kStatsBatch : kFwdBatch;
  __shared__ float sf[V::kFields][kBatch];
  const int tile = blockIdx.x;
  const int tx = tile % grid_w, ty = tile / grid_w;
  const int lane = threadIdx.x;
  const int x = tx * tile_w + lane % tile_w;
  const int y = ty * tile_h + lane / tile_w;
  const bool inside = x < width && y < height;
  const float px = (float)x, py = (float)y;
  const float gamma = params[0];
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];

  float T = inside ? 1.0f : 0.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int nc = 0;
  int done = 0;   // stats form: slots of the tile whose stream is written
  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // Uniform across the block: doubles as the barrier that keeps the
    // previous batch's readers ahead of this batch's writers.
    if (__syncthreads_count(T > kTEps) == 0) break;
    const int nb = min(kBatch, count - b0);
    for (int i = threadIdx.x; i < V::kFields * kBatch; i += blockDim.x) {
      const int f = i / kBatch, j = i % kBatch;
      if (j < nb) sf[f][j] = pairs[(size_t)f * mp + start + b0 + j];
    }
    __syncthreads();
    if constexpr (kStats) {
      // per batch entry, per warp (+1 pad against bank conflicts)
      __shared__ float psum[kStatsBatch][kMaxWarps + 1];
      __shared__ float pmax[kStatsBatch][kMaxWarps + 1];
      const int warp = lane >> 5, wl = lane & 31;
      int j = 0;
      for (; j < nb; ++j) {
        // the warp steps while any of its pixels is live, so that all 32
        // lanes reach the shuffle trees at the same entry
        const bool live = T > kTEps;
        if (!__any_sync(0xffffffffu, live)) break;
        float contrib = 0.0f;
        if (live) {
          ++nc;
          const AlphaTerms a = alpha_terms<k3D>(sf, j, px, py, gamma);
          if (a.ok) {
            contrib = __fmul_rn(a.alpha, T);
            c0 = __fadd_rn(c0, __fmul_rn(sf[V::kRgb][j], contrib));
            c1 = __fadd_rn(c1, __fmul_rn(sf[V::kRgb + 1][j], contrib));
            c2 = __fadd_rn(c2, __fmul_rn(sf[V::kRgb + 2][j], contrib));
            T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
          }
        }
        const float s = warp_sum(contrib);
        const float m = warp_max(contrib);
        if (wl == 0) {
          psum[j][warp] = s;
          pmax[j][warp] = m;
        }
      }
      // entries past the warp's last live pixel contribute nothing
      for (int k = j + wl; k < nb; k += 32) {
        psum[k][warp] = 0.0f;
        pmax[k][warp] = 0.0f;
      }
      __syncthreads();
      const int nwarps = blockDim.x >> 5;
      for (int i = lane; i < nb; i += blockDim.x) {
        float s = 0.0f, m = 0.0f;
        for (int w = 0; w < nwarps; ++w) {
          s += psum[i][w];
          m = fmaxf(m, pmax[i][w]);
        }
        pair_contrib[start + b0 + i] = s;
        pair_contrib[(size_t)mp + start + b0 + i] = m;
      }
      done = b0 + nb;
    } else {
      for (int j = 0; j < nb && T > kTEps; ++j) {
        // every entry iterated while the exclusive T > T_EPS counts, also
        // those skipped by the alpha cutoff (2D/3D last_contributor
        // semantics)
        ++nc;
        const AlphaTerms a = alpha_terms<k3D>(sf, j, px, py, gamma);
        if (a.ok) {
          const float contrib = __fmul_rn(a.alpha, T);
          c0 = __fadd_rn(c0, __fmul_rn(sf[V::kRgb][j], contrib));
          c1 = __fadd_rn(c1, __fmul_rn(sf[V::kRgb + 1][j], contrib));
          c2 = __fadd_rn(c2, __fmul_rn(sf[V::kRgb + 2][j], contrib));
          T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
        }
      }
    }
  }
  if constexpr (kStats) {
    // The tile's slots past the early exit and its alignment padding get
    // zeros, and every block zeroes a strided share of the buffer's tail
    // past the last tile's aligned end (slots of no tile).
    const int end = tile_starts[tile + 1];
    for (int i = start + done + lane; i < end; i += blockDim.x) {
      pair_contrib[i] = 0.0f;
      pair_contrib[(size_t)mp + i] = 0.0f;
    }
    const int tail0 = tile_starts[gridDim.x];
    for (int i = tail0 + blockIdx.x * blockDim.x + lane; i < mp;
         i += gridDim.x * blockDim.x) {
      pair_contrib[i] = 0.0f;
      pair_contrib[(size_t)mp + i] = 0.0f;
    }
  }
  if (!inside) return;
  const size_t hw = (size_t)height * width;
  const size_t o = (size_t)y * width + x;
  color[o] = __fadd_rn(c0, __fmul_rn(T, params[1]));
  color[hw + o] = __fadd_rn(c1, __fmul_rn(T, params[2]));
  color[2 * hw + o] = __fadd_rn(c2, __fmul_rn(T, params[3]));
  depth[o] = __fmul_rn(T, params[4]);
  normal[o] = 0.0f;
  normal[hw + o] = 0.0f;
  normal[2 * hw + o] = 0.0f;
  final_T[o] = T;
  n_contrib[o] = nc;
}

template <bool k3D>
__global__ void __launch_bounds__(1024) blend_backward_kernel(
    const float* __restrict__ pairs, int mp,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const float* __restrict__ params, int width, int height, int tile_w,
    int tile_h, int grid_w, int num_tiles, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, const float* __restrict__ g_color,
    const float* __restrict__ g_final_T, float* __restrict__ pair_grads) {
  using V = Variant<k3D>;
  constexpr int kBatch = V::kBwdBatch;
  constexpr int kLive = V::kLive;
  __shared__ float sf[V::kFields][kBatch];
  // per batch entry, per gradient row, per warp (+1 pad against bank
  // conflicts in the cross-warp sum)
  __shared__ float part[kBatch][kLive][kMaxWarps + 1];
  __shared__ int s_jmax;

  const int tile = blockIdx.x;
  const int tx = tile % grid_w, ty = tile / grid_w;
  const int lane = threadIdx.x;
  const int warp = lane >> 5, wl = lane & 31;
  const int nwarps = blockDim.x >> 5;
  const int x = tx * tile_w + lane % tile_w;
  const int y = ty * tile_h + lane / tile_w;
  const bool inside = x < width && y < height;
  const float px = (float)x, py = (float)y;
  const float gamma = params[0];
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const int count = tile_counts[tile];

  const size_t hw = (size_t)height * width;
  const size_t o = (size_t)y * width + x;
  const float fT = inside ? final_T[o] : 0.0f;
  const int nc_eff = inside ? min(n_contrib[o], count) : 0;
  const float gr = inside ? g_color[o] : 0.0f;
  const float gg = inside ? g_color[hw + o] : 0.0f;
  const float gb = inside ? g_color[2 * hw + o] : 0.0f;
  const float gft = inside ? g_final_T[o] : 0.0f;

  // Slots of the whole buffer past the last tile's aligned end belong to
  // no tile: every block zeroes a strided share of them.
  const int tail0 = tile_starts[num_tiles];
  for (int i = tail0 + blockIdx.x * blockDim.x + lane; i < mp;
       i += gridDim.x * blockDim.x) {
#pragma unroll
    for (int r = 0; r < kNumFields; ++r) pair_grads[(size_t)r * mp + i] = 0.0f;
  }

  if (lane == 0) s_jmax = 0;
  __syncthreads();
  int m = nc_eff;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  if (wl == 0) atomicMax(&s_jmax, m);
  __syncthreads();
  const int jmax = s_jmax;

  // Entries past the deepest contributor and the alignment padding get
  // zero gradients; rows past the live ones are structural zeros.
  for (int i = jmax + lane; i < end - start; i += blockDim.x) {
#pragma unroll
    for (int r = 0; r < kNumFields; ++r) pair_grads[(size_t)r * mp + start + i] = 0.0f;
  }
  for (int i = lane; i < jmax; i += blockDim.x) {
#pragma unroll
    for (int r = kLive; r < kNumFields; ++r) pair_grads[(size_t)r * mp + start + i] = 0.0f;
  }

  // Background term (everything behind the last entry) plus the direct
  // final_T cotangent: A = T_final * (bg . g + g_T).
  const float bg_dot = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(params[1], gr), __fmul_rn(params[2], gg)),
                __fmul_rn(params[3], gb)),
      gft);
  float A = __fmul_rn(fT, bg_dot);
  float T = fT;

  for (int b_end = jmax; b_end > 0; b_end -= kBatch) {
    const int b0 = max(0, b_end - kBatch);
    const int nb = b_end - b0;
    __syncthreads();   // the previous batch's cross-warp sums are done
    for (int i = lane; i < V::kFields * kBatch; i += blockDim.x) {
      const int f = i / kBatch, j = i % kBatch;
      if (j < nb) sf[f][j] = pairs[(size_t)f * mp + start + b0 + j];
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      float g[kLive];
#pragma unroll
      for (int k = 0; k < kLive; ++k) g[k] = 0.0f;
      bool nonzero = false;
      if (b0 + j < nc_eff) {
        const AlphaTerms a = alpha_terms<k3D>(sf, j, px, py, gamma);
        const float inv1m = __fdiv_rn(1.0f, __fsub_rn(1.0f, a.alpha));
        T = __fmul_rn(T, inv1m);                      // exclusive T of entry j
        const float contrib = __fmul_rn(a.alpha, T);
        const float gdot = __fadd_rn(
            __fadd_rn(__fmul_rn(sf[V::kRgb][j], gr), __fmul_rn(sf[V::kRgb + 1][j], gg)),
            __fmul_rn(sf[V::kRgb + 2][j], gb));
        const float dL_da = __fsub_rn(__fmul_rn(T, gdot), __fmul_rn(A, inv1m));
        A = __fadd_rn(A, __fmul_rn(contrib, gdot));   // suffix of later entries
        const float live = (a.ok && a.alpha_un < kAlphaMax) ? dL_da : 0.0f;
        const float d_opac = __fmul_rn(live, a.expp);
        float ecc_pow = a.eccs;
        if (gamma != 1.0f) {
          const float lg = __fmul_rn(__fsub_rn(__fmul_rn(2.0f, gamma), 1.0f), logf(a.eccs));
          ecc_pow = expf(fminf(fmaxf(lg, -87.0f), 44.0f));
        }
        const float dL_decc = __fmul_rn(__fmul_rn(__fmul_rn(live, a.alpha_un), -gamma), ecc_pow);
        // ecc subgradient on the argmin barycentric; a3 = 1 - a1 - a2
        const bool is1 = (a.a1 <= a.a2) && (a.a1 <= a.a3);
        const bool is2 = !is1 && (a.a2 <= a.a3);
        const bool is3 = !is1 && !is2;
        const float d_ecc3 = __fmul_rn(3.0f, dL_decc);
        const float s3 = is3 ? d_ecc3 : 0.0f;
        const float da1 = is1 ? -d_ecc3 : s3;
        const float da2 = is2 ? -d_ecc3 : s3;
        if constexpr (k3D) {
          // a_i = A_i / D: chain through the quotient into D, A1, A2
          const float dD = __fmul_rn(
              -__fadd_rn(__fmul_rn(da1, a.a1), __fmul_rn(da2, a.a2)), a.invD);
          const float dA1 = __fmul_rn(da1, a.invD);
          const float dA2 = __fmul_rn(da2, a.invD);
          g[0] = dD; g[1] = __fmul_rn(dD, px); g[2] = __fmul_rn(dD, py);
          g[3] = dA1; g[4] = __fmul_rn(dA1, px); g[5] = __fmul_rn(dA1, py);
          g[6] = dA2; g[7] = __fmul_rn(dA2, px); g[8] = __fmul_rn(dA2, py);
        } else {
          g[0] = da1; g[1] = __fmul_rn(da1, px); g[2] = __fmul_rn(da1, py);
          g[3] = da2; g[4] = __fmul_rn(da2, px); g[5] = __fmul_rn(da2, py);
        }
        // then opacity and rgb, the field order of the forward
        g[V::kOpac] = d_opac;
        g[V::kRgb] = __fmul_rn(contrib, gr);
        g[V::kRgb + 1] = __fmul_rn(contrib, gg);
        g[V::kRgb + 2] = __fmul_rn(contrib, gb);
        nonzero = a.alpha != 0.0f;
      }
      if (__any_sync(0xffffffffu, nonzero)) {
#pragma unroll
        for (int k = 0; k < kLive; ++k) {
          const float v = warp_sum(g[k]);
          if (wl == 0) part[j][k][warp] = v;
        }
      } else if (wl < kLive) {
        part[j][wl][warp] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = lane; i < kLive * nb; i += blockDim.x) {
      const int k = i / nb, j = i % nb;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += part[j][k][w];
      pair_grads[(size_t)k * mp + start + b0 + j] = s;
    }
  }
}

}  // namespace

extern "C" int ts_blend_forward(const float* pairs, int mp,
                                const int* tile_starts, const int* tile_counts,
                                const float* params, int width, int height,
                                int tile_w, int tile_h, int grid_w,
                                int num_tiles, int three_d, int stats,
                                float* color, float* depth, float* normal,
                                float* final_T, int* n_contrib,
                                float* pair_contrib, cudaStream_t stream) {
  const int threads = tile_w * tile_h;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (stats && pair_contrib == nullptr) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    const auto kernel =
        three_d ? (stats ? &blend_forward_kernel<true, true> : &blend_forward_kernel<true, false>)
                : (stats ? &blend_forward_kernel<false, true> : &blend_forward_kernel<false, false>);
    kernel<<<num_tiles, threads, 0, stream>>>(
        pairs, mp, tile_starts, tile_counts, params, width, height, tile_w,
        tile_h, grid_w, color, depth, normal, final_T, n_contrib, pair_contrib);
  }
  return (int)cudaGetLastError();
}

extern "C" int ts_blend_backward(const float* pairs, int mp,
                                 const int* tile_starts, const int* tile_counts,
                                 const float* params, int width, int height,
                                 int tile_w, int tile_h, int grid_w,
                                 int num_tiles, int three_d, const float* final_T,
                                 const int* n_contrib, const float* g_color,
                                 const float* g_final_T, float* pair_grads,
                                 cudaStream_t stream) {
  const int threads = tile_w * tile_h;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    const auto kernel = three_d ? &blend_backward_kernel<true> : &blend_backward_kernel<false>;
    kernel<<<num_tiles, threads, 0, stream>>>(
        pairs, mp, tile_starts, tile_counts, params, width, height, tile_w,
        tile_h, grid_w, num_tiles, final_T, n_contrib, g_color, g_final_T,
        pair_grads);
  }
  return (int)cudaGetLastError();
}
