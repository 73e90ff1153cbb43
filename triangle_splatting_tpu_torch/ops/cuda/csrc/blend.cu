// Tile alpha-blend kernels of the 2D triangle rasterizer, for Hopper (sm_90a).
//
// B1  blend_forward   replaces triangle_splatting_tpu/ops/pallas/blend.py
//                     blend_forward (:514, kernel _fwd_kernel :290)
// B2  blend_backward  replaces triangle_splatting_tpu/ops/pallas/blend.py
//                     blend_backward (:956, kernel _bwd_kernel :606)
//
// Only the variant the photo-training path runs is here: "2D", rich info
// off, contribution statistics off. Fields per pair (field-major (16, MP)):
//   0..2 a1 = f0 + f1*px + f2*py, 3..5 a2 likewise, 6 opacity, 7..9 rgb.
//
// What bounds them on the H100. Per (pair, pixel) evaluation the forward
// does ~30 float32 operations including one exp, the backward ~75 with one
// division, and both read the pair fields from shared memory as broadcasts.
// Their inputs and outputs are a few tens of MB, so the device-memory bound
// is ~10 us while the float32 bound of the evaluations a frame needs
// (67 TFLOP/s without tensor cores) is tens of us: both kernels are bound
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
//    intrinsics (__fadd_rn, __fmul_rn, ...) in the order the plain PyTorch
//    version evaluates it, so no multiply-add contraction changes a
//    rounding: the alpha mask, the transmittance and hence n_contrib match
//    the plain version bit for bit, and only the order of sums differs.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr float kTEps = (float)1e-4;             // blend.py T_EPS
constexpr float kAlphaMin = (float)(1.0 / 255.0);  // blend.py ALPHA_MIN
constexpr float kAlphaMax = (float)0.99;         // blend.py ALPHA_MAX
constexpr float kEccMax = 10.0f;                 // blend.py ECC_MAX
constexpr int kFwdFields = 10;                   // fields the forward reads
constexpr int kLiveRows = 10;                    // LIVE_GRAD_ROWS[("2D", False)]
constexpr int kNumFields = 16;
constexpr int kFwdBatch = 256;                   // pairs staged per batch
constexpr int kBwdBatch = 32;
constexpr int kMaxWarps = 32;

struct AlphaTerms {
  float a1, a2, a3, eccs, expp, alpha_un, alpha;
  bool ok;
};

// blend.py _alpha_terms (:177-219) for the 2D variant, same evaluation
// order, no contraction.
__device__ __forceinline__ AlphaTerms alpha_terms(const float f0, const float f1,
                                                  const float f2, const float f3,
                                                  const float f4, const float f5,
                                                  const float opac, float px,
                                                  float py, float gamma) {
  AlphaTerms r;
  r.a1 = __fadd_rn(__fadd_rn(f0, __fmul_rn(f1, px)), __fmul_rn(f2, py));
  r.a2 = __fadd_rn(__fadd_rn(f3, __fmul_rn(f4, px)), __fmul_rn(f5, py));
  r.a3 = __fsub_rn(__fsub_rn(1.0f, r.a1), r.a2);
  const float mn = fminf(fminf(r.a1, r.a2), r.a3);
  const float ecc = __fsub_rn(1.0f, __fmul_rn(3.0f, mn));
  bool ok = (ecc >= 0.0f) && (ecc <= kEccMax);
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

__global__ void __launch_bounds__(1024) blend_forward_kernel(
    const float* __restrict__ pairs, int mp,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const float* __restrict__ params, int width, int height, int tile_w,
    int tile_h, int grid_w, float* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ normal,
    float* __restrict__ final_T, int* __restrict__ n_contrib) {
  __shared__ float sf[kFwdFields][kFwdBatch];
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
  for (int b0 = 0; b0 < count; b0 += kFwdBatch) {
    // Uniform across the block: doubles as the barrier that keeps the
    // previous batch's readers ahead of this batch's writers.
    if (__syncthreads_count(T > kTEps) == 0) break;
    const int nb = min(kFwdBatch, count - b0);
    for (int i = threadIdx.x; i < kFwdFields * kFwdBatch; i += blockDim.x) {
      const int f = i / kFwdBatch, j = i % kFwdBatch;
      if (j < nb) sf[f][j] = pairs[(size_t)f * mp + start + b0 + j];
    }
    __syncthreads();
    for (int j = 0; j < nb && T > kTEps; ++j) {
      // every entry iterated while the exclusive T > T_EPS counts, also
      // those skipped by the alpha cutoff (2D last_contributor semantics)
      ++nc;
      const AlphaTerms a = alpha_terms(sf[0][j], sf[1][j], sf[2][j], sf[3][j],
                                       sf[4][j], sf[5][j], sf[6][j], px, py,
                                       gamma);
      if (a.ok) {
        const float contrib = __fmul_rn(a.alpha, T);
        c0 = __fadd_rn(c0, __fmul_rn(sf[7][j], contrib));
        c1 = __fadd_rn(c1, __fmul_rn(sf[8][j], contrib));
        c2 = __fadd_rn(c2, __fmul_rn(sf[9][j], contrib));
        T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
      }
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(1024) blend_backward_kernel(
    const float* __restrict__ pairs, int mp,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const float* __restrict__ params, int width, int height, int tile_w,
    int tile_h, int grid_w, int num_tiles, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, const float* __restrict__ g_color,
    const float* __restrict__ g_final_T, float* __restrict__ pair_grads) {
  __shared__ float sf[kFwdFields][kBwdBatch];
  // per batch entry, per gradient row, per warp (+1 pad against bank
  // conflicts in the cross-warp sum)
  __shared__ float part[kBwdBatch][kLiveRows][kMaxWarps + 1];
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
    for (int r = kLiveRows; r < kNumFields; ++r) pair_grads[(size_t)r * mp + start + i] = 0.0f;
  }

  // Background term (everything behind the last entry) plus the direct
  // final_T cotangent: A = T_final * (bg . g + g_T).
  const float bg_dot = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(params[1], gr), __fmul_rn(params[2], gg)),
                __fmul_rn(params[3], gb)),
      gft);
  float A = __fmul_rn(fT, bg_dot);
  float T = fT;

  for (int b_end = jmax; b_end > 0; b_end -= kBwdBatch) {
    const int b0 = max(0, b_end - kBwdBatch);
    const int nb = b_end - b0;
    __syncthreads();   // the previous batch's cross-warp sums are done
    for (int i = lane; i < kFwdFields * kBwdBatch; i += blockDim.x) {
      const int f = i / kBwdBatch, j = i % kBwdBatch;
      if (j < nb) sf[f][j] = pairs[(size_t)f * mp + start + b0 + j];
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      float g[kLiveRows];
#pragma unroll
      for (int k = 0; k < kLiveRows; ++k) g[k] = 0.0f;
      bool nonzero = false;
      if (b0 + j < nc_eff) {
        const AlphaTerms a = alpha_terms(sf[0][j], sf[1][j], sf[2][j], sf[3][j],
                                         sf[4][j], sf[5][j], sf[6][j], px, py,
                                         gamma);
        const float inv1m = __fdiv_rn(1.0f, __fsub_rn(1.0f, a.alpha));
        T = __fmul_rn(T, inv1m);                      // exclusive T of entry j
        const float contrib = __fmul_rn(a.alpha, T);
        const float gdot = __fadd_rn(
            __fadd_rn(__fmul_rn(sf[7][j], gr), __fmul_rn(sf[8][j], gg)),
            __fmul_rn(sf[9][j], gb));
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
        g[0] = da1; g[1] = __fmul_rn(da1, px); g[2] = __fmul_rn(da1, py);
        g[3] = da2; g[4] = __fmul_rn(da2, px); g[5] = __fmul_rn(da2, py);
        g[6] = d_opac;
        g[7] = __fmul_rn(contrib, gr);
        g[8] = __fmul_rn(contrib, gg);
        g[9] = __fmul_rn(contrib, gb);
        nonzero = a.alpha != 0.0f;
      }
      if (__any_sync(0xffffffffu, nonzero)) {
#pragma unroll
        for (int k = 0; k < kLiveRows; ++k) {
          const float v = warp_sum(g[k]);
          if (wl == 0) part[j][k][warp] = v;
        }
      } else if (wl < kLiveRows) {
        part[j][wl][warp] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = lane; i < kLiveRows * nb; i += blockDim.x) {
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
                                int num_tiles, float* color, float* depth,
                                float* normal, float* final_T, int* n_contrib,
                                cudaStream_t stream) {
  const int threads = tile_w * tile_h;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    blend_forward_kernel<<<num_tiles, threads, 0, stream>>>(
        pairs, mp, tile_starts, tile_counts, params, width, height, tile_w,
        tile_h, grid_w, color, depth, normal, final_T, n_contrib);
  }
  return (int)cudaGetLastError();
}

extern "C" int ts_blend_backward(const float* pairs, int mp,
                                 const int* tile_starts, const int* tile_counts,
                                 const float* params, int width, int height,
                                 int tile_w, int tile_h, int grid_w,
                                 int num_tiles, const float* final_T,
                                 const int* n_contrib, const float* g_color,
                                 const float* g_final_T, float* pair_grads,
                                 cudaStream_t stream) {
  const int threads = tile_w * tile_h;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    blend_backward_kernel<<<num_tiles, threads, 0, stream>>>(
        pairs, mp, tile_starts, tile_counts, params, width, height, tile_w,
        tile_h, grid_w, num_tiles, final_T, n_contrib, g_color, g_final_T,
        pair_grads);
  }
  return (int)cudaGetLastError();
}
