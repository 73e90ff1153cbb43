// Tile alpha-blend kernels of the triangle rasterizers, for Hopper (sm_90a).
//
// B1  blend_forward   replaces triangle_splatting_tpu/ops/pallas/blend.py
//                     blend_forward (:514, kernel _fwd_kernel :290)
// B2  blend_backward  replaces triangle_splatting_tpu/ops/pallas/blend.py
//                     blend_backward (:956, kernel _bwd_kernel :606)
//
// Two variants as template instantiations of the same kernels
// (Variant<k3D, kRich> below):
//   "2D" (photo training): 0..2 a1 = f0 + f1*px + f2*py, 3..5 a2 likewise,
//        6 opacity, 7..9 rgb; with rich info 10 d0, 11..13 normal,
//        14 d1, 15 d2 (depth d0 + d1*a1 + d2*a2);
//   "3D" (mesh training, perspective correct): 0..2 D = f0 + f1*px + f2*py,
//        3..5 A1, 6..8 A2 likewise, a1 = A1 / D, a2 = A2 / D (the ray-plane
//        barycentrics as ratios of three affine forms), 9 opacity,
//        10..12 rgb; with rich info 13 K (ray depth K / D; the raw normal
//        comes from the D rows, Pallas blend.py :411-420).
// The forward has two more template switches. kStats: the per-pair
// contribution stream of the ADC statistic window (Pallas blend.py
// :441-452, :475-493), (2, MP) float32 with row 0 = sum and row 1 = max
// over the tile's pixels of contrib = alive ? alpha * T_excl : 0. kRich:
// the depth and normal accumulators (Pallas :403-420, :504-506); the
// backward takes their cotangents (:653-677, :768-784, :858-906). With a
// switch false the kernel is the kernel without it, unchanged. Both
// switches on give the form the triangle renderer facade runs with rich
// info (depth, normal and the stream from one launch).
//
// What bounds them on the H100. Per (pair, pixel) evaluation the forward
// does ~30 float32 operations including one exp ("3D": ~40 and one
// division; rich info adds ~14 / ~9), the backward ~75 with one division
// ("3D": ~100 and two; rich info adds ~31 / ~22), and
// both read the pair fields from shared memory as broadcasts. Their inputs
// and outputs are a few tens of MB, so the device-memory bound is ~10-60 us
// while the float32 bound of the evaluations a frame needs (67 TFLOP/s
// without tensor cores) is tens to hundreds of us: both kernels are bound
// by operations, and in practice by the instructions a warp issues per
// entry it reaches. As first written (a warp per 32-pixel row of the tile,
// every entry's alpha terms evaluated at every live pixel, a 5-level
// shuffle tree per reduced row) most of that went to entries that hit no
// pixel of the warp: 72-89% of the forward's warp-entries, whose falloff
// (at gamma 50 a log and two exps) B1 still evaluated; to the stats
// form's two trees per warp-entry (16-20% of its time); and in the
// backward to the trees (10-30%) and the chain of entries no pixel hits
// (13-29%) (PERF.md, Findings).
//
// Design:
//  - one block per tile, one thread per pixel (tile_h * tile_w <= 1024
//    threads), so the per-pixel front-to-back loop of the reference CUDA
//    rasterizer is kept as it is and nothing is carried between blocks. A
//    warp covers an 8x4 block of the tile (fewer pairs reach a compact
//    block than a row; blend_common.cuh tile_pixel), and blocks take the
//    tiles heaviest first (a tile order from the wrapper: rasterize
//    computes it once a step for B1 and B2), so the last wave is not one
//    long tile;
//  - the tile's pairs are staged into dynamic shared memory in batches,
//    the next batch's fields copied in (cp.async) while one is computed:
//    256 entries a batch forward, 64-96 backward. The forward block leaves
//    early once every pixel's transmittance is at or below T_EPS
//    (__syncthreads_count), as the Pallas while_loop does per slab;
//  - the alpha terms come in two halves: the ecc, then the falloff (an
//    exp; at gamma != 1 a log and two exps). Between them the warp tests
//    each pixel's ecc against a bound from the entry's opacity (ecc_bound,
//    once per staged entry) past which alpha < 1/255 for certain, and
//    evaluates the falloff only if some live (forward) or processed
//    (backward) pixel of the warp is within it (__any_sync: the skip is
//    warp-uniform). The forward culls before even the ecc: each lane tests
//    one of the next 32 entries against the box of the warp's pixels
//    (box_may_hit: the barycentrics' largest values over the box, at its
//    corners, with a margin over every rounding), and the warp takes only
//    the entries whose bit the ballot sets, ~10% of them on random scenes
//    (PERF.md). The per-pixel test after the cull still pays where alpha
//    is near binary (gamma 50 on the city's surface: 12% of B1) and costs
//    3-10% at gamma 1; the kernel with the test only at gamma != 1 ran 2-5%
//    slower than this one at gamma 50 (PERF.md, Findings). An entry
//    the forward culls or skips changes no pixel's state: each pixel counts
//    it in n_contrib all the same, which the forward takes at the pixel's
//    end (the 1-based index of the entry that takes T to T_EPS or below,
//    else the tile's count);
//  - the backward walks each tile back to front from the forward's
//    n_contrib / final_T, rebuilding T by division as the reference
//    backward does. Where no pixel of the warp is processed with
//    alpha != 0 it leaves T, the suffix sum A and the rows as they are:
//    1 / (1 - 0) is exactly 1 and contrib exactly 0, so that is exact;
//    entries past the warp's deepest contributor it does not evaluate at
//    all. Where some pixel hits, the chain runs and the warp sums each
//    gradient row over its 32 pixels by a transposed reduction (16
//    shuffles for up to 16 rows, not 5 a row), then a fixed-order pass over
//    the warps in shared memory;
//  - the forward's stats form reduces each pair's contributions over the
//    tile's pixels. An entry that the warp skipped has sum and max exactly
//    0 there; the others the warp keeps as pending rows of its 32 lanes in
//    shared memory and sums (and maxes) 16 at a time by the transposed
//    reduction; then a fixed-order pass over the warps. Its warps step
//    while any lane is live, a finished pixel contributing 0 and skipping
//    every state update, as in the forms without the stream, so color,
//    final_T and n_contrib (and with rich info depth and normal) are those
//    of the stats-off form bit for bit. Every slot of the (2, MP) stream is
//    written: slots a tile never reached (early exit, alignment padding)
//    and the buffer's tail past the last tile get zeros from the blocks;
//  - no float atomics anywhere, each output slot belongs to exactly one
//    tile: two launches give the same bits, and the sums that rank
//    triangles for pruning do not change from run to run;
//  - the per-(pair, pixel) arithmetic is written with explicitly rounded
//    intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn, ...) in the order the
//    plain PyTorch version evaluates it, so no multiply-add contraction
//    changes a rounding: the alpha mask, the transmittance and hence
//    n_contrib match the plain version bit for bit (and B2's alpha mask is
//    B1's), and only the order of sums differs. The build has no
//    --use_fast_math. A pixel's entries are composited in list order
//    through one inlined helper (composite_entry) that takes and returns
//    its state by value, so the accumulators stay registers;
//  - the rich forms add four per-pixel accumulators (depth and the three
//    normal rows) to the forward and the depth / normal cotangents to the
//    backward's gdot, background term and gradient rows. They leave every
//    other operation as it is, so color, final_T and n_contrib are those
//    of the forms without rich info bit for bit. The backward sums 16
//    ("2D") or 14 ("3D") live rows.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <type_traits>

#include "blend_common.cuh"

namespace {

constexpr float kTEps = (float)1e-4;             // blend.py T_EPS
constexpr float kAlphaMin = (float)(1.0 / 255.0);  // blend.py ALPHA_MIN
constexpr float kAlphaMax = (float)0.99;         // blend.py ALPHA_MAX
constexpr float kEccMax = 10.0f;                 // blend.py ECC_MAX
constexpr float kMinAbsD = (float)1e-8;          // |ray . n| guard ("3D")
constexpr int kNumFields = 16;

// Per variant and rich switch: fields the kernels read, live gradient rows
// (LIVE_GRAD_ROWS[(variant, rich)]), the opacity and first rgb field, and
// the backward's batch: the entries staged at a time, sized so that one
// pass of the block's 1,024 threads sums a batch's rows over the warps
// (live rows x batch <= 1024) and the per-warp partials fit the dynamic
// shared memory (tiles::BwdLayout: 134,440 B "2D", 131,092 B
// "3D", 143,424 B "2D" rich, 141,176 B "3D" rich).
template <bool k3D, bool kRich> struct Variant;
template <> struct Variant<false, false> {
  static constexpr int kFields = 10, kLive = 10, kOpac = 6, kRgb = 7, kBwdBatch = 96;
};
template <> struct Variant<true, false> {
  static constexpr int kFields = 13, kLive = 13, kOpac = 9, kRgb = 10, kBwdBatch = 72;
};
template <> struct Variant<false, true> {
  static constexpr int kFields = 16, kLive = 16, kOpac = 6, kRgb = 7, kBwdBatch = 64;
};
template <> struct Variant<true, true> {
  static constexpr int kFields = 14, kLive = 14, kOpac = 9, kRgb = 10, kBwdBatch = 72;
};

struct AlphaTerms {
  float a1, a2, a3, eccs, expp, alpha_un, alpha, invD;
  bool ok;
};

__device__ __forceinline__ float affine(float c0, float cx, float cy, float px, float py) {
  return __fadd_rn(__fadd_rn(c0, __fmul_rn(cx, px)), __fmul_rn(cy, py));
}

// blend.py _alpha_terms (:177-219) from the barycentrics on, same
// evaluation order as the plain version, no contraction, in two halves so
// that B2 can test an entry between them. First the ecc and its range and
// plane masks (``ok_d`` is the "3D" plane guard, true for "2D") ...
__device__ __forceinline__ AlphaTerms ecc_terms(const float a1, const float a2,
                                                const float invD, const bool ok_d) {
  AlphaTerms r;
  r.a1 = a1;
  r.a2 = a2;
  r.invD = invD;
  r.a3 = __fsub_rn(__fsub_rn(1.0f, r.a1), r.a2);
  const float mn = fminf(fminf(r.a1, r.a2), r.a3);
  const float ecc = __fsub_rn(1.0f, __fmul_rn(3.0f, mn));
  r.ok = (ecc >= 0.0f) && (ecc <= kEccMax) && ok_d;
  r.eccs = fmaxf(ecc, 0.0f);
  return r;
}

// ... then the ecc falloff and the alpha mask.
__device__ __forceinline__ AlphaTerms alpha_falloff(AlphaTerms r, const float opac,
                                                    float gamma) {
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
  r.ok = r.ok && (alpha >= kAlphaMin);
  r.alpha = r.ok ? alpha : 0.0f;
  return r;
}

// "2D": the barycentrics are affine in the pixel.
__device__ __forceinline__ AlphaTerms ecc_terms_2d(
    const float f0, const float f1, const float f2, const float f3, const float f4,
    const float f5, float px, float py) {
  return ecc_terms(affine(f0, f1, f2, px, py), affine(f3, f4, f5, px, py), 1.0f, true);
}

// "3D": a1 = A1 / D and a2 = A2 / D, with the |D| >= 1e-8 guard and a
// correctly rounded reciprocal, as the plain version's 1 / where(ok, D, 1).
__device__ __forceinline__ AlphaTerms ecc_terms_3d(
    const float f0, const float f1, const float f2, const float f3, const float f4,
    const float f5, const float f6, const float f7, const float f8, float px, float py) {
  const float D = affine(f0, f1, f2, px, py);
  const bool ok_d = fabsf(D) >= kMinAbsD;
  const float invD = __fdiv_rn(1.0f, ok_d ? D : 1.0f);
  return ecc_terms(__fmul_rn(affine(f3, f4, f5, px, py), invD),
                   __fmul_rn(affine(f6, f7, f8, px, py), invD), invD, ok_d);
}

// The ecc terms of entry j of the staged batch.
template <bool k3D, int N, int B>
__device__ __forceinline__ AlphaTerms ecc_terms_at(const float (&sf)[N][B], int j, float px,
                                                   float py) {
  if constexpr (k3D) {
    return ecc_terms_3d(sf[0][j], sf[1][j], sf[2][j], sf[3][j], sf[4][j], sf[5][j],
                        sf[6][j], sf[7][j], sf[8][j], px, py);
  } else {
    return ecc_terms_2d(sf[0][j], sf[1][j], sf[2][j], sf[3][j], sf[4][j], sf[5][j], px, py);
  }
}

// The largest ecc at which an entry of opacity ``opac`` can still reach
// alpha >= ALPHA_MIN at ``gamma`` (the pre-test of B1 and B2): past it, ecc^(2 gamma)
// >= 2 ln(opac / ALPHA_MIN) + 2e-3, which keeps alpha_un = opac exp(-0.5
// ecc^(2 gamma)) below ALPHA_MIN through every rounding of alpha_falloff
// (relative errors < 1e-5 in powed, expf and the product); the bound adds
// a relative 1e-5 for its own rounding. -1 where alpha never reaches
// ALPHA_MIN (opac below it); +inf where there is no bound (gamma <= 0, a
// NaN opacity). In double, once per staged entry.
__device__ __forceinline__ float ecc_bound(float opac, float gamma) {
  if (!(gamma > 0.0f) || opac != opac) return __int_as_float(0x7f800000);
  if (!(opac >= kAlphaMin)) return -1.0f;
  const double c = 2.0 * log((double)opac / (double)kAlphaMin) + 2e-3;
  return (float)(pow(c, 0.5 / (double)gamma) * (1.0 + 1e-5));
}

// The largest value over the box [x0, x1] x [y0, y1] of the affine
// c0 + cx px + cy py (at a corner), and the magnitude of its terms at the
// box's far corner (px, py >= 0), in the order of cull_plain in
// ops/cuda/blend.py.
__device__ __forceinline__ float box_max(float c0, float cx, float cy, float x0, float x1,
                                         float y0, float y1) {
  return __fadd_rn(__fadd_rn(c0, fmaxf(__fmul_rn(cx, x0), __fmul_rn(cx, x1))),
                   fmaxf(__fmul_rn(cy, y0), __fmul_rn(cy, y1)));
}

__device__ __forceinline__ float magnitude(float c0, float cx, float cy, float x1, float y1) {
  return __fadd_rn(__fadd_rn(fabsf(c0), __fmul_rn(fabsf(cx), x1)), __fmul_rn(fabsf(cy), y1));
}

constexpr float kCullMargin = 2e-5f;   // relative to the magnitude of the terms

// The forward's cull of entry j for one warp, before any ecc: false only
// where no pixel of the warp's box [x0, x1] x [y0, y1] can have an ecc
// within ``bound`` (the entry's ecc_bound), so that alpha is 0 at each of
// them. Each pixel's ecc is 1 - 3 min(a1, a2, a3) >= 1 - 3 min_i max a_i,
// the maxima over the box, at its corners: the barycentrics are affine in
// "2D", and in "3D" ratios A_i / D of affine forms, whose extremes over the
// box lie at its corners where D keeps its sign over it (else, or where D
// comes near 0 against its terms, no cull). The lower bound gives up a
// margin of kCullMargin times the magnitude of the terms (in "3D" over
// min |D|), several times the rounding of the kernel's ecc and of this
// test's own (each ~3e-6 of it). NaN anywhere: no cull. Its twin is cull_plain in
// ops/cuda/blend.py, in the same float32 operations.
template <bool k3D, int N, int B>
__device__ __forceinline__ bool box_may_hit(const float (&sf)[N][B], int j, float x0, float x1,
                                            float y0, float y1, float bound) {
  float lower;
  if constexpr (k3D) {
    const float f0 = sf[0][j], f1 = sf[1][j], f2 = sf[2][j];
    const float g0 = __fsub_rn(__fsub_rn(f0, sf[3][j]), sf[6][j]);   // A3 = D - A1 - A2
    const float g1 = __fsub_rn(__fsub_rn(f1, sf[4][j]), sf[7][j]);
    const float g2 = __fsub_rn(__fsub_rn(f2, sf[5][j]), sf[8][j]);
    float dlo = __int_as_float(0x7f800000), dhi = -dlo, dabs = dlo;
    float hi1 = -dlo, hi2 = -dlo, hi3 = -dlo, amax = 0.0f;
#pragma unroll 1   // one corner at a time: unrolled, the "3D" rich forms spill
    for (int c = 0; c < 4; ++c) {
      const float px = (c & 1) ? x1 : x0, py = (c & 2) ? y1 : y0;
      const float D = affine(f0, f1, f2, px, py);
      const float inv = __fdiv_rn(1.0f, D);
      const float a1 = __fmul_rn(affine(sf[3][j], sf[4][j], sf[5][j], px, py), inv);
      const float a2 = __fmul_rn(affine(sf[6][j], sf[7][j], sf[8][j], px, py), inv);
      const float a3 = __fmul_rn(affine(g0, g1, g2, px, py), inv);
      dlo = fminf(dlo, D);
      dhi = fmaxf(dhi, D);
      dabs = fminf(dabs, fabsf(D));
      hi1 = fmaxf(hi1, a1);
      hi2 = fmaxf(hi2, a2);
      hi3 = fmaxf(hi3, a3);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(a1), fabsf(a2)), fabsf(a3)));
    }
    const float sd = magnitude(f0, f1, f2, x1, y1);
    const float sa = __fadd_rn(magnitude(sf[3][j], sf[4][j], sf[5][j], x1, y1),
                               magnitude(sf[6][j], sf[7][j], sf[8][j], x1, y1));
    if (!((dlo > 0.0f || dhi < 0.0f) && dabs > __fmul_rn(1e-3f, sd))) return true;
    const float r = __fadd_rn(__fadd_rn(__fdiv_rn(__fmul_rn(__fadd_rn(sd, sa),
                                                            __fadd_rn(1.0f, amax)), dabs),
                                        amax), 1.0f);
    const float m = fminf(fminf(hi1, hi2), hi3);
    lower = __fsub_rn(__fsub_rn(1.0f, __fmul_rn(3.0f, m)), __fmul_rn(kCullMargin, r));
  } else {
    const float f0 = sf[0][j], f1 = sf[1][j], f2 = sf[2][j];
    const float f3 = sf[3][j], f4 = sf[4][j], f5 = sf[5][j];
    const float g0 = __fsub_rn(__fsub_rn(1.0f, f0), f3);              // a3 = 1 - a1 - a2
    const float g1 = -__fadd_rn(f1, f4), g2 = -__fadd_rn(f2, f5);
    const float m = fminf(fminf(box_max(f0, f1, f2, x0, x1, y0, y1),
                                box_max(f3, f4, f5, x0, x1, y0, y1)),
                          box_max(g0, g1, g2, x0, x1, y0, y1));
    const float r = __fadd_rn(__fadd_rn(1.0f, magnitude(f0, f1, f2, x1, y1)),
                              magnitude(f3, f4, f5, x1, y1));
    lower = __fsub_rn(__fsub_rn(1.0f, __fmul_rn(3.0f, m)), __fmul_rn(kCullMargin, r));
  }
  return !(lower > bound);
}

// A pixel's composite state: the transmittance, the color and (rich form)
// depth and normal accumulators, and the last entry's contribution.
struct Composite {
  float T, c0, c1, c2, dacc, n0, n1, n2, contrib;
};

// Entry j composited into a pixel's front-to-back state, given its alpha
// terms with the falloff evaluated: where the alpha mask keeps the entry,
// its contribution alpha * T_excl, the color (with rich info the depth and
// normal) accumulators and T; else only contrib = 0. The state goes in and
// out by value, so the kernel's accumulators stay registers.
template <bool k3D, bool kRich, int N, int B>
__device__ __forceinline__ Composite composite_entry(const float (&sf)[N][B], int j,
                                                     const AlphaTerms a, Composite s) {
  using V = Variant<k3D, kRich>;
  s.contrib = 0.0f;
  if (a.ok) {
    s.contrib = __fmul_rn(a.alpha, s.T);
    s.c0 = __fadd_rn(s.c0, __fmul_rn(sf[V::kRgb][j], s.contrib));
    s.c1 = __fadd_rn(s.c1, __fmul_rn(sf[V::kRgb + 1][j], s.contrib));
    s.c2 = __fadd_rn(s.c2, __fmul_rn(sf[V::kRgb + 2][j], s.contrib));
    if constexpr (kRich && k3D) {
      // ray depth K / D, and the raw normal sum of the D rows
      s.dacc = __fadd_rn(s.dacc, __fmul_rn(sf[13][j], __fmul_rn(s.contrib, a.invD)));
      s.n0 = __fadd_rn(s.n0, __fmul_rn(sf[0][j], s.contrib));
      s.n1 = __fadd_rn(s.n1, __fmul_rn(sf[1][j], s.contrib));
      s.n2 = __fadd_rn(s.n2, __fmul_rn(sf[2][j], s.contrib));
    } else if constexpr (kRich) {
      // depth d0 + d1 * a1 + d2 * a2, normal rows 11..13
      s.dacc = __fadd_rn(s.dacc, __fadd_rn(
          __fadd_rn(__fmul_rn(sf[10][j], s.contrib),
                    __fmul_rn(sf[14][j], __fmul_rn(s.contrib, a.a1))),
          __fmul_rn(sf[15][j], __fmul_rn(s.contrib, a.a2))));
      s.n0 = __fadd_rn(s.n0, __fmul_rn(sf[11][j], s.contrib));
      s.n1 = __fadd_rn(s.n1, __fmul_rn(sf[12][j], s.contrib));
      s.n2 = __fadd_rn(s.n2, __fmul_rn(sf[13][j], s.contrib));
    }
    s.T = __fmul_rn(s.T, __fsub_rn(1.0f, a.alpha));
  }
  return s;
}

// B1's batch: the entries staged at a time, two buffers of them in dynamic
// shared memory with the per-entry bounds and, with the stream, the
// per-warp partials and pending rows (tiles::FwdLayout: 21,504 B "2D" to
// 166,912 B "2D" rich + stats).
constexpr int kFwdBatch = 256;

template <bool k3D, bool kStats, bool kRich>
__global__ void __launch_bounds__(1024, 1) blend_forward_kernel(
    const float* __restrict__ pairs, int mp,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const long long* __restrict__ tile_order, const float* __restrict__ params, int width,
    int height, int tile_w, int tile_h, int grid_w, float* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ normal,
    float* __restrict__ final_T, int* __restrict__ n_contrib,
    float* __restrict__ pair_contrib) {
  using V = Variant<k3D, kRich>;
  using L = tiles::FwdLayout<V::kFields, kFwdBatch, kStats>;
  using Fields = float[V::kFields][kFwdBatch];
  extern __shared__ float smem[];
  float* const s_bound = smem + L::kBound;
  float* const psum = smem + L::kSum;       // stats form: per entry, per warp
  float* const pmax = smem + L::kMax;

  const int tile = (int)tile_order[blockIdx.x];          // heaviest tiles first
  const int tx = tile % grid_w, ty = tile / grid_w;
  const int lane = threadIdx.x;
  const int warp = lane >> 5, wl = lane & 31;
  float* const pend = smem + L::kPending + warp * tiles::kPend * 32;
  int lx, ly;
  tiles::tile_pixel(lane, tile_w, tile_h, lx, ly);
  const int x = tx * tile_w + lx;
  const int y = ty * tile_h + ly;
  const bool inside = x < width && y < height;
  const float px = (float)x, py = (float)y;
  // the box of the warp's pixels, for the cull
  const float bx0 = (float)__reduce_min_sync(tiles::kFullMask, x);
  const float bx1 = (float)__reduce_max_sync(tiles::kFullMask, x);
  const float by0 = (float)__reduce_min_sync(tiles::kFullMask, y);
  const float by1 = (float)__reduce_max_sync(tiles::kFullMask, y);
  const float gamma = params[0];
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];

  Composite s{inside ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // n_contrib counts the entries a pixel meets while its exclusive T is
  // above T_EPS, also those the alpha mask drops (2D/3D last_contributor
  // semantics): the 1-based index of the entry that takes T to T_EPS or
  // below, else the tile's count
  int nc = 0;
  int done = 0;   // stats form: slots of the tile whose stream is written
  if (count > 0)
    tiles::stage_async<V::kFields, kFwdBatch>(smem, pairs, mp, start, min(kFwdBatch, count));
  int buf = 0;
  for (int b0 = 0; b0 < count; b0 += kFwdBatch, buf ^= 1) {
    const int nb = min(kFwdBatch, count - b0);
    __pipeline_wait_prior(0);
    // Uniform across the block: doubles as the barrier that makes this
    // batch's fields visible and keeps the last batch's readers ahead of
    // this batch's writers. The next batch's fields are copied in while
    // this one is computed.
    if (__syncthreads_count(s.T > kTEps) == 0) break;
    if (b0 + nb < count)
      tiles::stage_async<V::kFields, kFwdBatch>(smem + (buf ^ 1) * L::kBufFloats, pairs, mp,
                                                start + b0 + nb, min(kFwdBatch, count - b0 - nb));
    const Fields& sf = *reinterpret_cast<const Fields*>(smem + buf * L::kBufFloats);
    for (int j = lane; j < nb; j += blockDim.x) s_bound[j] = ecc_bound(sf[V::kOpac][j], gamma);
    __syncthreads();
    // j: the warp has passed the entries before it (all of them, unless
    // its last live pixel ends inside the batch)
    int j = 0, npend = 0, pidx = 0;
    bool wlive = __any_sync(tiles::kFullMask, s.T > kTEps);
    for (int w0 = 0; wlive && w0 < nb; w0 += 32) {
      // each lane culls one of the next 32 entries for the warp's box; an
      // entry culled or skipped changes nothing (its count in n_contrib is
      // taken at the pixel's end) and contributes 0
      const int jl = w0 + wl;
      const bool maybe = jl < nb && box_may_hit<k3D>(sf, jl, bx0, bx1, by0, by1, s_bound[jl]);
      if constexpr (kStats) {
        if (jl < nb && !maybe) psum[jl * L::kEntry + warp] = pmax[jl * L::kEntry + warp] = 0.0f;
      }
      j = min(w0 + 32, nb);
      for (unsigned m = __ballot_sync(tiles::kFullMask, maybe); m != 0; m &= m - 1) {
        const int jj = w0 + __ffs(m) - 1;
        const bool live = s.T > kTEps;
        const AlphaTerms e = ecc_terms_at<k3D>(sf, jj, px, py);
        // then the falloff only if a live pixel of the warp is within the bound
        if (!__any_sync(tiles::kFullMask, live && e.ok && e.eccs <= s_bound[jj])) {
          if constexpr (kStats) {
            if (wl == 0) psum[jj * L::kEntry + warp] = pmax[jj * L::kEntry + warp] = 0.0f;
          }
          continue;
        }
        s.contrib = 0.0f;
        if (live) {
          s = composite_entry<k3D, kRich>(sf, jj, alpha_falloff(e, sf[V::kOpac][jj], gamma), s);
          if (!(s.T > kTEps)) nc = b0 + jj + 1;
        }
        if constexpr (kStats) {
          // kept as a pending row, summed with up to 15 more at once
          pend[npend * 32 + wl] = s.contrib;
          if (wl == npend) pidx = jj;
          if (++npend == tiles::kPend) {
            tiles::flush_pending<L::kEntry>(pend, pidx, npend, wl, warp, psum, pmax);
            npend = 0;
          }
        }
        if (!__any_sync(tiles::kFullMask, s.T > kTEps)) {
          j = jj + 1;
          wlive = false;
          break;
        }
      }
    }
    if constexpr (kStats) {
      if (npend > 0) tiles::flush_pending<L::kEntry>(pend, pidx, npend, wl, warp, psum, pmax);
      // entries past the warp's last live pixel contribute nothing
      for (int k = j + wl; k < nb; k += 32) psum[k * L::kEntry + warp] = pmax[k * L::kEntry + warp] = 0.0f;
      __syncthreads();
      // each entry of the batch summed (and maxed) over the warps in warp order
      const int nwarps = blockDim.x >> 5;
      for (int i = lane; i < nb; i += blockDim.x) {
        float sum = 0.0f, mx = 0.0f;
        for (int w = 0; w < nwarps; ++w) {
          sum += psum[i * L::kEntry + w];
          mx = fmaxf(mx, pmax[i * L::kEntry + w]);
        }
        pair_contrib[start + b0 + i] = sum;
        pair_contrib[(size_t)mp + start + b0 + i] = mx;
      }
      done = b0 + nb;
    }
  }
  if (s.T > kTEps) nc = count;
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
  const float T = s.T;
  const size_t hw = (size_t)height * width;
  const size_t o = (size_t)y * width + x;
  color[o] = __fadd_rn(s.c0, __fmul_rn(T, params[1]));
  color[hw + o] = __fadd_rn(s.c1, __fmul_rn(T, params[2]));
  color[2 * hw + o] = __fadd_rn(s.c2, __fmul_rn(T, params[3]));
  if constexpr (kRich) {
    depth[o] = __fadd_rn(s.dacc, __fmul_rn(T, params[4]));
    if constexpr (k3D) {
      // n = (sx N1, sy N2, N0 - cW N1 - cH N2), cW = (1 - W) / 2
      const float cW = __fmul_rn(__fsub_rn(1.0f, (float)width), 0.5f);
      const float cH = __fmul_rn(__fsub_rn(1.0f, (float)height), 0.5f);
      normal[o] = __fmul_rn(params[5], s.n1);
      normal[hw + o] = __fmul_rn(params[6], s.n2);
      normal[2 * hw + o] = __fsub_rn(__fsub_rn(s.n0, __fmul_rn(cW, s.n1)), __fmul_rn(cH, s.n2));
    } else {
      normal[o] = s.n0;
      normal[hw + o] = s.n1;
      normal[2 * hw + o] = s.n2;
    }
  } else {
    depth[o] = __fmul_rn(T, params[4]);
    normal[o] = 0.0f;
    normal[hw + o] = 0.0f;
    normal[2 * hw + o] = 0.0f;
  }
  final_T[o] = T;
  n_contrib[o] = nc;
}

template <bool k3D, bool kRich>
__global__ void __launch_bounds__(1024) blend_backward_kernel(
    const float* __restrict__ pairs, int mp,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const long long* __restrict__ tile_order, const float* __restrict__ params, int width,
    int height, int tile_w, int tile_h, int grid_w, int num_tiles,
    const float* __restrict__ final_T, const int* __restrict__ n_contrib,
    const float* __restrict__ g_color, const float* __restrict__ g_final_T,
    float* __restrict__ pair_grads, const float* __restrict__ g_depth,
    const float* __restrict__ g_normal) {
  using V = Variant<k3D, kRich>;
  constexpr int kBatch = V::kBwdBatch;
  constexpr int kLive = V::kLive;
  using L = tiles::BwdLayout<kLive, V::kFields, kBatch>;
  using Fields = float[V::kFields][kBatch];
  // part: per live row, per staged entry, per warp; then the two field
  // buffers (tiles::BwdLayout)
  extern __shared__ float smem[];
  float* const part = smem;
  __shared__ float s_bound[kBatch];   // per staged entry: its ecc bound
  __shared__ int s_jmax;

  const int tile = (int)tile_order[blockIdx.x];          // heaviest tiles first
  const int tx = tile % grid_w, ty = tile / grid_w;
  const int lane = threadIdx.x;
  const int warp = lane >> 5, wl = lane & 31;
  const int nwarps = blockDim.x >> 5;
  int lx, ly;
  tiles::tile_pixel(lane, tile_w, tile_h, lx, ly);
  const int x = tx * tile_w + lx;
  const int y = ty * tile_h + ly;
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
  // rich: the depth cotangent and the normal cotangent folded into the
  // rows it multiplies ("3D": gn0 = g_nz, gn1 = sx g_nx - cW g_nz,
  // gn2 = sy g_ny - cH g_nz, the D rows of the raw normal; "2D": the
  // normal fields 11..13 directly)
  float gd = 0.0f, gn0 = 0.0f, gn1 = 0.0f, gn2 = 0.0f;
  if constexpr (kRich) {
    if (inside) {
      gd = g_depth[o];
      const float gnx = g_normal[o], gny = g_normal[hw + o], gnz = g_normal[2 * hw + o];
      if constexpr (k3D) {
        const float cW = __fmul_rn(__fsub_rn(1.0f, (float)width), 0.5f);
        const float cH = __fmul_rn(__fsub_rn(1.0f, (float)height), 0.5f);
        gn0 = gnz;
        gn1 = __fsub_rn(__fmul_rn(params[5], gnx), __fmul_rn(cW, gnz));
        gn2 = __fsub_rn(__fmul_rn(params[6], gny), __fmul_rn(cH, gnz));
      } else {
        gn0 = gnx;
        gn1 = gny;
        gn2 = gnz;
      }
    }
  }

  // Slots of the whole buffer past the last tile's aligned end belong to
  // no tile: every block zeroes a strided share of them.
  const int tail0 = tile_starts[num_tiles];
  for (int i = tail0 + blockIdx.x * blockDim.x + lane; i < mp;
       i += gridDim.x * blockDim.x) {
#pragma unroll
    for (int r = 0; r < kNumFields; ++r) pair_grads[(size_t)r * mp + i] = 0.0f;
  }

  // the deepest contributor of the warp (wmax) and of the tile (jmax)
  if (lane == 0) s_jmax = 0;
  __syncthreads();
  int wmax = nc_eff;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wmax = max(wmax, __shfl_xor_sync(tiles::kFullMask, wmax, off));
  if (wl == 0) atomicMax(&s_jmax, wmax);
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
  float bg_dot = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(params[1], gr), __fmul_rn(params[2], gg)),
                __fmul_rn(params[3], gb)),
      gft);
  if constexpr (kRich) bg_dot = __fadd_rn(bg_dot, __fmul_rn(params[4], gd));
  float A = __fmul_rn(fT, bg_dot);
  float T = fT;

  // Batches from the back; the next batch's fields are copied in while the
  // current one is computed.
  if (jmax > 0) {
    const int nb0 = min(kBatch, jmax);
    tiles::stage_async<V::kFields, kBatch>(smem + L::kPartFloats, pairs, mp, start + jmax - nb0, nb0);
  }
  int buf = 0;
  for (int b_end = jmax; b_end > 0; b_end -= kBatch, buf ^= 1) {
    const int b0 = max(0, b_end - kBatch);
    const int nb = b_end - b0;
    __pipeline_wait_prior(0);
    __syncthreads();   // this batch's fields are in, the last batch's sums read
    if (b0 > 0) {
      const int nb_next = min(kBatch, b0);
      tiles::stage_async<V::kFields, kBatch>(smem + L::kPartFloats + (buf ^ 1) * L::kBufFloats,
                                          pairs, mp, start + b0 - nb_next, nb_next);
    }
    const Fields& sf = *reinterpret_cast<const Fields*>(smem + L::kPartFloats + buf * L::kBufFloats);
    for (int j = lane; j < nb; j += blockDim.x)
      s_bound[j] = ecc_bound(sf[V::kOpac][j], gamma);
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      float* const pj = part + j * L::kEntry + warp;
      // No pixel of the warp reaches the entry, or none has alpha != 0 at
      // it: then 1 / (1 - alpha) is exactly 1, contrib exactly 0 and every
      // row 0, so T, A and the rows stay as they are. The falloff (its exps)
      // is evaluated only where some pixel's ecc is within the bound.
      bool hit = false, proc = false;
      AlphaTerms a{};
      if (b0 + j < wmax) {
        proc = b0 + j < nc_eff;
        a = ecc_terms_at<k3D>(sf, j, px, py);
        if (__any_sync(tiles::kFullMask, proc && a.ok && a.eccs <= s_bound[j])) {
          a = alpha_falloff(a, sf[V::kOpac][j], gamma);
          hit = __any_sync(tiles::kFullMask, proc && a.ok);
        }
      }
      if (!hit) {
        if (wl < kLive) pj[wl * L::kRowStride] = 0.0f;
        continue;
      }
      float g[kLive];
#pragma unroll
      for (int k = 0; k < kLive; ++k) g[k] = 0.0f;
      if (proc) {
        const float inv1m = __fdiv_rn(1.0f, __fsub_rn(1.0f, a.alpha));
        T = __fmul_rn(T, inv1m);                      // exclusive T of entry j
        const float contrib = __fmul_rn(a.alpha, T);
        float gdot = __fadd_rn(
            __fadd_rn(__fmul_rn(sf[V::kRgb][j], gr), __fmul_rn(sf[V::kRgb + 1][j], gg)),
            __fmul_rn(sf[V::kRgb + 2][j], gb));
        float tr = 0.0f;   // "3D" rich: the ray depth K / D
        if constexpr (kRich && k3D) {
          tr = __fmul_rn(sf[13][j], a.invD);
          gdot = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(gdot, __fmul_rn(tr, gd)),
                                               __fmul_rn(sf[0][j], gn0)),
                                     __fmul_rn(sf[1][j], gn1)),
                           __fmul_rn(sf[2][j], gn2));
        } else if constexpr (kRich) {
          const float d = __fadd_rn(__fadd_rn(sf[10][j], __fmul_rn(sf[14][j], a.a1)),
                                    __fmul_rn(sf[15][j], a.a2));
          gdot = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(gdot, __fmul_rn(d, gd)),
                                               __fmul_rn(sf[11][j], gn0)),
                                     __fmul_rn(sf[12][j], gn1)),
                           __fmul_rn(sf[13][j], gn2));
        }
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
        float da1 = is1 ? -d_ecc3 : s3;
        float da2 = is2 ? -d_ecc3 : s3;
        if constexpr (kRich && !k3D) {
          // the depth's barycentric terms d1 * a1 + d2 * a2
          const float cgd = __fmul_rn(contrib, gd);
          da1 = __fadd_rn(da1, __fmul_rn(cgd, sf[14][j]));
          da2 = __fadd_rn(da2, __fmul_rn(cgd, sf[15][j]));
        }
        if constexpr (k3D) {
          // a_i = A_i / D: chain through the quotient into D, A1, A2
          float dD = __fmul_rn(
              -__fadd_rn(__fmul_rn(da1, a.a1), __fmul_rn(da2, a.a2)), a.invD);
          if constexpr (kRich) {
            // ray depth t = K / D
            dD = __fsub_rn(dD, __fmul_rn(__fmul_rn(__fmul_rn(gd, contrib), tr), a.invD));
          }
          const float dA1 = __fmul_rn(da1, a.invD);
          const float dA2 = __fmul_rn(da2, a.invD);
          g[0] = dD; g[1] = __fmul_rn(dD, px); g[2] = __fmul_rn(dD, py);
          if constexpr (kRich) {
            // the raw normal sums the D rows against contrib
            g[0] = __fadd_rn(g[0], __fmul_rn(contrib, gn0));
            g[1] = __fadd_rn(g[1], __fmul_rn(contrib, gn1));
            g[2] = __fadd_rn(g[2], __fmul_rn(contrib, gn2));
          }
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
        if constexpr (kRich && k3D) {
          g[13] = __fmul_rn(__fmul_rn(contrib, a.invD), gd);               // K
        } else if constexpr (kRich) {
          g[10] = __fmul_rn(contrib, gd);                                  // d0
          g[11] = __fmul_rn(contrib, gn0);                                 // normal
          g[12] = __fmul_rn(contrib, gn1);
          g[13] = __fmul_rn(contrib, gn2);
          g[14] = __fmul_rn(__fmul_rn(contrib, a.a1), gd);                 // d1
          g[15] = __fmul_rn(__fmul_rn(contrib, a.a2), gd);                 // d2
        }
      }
      // lanes 2r and 2r + 1 hold row r's sum over the warp
      const float v = tiles::warp_sum_rows(g, wl);
      if ((wl & 1) == 0 && (wl >> 1) < kLive) pj[(wl >> 1) * L::kRowStride] = v;
    }
    __syncthreads();
    // each (row, entry) of the batch summed over the warps in warp order
    for (int i = lane; i < kLive * nb; i += blockDim.x) {
      const int k = i / nb, j = i % nb;
      const float* const pk = part + k * L::kRowStride + j * L::kEntry;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += pk[w];
      pair_grads[(size_t)k * mp + start + b0 + j] = s;
    }
  }
}

}  // namespace

// The forward's dynamic shared memory, in bytes (tiles::FwdLayout).
template <bool k3D, bool kStats, bool kRich>
constexpr size_t forward_smem() {
  return tiles::FwdLayout<Variant<k3D, kRich>::kFields, kFwdBatch, kStats>::kBytes;
}

extern "C" int ts_blend_forward_smem(int three_d, int stats, int rich) {
  const auto bytes = [&](auto k3D) {
    constexpr bool k = decltype(k3D)::value;
    return stats ? (rich ? forward_smem<k, true, true>() : forward_smem<k, true, false>())
                 : (rich ? forward_smem<k, false, true>() : forward_smem<k, false, false>());
  };
  return (int)(three_d ? bytes(std::true_type{}) : bytes(std::false_type{}));
}

template <bool k3D, bool kStats, bool kRich, typename... Args>
int launch_forward(int num_tiles, int threads, cudaStream_t stream, Args... args) {
  const auto kernel = &blend_forward_kernel<k3D, kStats, kRich>;
  constexpr size_t bytes = forward_smem<k3D, kStats, kRich>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<num_tiles, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" int ts_blend_forward(const float* pairs, int mp,
                                const int* tile_starts, const int* tile_counts,
                                const long long* tile_order, const float* params, int width,
                                int height, int tile_w, int tile_h, int grid_w,
                                int num_tiles, int three_d, int stats, int rich,
                                float* color, float* depth, float* normal,
                                float* final_T, int* n_contrib,
                                float* pair_contrib, cudaStream_t stream) {
  const int threads = tile_w * tile_h;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (stats && pair_contrib == nullptr) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const auto launch = [&](auto k3D, auto kStats, auto kRich) {
    return launch_forward<decltype(k3D)::value, decltype(kStats)::value, decltype(kRich)::value>(
        num_tiles, threads, stream, pairs, mp, tile_starts, tile_counts, tile_order, params,
        width, height, tile_w, tile_h, grid_w, color, depth, normal, final_T, n_contrib,
        pair_contrib);
  };
  constexpr std::true_type on{};
  constexpr std::false_type off{};
  if (three_d) {
    return stats ? (rich ? launch(on, on, on) : launch(on, on, off))
                 : (rich ? launch(on, off, on) : launch(on, off, off));
  }
  return stats ? (rich ? launch(off, on, on) : launch(off, on, off))
               : (rich ? launch(off, off, on) : launch(off, off, off));
}

// The backward's dynamic shared memory, in bytes (tiles::BwdLayout).
template <bool k3D, bool kRich>
constexpr size_t backward_smem() {
  using V = Variant<k3D, kRich>;
  return tiles::BwdLayout<V::kLive, V::kFields, V::kBwdBatch>::kBytes;
}

extern "C" int ts_blend_backward_smem(int three_d, int rich) {
  return (int)(three_d ? (rich ? backward_smem<true, true>() : backward_smem<true, false>())
                       : (rich ? backward_smem<false, true>() : backward_smem<false, false>()));
}

template <bool k3D, bool kRich, typename... Args>
int launch_backward(int num_tiles, int threads, cudaStream_t stream, Args... args) {
  const auto kernel = &blend_backward_kernel<k3D, kRich>;
  constexpr size_t bytes = backward_smem<k3D, kRich>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<num_tiles, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" int ts_blend_backward(const float* pairs, int mp,
                                 const int* tile_starts, const int* tile_counts,
                                 const long long* tile_order, const float* params, int width,
                                 int height, int tile_w, int tile_h, int grid_w,
                                 int num_tiles, int three_d, int rich,
                                 const float* final_T, const int* n_contrib,
                                 const float* g_color, const float* g_final_T,
                                 const float* g_depth, const float* g_normal,
                                 float* pair_grads, cudaStream_t stream) {
  const int threads = tile_w * tile_h;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (rich && (g_depth == nullptr || g_normal == nullptr)) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const auto launch = [&](auto k3D, auto kRich) {
    return launch_backward<decltype(k3D)::value, decltype(kRich)::value>(
        num_tiles, threads, stream, pairs, mp, tile_starts, tile_counts, tile_order, params,
        width, height, tile_w, tile_h, grid_w, num_tiles, final_T, n_contrib, g_color,
        g_final_T, pair_grads, g_depth, g_normal);
  };
  constexpr std::true_type on{};
  constexpr std::false_type off{};
  return three_d ? (rich ? launch(on, on) : launch(on, off))
                 : (rich ? launch(off, on) : launch(off, off));
}
