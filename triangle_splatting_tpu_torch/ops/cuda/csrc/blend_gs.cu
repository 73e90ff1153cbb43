// Tile alpha-blend kernels of the Gaussian renderer ("GS"), for Hopper (sm_90a).
//
// B1-GS  blend_forward_gs   replaces triangle_splatting_tpu/ops/pallas/blend.py
//                           blend_forward (:514, kernel _fwd_kernel :290),
//                           variant "GS"
// B2-GS  blend_backward_gs  replaces triangle_splatting_tpu/ops/pallas/blend.py
//                           blend_backward (:956, kernel _bwd_kernel :606),
//                           variant "GS"
//
// Fields per pair (ops/gaussian.py gaussian_field_matrix): 0 X, 1 Y (the
// screen center), 2 a, 3 b, 4 c (the conic), 5 zero, 6 opacity, 7..9 rgb,
// 10 view depth. Per pixel (px, py) at integer coordinates, with
// dx = X - px and dy = Y - py (Pallas _alpha_terms_gs :222-245):
//   q = a dx^2 + 2 b dx dy + c dy^2, skipped if q < 0;
//   power = -0.5 q at gamma 1, else -0.5 exp(clip(gamma log max(q, 1e-30),
//           -87, 44));
//   alpha = min(0.99, opacity exp(min(power, 0))), skipped below 1/255.
// The Gaussian semantics differ from the triangle kernels of blend.cu in
// three ways (Pallas :368-399, :421-428, :454-465):
//   - the entry whose test_T = T (1 - alpha) would fall below T_EPS is not
//     composited and ends the pixel: a done flag per pixel, carried across
//     the staged batches, so that a later small alpha cannot resurrect the
//     pixel. T never drops below T_EPS, so the block leaves early once every
//     pixel is done or outside the image (__syncthreads_count), not on T;
//   - n_contrib is the 1-based index in the tile's list of the last
//     composited entry (skipped entries before it count, the kill entry and
//     trailing skips do not): it is not a count;
//   - the backward walks back from n_contrib over the entries e < n_contrib.
//
// Forms. The forward has two template switches: kStats, the per-pair (2, MP)
// contribution stream of the ADC statistic window (row 0 the sum, row 1 the
// max over the tile's pixels of contrib = alpha * T of every composited
// entry), and kRich, the depth accumulator (field 10 against contrib, plus
// T * bg_depth; the normal rows are zero, Pallas :403-406, :500-506). All
// four pairs are instantiated: the Gaussian renderer's facade renders with
// rich info and statistics together. The backward has kRich: the depth
// cotangent enters gdot, the background term and its own row 10.
//
// What bounds them on the H100. Per evaluated (pair, pixel) the forward does
// ~25 float32 operations with one exp (gamma 1; a log and a second exp
// otherwise), the backward ~55 with one division; the fields come from
// shared memory as broadcasts. Inputs and outputs are tens of MB (tens of
// us at 3.35 TB/s), the evaluations a frame needs are 1e8-1e9 operations:
// both are bound by operations, in practice by the instructions a warp
// issues per entry. As first written the per-row shuffle trees took a
// fifth of each kernel's time: the backward's, and the forward stats
// form's two per warp-entry (PERF.md, Findings).
//
// Design (as blend.cu):
//  - one block per tile, one thread per pixel, a warp over an 8x4 block of
//    the tile, the tiles heaviest first (a tile order from the wrapper);
//    the tile's pairs staged into dynamic shared memory in batches, the
//    next batch's fields copied in (cp.async) while one is computed: 256
//    entries a batch forward, 96 backward;
//  - the per-(pair, pixel) arithmetic is written with explicitly rounded
//    intrinsics in the order of the plain PyTorch version (no multiply-add
//    contraction, no --use_fast_math), so alpha, the done flag, final_T and
//    n_contrib match it bit for bit and only the order of sums differs;
//  - not the triangles' per-pixel pre-test before the falloff: q costs
//    about what it would save, forward and backward (PERF.md, Findings).
//    The forward culls per warp instead: each lane tests one
//    of the next 32 entries against the box of the warp's pixels
//    (box_may_hit_gs: q >= the conic's smaller eigenvalue times the
//    squared distance from the center to the box, against q_bound, with a
//    margin over every rounding), and the warp takes only the entries
//    whose bit the ballot sets;
//  - every per-pair sum over the tile's pixels is in a fixed order with no
//    float atomics, each output slot belongs to one tile, so results do
//    not change from run to run. The forward's stream: an entry that no
//    pixel of the warp composites has sum and max exactly 0 there, the
//    others the warp keeps as pending rows in shared memory and reduces 16
//    at a time by the transposed warp sum and max (blend_common.cuh). The
//    backward's gradient rows: blend.cu's B2 design (an entry skipped for a
//    warp where none of its pixels is processed with alpha != 0, a
//    transposed warp sum of the 9 / 10 reduced rows). Both then take a
//    fixed-order pass over the warps in shared memory. GX / GY, the
//    gradient of mean2d_offset and hence the densification statistic, are
//    reduced like every other row;
//  - the stats form steps a warp while any of its pixels is not done
//    (__any_sync), a done pixel contributing 0 and skipping every state
//    update, so its blend outputs are those of the form without stats bit
//    for bit. Every slot of the (2, MP) stream is written: slots past the
//    early exit, alignment padding and the buffer's tail get zeros.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <type_traits>

#include "blend_common.cuh"

namespace {

constexpr float kTEps = (float)1e-4;               // blend.py T_EPS
constexpr float kAlphaMin = (float)(1.0 / 255.0);  // blend.py ALPHA_MIN
constexpr float kAlphaMax = (float)0.99;           // blend.py ALPHA_MAX
constexpr int kNumFields = 16;
constexpr int kOpac = 6, kRgb = 7, kDepth = 10;    // field indices

struct GSTerms {
  float qs, dx, dy, expp, alpha_un, alpha;
  bool ok;
};

// blend.py _alpha_terms_gs in the plain version's order, no contraction.
__device__ __forceinline__ GSTerms gs_terms(const float X, const float Y, const float a,
                                            const float b, const float c, const float opac,
                                            float px, float py, float gamma) {
  GSTerms r;
  r.dx = __fsub_rn(X, px);
  r.dy = __fsub_rn(Y, py);
  const float t1 = __fmul_rn(__fmul_rn(a, r.dx), r.dx);
  const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, b), r.dx), r.dy);
  const float t3 = __fmul_rn(__fmul_rn(c, r.dy), r.dy);
  const float q = __fadd_rn(__fadd_rn(t1, t2), t3);
  bool ok = q >= 0.0f;
  r.qs = fmaxf(q, 1e-30f);
  float power;
  if (gamma == 1.0f) {
    power = __fmul_rn(-0.5f, r.qs);
  } else {
    const float lg = __fmul_rn(gamma, logf(r.qs));
    power = __fmul_rn(-0.5f, expf(fminf(fmaxf(lg, -87.0f), 44.0f)));
  }
  r.expp = expf(fminf(power, 0.0f));
  r.alpha_un = __fmul_rn(opac, r.expp);
  const float alpha = fminf(kAlphaMax, r.alpha_un);
  ok = ok && (alpha >= kAlphaMin);
  r.alpha = ok ? alpha : 0.0f;
  r.ok = ok;
  return r;
}

template <int N, int B>
__device__ __forceinline__ GSTerms gs_terms_at(const float (&sf)[N][B], int j, float px,
                                               float py, float gamma) {
  return gs_terms(sf[0][j], sf[1][j], sf[2][j], sf[3][j], sf[4][j], sf[kOpac][j], px, py,
                  gamma);
}

// The largest q at which an entry of opacity ``opac`` can still reach
// alpha >= ALPHA_MIN at ``gamma``: past it, q^gamma >= 2 ln(opac /
// ALPHA_MIN) + 2e-3, which keeps alpha_un = opac exp(-0.5 q^gamma) below
// ALPHA_MIN through every rounding of gs_terms; the bound adds a relative
// 1e-5 for its own rounding. -1 where alpha never reaches ALPHA_MIN (opac
// below it); +inf where there is no bound (gamma <= 0, a NaN opacity). In
// double, once per staged entry; q_bound_plain in ops/cuda/blend.py is its
// twin.
__device__ __forceinline__ float q_bound(float opac, float gamma) {
  if (!(gamma > 0.0f) || opac != opac) return __int_as_float(0x7f800000);
  if (!(opac >= kAlphaMin)) return -1.0f;
  const double c = 2.0 * log((double)opac / (double)kAlphaMin) + 2e-3;
  return (float)(pow(c, 1.0 / (double)gamma) * (1.0 + 1e-5));
}

constexpr float kCullMargin = 2e-5f;   // relative to the magnitude of the terms

// The forward's cull of entry j for one warp: false only where no pixel of
// the warp's box [x0, x1] x [y0, y1] can have q within ``bound`` (the
// entry's q_bound), so that alpha is 0 at each of them. With lambda the
// conic's smaller eigenvalue, q >= lambda |d|^2 at every pixel, d its offset
// from the center, and |d| at least the center's distance to the box. The
// test gives up kCullMargin times the conic's magnitude |a| + |b| + |c|,
// on lambda and against the farthest corner's |d|^2: several times the
// rounding of the kernel's q and of this test's own. NaN anywhere: no
// cull. Its twin is box_cull_gs_plain in ops/cuda/blend.py, in the same
// float32 operations.
template <int N, int B>
__device__ __forceinline__ bool box_may_hit_gs(const float (&sf)[N][B], int j, float x0,
                                               float x1, float y0, float y1, float bound) {
  const float X = sf[0][j], Y = sf[1][j], a = sf[2][j], b = sf[3][j], c = sf[4][j];
  const float ex = fmaxf(fmaxf(__fsub_rn(x0, X), __fsub_rn(X, x1)), 0.0f);
  const float ey = fmaxf(fmaxf(__fsub_rn(y0, Y), __fsub_rn(Y, y1)), 0.0f);
  const float fx = fmaxf(fabsf(__fsub_rn(X, x0)), fabsf(__fsub_rn(X, x1)));
  const float fy = fmaxf(fabsf(__fsub_rn(Y, y0)), fabsf(__fsub_rn(Y, y1)));
  const float near2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
  const float far2 = __fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy));
  const float h = __fmul_rn(0.5f, __fsub_rn(a, c));
  const float lam = __fsub_rn(__fmul_rn(0.5f, __fadd_rn(a, c)),
                              sqrtf(__fadd_rn(__fmul_rn(h, h), __fmul_rn(b, b))));
  const float mag = __fmul_rn(kCullMargin, __fadd_rn(__fadd_rn(fabsf(a), fabsf(b)), fabsf(c)));
  const float lower = __fsub_rn(__fmul_rn(__fsub_rn(lam, mag), near2), __fmul_rn(mag, far2));
  return !(lower > bound);
}

// One entry j of batch b0 of a pixel's front-to-back composite (Pallas
// :368-399), shared by the forward's two loops so that they stay
// bit-identical: the kill entry is not composited and sets done; a
// composited entry updates T, the colour (and depth) and n_contrib, its
// 1-based index in the tile's list. Returns the entry's contrib, 0 where it
// is skipped or kills.
template <bool kRich, int N, int B>
__device__ __forceinline__ float composite_entry(const float (&sf)[N][B], int b0, int j,
                                                 float px, float py, float gamma, float& T,
                                                 bool& done, float& c0, float& c1, float& c2,
                                                 float& dacc, int& nc) {
  float contrib = 0.0f;
  const GSTerms a = gs_terms_at(sf, j, px, py, gamma);
  if (a.ok) {
    const float test_T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
    if (test_T < kTEps) {
      done = true;                           // the kill entry: not composited
    } else {
      contrib = __fmul_rn(a.alpha, T);
      c0 = __fadd_rn(c0, __fmul_rn(sf[kRgb][j], contrib));
      c1 = __fadd_rn(c1, __fmul_rn(sf[kRgb + 1][j], contrib));
      c2 = __fadd_rn(c2, __fmul_rn(sf[kRgb + 2][j], contrib));
      if constexpr (kRich) dacc = __fadd_rn(dacc, __fmul_rn(sf[kDepth][j], contrib));
      T = test_T;
      nc = b0 + j + 1;
    }
  }
  return contrib;
}

// B1-GS's batch: the entries staged at a time, two buffers of them in
// dynamic shared memory and, with the stream, the per-warp partials and
// pending rows (tiles::FwdLayout: 21,504 B plain to 156,672 B rich + stats).
constexpr int kFwdBatch = 256;

template <bool kStats, bool kRich>
__global__ void __launch_bounds__(1024, 1) blend_forward_gs_kernel(
    const float* __restrict__ pairs, int mp,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const long long* __restrict__ tile_order, const float* __restrict__ params, int width,
    int height, int tile_w, int tile_h, int grid_w, float* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ normal,
    float* __restrict__ final_T, int* __restrict__ n_contrib,
    float* __restrict__ pair_contrib) {
  constexpr int kFields = kRich ? 11 : 10;
  using L = tiles::FwdLayout<kFields, kFwdBatch, kStats>;
  using Fields = float[kFields][kFwdBatch];
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

  float T = inside ? 1.0f : 0.0f;
  bool done = !inside;     // a pixel outside the image never composites
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dacc = 0.0f;
  int nc = 0;
  int reached = 0;         // stats form: slots of the tile whose stream is written
  if (count > 0) tiles::stage_async<kFields, kFwdBatch>(smem, pairs, mp, start, min(kFwdBatch, count));
  int buf = 0;
  for (int b0 = 0; b0 < count; b0 += kFwdBatch, buf ^= 1) {
    const int nb = min(kFwdBatch, count - b0);
    __pipeline_wait_prior(0);
    // Uniform across the block: doubles as the barrier that makes this
    // batch's fields visible and keeps the last batch's readers ahead of
    // this batch's writers. The next batch's fields are copied in while
    // this one is computed.
    if (__syncthreads_count(!done) == 0) break;
    if (b0 + nb < count)
      tiles::stage_async<kFields, kFwdBatch>(smem + (buf ^ 1) * L::kBufFloats, pairs, mp,
                                             start + b0 + nb, min(kFwdBatch, count - b0 - nb));
    const Fields& sf = *reinterpret_cast<const Fields*>(smem + buf * L::kBufFloats);
    for (int j = lane; j < nb; j += blockDim.x) s_bound[j] = q_bound(sf[kOpac][j], gamma);
    __syncthreads();
    // j: the warp has passed the entries before it (all of them, unless
    // its last pixel ends inside the batch)
    int j = 0, npend = 0, pidx = 0;
    bool wlive = __any_sync(tiles::kFullMask, !done);
    for (int w0 = 0; wlive && w0 < nb; w0 += 32) {
      // each lane culls one of the next 32 entries for the warp's box; an
      // entry culled changes nothing and contributes 0
      const int jl = w0 + wl;
      const bool maybe = jl < nb && box_may_hit_gs(sf, jl, bx0, bx1, by0, by1, s_bound[jl]);
      if constexpr (kStats) {
        if (jl < nb && !maybe) psum[jl * L::kEntry + warp] = pmax[jl * L::kEntry + warp] = 0.0f;
      }
      j = min(w0 + 32, nb);
      for (unsigned m = __ballot_sync(tiles::kFullMask, maybe); m != 0; m &= m - 1) {
        const int jj = w0 + __ffs(m) - 1;
        // a done pixel contributes 0 and skips every state update
        const float contrib =
            done ? 0.0f
                 : composite_entry<kRich>(sf, b0, jj, px, py, gamma, T, done, c0, c1, c2,
                                          dacc, nc);
        if constexpr (kStats) {
          if (__any_sync(tiles::kFullMask, contrib != 0.0f)) {
            // kept as a pending row, summed with up to 15 more at once
            pend[npend * 32 + wl] = contrib;
            if (wl == npend) pidx = jj;
            if (++npend == tiles::kPend) {
              tiles::flush_pending<L::kEntry>(pend, pidx, npend, wl, warp, psum, pmax);
              npend = 0;
            }
          } else if (wl == 0) {
            // no pixel of the warp composites the entry: sum and max are 0
            psum[jj * L::kEntry + warp] = pmax[jj * L::kEntry + warp] = 0.0f;
          }
        }
        if (!__any_sync(tiles::kFullMask, !done)) {
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
        float s = 0.0f, m = 0.0f;
        for (int w = 0; w < nwarps; ++w) {
          s += psum[i * L::kEntry + w];
          m = fmaxf(m, pmax[i * L::kEntry + w]);
        }
        pair_contrib[start + b0 + i] = s;
        pair_contrib[(size_t)mp + start + b0 + i] = m;
      }
      reached = b0 + nb;
    }
  }
  if constexpr (kStats) {
    // The tile's slots past the early exit and its alignment padding get
    // zeros, and every block zeroes a strided share of the buffer's tail
    // past the last tile's aligned end (slots of no tile).
    const int end = tile_starts[tile + 1];
    for (int i = start + reached + lane; i < end; i += blockDim.x) {
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
  if constexpr (kRich) {
    depth[o] = __fadd_rn(dacc, __fmul_rn(T, params[4]));
  } else {
    depth[o] = __fmul_rn(T, params[4]);
  }
  normal[o] = 0.0f;
  normal[hw + o] = 0.0f;
  normal[2 * hw + o] = 0.0f;
  final_T[o] = T;
  n_contrib[o] = nc;
}

// Output row of reduced row k: the live rows but the structural zero row 5
// (GX GY GA GB GC2 | 0 | GOP r g b [GDEP]).
__device__ __forceinline__ int out_row(int k) { return k < 5 ? k : k + 1; }

// The backward's batch: 96 entries staged at a time (reduced rows x batch
// <= 1024, one pass of the block sums a batch over the warps), and its
// dynamic shared memory (tiles::BwdLayout: 121,764 B, 135,208 B
// with rich info).
template <bool kRich> struct GSBackward {
  static constexpr int kFields = kRich ? 11 : 10;
  static constexpr int kLive = kRich ? 11 : 10;   // LIVE_GRAD_ROWS[("GS", kRich)]
  static constexpr int kRed = kLive - 1;          // reduced rows (row 5 is zero)
  static constexpr int kBatch = 96;
  using L = tiles::BwdLayout<kRed, kFields, kBatch>;
};

template <bool kRich>
__global__ void __launch_bounds__(1024) blend_backward_gs_kernel(
    const float* __restrict__ pairs, int mp,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const long long* __restrict__ tile_order, const float* __restrict__ params, int width,
    int height, int tile_w, int tile_h, int grid_w, int num_tiles,
    const float* __restrict__ final_T, const int* __restrict__ n_contrib,
    const float* __restrict__ g_color, const float* __restrict__ g_final_T,
    const float* __restrict__ g_depth, float* __restrict__ pair_grads) {
  using B = GSBackward<kRich>;
  using L = typename B::L;
  constexpr int kFields = B::kFields, kLive = B::kLive, kRed = B::kRed, kBatch = B::kBatch;
  using Fields = float[kFields][kBatch];
  // part: per reduced row, per staged entry, per warp; then the two field
  // buffers (tiles::BwdLayout)
  extern __shared__ float smem[];
  float* const part = smem;
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
  float gd = 0.0f;
  if constexpr (kRich) gd = inside ? g_depth[o] : 0.0f;

  // Slots of the whole buffer past the last tile's aligned end belong to
  // no tile: every block zeroes a strided share of them.
  const int tail0 = tile_starts[num_tiles];
  for (int i = tail0 + blockIdx.x * blockDim.x + lane; i < mp;
       i += gridDim.x * blockDim.x) {
#pragma unroll
    for (int r = 0; r < kNumFields; ++r) pair_grads[(size_t)r * mp + i] = 0.0f;
  }

  // the deepest last contributor of the warp (wmax) and of the tile (jmax)
  if (lane == 0) s_jmax = 0;
  __syncthreads();
  int wmax = nc_eff;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wmax = max(wmax, __shfl_xor_sync(tiles::kFullMask, wmax, off));
  if (wl == 0) atomicMax(&s_jmax, wmax);
  __syncthreads();
  const int jmax = s_jmax;

  // Entries past the deepest last contributor and the alignment padding
  // get zero gradients; row 5 and the rows past the live ones are
  // structural zeros.
  for (int i = jmax + lane; i < end - start; i += blockDim.x) {
#pragma unroll
    for (int r = 0; r < kNumFields; ++r) pair_grads[(size_t)r * mp + start + i] = 0.0f;
  }
  for (int i = lane; i < jmax; i += blockDim.x) {
    pair_grads[(size_t)5 * mp + start + i] = 0.0f;
#pragma unroll
    for (int r = kLive; r < kNumFields; ++r) pair_grads[(size_t)r * mp + start + i] = 0.0f;
  }

  // Background term (everything behind the last composited entry) plus the
  // direct final_T cotangent: A = T_final * (bg . g + g_T [+ bg_depth g_d]).
  float bg_dot = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(params[1], gr), __fmul_rn(params[2], gg)),
                __fmul_rn(params[3], gb)),
      gft);
  if constexpr (kRich) bg_dot = __fadd_rn(bg_dot, __fmul_rn(params[4], gd));
  float A = __fmul_rn(fT, bg_dot);
  float T = fT;
  const float dpow_g = __fmul_rn(-0.5f, gamma);   // gamma != 1: -0.5 gamma q^(gamma-1)

  // Batches from the back; the next batch's fields are copied in while the
  // current one is computed.
  if (jmax > 0) {
    const int nb0 = min(kBatch, jmax);
    tiles::stage_async<kFields, kBatch>(smem + L::kPartFloats, pairs, mp, start + jmax - nb0, nb0);
  }
  int buf = 0;
  for (int b_end = jmax; b_end > 0; b_end -= kBatch, buf ^= 1) {
    const int b0 = max(0, b_end - kBatch);
    const int nb = b_end - b0;
    __pipeline_wait_prior(0);
    __syncthreads();   // this batch's fields are in, the last batch's sums read
    if (b0 > 0) {
      const int nb_next = min(kBatch, b0);
      tiles::stage_async<kFields, kBatch>(smem + L::kPartFloats + (buf ^ 1) * L::kBufFloats,
                                       pairs, mp, start + b0 - nb_next, nb_next);
    }
    const Fields& sf = *reinterpret_cast<const Fields*>(smem + L::kPartFloats + buf * L::kBufFloats);
    for (int j = nb - 1; j >= 0; --j) {
      float* const pj = part + j * L::kEntry + warp;
      // No pixel of the warp reaches the entry, or none has alpha != 0 at
      // it: then 1 / (1 - alpha) is exactly 1, contrib exactly 0 and every
      // row 0, so T, A and the rows stay as they are.
      bool hit = false, proc = false;
      GSTerms a{};
      if (b0 + j < wmax) {
        proc = b0 + j < nc_eff;
        a = gs_terms_at(sf, j, px, py, gamma);
        hit = __any_sync(tiles::kFullMask, proc && a.ok);
      }
      if (!hit) {
        if (wl < kRed) pj[wl * L::kRowStride] = 0.0f;
        continue;
      }
      float g[kRed];
#pragma unroll
      for (int k = 0; k < kRed; ++k) g[k] = 0.0f;
      if (proc) {
        const float inv1m = __fdiv_rn(1.0f, __fsub_rn(1.0f, a.alpha));
        T = __fmul_rn(T, inv1m);                      // exclusive T of entry j
        const float contrib = __fmul_rn(a.alpha, T);
        float gdot = __fadd_rn(
            __fadd_rn(__fmul_rn(sf[kRgb][j], gr), __fmul_rn(sf[kRgb + 1][j], gg)),
            __fmul_rn(sf[kRgb + 2][j], gb));
        if constexpr (kRich) gdot = __fadd_rn(gdot, __fmul_rn(sf[kDepth][j], gd));
        const float dL_da = __fsub_rn(__fmul_rn(T, gdot), __fmul_rn(A, inv1m));
        A = __fadd_rn(A, __fmul_rn(contrib, gdot));   // suffix of later entries
        const float live = (a.ok && a.alpha_un < kAlphaMax) ? dL_da : 0.0f;
        // d(power)/dq = -0.5 at gamma 1, else -0.5 gamma q^(gamma - 1)
        float dpow = -0.5f;
        if (gamma != 1.0f) {
          const float lg = __fmul_rn(__fsub_rn(gamma, 1.0f), logf(a.qs));
          dpow = __fmul_rn(dpow_g, expf(fminf(fmaxf(lg, -87.0f), 44.0f)));
        }
        const float dL_dq = __fmul_rn(__fmul_rn(live, a.alpha_un), dpow);
        const float gdx = __fmul_rn(dL_dq, a.dx);
        const float gdy = __fmul_rn(dL_dq, a.dy);
        // dq/dX = 2a dx + 2b dy, dq/dY = 2b dx + 2c dy, dq/da = dx^2,
        // dq/db = 2 dx dy, dq/dc = dy^2
        const float a2 = __fmul_rn(2.0f, sf[2][j]);
        const float b2 = __fmul_rn(2.0f, sf[3][j]);
        const float c2 = __fmul_rn(2.0f, sf[4][j]);
        g[0] = __fadd_rn(__fmul_rn(a2, gdx), __fmul_rn(b2, gdy));
        g[1] = __fadd_rn(__fmul_rn(b2, gdx), __fmul_rn(c2, gdy));
        g[2] = __fmul_rn(gdx, a.dx);
        g[3] = __fmul_rn(__fmul_rn(2.0f, gdx), a.dy);
        g[4] = __fmul_rn(gdy, a.dy);
        g[5] = __fmul_rn(live, a.expp);               // opacity (row 6)
        g[6] = __fmul_rn(contrib, gr);                // rgb (rows 7..9)
        g[7] = __fmul_rn(contrib, gg);
        g[8] = __fmul_rn(contrib, gb);
        if constexpr (kRich) g[9] = __fmul_rn(contrib, gd);   // depth (row 10)
      }
      // lanes 2r and 2r + 1 hold reduced row r's sum over the warp
      const float v = tiles::warp_sum_rows(g, wl);
      if ((wl & 1) == 0 && (wl >> 1) < kRed) pj[(wl >> 1) * L::kRowStride] = v;
    }
    __syncthreads();
    // each (row, entry) of the batch summed over the warps in warp order
    for (int i = lane; i < kRed * nb; i += blockDim.x) {
      const int k = i / nb, j = i % nb;
      const float* const pk = part + k * L::kRowStride + j * L::kEntry;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += pk[w];
      pair_grads[(size_t)out_row(k) * mp + start + b0 + j] = s;
    }
  }
}

}  // namespace

template <bool kStats, bool kRich>
constexpr size_t forward_gs_smem() {
  return tiles::FwdLayout<kRich ? 11 : 10, kFwdBatch, kStats>::kBytes;
}

// The forward's dynamic shared memory, in bytes (tiles::FwdLayout).
extern "C" int ts_blend_forward_gs_smem(int stats, int rich) {
  return (int)(stats ? (rich ? forward_gs_smem<true, true>() : forward_gs_smem<true, false>())
                     : (rich ? forward_gs_smem<false, true>() : forward_gs_smem<false, false>()));
}

template <bool kStats, bool kRich, typename... Args>
int launch_forward_gs(int num_tiles, int threads, cudaStream_t stream, Args... args) {
  const auto kernel = &blend_forward_gs_kernel<kStats, kRich>;
  constexpr size_t bytes = forward_gs_smem<kStats, kRich>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<num_tiles, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" int ts_blend_forward_gs(const float* pairs, int mp,
                                   const int* tile_starts, const int* tile_counts,
                                   const long long* tile_order, const float* params, int width,
                                   int height, int tile_w, int tile_h, int grid_w,
                                   int num_tiles, int stats, int rich,
                                   float* color, float* depth, float* normal,
                                   float* final_T, int* n_contrib,
                                   float* pair_contrib, cudaStream_t stream) {
  const int threads = tile_w * tile_h;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (stats && pair_contrib == nullptr) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const auto launch = [&](auto kStats, auto kRich) {
    return launch_forward_gs<decltype(kStats)::value, decltype(kRich)::value>(
        num_tiles, threads, stream, pairs, mp, tile_starts, tile_counts, tile_order, params,
        width, height, tile_w, tile_h, grid_w, color, depth, normal, final_T, n_contrib,
        pair_contrib);
  };
  constexpr std::true_type on{};
  constexpr std::false_type off{};
  return stats ? (rich ? launch(on, on) : launch(on, off))
               : (rich ? launch(off, on) : launch(off, off));
}

extern "C" int ts_blend_backward_gs_smem(int rich) {
  return (int)(rich ? GSBackward<true>::L::kBytes : GSBackward<false>::L::kBytes);
}

template <bool kRich, typename... Args>
int launch_backward_gs(int num_tiles, int threads, cudaStream_t stream, Args... args) {
  const auto kernel = &blend_backward_gs_kernel<kRich>;
  constexpr size_t bytes = GSBackward<kRich>::L::kBytes;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<num_tiles, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" int ts_blend_backward_gs(const float* pairs, int mp,
                                    const int* tile_starts, const int* tile_counts,
                                    const long long* tile_order, const float* params, int width,
                                    int height, int tile_w, int tile_h, int grid_w,
                                    int num_tiles, int rich,
                                    const float* final_T, const int* n_contrib,
                                    const float* g_color, const float* g_final_T,
                                    const float* g_depth, float* pair_grads,
                                    cudaStream_t stream) {
  const int threads = tile_w * tile_h;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  if (rich && g_depth == nullptr) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const auto launch = [&](auto kRich) {
    return launch_backward_gs<decltype(kRich)::value>(
        num_tiles, threads, stream, pairs, mp, tile_starts, tile_counts, tile_order, params,
        width, height, tile_w, tile_h, grid_w, num_tiles, final_T, n_contrib, g_color,
        g_final_T, g_depth, pair_grads);
  };
  return rich ? launch(std::true_type{}) : launch(std::false_type{});
}
