// Probe kernels P1-P3: micro-benchmarks of the H100's rates for the blend
// kernels' building blocks, for Hopper (sm_90a).
//
// P1  vpu_probe   replaces tools/vpu_probe.py run (:50, kernel _kernel :31):
//                 K dependent passes of mul, fma, min3 or exp over every
//                 element, in float32 and in bfloat16;
// P2  exp_probe   replaces tools/exp_probe.py run (:68, kernel _kernel :49):
//                 K dependent passes of eight products, of expf, of the
//                 polynomial fast_exp (and of the __expf intrinsic);
// P3  scan_probe  replaces tools/scan_probe.py run / check (:112, :133;
//                 kernel _kernel :101): K dependent prefix products along
//                 the 256 rows of each column, clipped to [0.9, 1] per rep.
//
// What bounds them: nothing but the issue of the operations being measured.
// Each loop keeps its element in registers from the one load to the one
// store, so device memory carries 8 bytes per element for the whole launch;
// the constants are kernel arguments, so the compiler can fold none of the
// products (bf16(1.0000001) is exactly 1). A chain is dependent, so an SM
// hides its latency only with enough warps in flight: P1 and P2 run one
// thread per element (per element pair in bf16, packed __nv_bfloat162
// arithmetic) in blocks of 256, so 512 x 1024 elements make 2,048 blocks,
// ~1.94 waves of 2,048 resident threads on 132 SMs. fma is one FFMA
// (__fmaf_rn, one rounding), where the JAX probe's op is a mul and an add.
//
// P3 keeps the scanned axis inside one warp or block (the TPU keeps it in
// one vreg stack). "hs" holds a column in registers: one warp per column,
// 8 consecutive rows a lane, eight columns a block; a Hillis-Steele pass with a shift below the rows a lane holds multiplies
// in registers, taking the first rows' partners from the previous lane by
// __shfl_up_sync, and a pass with a larger shift is a shuffle of every row
// by shift / rows lanes. No shared memory and no barrier: a rep is 8 passes
// of at most 8 shuffles and 8 products a lane, and every element gets the
// products, in the order, of the Hillis-Steele passes through shared
// memory that it replaces (so the outputs are bit for bit those of the
// plain version's passes). What bounds it is the shuffle issue (47 a rep
// and column) and the dependent chain of 8 shuffle-then-multiply steps a
// rep, not the products. "hs_roll" keeps one thread per (row, column),
// 256 threads a column (warp shuffles, then a carry across the column's
// eight warps), four columns a block; 256 / chunk threads per column for
// "two_level" (a sequential product over the chunk in registers, a
// shuffle scan of the chunk totals, one broadcast multiply) and one warp
// per column for "mxu_log" (exp of a dense lower-triangular product with
// log x, written out in float32: 8 rows a lane, the column's logs in
// shared memory), eight columns a block, so 1,024 columns make 128
// blocks, one per SM.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kElemThreads = 256;   // P1 / P2 block
constexpr int kScanRows = 256;      // P3: rows of the scanned axis
constexpr int kScanThreads = 1024;  // P3: the largest block ("hs_roll")
constexpr int kScanCols = 8;        // P3: columns per block but "hs_roll"
constexpr int kHsRows = kScanRows / 32;  // P3 "hs": the rows a lane holds

// ---------------------------------------------------------------------------
// P1
// ---------------------------------------------------------------------------

enum VpuOp { kMul = 0, kFma = 1, kMin3 = 2, kExp = 3 };

template <int OP>
__device__ __forceinline__ float vpu_step(float v, float c, float s) {
  if constexpr (OP == kMul) {
    return __fmul_rn(v, c);
  } else if constexpr (OP == kFma) {
    return __fmaf_rn(v, c, c);
  } else if constexpr (OP == kMin3) {
    return fminf(fminf(v, __fmul_rn(v, c)), __fadd_rn(v, c));
  } else {
    return expf(__fmul_rn(-fabsf(v), s));
  }
}

template <int OP>
__device__ __forceinline__ __nv_bfloat162 vpu_step(__nv_bfloat162 v, __nv_bfloat162 c,
                                                   __nv_bfloat162 s) {
  if constexpr (OP == kMul) {
    return __hmul2(v, c);
  } else if constexpr (OP == kFma) {
    return __hfma2(v, c, c);
  } else if constexpr (OP == kMin3) {
    return __hmin2(__hmin2(v, __hmul2(v, c)), __hadd2(v, c));
  } else {
    return h2exp(__hmul2(__hneg2(__habs2(v)), s));
  }
}

template <int OP>
__global__ void __launch_bounds__(kElemThreads) vpu_probe_f32_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int k, float c, float s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int it = 0; it < k; ++it) v = vpu_step<OP>(v, c, s);
  out[i] = v;
}

// one thread per element pair: n2 = n / 2
template <int OP>
__global__ void __launch_bounds__(kElemThreads) vpu_probe_bf16_kernel(
    const float2* __restrict__ x, float2* __restrict__ out, int n2, int k, float c, float s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 c2 = __float2bfloat162_rn(c);
  const __nv_bfloat162 s2 = __float2bfloat162_rn(s);
  const float2 xv = x[i];
  __nv_bfloat162 v = __floats2bfloat162_rn(xv.x, xv.y);
  for (int it = 0; it < k; ++it) v = vpu_step<OP>(v, c2, s2);
  out[i] = __bfloat1622float2(v);
}

// ---------------------------------------------------------------------------
// P2
// ---------------------------------------------------------------------------

enum ExpOp { kMul8 = 0, kExpf = 1, kFastExp = 2, kIntrinsicExp = 3 };

// exp_probe.py fast_exp: exp(x) for x <= 0 as 2^k * poly4(f), k = round(x
// log2 e), the exponent spliced in by an integer bitcast. The Horner steps
// are FFMAs (one rounding each; the plain version rounds twice).
__device__ __forceinline__ float fast_exp(float x) {
  const float y = __fmul_rn(x, 1.4426950408889634f);
  const float k = floorf(__fadd_rn(y, 0.5f));
  const float f = __fsub_rn(y, k);
  float p = 9.5541051638e-03f;
  p = __fmaf_rn(p, f, 5.5870408514e-02f);
  p = __fmaf_rn(p, f, 2.4024696602e-01f);
  p = __fmaf_rn(p, f, 6.9312802817e-01f);
  p = __fmaf_rn(p, f, 9.9999943979e-01f);
  const int ki = (int)k;
  return __fmul_rn(p, __int_as_float((ki + 127) << 23));
}

template <int OP>
__global__ void __launch_bounds__(kElemThreads) exp_probe_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int k, float c, float s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int it = 0; it < k; ++it) {
    if constexpr (OP == kMul8) {
#pragma unroll
      for (int m = 0; m < 8; ++m) v = __fmul_rn(v, c);
    } else {
      const float t = __fmul_rn(fabsf(v), s);
      if constexpr (OP == kExpf) {
        v = expf(-t);
      } else if constexpr (OP == kFastExp) {
        v = fast_exp(-t);
      } else {
        v = __expf(-t);
      }
    }
  }
  out[i] = v;
}

// ---------------------------------------------------------------------------
// P3
// ---------------------------------------------------------------------------

__device__ __forceinline__ float clip_unit(float v) { return fminf(fmaxf(v, 0.9f), 1.0f); }

// Inclusive product scan of v over the kN consecutive threads of one column
// (kN a power of two, 2..256): Hillis-Steele by warp shuffles over at most
// 32 lanes, then for kN > 32 a carry of the column's earlier warp totals
// through shared memory. ``prev`` gets that carry (1 for kN <= 32).
template <int kN>
__device__ __forceinline__ float column_scan(float v, float* carry, float& prev) {
  constexpr int kWidth = kN < 32 ? kN : 32;
  const int sl = threadIdx.x & (kWidth - 1);
#pragma unroll
  for (int sh = 1; sh < kWidth; sh <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, sh, kWidth);
    if (sl >= sh) v = __fmul_rn(v, t);
  }
  prev = 1.0f;
  if constexpr (kN > 32) {
    const int warp = threadIdx.x >> 5;
    const int first = warp & ~(kN / 32 - 1);   // the column's first warp
    if ((threadIdx.x & 31) == 31) carry[warp] = v;
    __syncthreads();
    for (int w = first; w < warp; ++w) prev = __fmul_rn(prev, carry[w]);
    __syncthreads();   // every carry read before the next rep writes
    v = __fmul_rn(v, prev);
  }
  return v;
}

// One "hs" pass with shift kShift < kHsRows, and the later ones: row
// r0 + i takes row r0 + i - kShift, from this lane for i >= kShift (updated
// from the top down, so each reads the pass's input) and from the previous
// lane's row kHsRows - kShift + i otherwise (lane 0 keeps its first rows).
// A template per shift, so every register index is a constant.
template <int kShift>
__device__ __forceinline__ void hs_lane_passes(float (&v)[kHsRows], int lane) {
  float t[kShift];
#pragma unroll
  for (int i = 0; i < kShift; ++i)
    t[i] = __shfl_up_sync(0xffffffffu, v[kHsRows - kShift + i], 1);
#pragma unroll
  for (int i = kHsRows - 1; i >= kShift; --i) v[i] = __fmul_rn(v[i], v[i - kShift]);
  if (lane > 0) {
#pragma unroll
    for (int i = 0; i < kShift; ++i) v[i] = __fmul_rn(v[i], t[i]);
  }
  if constexpr (2 * kShift < kHsRows) hs_lane_passes<2 * kShift>(v, lane);
}

// "hs": a warp per column, kHsRows consecutive rows a lane, the
// Hillis-Steele passes in registers and shuffles; kScanCols columns a block.
__global__ void __launch_bounds__(kScanCols * 32) scan_hs_kernel(
    const float* __restrict__ x, float* __restrict__ out, int cols, int k, int clip) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kScanCols + threadIdx.x / 32;
  const int r0 = lane * kHsRows;
  float v[kHsRows];
#pragma unroll
  for (int i = 0; i < kHsRows; ++i) v[i] = x[(size_t)(r0 + i) * cols + c];
  for (int it = 0; it < k; ++it) {
    hs_lane_passes<1>(v, lane);
    // shifts d * kHsRows: every row takes the same row d lanes back
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int i = 0; i < kHsRows; ++i) {
        const float t = __shfl_up_sync(0xffffffffu, v[i], d);
        if (lane >= d) v[i] = __fmul_rn(v[i], t);
      }
    }
    if (clip) {
#pragma unroll
      for (int i = 0; i < kHsRows; ++i) v[i] = clip_unit(v[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kHsRows; ++i) out[(size_t)(r0 + i) * cols + c] = v[i];
}

// "hs_roll": one thread per (row, column), 256 consecutive threads per
// column, four columns per block.
__global__ void __launch_bounds__(kScanThreads) scan_hs_roll_kernel(
    const float* __restrict__ x, float* __restrict__ out, int cols, int k, int clip) {
  constexpr int kCols = kScanThreads / kScanRows;
  __shared__ float carry[kScanThreads / 32];  // the warp totals
  const int r = threadIdx.x % kScanRows, cl = threadIdx.x / kScanRows;
  const int c = blockIdx.x * kCols + cl;
  float v = x[(size_t)r * cols + c];
  for (int it = 0; it < k; ++it) {
    float prev;
    v = column_scan<kScanRows>(v, carry, prev);
    if (clip) v = clip_unit(v);
  }
  out[(size_t)r * cols + c] = v;
}

// "two_level<kChunk>": a thread holds kChunk consecutive rows of a column;
// blocks of kScanCols * 256 / kChunk threads.
template <int kChunk>
__global__ void __launch_bounds__(kScanCols * kScanRows / kChunk) scan_two_level_kernel(
    const float* __restrict__ x, float* __restrict__ out, int cols, int k, int clip) {
  constexpr int kN = kScanRows / kChunk;           // threads per column
  constexpr int kWidth = kN < 32 ? kN : 32;
  __shared__ float carry[kScanCols * kN / 32 + 1];
  const int q = threadIdx.x % kN, cl = threadIdx.x / kN;
  const int c = blockIdx.x * kScanCols + cl;
  float a[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) a[i] = x[(size_t)(q * kChunk + i) * cols + c];
  for (int it = 0; it < k; ++it) {
#pragma unroll
    for (int i = 1; i < kChunk; ++i) a[i] = __fmul_rn(a[i - 1], a[i]);
    float prev;
    const float incl = column_scan<kN>(a[kChunk - 1], carry, prev);
    // exclusive product of the chunk totals: the previous thread's
    // inclusive one, or the carry of the earlier warps at a warp's lane 0
    const float up = __shfl_up_sync(0xffffffffu, incl, 1, kWidth);
    const float excl = (threadIdx.x & (kWidth - 1)) == 0 ? prev : up;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      a[i] = __fmul_rn(a[i], excl);
      if (clip) a[i] = clip_unit(a[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) out[(size_t)(q * kChunk + i) * cols + c] = a[i];
}

// "mxu_log": exp(L @ log(max(x, 1e-30))), L the lower-triangular ones, as a
// dense float32 product: a warp per column, lane l holds rows 8l..8l+7 and
// sums every row of L against the column's logs (L's zeros included, in
// row order j = 0..255); blocks of kScanCols warps.
__global__ void __launch_bounds__(kScanCols * 32) scan_mxu_log_kernel(
    const float* __restrict__ x, float* __restrict__ out, int cols, int k, int clip) {
  constexpr int kRowsPerLane = kScanRows / 32;
  __shared__ float sl[kScanCols][kScanRows];
  const int lane = threadIdx.x & 31, cl = threadIdx.x >> 5;
  const int c = blockIdx.x * kScanCols + cl;
  const int r0 = lane * kRowsPerLane;
  float v[kRowsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) v[i] = x[(size_t)(r0 + i) * cols + c];
  for (int it = 0; it < k; ++it) {
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) sl[cl][r0 + i] = logf(fmaxf(v[i], 1e-30f));
    __syncwarp();
    float acc[kRowsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) acc[i] = 0.0f;
    for (int j = 0; j < kScanRows; ++j) {
      const float lj = sl[cl][j];
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i)
        acc[i] = __fmaf_rn(j <= r0 + i ? 1.0f : 0.0f, lj, acc[i]);
    }
    __syncwarp();   // every log read before the next rep writes
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      v[i] = expf(acc[i]);
      if (clip) v[i] = clip_unit(v[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) out[(size_t)(r0 + i) * cols + c] = v[i];
}

}  // namespace

extern "C" int ts_probe_vpu(const float* x, float* out, int n, int k, int op, int bf16,
                            float c, float s, cudaStream_t stream) {
  if (n <= 0 || k < 0 || op < 0 || op > 3 || (bf16 && n % 2 != 0))
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    const int n2 = n / 2;
    const int blocks = (n2 + kElemThreads - 1) / kElemThreads;
    const auto kernel = op == kMul ? &vpu_probe_bf16_kernel<kMul>
                        : op == kFma ? &vpu_probe_bf16_kernel<kFma>
                        : op == kMin3 ? &vpu_probe_bf16_kernel<kMin3>
                                      : &vpu_probe_bf16_kernel<kExp>;
    kernel<<<blocks, kElemThreads, 0, stream>>>(reinterpret_cast<const float2*>(x),
                                                reinterpret_cast<float2*>(out), n2, k, c, s);
  } else {
    const int blocks = (n + kElemThreads - 1) / kElemThreads;
    const auto kernel = op == kMul ? &vpu_probe_f32_kernel<kMul>
                        : op == kFma ? &vpu_probe_f32_kernel<kFma>
                        : op == kMin3 ? &vpu_probe_f32_kernel<kMin3>
                                      : &vpu_probe_f32_kernel<kExp>;
    kernel<<<blocks, kElemThreads, 0, stream>>>(x, out, n, k, c, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int ts_probe_exp(const float* x, float* out, int n, int k, int op, float c,
                            float s, cudaStream_t stream) {
  if (n <= 0 || k < 0 || op < 0 || op > 3) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kElemThreads - 1) / kElemThreads;
  const auto kernel = op == kMul8 ? &exp_probe_kernel<kMul8>
                      : op == kExpf ? &exp_probe_kernel<kExpf>
                      : op == kFastExp ? &exp_probe_kernel<kFastExp>
                                       : &exp_probe_kernel<kIntrinsicExp>;
  kernel<<<blocks, kElemThreads, 0, stream>>>(x, out, n, k, c, s);
  return (int)cudaGetLastError();
}

// variant: 0 hs, 1 hs_roll, 2 two_level (chunk 4, 8, 16 or 32), 3 mxu_log.
// rows must be 256 and cols a multiple of 8.
extern "C" int ts_probe_scan(const float* x, float* out, int rows, int cols, int k,
                             int variant, int chunk, int clip, cudaStream_t stream) {
  if (rows != kScanRows || cols <= 0 || cols % kScanCols != 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      scan_hs_kernel<<<cols / kScanCols, kScanCols * 32, 0, stream>>>(x, out, cols, k, clip);
      break;
    case 1:
      scan_hs_roll_kernel<<<cols / 4, kScanThreads, 0, stream>>>(x, out, cols, k, clip);
      break;
    case 2: {
      const auto kernel = chunk == 4 ? &scan_two_level_kernel<4>
                          : chunk == 8 ? &scan_two_level_kernel<8>
                          : chunk == 16 ? &scan_two_level_kernel<16>
                          : chunk == 32 ? &scan_two_level_kernel<32>
                                        : nullptr;
      if (kernel == nullptr) return (int)cudaErrorInvalidValue;
      kernel<<<cols / kScanCols, kScanCols * kScanRows / chunk, 0, stream>>>(x, out, cols,
                                                                           k, clip);
      break;
    }
    case 3:
      scan_mxu_log_kernel<<<cols / kScanCols, kScanCols * 32, 0, stream>>>(x, out, cols, k,
                                                                         clip);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
