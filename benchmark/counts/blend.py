"""Operation and byte counts of the blend kernels and of a training step:
the yardstick of the roofline and utilization metrics.

Frozen copies of ``chip_smoke.py``'s counts (``HBM_BYTES_PER_S``,
``F32_OPS_PER_S``, ``FWD/BWD_OPS_PER_EVAL*``, ``RICH_*_OPS``, the B2 byte
count of ``check_blend_rich`` / ``check_blend_gs``, ``bound_ms``), with the
step's other terms (SSIM, the depth-normal term, L1, preprocessing and SH,
Adam) counted here. Every count is of the work the algorithm needs on the
frame's own inputs, whatever implements it.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bandwidth and
# float32 throughput outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Operations per evaluated (pair, pixel), keyed by gamma == 1; "3D" counted
# from csrc/blend.cu, "GS" from csrc/blend_gs.cu (see chip_smoke.py).
FWD_OPS_PER_EVAL = {"3D": {True: 43, False: 48}, "GS": {True: 30, False: 35}}
BWD_OPS_PER_EVAL = {"3D": {True: 92, False: 104}, "GS": {True: 66, False: 78}}
RICH_FWD_OPS = {"3D": 9, "GS": 2}
RICH_BWD_OPS = {"3D": 22, "GS": 4}
# leading per-pair gradient rows B2 writes and B4 reads, (variant, rich)
LIVE_GRAD_ROWS = {("3D", True): 14, ("3D", False): 13, ("GS", True): 11, ("GS", False): 10}
# SSIM: five 11x11 depthwise convolutions per channel (121 multiply-adds
# each) and ~20 elementwise operations per pixel and channel forward; the
# backward twice the forward
SSIM_OPS_PER_PIXEL_CHANNEL = 3 * (5 * 2 * 121 + 20)
# L1 forward and backward per pixel and channel
L1_OPS_PER_PIXEL_CHANNEL = 6
# the depth-normal term per full-size pixel: the half-size Scharr pair and
# normal (2 * 18 + 20) at a quarter of the pixels, the two antialiased
# resizes (~16 a channel, 4 channels), the cosine and mask (12); backward
# twice the forward
DEPTH_NORMAL_OPS_PER_PIXEL = 3 * ((2 * 18 + 20) / 4 + 4 * 16 + 12)
# per primitive: the "3D" preprocess (view transform 3 x 18, cross and
# norm 12, dilation and projection of three vertices 3 x 28, rect 16),
# degree-0 SH (6), the gamma rescale (12) and the field matrix (~80);
# backward twice the forward
PRIM_OPS = {"3D": 3 * (54 + 12 + 84 + 16 + 6 + 12 + 80)}
# per Gaussian, forward only: the EWA preprocess (the quaternion's rotation
# 30, R S 9, the covariance 27, the projection and clamped Jacobian 30, J W
# 18, T cov T^T 30, the blur, conic and radius 20, the rect 16)
PRIM_OPS_FWD = {"GS": 180}
# per decoded Gaussian, forward only: the offset's tanh and scale (7), the
# scale's sigmoid and product (9), the quaternion's norm (12), the opacity
# and color sigmoids (16), the selection (3)
SCAFFOLD_DECODE_OPS = 47
# Adam per parameter: two moment updates (5), the bias corrections and the
# update (7)
ADAM_OPS_PER_PARAM = 12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time of a kernel: the larger of bytes over HBM bandwidth
    and operations over float32 throughput."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def b2(variant: str, rich: bool, gamma1: bool, evals: float, num_pairs: int, tiles: int,
       pixels: int) -> tuple[float, float]:
    """(operations, bytes) of B2 on one frame: per evaluated (pair, pixel)
    up to each pixel's contributor count, the live rows of every binned
    pair, the tile ranges and parameters read, the per-pixel cotangents and
    state read ("3D" rich: color 3, final_T, n_contrib, depth, normal 3,
    and T; "GS" plain: 6), and the live gradient rows of every binned pair
    written once."""
    live = LIVE_GRAD_ROWS[(variant, rich)]
    ops = (BWD_OPS_PER_EVAL[variant][gamma1] + (RICH_BWD_OPS[variant] if rich else 0)) * evals
    per_pixel = 10 if (variant == "3D" and rich) else (7 if rich else 6)
    nbytes = 4 * (live * num_pairs + 2 * tiles + 1 + 8) + 4 * per_pixel * pixels \
        + 4 * 16 * num_pairs
    return ops, nbytes


def b1_ops_dense(variant: str, rich: bool, gamma1: bool, evals: float) -> float:
    """B1's operations at every evaluated (pair, pixel)."""
    return (FWD_OPS_PER_EVAL[variant][gamma1] + (RICH_FWD_OPS[variant] if rich else 0)) * evals


def b1(variant: str, rich: bool, gamma1: bool, evals: float, num_pairs: int, tiles: int,
       pixels: int) -> tuple[float, float]:
    """(operations, bytes) of B1 on one frame: every evaluated (pair,
    pixel), the live field rows of every binned pair and the tile ranges
    read, the nine per-pixel outputs (color 3, depth, normal 3, final_T,
    n_contrib) written once."""
    live = LIVE_GRAD_ROWS[(variant, rich)]
    nbytes = 4 * (live * num_pairs + 2 * tiles + 1 + 8) + 4 * 9 * pixels
    return b1_ops_dense(variant, rich, gamma1, evals), nbytes
