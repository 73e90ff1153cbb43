"""Dense reference rasterizer (the semantic oracle), plain PyTorch.

Port of ``triangle_splatting_tpu/ops/oracle.py:blend_oracle`` (2D): an
O(P * H * W) front-to-back blend over depth-sorted triangles, one Python
step per triangle (the JAX ``lax.scan``):

- per-pixel barycentrics against the dilated screen triangle;
  ``ecc = 1 - 3*min(a1, a2, a3)``, skipped outside [0, 10];
- ``alpha = min(0.99, opacity * exp(-0.5 * ecc**(2*gamma)))``, skipped
  below 1/255;
- early stop at T <= 1e-4 (a pixel's "done" flag freezes T and stops
  counting contributors);
- a triangle only affects pixels whose tile lies in its rect (the binning
  membership rule).

Fully differentiable with autograd; independent of binning and of the
blend kernels, so it is the reference for both. Small scenes only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .binning import depth_bits_for, quantize_depth
from .projection import Preprocessed, RasterSettings, _cross2

T_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
ECC_MAX = 10.0


class OracleOutputs(NamedTuple):
    color: torch.Tensor        # (3, H, W)
    depth: torch.Tensor        # (H, W)
    normal: torch.Tensor       # (3, H, W)
    final_T: torch.Tensor      # (H, W)
    n_contrib: torch.Tensor    # (H, W) int32
    contrib_sum: torch.Tensor  # (P,)
    contrib_max: torch.Tensor  # (P,)


def blend_oracle(prep: Preprocessed, opacity: torch.Tensor, gamma,
                 background: torch.Tensor, background_depth,
                 settings: RasterSettings) -> OracleOutputs:
    """Composite all triangles over the full image, front to back."""
    W, H = settings.image_width, settings.image_height
    tile_w, tile_h = settings.tile_w, settings.tile_h
    dev, dt = opacity.device, opacity.dtype
    P = opacity.shape[0]

    # stable depth sort on the binning's quantized depths, so the composite
    # order matches the tile pipeline exactly
    dq = quantize_depth(prep.depth, prep.valid, depth_bits_for(settings.num_tiles))
    sort_depth = torch.where(prep.valid, dq, torch.full_like(dq, torch.iinfo(torch.int32).max))
    order = torch.argsort(sort_depth, stable=True)

    px = torch.arange(W, dtype=dt, device=dev)[None, :].expand(H, W)
    py = torch.arange(H, dtype=dt, device=dev)[:, None].expand(H, W)
    tx = (torch.arange(W, device=dev) // tile_w)[None, :].expand(H, W)
    ty = (torch.arange(H, device=dev) // tile_h)[:, None].expand(H, W)
    gamma = torch.as_tensor(gamma, dtype=dt, device=dev)

    T = torch.ones((H, W), dtype=dt, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    n_contrib = torch.zeros((H, W), dtype=torch.int32, device=dev)
    accum_c = torch.zeros((3, H, W), dtype=dt, device=dev)
    accum_d = torch.zeros((H, W), dtype=dt, device=dev)
    accum_n = torch.zeros((3, H, W), dtype=dt, device=dev)
    c_sums, c_maxs = [], []
    zero = torch.zeros((), dtype=dt, device=dev)
    for i in order.tolist():
        valid = prep.valid[i]
        # invalid triangles may carry garbage; keep their terms exactly zero
        color = torch.where(valid, prep.rgb[i], zero)
        nrm = torch.where(valid, prep.normal_view[i], zero)
        vd = torch.where(valid, prep.v_depth[i], zero)
        area2 = torch.where(valid, prep.area2[i], torch.ones_like(zero))
        v1, v2, v3 = prep.v1_2d[i], prep.v2_2d[i], prep.v3_2d[i]
        rmin, rmax = prep.rect_min[i], prep.rect_max[i]

        member = ((tx >= rmin[0]) & (tx < rmax[0]) & (ty >= rmin[1])
                  & (ty < rmax[1]) & valid)
        proc = member & ~done

        pv1 = torch.stack([v1[0] - px, v1[1] - py], -1)
        pv2 = torch.stack([v2[0] - px, v2[1] - py], -1)
        pv3 = torch.stack([v3[0] - px, v3[1] - py], -1)
        a1 = _cross2(pv2, pv3) / area2
        a2 = _cross2(pv3, pv1) / area2
        a3 = 1.0 - a1 - a2
        ecc = 1.0 - 3.0 * torch.minimum(torch.minimum(a1, a2), a3)
        ecc_ok = (ecc >= 0.0) & (ecc <= ECC_MAX)
        ecc_safe = torch.clamp(ecc, 0.0, ECC_MAX)
        logp = 2.0 * gamma * torch.log(torch.clamp_min(ecc_safe, 1e-30))
        power = -0.5 * torch.exp(torch.clamp(logp, -87.0, 44.0))
        alpha = torch.clamp_max(opacity[i] * torch.exp(power), ALPHA_MAX)
        eff = proc & ecc_ok & (alpha >= ALPHA_MIN)

        contrib = torch.where(eff, alpha * T, zero)
        accum_c = accum_c + color[:, None, None] * contrib[None]
        d = vd[0] * a1 + vd[1] * a2 + vd[2] * a3
        accum_d = accum_d + torch.where(eff, d * contrib, zero)
        accum_n = accum_n + nrm[:, None, None] * contrib[None]

        T = torch.where(eff, T * (1.0 - alpha), T)
        done = done | (eff & (T <= T_EPS))
        n_contrib = n_contrib + proc.to(torch.int32)
        c_sums.append(contrib.sum())
        c_maxs.append(contrib.max())

    color = accum_c + T[None] * background[:, None, None]
    depth = accum_d + T * background_depth
    contrib_sum = torch.zeros((P,), dtype=dt, device=dev)
    contrib_max = torch.zeros((P,), dtype=dt, device=dev)
    if P:
        contrib_sum = contrib_sum.index_put((order,), torch.stack(c_sums))
        contrib_max = contrib_max.index_put((order,), torch.stack(c_maxs))
    return OracleOutputs(color=color, depth=depth, normal=accum_n,
                         final_T=T, n_contrib=n_contrib,
                         contrib_sum=contrib_sum, contrib_max=contrib_max)
