"""Gaussian-splat preprocess and dense oracle (differentiable, plain PyTorch).

Port of ``triangle_splatting_tpu/ops/gaussian.py``:

- the 3D covariance R S S^T R^T from scales and (w, x, y, z) quaternions;
- the EWA projection to a 2D screen covariance J W Sigma W^T J^T with the
  1.3 * tan(fov) clamp and the +0.3 px low-pass diagonal, its conic
  (inverse), and the radius from its larger eigenvalue: 3 sigma, or with
  ``opacity`` and ``gamma`` the tight q <= (2 ln(255 o))^(1/gamma) support
  of alpha >= 1/255 (at most 3 sigma), without gradient;
- the tile rect, the packed kernel fields (``gaussian_field_matrix``) and
  the dense oracle with the Gaussian semantics (``blend_oracle_gs``).

The covariances are written elementwise in float32 (the JAX package runs
them at ``Precision.HIGHEST``): no matrix product, so no TF32 rounding on
the card whatever ``torch.backends.cuda.matmul.allow_tf32`` says.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from .binning import depth_bits_for, quantize_depth
from .oracle import OracleOutputs
from .projection import EPS, RasterSettings, _floor_i32, _to_i32, ndc2pix

T_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99


@dataclass(frozen=True)
class PreprocessedGS:
    """Per-Gaussian screen-space quantities feeding binning and blend."""
    mean2d: torch.Tensor         # (P, 2) pixel-space center
    conic: torch.Tensor          # (P, 3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor          # (P,) view z (sort key)
    rgb: torch.Tensor            # (P, 3)
    valid: torch.Tensor          # (P,) bool
    rect_min: torch.Tensor       # (P, 2) int32 tile coords, inclusive
    rect_max: torch.Tensor       # (P, 2) int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # (P,) int32
    radii: torch.Tensor          # (P,) int32 pixel radius (0 if culled)

    def detach(self) -> "PreprocessedGS":
        return PreprocessedGS(**{f.name: getattr(self, f.name).detach()
                                 for f in fields(self)})


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(P, 4) wxyz quaternions -> (P, 3, 3) rotations."""
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=1)


def build_cov3d(scale: torch.Tensor, rotation: torch.Tensor,
                scale_modifier=1.0) -> torch.Tensor:
    """(P, 3) scales + (P, 4) quaternions -> (P, 3, 3) world covariance
    R S S^T R^T, elementwise in float32."""
    R = quat_to_rotmat(rotation)
    M = R * (scale * scale_modifier)[:, None, :]               # R @ diag(S)
    return (M[:, :, None, :] * M[:, None, :, :]).sum(-1)


def preprocess_gaussian(xyz: torch.Tensor, scale: torch.Tensor,
                        rotation: torch.Tensor, rgb: torch.Tensor,
                        world_view: torch.Tensor, full_proj: torch.Tensor,
                        tan_fovx, tan_fovy, settings: RasterSettings,
                        alive_mask=None, opacity=None, gamma=None,
                        scale_modifier=1.0, mean2d_offset=None) -> PreprocessedGS:
    """Project Gaussians to screen space (EWA splatting)."""
    W, H = settings.image_width, settings.image_height
    TW, TH = settings.tile_w, settings.tile_h

    if alive_mask is not None:
        # dead capacity slots may hold zero quaternions (a singular
        # covariance, NaN conic gradients through the masked rows): give
        # them a unit quaternion and unit scales
        unit_q = torch.zeros((1, 4), dtype=rotation.dtype, device=rotation.device)
        unit_q[0, 0] = 1.0
        rotation = torch.where(alive_mask[:, None], rotation, unit_q)
        scale = torch.where(alive_mask[:, None], scale, torch.ones_like(scale))

    def _apply(M, pts):
        out = M[:, 0] * pts[:, 0:1] + M[:, 1] * pts[:, 1:2] + M[:, 2] * pts[:, 2:3]
        return out + M[:, 3]

    h = _apply(full_proj, xyz)
    w_inv = 1.0 / (torch.abs(h[:, 3]) + EPS)
    proj = h[:, :3] * w_inv[:, None]
    valid = proj[:, 2] > 0                                      # near culling
    if alive_mask is not None:
        valid = valid & alive_mask

    t = _apply(world_view[:3], xyz)                             # view point
    tz = torch.where(torch.abs(t[:, 2]) < EPS, torch.ones_like(t[:, 2]), t[:, 2])
    limx = torch.as_tensor(1.3 * tan_fovx, dtype=xyz.dtype, device=xyz.device)
    limy = torch.as_tensor(1.3 * tan_fovy, dtype=xyz.dtype, device=xyz.device)
    tx = torch.minimum(torch.maximum(t[:, 0] / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(t[:, 1] / tz, -limy), limy) * tz

    focal_x = W / (2.0 * tan_fovx)
    focal_y = H / (2.0 * tan_fovy)
    cov3d = build_cov3d(scale, rotation, scale_modifier)        # (P, 3, 3)

    # the two rows of the EWA Jacobian J, then T = J W and T cov3d T^T
    zero = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([focal_x / tz, zero, -focal_x * tx / (tz * tz)], -1),
        torch.stack([zero, focal_y / tz, -focal_y * ty / (tz * tz)], -1),
    ], dim=1)                                                   # (P, 2, 3)
    Wv = world_view[:3, :3]                                     # world -> view rotation
    Tm = (J[:, :, :, None] * Wv[None, None, :, :]).sum(2)      # (P, 2, 3)
    U = (Tm[:, :, :, None] * cov3d[:, None, :, :]).sum(2)      # (P, 2, 3)
    cov2d = (U[:, :, None, :] * Tm[:, None, :, :]).sum(-1)     # (P, 2, 2)
    cxx = cov2d[:, 0, 0] + 0.3
    cyy = cov2d[:, 1, 1] + 0.3
    cxy = cov2d[:, 0, 1]

    det = cxx * cyy - cxy * cxy
    valid = valid & (det > 0)
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([cyy / det_safe, -cxy / det_safe, cxx / det_safe], -1)

    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    with torch.no_grad():
        if opacity is not None and gamma is not None:
            # tight radius: alpha >= 1/255 needs q <= (2 ln(255 o))^(1/gamma)
            o = opacity.reshape(-1)
            g = torch.as_tensor(gamma, dtype=torch.float32, device=o.device)
            valid = valid & (o * 255.0 > 1.0 + 1e-6)
            q_max = torch.exp(torch.log(torch.clamp_min(
                2.0 * torch.log(torch.clamp_min(255.0 * o, 1.0 + 1e-6)), 1e-12)) / g)
            radius_f = torch.ceil(torch.sqrt(torch.clamp_max(q_max, 9.0)
                                             * torch.clamp_min(lam, 1e-12)))
        else:
            radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 1e-12)))

    mean2d = torch.stack([ndc2pix(proj[:, 0], W), ndc2pix(proj[:, 1], H)], -1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    with torch.no_grad():
        v_min = mean2d - radius_f[:, None]
        v_max = mean2d + radius_f[:, None]
        rect_min = torch.stack([
            torch.clamp(_floor_i32(v_min[:, 0] / TW), 0, settings.grid_w),
            torch.clamp(_floor_i32(v_min[:, 1] / TH), 0, settings.grid_h),
        ], -1)
        rect_max = torch.stack([
            torch.clamp(_floor_i32((v_max[:, 0] + TW - 1) / TW), 0, settings.grid_w),
            torch.clamp(_floor_i32((v_max[:, 1] + TH - 1) / TH), 0, settings.grid_h),
        ], -1)
        valid = valid & (rect_max[:, 0] > rect_min[:, 0]) & (rect_max[:, 1] > rect_min[:, 1])
        tiles = torch.where(valid, (rect_max[:, 0] - rect_min[:, 0])
                            * (rect_max[:, 1] - rect_min[:, 1]),
                            torch.zeros_like(rect_max[:, 0])).to(torch.int32)
        radii = torch.where(valid, _to_i32(radius_f), torch.zeros_like(tiles))

    return PreprocessedGS(mean2d=mean2d, conic=conic, depth=t[:, 2], rgb=rgb,
                          valid=valid, rect_min=rect_min, rect_max=rect_max,
                          tiles_touched=tiles, radii=radii)


def gaussian_field_matrix(prep: PreprocessedGS, opacity: torch.Tensor) -> torch.Tensor:
    """(P, 16) kernel fields: the screen center and the conic, from which
    the kernels evaluate q = a*dx^2 + 2b*dx*dy + c*dy^2 directly (the
    polynomial expansion in the pixel coordinates is badly conditioned:
    its constant term ~ conic * center^2 cancels the linear terms by ~3
    orders of magnitude), then opacity, rgb and the view depth."""
    X, Y = prep.mean2d[:, 0], prep.mean2d[:, 1]
    a, b, c = prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2]
    rgb = prep.rgb
    z = torch.zeros_like(X)
    fmat = torch.stack([X, Y, a, b, c, z, opacity, rgb[:, 0], rgb[:, 1], rgb[:, 2],
                        prep.depth, z, z, z, z, z], dim=1)
    return torch.where(prep.valid[:, None], fmat, torch.zeros_like(fmat))


def blend_oracle_gs(prep: PreprocessedGS, opacity: torch.Tensor, gamma,
                    background: torch.Tensor, background_depth,
                    settings: RasterSettings) -> OracleOutputs:
    """Dense oracle with the Gaussian semantics: the entry that would push T
    below 1e-4 is skipped and ends the pixel, and ``n_contrib`` is the
    1-based tile-list index of the last composited entry (the kill entry
    and trailing skips excluded, interleaved skips before the last
    composite counted). One Python step per Gaussian in the binning's
    depth order; differentiable with autograd. Small scenes only."""
    W, H = settings.image_width, settings.image_height
    tile_w, tile_h = settings.tile_w, settings.tile_h
    dev, dt = opacity.device, opacity.dtype
    P = opacity.shape[0]

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
    cnt = torch.zeros((H, W), dtype=torch.int32, device=dev)
    n_contrib = torch.zeros((H, W), dtype=torch.int32, device=dev)
    accum_c = torch.zeros((3, H, W), dtype=dt, device=dev)
    accum_d = torch.zeros((H, W), dtype=dt, device=dev)
    c_sums, c_maxs = [], []
    zero = torch.zeros((), dtype=dt, device=dev)
    for i in order.tolist():
        valid = prep.valid[i]
        color = torch.where(valid, prep.rgb[i], zero)
        mean, conic = prep.mean2d[i], prep.conic[i]
        rmin, rmax = prep.rect_min[i], prep.rect_max[i]

        member = ((tx >= rmin[0]) & (tx < rmax[0]) & (ty >= rmin[1])
                  & (ty < rmax[1]) & valid)
        cnt = cnt + member.to(torch.int32)          # contributor++ per member
        proc = member & ~done

        dx = mean[0] - px
        dy = mean[1] - py
        q = conic[0] * dx * dx + conic[2] * dy * dy + 2 * conic[1] * dx * dy
        qs = torch.clamp_min(q, 1e-30)
        power = torch.where(gamma == 1.0, -0.5 * q,
                            -0.5 * torch.exp(torch.clamp(gamma * torch.log(qs), -87.0, 44.0)))
        alpha = torch.clamp_max(opacity[i] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
        a_ok = (q >= 0.0) & (alpha >= ALPHA_MIN)
        test_T = T * (1.0 - alpha)
        kill = proc & a_ok & (test_T < T_EPS)       # done; not composited
        eff = proc & a_ok & (test_T >= T_EPS)

        contrib = torch.where(eff, alpha * T, zero)
        accum_c = accum_c + color[:, None, None] * contrib[None]
        accum_d = accum_d + torch.where(eff, prep.depth[i] * contrib, zero)
        T = torch.where(eff, test_T, T)
        done = done | kill
        n_contrib = torch.where(eff, cnt, n_contrib)  # last composited index
        c_sums.append(contrib.sum())
        c_maxs.append(contrib.max())

    color = accum_c + T[None] * background[:, None, None]
    depth = accum_d + T * torch.as_tensor(background_depth, dtype=dt, device=dev)
    contrib_sum = torch.zeros((P,), dtype=dt, device=dev)
    contrib_max = torch.zeros((P,), dtype=dt, device=dev)
    if P:
        contrib_sum = contrib_sum.index_put((order,), torch.stack(c_sums))
        contrib_max = contrib_max.index_put((order,), torch.stack(c_maxs))
    return OracleOutputs(color=color, depth=depth,
                         normal=torch.zeros((3, H, W), dtype=dt, device=dev),
                         final_T=T, n_contrib=n_contrib,
                         contrib_sum=contrib_sum, contrib_max=contrib_max)
