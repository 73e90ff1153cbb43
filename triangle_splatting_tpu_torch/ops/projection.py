"""Per-triangle screen-space preprocess (differentiable, plain PyTorch).

Port of ``triangle_splatting_tpu/ops/projection.py`` (the 2D variant;
``preprocess_3d`` is not ported yet). The math and the order of every
floating-point operation follow the JAX function so both produce the same
numbers on the same inputs; gradients come from autograd.

2D variant semantics:
- linearized projection of centroid-relative vectors with view-space
  clipping at 1.3*tan(fov);
- 0.5 px low-pass dilation of the projected radii;
- near culling on projected z, degenerate culling on view-space normal and
  projected radii, optional backface culling on signed screen area;
- the tight dilated bounding rectangle -> touched tiles + pixel radius.

``center2d_offset`` is a zeros (P, 2) input added to the projected
centroid; its gradient is the densification statistic.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch

EPS = 1e-8


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Norm whose gradient is finite at x = 0 (dead slots are zero
    triangles; the tiny bias changes live values by < 1e-12)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-24)


@dataclass(frozen=True)
class RasterSettings:
    """Static rasterization configuration (see the JAX twin for the
    meaning of each field). Tiles are 32x32 pixels by default."""
    image_width: int = 800
    image_height: int = 800
    tile_h: int = 32
    tile_w: int = 32
    back_culling: bool = False
    rich_info: bool = True
    max_sh_degree: int = 3
    rasterizer_type: str = "2D"
    pairs_per_triangle: float = 6

    @property
    def grid_w(self) -> int:
        return (self.image_width + self.tile_w - 1) // self.tile_w

    @property
    def grid_h(self) -> int:
        return (self.image_height + self.tile_h - 1) // self.tile_h

    @property
    def num_tiles(self) -> int:
        return self.grid_w * self.grid_h


@dataclass(frozen=True)
class Preprocessed:
    """Per-triangle screen-space quantities feeding binning + blend."""
    v1_2d: torch.Tensor        # (P, 2) screen-space vertices (pixels)
    v2_2d: torch.Tensor
    v3_2d: torch.Tensor
    area2: torch.Tensor        # (P,) signed 2x area in pixel^2
    depth: torch.Tensor        # (P,) view-space z of the centroid (sort key)
    rgb: torch.Tensor          # (P, 3) SH-evaluated color
    valid: torch.Tensor        # (P,) bool — survives culling
    rect_min: torch.Tensor     # (P, 2) int32 tile coords (x, y), inclusive
    rect_max: torch.Tensor     # (P, 2) int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # (P,) int32
    radii: torch.Tensor        # (P,) int32 pixel radius (0 if culled)
    normal_view: torch.Tensor  # (P, 3) unit view-space normal
    v_depth: torch.Tensor      # (P, 3) per-vertex view depth

    def detach(self) -> "Preprocessed":
        return Preprocessed(**{f.name: getattr(self, f.name).detach()
                               for f in fields(self)})


def ndc2pix(v: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1,1] -> pixel center coordinates."""
    return ((v + 1.0) * size - 1.0) * 0.5


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def project_vec_approx(p_view, vec_view, tan_fovx, tan_fovy):
    """Linearized perspective projection of a view-space vector at p_view:
    d(x_proj) = (dx - dz*x/z) / (z * tan_fovx), same for y."""
    z = p_view[..., 2]
    x = vec_view[..., 0] - vec_view[..., 2] * p_view[..., 0] / z
    y = vec_view[..., 1] - vec_view[..., 2] * p_view[..., 1] / z
    return torch.stack([x / (z * tan_fovx), y / (z * tan_fovy)], dim=-1)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Saturating float -> int32 (a plain cast of an out-of-range float is
    undefined; XLA saturates). NaN maps to 0."""
    lim = float(2 ** 30)
    return torch.nan_to_num(x, nan=0.0, posinf=lim, neginf=-lim).clamp(
        -lim, lim).to(torch.int32)


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    return _to_i32(torch.floor(x))


def preprocess_2d(vertex: torch.Tensor, center2d_offset: torch.Tensor,
                  rgb: torch.Tensor, world_view: torch.Tensor,
                  full_proj: torch.Tensor, tan_fovx, tan_fovy,
                  settings: RasterSettings,
                  alive_mask: Optional[torch.Tensor] = None,
                  opacity: Optional[torch.Tensor] = None,
                  gamma=None) -> Preprocessed:
    """Project (P, 3, 3) world-space triangles to screen space.

    ``opacity``/``gamma`` enable the tight bounding box: the exact support
    of ``alpha >= 1/255`` is ``ecc <= (2 ln(255 o))^(1/(2 gamma))``, at most
    3, so the rectangle shrinks at low opacity or high gamma and renders the
    same image with fewer tile pairs.
    """
    W, H = settings.image_width, settings.image_height
    TW, TH = settings.tile_w, settings.tile_h
    grid_w, grid_h = settings.grid_w, settings.grid_h

    center = vertex.mean(dim=1)                                     # (P, 3)

    def _apply(M, pts):
        """(R, 4) affine matrix applied to (P, 3) points -> (P, R), spelled
        out as broadcasts in the same order as the JAX twin."""
        out = M[:, 0] * pts[:, 0:1] + M[:, 1] * pts[:, 1:2] + M[:, 2] * pts[:, 2:3]
        return out + M[:, 3]

    c_hom = _apply(full_proj, center)                               # (P, 4)
    cw = c_hom[:, 3]
    w_inv = 1.0 / (torch.abs(cw) + EPS)
    center_proj = c_hom[:, :3] * w_inv[:, None]                     # (P, 3)
    valid = center_proj[:, 2] > 0                                   # near culling
    if alive_mask is not None:
        valid = valid & alive_mask

    Rv = world_view[:3, :3]
    center_view = _apply(world_view[:3], center)                    # (P, 3)
    zv = center_view[:, 2]
    zv_safe = torch.where(torch.abs(zv) < EPS, torch.ones_like(zv), zv)
    limx = 1.3 * tan_fovx * zv_safe
    limy = 1.3 * tan_fovy * zv_safe
    cvc = torch.stack([
        torch.minimum(torch.maximum(center_view[:, 0], -limx), limx),
        torch.minimum(torch.maximum(center_view[:, 1], -limy), limy),
        zv_safe,
    ], dim=-1)

    r = vertex - center[:, None, :]                                 # (P, 3, 3)
    r_view = (Rv[:, 0] * r[..., 0:1] + Rv[:, 1] * r[..., 1:2]
              + Rv[:, 2] * r[..., 2:3])                             # (P, 3, 3)
    n_view_raw = torch.linalg.cross(r_view[:, 0], r_view[:, 1])     # (P, 3)
    n_view_norm = safe_norm(n_view_raw)
    valid = valid & (n_view_norm >= EPS)

    r_proj = project_vec_approx(cvc[:, None, :], r_view, tan_fovx, tan_fovy)
    n_proj = safe_norm(r_proj)                                      # (P, 3)
    valid = valid & torch.all(n_proj >= EPS, dim=-1)
    n_proj_safe = torch.where(n_proj < EPS, torch.ones_like(n_proj), n_proj)

    kernel_size = 0.5
    scale = torch.stack([
        0.5 * W + kernel_size / n_proj_safe,
        0.5 * H + kernel_size / n_proj_safe,
    ], dim=-1)                                                      # (P, 3, 2)
    r_2d = r_proj * scale

    center_2d = torch.stack([
        ndc2pix(center_proj[:, 0], W),
        ndc2pix(center_proj[:, 1], H),
    ], dim=-1) + center2d_offset                                    # (P, 2)

    v_2d = center_2d[:, None, :] + r_2d                             # (P, 3, 2)
    area2 = _cross2(v_2d[:, 1] - v_2d[:, 0], v_2d[:, 2] - v_2d[:, 0])
    if settings.back_culling:
        valid = valid & (area2 < -EPS)
    else:
        valid = valid & (torch.abs(area2) >= EPS)

    if opacity is not None and gamma is not None:
        o = opacity.reshape(-1).detach()
        g = torch.as_tensor(gamma, dtype=torch.float32, device=o.device).detach()
        vis = o * 255.0 > 1.0 + 1e-6
        valid = valid & vis                      # alpha < 1/255 everywhere
        log_pow = torch.log(torch.clamp_min(
            2.0 * torch.log(torch.clamp_min(255.0 * o, 1.0 + 1e-6)), 1e-12))
        dilation = torch.clamp_max(torch.exp(log_pow / (2.0 * g)), 3.0)[:, None, None]
    else:
        dilation = 3.0
    v_dil = center_2d[:, None, :] + dilation * r_2d                 # (P, 3, 2)
    v_min = v_dil.amin(dim=1)
    v_max = v_dil.amax(dim=1)

    rect_min = torch.stack([
        torch.clamp(_floor_i32(v_min[:, 0] / TW), 0, grid_w),
        torch.clamp(_floor_i32(v_min[:, 1] / TH), 0, grid_h),
    ], dim=-1)
    rect_max = torch.stack([
        torch.clamp(_floor_i32((v_max[:, 0] + TW - 1) / TW), 0, grid_w),
        torch.clamp(_floor_i32((v_max[:, 1] + TH - 1) / TH), 0, grid_h),
    ], dim=-1)
    valid = valid & (rect_max[:, 0] > rect_min[:, 0]) & (rect_max[:, 1] > rect_min[:, 1])

    tiles_touched = torch.where(
        valid, (rect_max[:, 0] - rect_min[:, 0]) * (rect_max[:, 1] - rect_min[:, 1]),
        torch.zeros_like(rect_max[:, 0])).to(torch.int32)
    radii = torch.where(valid, _to_i32(torch.maximum(
        torch.ceil((v_max[:, 0] - v_min[:, 0]) * 0.5),
        torch.ceil((v_max[:, 1] - v_min[:, 1]) * 0.5),
    )), torch.zeros_like(tiles_touched))

    n_safe = torch.where(n_view_norm < EPS, torch.ones_like(n_view_norm), n_view_norm)
    normal_view = n_view_raw / n_safe[:, None]
    v_depth = r_view[:, :, 2] + zv[:, None]                         # (P, 3)

    return Preprocessed(
        v1_2d=v_2d[:, 0], v2_2d=v_2d[:, 1], v3_2d=v_2d[:, 2],
        area2=area2, depth=zv, rgb=rgb, valid=valid,
        rect_min=rect_min, rect_max=rect_max,
        tiles_touched=tiles_touched, radii=radii,
        normal_view=normal_view, v_depth=v_depth,
    )
