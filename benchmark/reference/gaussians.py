"""Plain reference of the 3D Gaussian splat ("GS" variant).

The EWA preprocess follows ``triangle_splatting_tpu_torch/ops/gaussian.py:
preprocess_gaussian`` (a frozen copy of the model's definition: the
covariance R S S^T R^T, the clamped Jacobian, the 0.3 blur, the conic and
the tight radius that decides which tiles a Gaussian reaches); the
per-pixel falloff and the compositing follow the dense Gaussian oracle
(``blend_oracle_gs``): q = a dx^2 + 2 b dx dy + c dy^2, alpha = min(0.99,
o exp(-q / 2)), the entry that would bring T below 1e-4 skipped and the
pixel ended there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import tiles as TL
from .triangles import EPS, _floor_i32, _to_i32


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=1)


@dataclass
class PrepGS:
    mean2d: torch.Tensor
    conic: torch.Tensor
    depth: torch.Tensor
    rgb: torch.Tensor
    opacity: torch.Tensor
    valid: torch.Tensor
    rect_min: torch.Tensor
    rect_max: torch.Tensor
    radii: torch.Tensor


def preprocess(xyz, scale, rotation, rgb, opacity, cam, alive, gamma: float = 1.0,
               mean2d_offset=None) -> PrepGS:
    W, H = cam["width"], cam["height"]
    wv, fp = cam["world_view"], cam["full_proj"]
    unit_q = torch.zeros((1, 4), dtype=rotation.dtype, device=rotation.device)
    unit_q[0, 0] = 1.0
    rotation = torch.where(alive[:, None], rotation, unit_q)
    scale = torch.where(alive[:, None], scale, torch.ones_like(scale))

    def apply(M, p):
        return M[:, 0] * p[:, 0:1] + M[:, 1] * p[:, 1:2] + M[:, 2] * p[:, 2:3] + M[:, 3]

    h = apply(fp, xyz)
    w_inv = 1.0 / (torch.abs(h[:, 3]) + EPS)
    proj = h[:, :3] * w_inv[:, None]
    valid = (proj[:, 2] > 0) & alive
    t = apply(wv[:3], xyz)
    tz = torch.where(torch.abs(t[:, 2]) < EPS, torch.ones_like(t[:, 2]), t[:, 2])
    limx, limy = 1.3 * cam["tan_fovx"], 1.3 * cam["tan_fovy"]
    tx = torch.minimum(torch.maximum(t[:, 0] / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(t[:, 1] / tz, -limy), limy) * tz
    fx = W / (2.0 * cam["tan_fovx"])
    fy = H / (2.0 * cam["tan_fovy"])
    R = quat_to_rotmat(rotation)
    M = R * scale[:, None, :]
    cov3d = (M[:, :, None, :] * M[:, None, :, :]).sum(-1)
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
                     torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)], dim=1)
    Tm = (J[:, :, :, None] * wv[:3, :3][None, None, :, :]).sum(2)
    U = (Tm[:, :, :, None] * cov3d[:, None, :, :]).sum(2)
    cov2d = (U[:, :, None, :] * Tm[:, None, :, :]).sum(-1)
    cxx, cyy, cxy = cov2d[:, 0, 0] + 0.3, cov2d[:, 1, 1] + 0.3, cov2d[:, 0, 1]
    det = cxx * cyy - cxy * cxy
    valid = valid & (det > 0)
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([cyy / det_safe, -cxy / det_safe, cxx / det_safe], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    with torch.no_grad():
        o = opacity.reshape(-1)
        valid = valid & (o * 255.0 > 1.0 + 1e-6)
        q_max = torch.exp(torch.log(torch.clamp_min(
            2.0 * torch.log(torch.clamp_min(255.0 * o, 1.0 + 1e-6)), 1e-12)) / gamma)
        radius = torch.ceil(torch.sqrt(torch.clamp_max(q_max, 9.0) * torch.clamp_min(lam, 1e-12)))
    mean2d = torch.stack([((proj[:, 0] + 1.0) * W - 1.0) * 0.5,
                          ((proj[:, 1] + 1.0) * H - 1.0) * 0.5], -1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    with torch.no_grad():
        T = TL.TILE
        gw, gh = -(-W // T), -(-H // T)
        v_min, v_max = mean2d - radius[:, None], mean2d + radius[:, None]
        rect_min = torch.stack([torch.clamp(_floor_i32(v_min[:, 0] / T), 0, gw),
                                torch.clamp(_floor_i32(v_min[:, 1] / T), 0, gh)], -1)
        rect_max = torch.stack([torch.clamp(_floor_i32((v_max[:, 0] + T - 1) / T), 0, gw),
                                torch.clamp(_floor_i32((v_max[:, 1] + T - 1) / T), 0, gh)], -1)
        valid = valid & (rect_max[:, 0] > rect_min[:, 0]) & (rect_max[:, 1] > rect_min[:, 1])
        radii = torch.where(valid, _to_i32(radius), torch.zeros_like(rect_max[:, 0]))
    return PrepGS(mean2d, conic, t[:, 2], rgb, opacity, valid, rect_min, rect_max, radii)


def leaves_of(prep: PrepGS):
    src = dict(mean=prep.mean2d, conic=prep.conic, rgb=prep.rgb, op=prep.opacity)
    out = {k: v.detach().requires_grad_(True) for k, v in src.items()}
    out["valid"], out["depth"] = prep.valid, prep.depth.detach()
    return out, src


def chunk_fn(leaves: dict):
    """The per-chunk falloff at gamma 1 (the recipe's)."""
    def fn(prim, entry_ok, x, y, inside):
        mean, conic = leaves["mean"][prim], leaves["conic"][prim]
        ok = entry_ok & leaves["valid"][prim][..., None]
        dx = mean[..., 0:1] - x.to(mean.dtype)
        dy = mean[..., 1:2] - y.to(mean.dtype)
        q = conic[..., 0:1] * dx * dx + conic[..., 2:3] * dy * dy + 2 * conic[..., 1:2] * dx * dy
        alpha = torch.clamp_max(leaves["op"][prim][..., None]
                                * torch.exp(torch.clamp_max(-0.5 * q, 0.0)), TL.ALPHA_MAX)
        cand = ok & (q >= 0.0) & (alpha >= TL.ALPHA_MIN)
        return alpha, cand, ok, leaves["rgb"][prim], leaves["depth"][prim][..., None], None
    return fn
