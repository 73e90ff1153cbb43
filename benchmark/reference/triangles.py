"""Plain reference of the perspective-correct ("3D") triangle splat.

The preprocess follows ``triangle_splatting_tpu_torch/ops/projection.py:
preprocess_3d`` and the SH color ``ops/sh.py:eval_sh`` (frozen copies of
the model's definition: they decide which tiles a triangle reaches and in
what order). The per-pixel falloff is the dense oracle's DIRECT form
(``ops/oracle.py:blend_oracle_3d``): each pixel ray is intersected with the
triangle's plane and the barycentrics are 3D cross products, not the
kernels' ratios of affine forms, so the comparison checks that
reformulation too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import tiles as TL

EPS = 1e-8
SH_C0 = 0.28209479177387814
ECC_MAX = 10.0


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Norm with a finite gradient at 0."""
    sq = torch.sum(x * x, dim=dim)
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def sh_color_dc(f_dc: torch.Tensor) -> torch.Tensor:
    """Degree-0 SH color: (P, 1, 3) -> (P, 3), +0.5, clamped at zero."""
    return torch.clamp_min(SH_C0 * f_dc[:, 0] + 0.5, 0.0)


def gamma_rescale_ratio(gamma: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(2^b * b * Gamma(b)), b = 1 / gamma (float32)."""
    b = 1.0 / gamma.to(torch.float32)
    return torch.exp(-0.5 * (b * math.log(2.0) + torch.log(b) + torch.lgamma(b)))


def rescale_about_centroid(vertex: torch.Tensor, ratio) -> torch.Tensor:
    center = vertex.mean(dim=1, keepdim=True)
    return (vertex - center) * ratio + center


def _to_i32(x):
    lim = float(2 ** 30)
    return torch.nan_to_num(x, nan=0.0, posinf=lim, neginf=-lim).clamp(-lim, lim).to(torch.int32)


def _floor_i32(x):
    return _to_i32(torch.floor(x))


def tile_rect(v_min, v_max, valid, width: int, height: int):
    """Pixel bbox -> (rect_min, rect_max, valid, radii) in 32x32 tiles."""
    T = TL.TILE
    gw, gh = -(-width // T), -(-height // T)
    rect_min = torch.stack([torch.clamp(_floor_i32(v_min[:, 0] / T), 0, gw),
                            torch.clamp(_floor_i32(v_min[:, 1] / T), 0, gh)], -1)
    rect_max = torch.stack([torch.clamp(_floor_i32((v_max[:, 0] + T - 1) / T), 0, gw),
                            torch.clamp(_floor_i32((v_max[:, 1] + T - 1) / T), 0, gh)], -1)
    valid = valid & (rect_max[:, 0] > rect_min[:, 0]) & (rect_max[:, 1] > rect_min[:, 1])
    radii = torch.where(valid, _to_i32(torch.maximum(
        torch.ceil((v_max[:, 0] - v_min[:, 0]) * 0.5),
        torch.ceil((v_max[:, 1] - v_min[:, 1]) * 0.5))), torch.zeros_like(rect_max[:, 0]))
    return rect_min, rect_max, valid, radii


def tight_dilation(opacity, gamma, valid):
    """The world-space dilation (P, 1, 1) beyond which alpha < 1/255, capped
    at 3; triangles that never reach 1/255 leave ``valid``."""
    o = opacity.reshape(-1).detach()
    g = gamma.detach().to(torch.float32)
    valid = valid & (o * 255.0 > 1.0 + 1e-6)
    log_pow = torch.log(torch.clamp_min(
        2.0 * torch.log(torch.clamp_min(255.0 * o, 1.0 + 1e-6)), 1e-12))
    return torch.clamp_max(torch.exp(log_pow / (2.0 * g)), 3.0)[:, None, None], valid


@dataclass
class Prep3D:
    v_view: torch.Tensor      # (P, 3, 3) view-space vertices
    normal: torch.Tensor      # (P, 3) unnormalized plane normal
    depth: torch.Tensor       # (P,) centroid view z
    rgb: torch.Tensor         # (P, 3)
    opacity: torch.Tensor     # (P,)
    valid: torch.Tensor
    rect_min: torch.Tensor
    rect_max: torch.Tensor
    radii: torch.Tensor


def preprocess_3d(vertex, rgb, opacity, cam, alive, gamma) -> Prep3D:
    """World triangles (P, 3, 3) through camera ``cam`` (a dict of float32
    tensors: world_view, full_proj, tan_fovx, tan_fovy, width, height)."""
    wv, fp = cam["world_view"], cam["full_proj"]
    W, H = cam["width"], cam["height"]
    v_view = (wv[:3, 0] * vertex[..., 0:1] + wv[:3, 1] * vertex[..., 1:2]
              + wv[:3, 2] * vertex[..., 2:3] + wv[:3, 3])
    center_view = v_view.mean(dim=1)
    normal = torch.linalg.cross(v_view[:, 1] - v_view[:, 0], v_view[:, 2] - v_view[:, 0], dim=-1)
    valid = (safe_norm(normal) >= EPS) & alive
    center = vertex.mean(dim=1)
    dil, valid = tight_dilation(opacity, gamma, valid)
    v_dil = center[:, None, :] + dil * (vertex - center[:, None, :])
    flat = v_dil.reshape(-1, 3)
    h = (fp[:, 0] * flat[:, 0:1] + fp[:, 1] * flat[:, 1:2] + fp[:, 2] * flat[:, 2:3]) + fp[:, 3]
    w_inv = 1.0 / (torch.abs(h[:, 3]) + EPS)
    proj = (h[:, :3] * w_inv[:, None]).reshape(-1, 3, 3)
    valid = valid & torch.all(proj[:, :, 2] > 0, dim=1)
    pix_x = (proj[:, :, 0] + 1.0) * (W * 0.5) - 0.5
    pix_y = (proj[:, :, 1] + 1.0) * (H * 0.5) - 0.5
    v_min = torch.stack([pix_x.amin(dim=1), pix_y.amin(dim=1)], -1)
    v_max = torch.stack([pix_x.amax(dim=1), pix_y.amax(dim=1)], -1)
    rect_min, rect_max, valid, radii = tile_rect(v_min.detach(), v_max.detach(), valid, W, H)
    return Prep3D(v_view, normal, center_view[:, 2], rgb, opacity, valid.detach(),
                  rect_min, rect_max, radii)


def chunk_fn_3d(leaves: dict, gamma, cam):
    """The per-chunk falloff of the 3D variant over ``leaves`` (v1, v2, v3,
    n, rgb, op, valid: per-triangle tensors, autograd leaves of the
    backward), the dense oracle's direct form."""
    W, H = cam["width"], cam["height"]
    tanx, tany = cam["tan_fovx"], cam["tan_fovy"]

    def fn(prim, entry_ok, x, y, inside):
        v1, v2, v3 = leaves["v1"][prim], leaves["v2"][prim], leaves["v3"][prim]
        n = leaves["n"][prim]
        ok = entry_ok & leaves["valid"][prim][..., None]
        rx = tanx * (2.0 * x.to(v1.dtype) - W + 1.0) / W          # (nt, 1, npix)
        ry = tany * (2.0 * y.to(v1.dtype) - H + 1.0) / H
        n0, n1, n2 = (n[..., i:i + 1] for i in range(3))          # (nt, L, 1)
        rdn = rx * n0 + ry * n1 + n2
        plane_ok = torch.abs(rdn) >= 1e-8
        rdn = torch.where(plane_ok, rdn, torch.ones_like(rdn))
        t = (v1 * n).sum(-1, keepdim=True) / rdn                  # ray depth
        inv_nn = 1.0 / torch.clamp_min((n * n).sum(-1, keepdim=True), 1e-20)

        def pv(v):
            return v[..., 0:1] - t * rx, v[..., 1:2] - t * ry, v[..., 2:3] - t

        def cross_dot_n(a, b):
            ax, ay, az = a
            bx, by, bz = b
            return (ay * bz - az * by) * n0 + (az * bx - ax * bz) * n1 + (ax * by - ay * bx) * n2

        p1, p2, p3 = pv(v1), pv(v2), pv(v3)
        a1 = cross_dot_n(p2, p3) * inv_nn
        a2 = cross_dot_n(p3, p1) * inv_nn
        a3 = 1.0 - a1 - a2
        ecc = 1.0 - 3.0 * torch.minimum(torch.minimum(a1, a2), a3)
        ecc_ok = (ecc >= 0.0) & (ecc <= ECC_MAX) & plane_ok
        logp = 2.0 * gamma * torch.log(torch.clamp_min(torch.clamp(ecc, 0.0, ECC_MAX), 1e-30))
        power = -0.5 * torch.exp(torch.clamp(logp, -87.0, 44.0))
        alpha = torch.clamp_max(leaves["op"][prim][..., None] * torch.exp(power), TL.ALPHA_MAX)
        cand = ok & ecc_ok & (alpha >= TL.ALPHA_MIN)
        return alpha, cand, ok, leaves["rgb"][prim], t, n

    return fn


def leaves_of(prep: Prep3D) -> dict:
    """The per-triangle quantities the blend reads, detached as autograd
    leaves."""
    src = dict(v1=prep.v_view[:, 0], v2=prep.v_view[:, 1], v3=prep.v_view[:, 2],
               n=prep.normal, rgb=prep.rgb, op=prep.opacity)
    out = {k: v.detach().requires_grad_(True) for k, v in src.items()}
    out["valid"] = prep.valid
    return out, src
