"""Spherical-harmonics color evaluation (degrees 0..3) in PyTorch.

Port of ``triangle_splatting_tpu/ops/sh.py``: real SH basis up to degree 3,
+0.5 shift, clamp at zero. ``active_degree`` may be a Python int or a 0-dim
tensor; bands above it are masked to zero so a degree bump changes no
shapes. Gradients come from autograd.
"""

from __future__ import annotations

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def RGB2SH(rgb):
    return (rgb - 0.5) / SH_C0


def SH2RGB(sh):
    return sh * SH_C0 + 0.5


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(dirs: torch.Tensor, max_degree: int) -> torch.Tensor:
    """(..., 3) unit vectors -> (..., (max_degree+1)**2) basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if max_degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if max_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if max_degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def band_mask(active_degree, max_degree: int,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """(K,) 0/1 float mask keeping coefficients with l <= active_degree."""
    k = num_sh_coeffs(max_degree)
    coeff_degree = torch.as_tensor(
        np.floor(np.sqrt(np.arange(k))).astype(np.int32)).to(device)
    if isinstance(active_degree, torch.Tensor):
        active_degree = active_degree.to(device)
    return (coeff_degree <= active_degree).to(torch.float32)


def eval_sh(sh: torch.Tensor, positions: torch.Tensor, campos: torch.Tensor,
            active_degree, max_degree: int) -> torch.Tensor:
    """(P, K, 3) coefficients at (P, 3) positions seen from (3,) campos ->
    (P, 3) colors, clamped at zero after the +0.5 shift."""
    d = positions - campos[None, :]
    # eps inside the sqrt: zero directions (dead slots parked at the camera
    # center) keep a finite gradient
    n = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-24)
    d = d / n
    basis = sh_basis(d, max_degree)                        # (P, K)
    basis = basis * band_mask(active_degree, max_degree, sh.device)[None, :]
    rgb = (basis[:, :, None] * sh).sum(dim=1) + 0.5
    return torch.clamp_min(rgb, 0.0)
