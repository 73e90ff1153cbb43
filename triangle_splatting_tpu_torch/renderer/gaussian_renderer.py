"""Object-style Gaussian renderer (port of
``triangle_splatting_tpu/renderer/gaussian_renderer.py``).

Wraps :func:`~triangle_splatting_tpu_torch.ops.rasterize.rasterize_gaussian`
with the reference's constructor / render surface, plus its two queries:

- ``get_radii``: the no-grad screen radii (3 sigma) used to prefilter;
- ``in_frustum``: the view-space ``z > 0.2`` test.

With ``rich_info=True``, ``render`` runs B1-GS with rich info and the
contribution stream together, and B2-GS with rich info, and returns the
depth and the contribution statistics. Without it, it runs the plain forms
and computes no statistics, which it would only drop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.gaussian import preprocess_gaussian
from ..ops.projection import RasterSettings
from ..ops.rasterize import rasterize_gaussian
from ..utils.camera import Camera


class GaussianRenderer:
    def __init__(self, cam: Camera, bg_color=(0.0, 0.0, 0.0),
                 scaling_modifier: float = 1.0, sh_degree: int = 0,
                 gamma: float = 1.0, rich_info: bool = False, impl: str = "cuda",
                 max_pairs: Optional[int] = None):
        self.cam = cam
        self.device = cam.device
        self.bg_color = torch.as_tensor(bg_color, dtype=torch.float32, device=self.device)
        self.scaling_modifier = float(scaling_modifier)
        self.sh_degree = int(sh_degree)
        self.gamma = gamma
        self.impl = impl
        self.max_pairs = max_pairs
        self.settings = RasterSettings(
            image_width=int(cam.image_width), image_height=int(cam.image_height),
            rich_info=bool(rich_info), rasterizer_type="GS")

    def _t(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def render(self, xyz, shs, color, opacity, scaling, rot, means2d=None) -> dict:
        """Render; differentiable w.r.t. every tensor argument. ``means2d``
        (zeros (P, 2) by default) is the densification-statistics hook whose
        gradient is the screen-space center gradient; it is echoed back
        under ``"means2D"``. Without rich info the depth, normal and the
        contribution statistics are dropped from the result."""
        settings = self.settings
        xyz = self._t(xyz)
        if shs is not None:
            shs = self._t(shs)
            max_deg = int(round(shs.shape[1] ** 0.5)) - 1
            if settings.max_sh_degree != max_deg:
                settings = dataclasses.replace(settings, max_sh_degree=max_deg)
        if means2d is None:
            means2d = torch.zeros((xyz.shape[0], 2), dtype=torch.float32, device=self.device)
        out = rasterize_gaussian(
            xyz, self._t(scaling), self._t(rot), self._t(opacity), shs, self.cam, settings,
            gamma=self.gamma, background=self.bg_color, active_sh_degree=self.sh_degree,
            colors=None if color is None else self._t(color), mean2d_offset=means2d,
            scale_modifier=self.scaling_modifier, impl=self.impl, max_pairs=self.max_pairs,
            need_stats=settings.rich_info)
        out["means2D"] = means2d
        if not settings.rich_info:
            out = {k: v for k, v in out.items()
                   if k not in ("depth", "normal", "contrib_sum", "contrib_max")}
        return out

    @torch.no_grad()
    def get_radii(self, means3D, scales, rotations) -> torch.Tensor:
        """Screen-space radii in pixels (3 sigma), 0 for culled Gaussians."""
        means3D = self._t(means3D)
        prep = preprocess_gaussian(
            means3D, self._t(scales), self._t(rotations),
            torch.zeros((means3D.shape[0], 3), dtype=torch.float32, device=self.device),
            self.cam.world_view, self.cam.full_proj, self.cam.tan_fovx, self.cam.tan_fovy,
            self.settings, scale_modifier=self.scaling_modifier)
        return prep.radii

    @torch.no_grad()
    def in_frustum(self, positions) -> torch.Tensor:
        """Visibility per point: view-space ``z > 0.2``."""
        p = self._t(positions)
        wv = self.cam.world_view
        z = (p[:, 0] * wv[2, 0] + p[:, 1] * wv[2, 1] + p[:, 2] * wv[2, 2]) + wv[2, 3]
        return z > 0.2
