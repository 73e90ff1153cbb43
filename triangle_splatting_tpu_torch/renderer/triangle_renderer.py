"""Object-style triangle renderer (port of
``triangle_splatting_tpu/renderer/triangle_renderer.py``).

Wraps :func:`~triangle_splatting_tpu_torch.ops.rasterize.rasterize` with
the reference's constructor / render surface. ``center2d`` is an explicit
tensor argument, as in the JAX class: pass one with ``requires_grad`` to
read the screen-space gradients the densification statistics use; the
result echoes it under ``"center2D"``.

With ``rich_info=True``, ``render`` runs B1 with rich info and the
contribution stream together (``"2D_rich_stats"`` / ``"3D_rich_stats"``)
and B2 with rich info, and returns depth, normal and the contribution
statistics. Without it, it runs the plain forms and computes no
statistics, which it would only drop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.projection import RasterSettings
from ..ops.rasterize import rasterize
from ..utils.camera import Camera


class TriangleRenderer:
    """Per-camera triangle-splat renderer. ``scaling_modifier`` is accepted
    for signature parity and, as in the reference, has no effect on
    triangles; ``debug`` likewise (the kernels have no interpreted mode)."""

    def __init__(self, cam: Camera, bg_depth: float = 5000.0,
                 bg_color=(0.0, 0.0, 0.0), scaling_modifier: float = 1.0,
                 sh_degree: int = 0, gamma: float = 1.0,
                 back_culling: bool = False, rich_info: bool = False,
                 debug: bool = False, rasterizer_type: str = "3D",
                 impl: str = "cuda", max_pairs: Optional[int] = None):
        if rasterizer_type not in ("2D", "3D"):
            raise ValueError(
                f"Unknown rasterizer type: {rasterizer_type}. Use '2D' or '3D'.")
        self.cam = cam
        self.device = cam.device
        self.bg_color = torch.as_tensor(bg_color, dtype=torch.float32, device=self.device)
        self.bg_depth = bg_depth
        self.sh_degree = int(sh_degree)
        self.gamma = gamma
        self.impl = impl
        self.max_pairs = max_pairs
        self.settings = RasterSettings(
            image_width=int(cam.image_width), image_height=int(cam.image_height),
            back_culling=bool(back_culling), rich_info=bool(rich_info),
            rasterizer_type=rasterizer_type)

    def _t(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def render(self, vertex, shs, color, opacity, center2d=None) -> dict:
        """Render; differentiable w.r.t. every tensor argument.

        Returns ``render`` / ``radii`` / ``center2D``, plus ``depth`` /
        ``normal`` / ``contrib_sum`` / ``contrib_max`` under ``rich_info``,
        and the diagnostics ``final_T``, ``n_contrib``, ``visible_mask``,
        ``overflow`` and ``num_pairs``."""
        settings = self.settings
        vertex = self._t(vertex)
        if shs is not None:
            shs = self._t(shs)
            max_deg = int(round(shs.shape[1] ** 0.5)) - 1
            if settings.max_sh_degree != max_deg:
                settings = dataclasses.replace(settings, max_sh_degree=max_deg)
        if center2d is None:
            center2d = torch.zeros((vertex.shape[0], 2), dtype=torch.float32,
                                   device=self.device)
        out = rasterize(
            vertex, self._t(opacity), shs, self.cam, settings, gamma=self.gamma,
            background=self.bg_color, bg_depth=self.bg_depth,
            active_sh_degree=self.sh_degree, center2d_offset=center2d,
            colors=None if color is None else self._t(color), impl=self.impl,
            max_pairs=self.max_pairs, need_stats=settings.rich_info)
        out["center2D"] = center2d
        if not settings.rich_info:
            out = {k: v for k, v in out.items()
                   if k not in ("depth", "normal", "contrib_sum", "contrib_max")}
        return out
