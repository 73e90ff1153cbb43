"""Opaque mesh comparison renderer (port of
``triangle_splatting_tpu/renderer/mesh_renderer.py``).

Renders a mesh, typically a GLB the mesh recipe exported, through the
perspective-correct "3D" triangle pipeline with opacity 1 and gamma 50
(the solidified falloff), front to back with early termination: a
depth-sorted z-buffer. Depth ordering is per triangle (its view depth),
not per pixel, and edge pixels keep the soft sub-pixel falloff, as in the
JAX class.

It returns ``render`` (clamped to [0, 1]), ``mask`` (1 - final_T) and
``depth`` and nothing of the contribution statistics, so it renders
without them (B1-3D's rich form); the outputs equal the JAX class's,
which computes the statistics and drops them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.projection import RasterSettings
from ..ops.rasterize import rasterize
from ..utils.camera import Camera
from ..utils.gltf import read_glb


def _load_mesh(path: str):
    """(vertices (V,3), faces (F,3), face_colors (F,3) in [0,1]) from GLB."""
    vertices, faces, vertex_colors = read_glb(path)
    if vertex_colors is None:
        face_colors = np.full((faces.shape[0], 3), 0.5, np.float32)
    else:
        face_colors = vertex_colors[faces[:, 0], :3].astype(np.float32)
    return vertices.astype(np.float32), faces.astype(np.int64), face_colors


class MeshRenderer:
    def __init__(self, cam: Camera, bg_color=(0.0, 0.0, 0.0),
                 gamma: float = 50.0, impl: str = "cuda",
                 max_pairs: Optional[int] = None):
        self.cam = cam
        self.device = cam.device
        self.bg_color = torch.as_tensor(bg_color, dtype=torch.float32, device=self.device)
        self.gamma = gamma
        self.impl = impl
        self.max_pairs = max_pairs
        self.settings = RasterSettings(
            image_width=int(cam.image_width), image_height=int(cam.image_height),
            back_culling=False, rich_info=True, rasterizer_type="3D")

    @torch.no_grad()
    def render(self, vertices=None, faces=None, faces_color=None,
               mesh_path: Optional[str] = None) -> dict:
        """``{"render": (3,H,W), "mask": (1,H,W), "depth": (H,W)}`` of the
        mesh at ``mesh_path`` or of the given arrays, composited over
        ``bg_color``."""
        if mesh_path is not None:
            vertices, faces, faces_color = _load_mesh(mesh_path)
        elif vertices is None or faces is None or faces_color is None:
            raise ValueError(
                "Either mesh_path or vertices, faces, and faces_color must be provided")
        vertices = torch.as_tensor(vertices, dtype=torch.float32, device=self.device)
        faces = torch.as_tensor(faces, dtype=torch.int64, device=self.device)
        tri = vertices[faces.reshape(-1)].reshape(-1, 3, 3)          # (F, 3, 3)
        colors = torch.as_tensor(faces_color, dtype=torch.float32,
                                 device=self.device)[:, :3].contiguous()
        opacity = torch.ones((tri.shape[0],), dtype=torch.float32, device=self.device)
        out = rasterize(tri, opacity, None, self.cam, self.settings, gamma=self.gamma,
                        background=self.bg_color, colors=colors, impl=self.impl,
                        max_pairs=self.max_pairs, need_stats=False)
        mask = (1.0 - out["final_T"])[None]                           # (1, H, W)
        image = torch.clamp(out["render"], 0.0, 1.0)
        return {"render": image, "mask": mask, "depth": out["depth"]}
