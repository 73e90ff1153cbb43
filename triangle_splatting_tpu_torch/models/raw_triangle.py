"""Numpy value type for triangle-splat sets + PLY/GLB IO.

The port's own copy of ``triangle_splatting_tpu/models/raw_triangle.py``
(over the port's ``utils/ply.py``, ``utils/gltf.py`` and ``ops/sh.py``),
writing the same bytes as the JAX package for the same arrays.
Byte-compatible with the reference's serialization (models/raw_triangle.py):
- PLY vertex schema ``x1..z3, opacity, f_dc_0..2, f_rest_*`` (:137-181),
- GLB export with one face per triangle, per-vertex RGBA from SH DC +
  sigmoid opacity, back faces duplicated unless back-culling (:183-207),
- GLB import inverting that (:209-223).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.sh import SH2RGB, RGB2SH
from ..utils.gltf import read_glb, write_glb
from ..utils.ply import read_ply, write_ply


class RawTriangle:
    def __init__(self, vertex: np.ndarray | None = None,
                 opacity: np.ndarray | None = None,
                 shs: np.ndarray | None = None,
                 ply_path: str | None = None, glb_path: str | None = None):
        self.vertex = np.zeros((0, 3, 3), np.float32) if vertex is None else np.asarray(vertex, np.float32)
        n = self.vertex.shape[0]
        if opacity is None or n == 0:
            self.opacity = np.zeros((n, 1), np.float32)
        else:
            self.opacity = np.asarray(opacity, np.float32).reshape(n, -1)
        if shs is None or n == 0:
            self.shs = np.zeros((n, 3), np.float32)
        else:
            self.shs = np.asarray(shs, np.float32).reshape(n, -1)
        if ply_path is not None:
            self.loadPLY(ply_path)
        if glb_path is not None:
            self.loadGLB(glb_path)

    def __len__(self):
        return self.vertex.shape[0]

    def __iadd__(self, other: "RawTriangle"):
        self.vertex = np.concatenate([self.vertex, other.vertex], 0)
        self.opacity = np.concatenate([self.opacity, other.opacity], 0)
        self.shs = np.concatenate([self.shs, other.shs], 0)
        return self

    def __isub__(self, other: "RawTriangle"):
        """Remove triangles whose centroid matches one in ``other``
        (KD-tree match, reference :79-93)."""
        from scipy.spatial import cKDTree
        if len(other) == 0 or len(self) == 0:
            return self
        centers = self.vertex.mean(axis=1)
        tree = cKDTree(other.vertex.mean(axis=1))
        dist, _ = tree.query(centers, k=1)
        keep = dist > 1e-8
        self.vertex = self.vertex[keep]
        self.opacity = self.opacity[keep]
        self.shs = self.shs[keep]
        return self

    # -- PLY --------------------------------------------------------------
    def savePLY(self, path, save_empty: bool = False, save_extra: bool = False):
        if not save_empty and len(self) == 0:
            return
        names = ["x1", "y1", "z1", "x2", "y2", "z2", "x3", "y3", "z3",
                 "opacity", "f_dc_0", "f_dc_1", "f_dc_2"]
        f_dc, f_rest = self.shs[:, :3], self.shs[:, 3:]
        if save_extra:
            names += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
            attrs = np.concatenate([self.vertex.reshape(-1, 9), self.opacity,
                                    f_dc, f_rest], axis=1)
        else:
            attrs = np.concatenate([self.vertex.reshape(-1, 9), self.opacity,
                                    f_dc], axis=1)
        rec = np.zeros(len(self), dtype=[(nm, "f4") for nm in names])
        for i, nm in enumerate(names):
            rec[nm] = attrs[:, i]
        write_ply(path, {"vertex": rec})

    def loadPLY(self, path):
        data = read_ply(path)["vertex"]
        vp = ["x1", "y1", "z1", "x2", "y2", "z2", "x3", "y3", "z3"]
        self.vertex = np.stack([data[p] for p in vp], 1).astype(np.float32).reshape(-1, 3, 3)
        self.opacity = np.asarray(data["opacity"], np.float32)[:, None]
        f_dc = np.stack([data[f"f_dc_{i}"] for i in range(3)], 1)
        rest_names = sorted((nm for nm in data.dtype.names
                             if nm.startswith("f_rest_")),
                            key=lambda x: int(x.split("_")[-1]))
        if rest_names:
            f_rest = np.stack([data[nm] for nm in rest_names], 1)
            self.shs = np.concatenate([f_dc, f_rest], 1).astype(np.float32)
        else:
            self.shs = f_dc.astype(np.float32)
        self.ply_path = str(path)
        return self

    # -- GLB --------------------------------------------------------------
    def saveGLB(self, path, save_empty: bool = False, save_back: bool = True):
        """Opaque mesh export: one face per splat, per-face RGBA from the SH
        DC band and sigmoid opacity (reference :183-207)."""
        if not save_empty and len(self) == 0:
            return
        color = np.clip(SH2RGB(self.shs[:, :3]), 0, 1)
        alpha = 1.0 / (1.0 + np.exp(-self.opacity[:, :1]))
        rgba = np.concatenate([color, alpha], axis=1)          # (F, 4)
        faces = np.arange(len(self) * 3).reshape(-1, 3)
        vertices = self.vertex.reshape(-1, 3)
        if save_back:
            # back faces reverse the winding but reuse the front vertices
            # (and so the same per-vertex colors)
            faces = np.concatenate([faces, faces[:, ::-1]], axis=0)
        vertex_colors = np.repeat(rgba, 3, axis=0)
        write_glb(path, vertices, faces, vertex_colors)

    def loadGLB(self, path):
        vertices, faces, colors = read_glb(path)
        # Back faces (if present) mirror the front set; keep the first half.
        n_front = vertices.shape[0] // 3
        faces = faces[:n_front]
        tri = vertices[faces.reshape(-1)].reshape(-1, 3, 3)
        if colors is None:
            rgba = np.ones((n_front, 4), np.float32) * 0.5
        else:
            rgba = colors[faces[:, 0]]
        eps = 1e-5
        self.vertex = tri.astype(np.float32)
        self.opacity = -np.log(1.0 / np.clip(rgba[:, 3:4], eps, 1 - eps) - 1.0)
        self.shs = RGB2SH(rgba[:, :3]).astype(np.float32)
        self.glb_path = str(path)
        return self
