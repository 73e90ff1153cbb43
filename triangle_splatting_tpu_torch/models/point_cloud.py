"""Point-cloud value type with PLY IO.

Copy of ``triangle_splatting_tpu/models/point_cloud.py`` (host numpy only).
"""

from __future__ import annotations

import numpy as np

from ..utils.ply import read_ply, write_ply


class PointCloud:
    def __init__(self, points: np.ndarray | None = None,
                 colors: np.ndarray | None = None,
                 normals: np.ndarray | None = None):
        self.points = np.zeros((0, 3), np.float32) if points is None else np.asarray(points, np.float32)
        n = self.points.shape[0]
        self.colors = (np.zeros((n, 3), np.float32) if colors is None
                       else np.asarray(colors, np.float32))
        self.normals = (np.zeros((n, 3), np.float32) if normals is None
                        else np.asarray(normals, np.float32))

    def __len__(self):
        return self.points.shape[0]

    def __iadd__(self, other: "PointCloud"):
        self.points = np.concatenate([self.points, other.points], 0)
        self.colors = np.concatenate([self.colors, other.colors], 0)
        self.normals = np.concatenate([self.normals, other.normals], 0)
        return self

    def fetchPly(self, path) -> "PointCloud":
        data = read_ply(path)["vertex"]
        self.points = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
        names = data.dtype.names
        if "red" in names:
            scale = 255.0 if data["red"].dtype == np.uint8 else 1.0
            self.colors = np.stack([data["red"], data["green"], data["blue"]],
                                   -1).astype(np.float32) / scale
        else:
            self.colors = np.zeros_like(self.points)
        if "nx" in names:
            self.normals = np.stack([data["nx"], data["ny"], data["nz"]],
                                    -1).astype(np.float32)
        else:
            self.normals = np.zeros_like(self.points)
        return self

    def storePly(self, path) -> None:
        n = len(self)
        rec = np.zeros(n, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                                 ("nx", "f4"), ("ny", "f4"), ("nz", "f4"),
                                 ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        rec["x"], rec["y"], rec["z"] = self.points.T
        rec["nx"], rec["ny"], rec["nz"] = self.normals.T
        rgb = np.clip(self.colors * 255, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = rgb.T
        write_ply(path, {"vertex": rec})
