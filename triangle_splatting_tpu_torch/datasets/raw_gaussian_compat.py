"""Load a 3DGS Gaussian PLY as an initial point cloud (port of
``triangle_splatting_tpu/datasets/raw_gaussian_compat.py``): positions,
colours ``clip(SH2RGB(f_dc), 0, 1)`` and the file's normals."""

from __future__ import annotations

import numpy as np

from ..models.point_cloud import PointCloud
from ..models.raw_gaussian import RawGaussian
from ..ops.sh import SH2RGB


def load_gaussian_as_pointcloud(path) -> PointCloud:
    g = RawGaussian(ply_path=str(path))
    if len(g) == 0:
        raise ValueError("empty gaussian ply")
    return PointCloud(points=g.xyz, colors=np.clip(SH2RGB(g.shs[:, :3]), 0, 1),
                      normals=g.normals)
