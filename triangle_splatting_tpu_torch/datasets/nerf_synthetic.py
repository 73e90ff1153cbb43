"""NeRF-Synthetic (Blender) dataset factory (port of
``triangle_splatting_tpu/datasets/nerf_synthetic.py``)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .colmap import ColmapDatasetFactory
from .colmap_loader import CameraInfo


class NerfSyntheticDatasetFactory(ColmapDatasetFactory):
    def _read_transforms(self, transforms_file: str) -> list[CameraInfo]:
        with open(self.root / transforms_file) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(contents["frames"]):
            c2w = np.array(frame["transform_matrix"], np.float64)
            # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            infos.append(CameraInfo(
                camera_id=idx, R=w2c[:3, :3].T, T=w2c[:3, 3], FovY=None,
                FovX=fovx, image_path=frame["file_path"] + ".png",
                image_name=Path(frame["file_path"]).stem,
                width=None, height=None))
        return infos

    def _getCameraInfos(self):
        self._logger.info("Reading transforms_train.json / transforms_test.json")
        return (self._read_transforms("transforms_train.json"),
                self._read_transforms("transforms_test.json"))
