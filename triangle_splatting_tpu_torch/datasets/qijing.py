"""Qijing city-tile dataset (port of ``triangle_splatting_tpu/datasets/qijing.py``).

A COLMAP scene stored on a remote mirror, split by tile geometry: test
views are those whose ground-projected frustum lies strictly inside the
tile's xy bbox polygon (the reference's Qijing_dataset.py:56-86). The fetch
goes through the port's ``MirrorHandler`` (utils/file_handler.py), and the
polygon containment is plain numpy (the tile is an axis-aligned rectangle,
so containment is a per-vertex bound check). Views load onto the factory's
device as in the COLMAP factory.
"""

from __future__ import annotations

import json
import math

import numpy as np

from ..models.raw_gaussian import RawGaussian
from ..utils.file_handler import LocalHandler, MirrorHandler
from .colmap import ColmapDatasetFactory
from .colmap_loader import CameraInfo, readColmapCameras


def frustum_ground_polygon(cam_info: CameraInfo,
                           ground_z: float) -> np.ndarray:
    """Project the 4 image-corner rays onto the z = ground_z plane
    (Qijing_dataset.py:68-76). Returns (4, 2) xy vertices."""
    R, T = cam_info.R, cam_info.T
    cam_center = R @ (-T)
    nx = math.tan(cam_info.FovX / 2)
    ny = math.tan(cam_info.FovY / 2)
    rays = np.array([[nx, ny, 1], [nx, -ny, 1],
                     [-nx, -ny, 1], [-nx, ny, 1]], np.float64)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    rays_world = R @ rays.T                                  # (3, 4)
    t = (ground_z - cam_center[2]) / rays_world[2]
    intersection = cam_center[:, None] + t * rays_world
    return intersection[:2].T


def polygon_in_bbox(poly_xy: np.ndarray, bbox) -> bool:
    """Strict containment of a convex polygon in an axis-aligned bbox
    (shapely Polygon.contains equivalent for rectangular tiles)."""
    x_min, y_min, x_max, y_max = bbox
    return bool(np.all((poly_xy[:, 0] > x_min) & (poly_xy[:, 0] < x_max)
                       & (poly_xy[:, 1] > y_min) & (poly_xy[:, 1] < y_max)))


class QijingDatasetFactory(ColmapDatasetFactory):
    """Config keys: ``remote_dir`` (mirror root; optional), ``local_dir``,
    ``scene_id``, ``n_test``, ``skip_exist``."""

    def _get_file_handler(self):
        cfg = self._config
        if cfg.remote_dir:
            return MirrorHandler(
                f"{cfg.remote_dir}/{cfg.scene_id}",
                f"{cfg.local_dir}/{cfg.scene_id}",
                get_skip_exist=(cfg.skip_exist
                                if cfg.skip_exist is not None else True),
                upload_lock=False)
        return LocalHandler(f"{cfg.local_dir}/{cfg.scene_id}")

    def _getCameraInfos(self):
        fs = self._file_handler = self._get_file_handler()
        images_path = cameras_path = None
        for images, cameras in [("sparse/0/images.bin", "sparse/0/cameras.bin"),
                                ("sparse/0/images.txt", "sparse/0/cameras.txt")]:
            if fs.hasFile(images) and fs.hasFile(cameras):
                images_path = fs.getFilePath(images)
                cameras_path = fs.getFilePath(cameras)
                self._logger.info(f"Fetching extrinsics data from {images}.")
                break
        if images_path is None:
            raise FileNotFoundError("Cannot find sparse/0/{images,cameras}"
                                    ".{bin,txt} on the Qijing mirror")
        if isinstance(fs, MirrorHandler) and not fs.localExists("images"):
            fs.getFile("images")          # mirror the image directory once
        infos = sorted(readColmapCameras(images_path, cameras_path, "images"),
                       key=lambda x: x.image_name)
        return self._split_train_test_views(infos)

    def _split_train_test_views(self, cam_infos):
        """Test views = evenly-strided subset of the views whose projected
        frustum is inside the tile (Qijing_dataset.py:56-86)."""
        n_test = self._config.n_test or 10
        scene_info = self.getSceneInfo()
        bbox = scene_info["bbox_xyz"]
        ground_z = scene_info["ground_z"]

        inside_idx = [i for i, c in enumerate(cam_infos)
                      if polygon_in_bbox(
                          frustum_ground_polygon(c, ground_z), bbox)]
        if len(inside_idx) > n_test:
            stride = len(inside_idx) // n_test
            test_idx = set(inside_idx[:stride * n_test:stride])
        else:
            test_idx = set(inside_idx)
        train = [c for i, c in enumerate(cam_infos) if i not in test_idx]
        test = [c for i, c in enumerate(cam_infos) if i in test_idx]
        return train, test

    def getSceneInfo(self) -> dict | None:
        if getattr(self, "_scene_info", None) is None:
            fs = getattr(self, "_file_handler", None) or \
                self._get_file_handler()
            if fs.hasFile("tile_bbox.json"):
                with open(fs.getFilePath("tile_bbox.json")) as f:
                    self._scene_info = json.load(f)
            else:
                self._scene_info = None
        return self._scene_info

    def getGTGaussian(self) -> RawGaussian | None:
        """Per-tile ground-truth gaussian for Scaffold distillation
        (Qijing_dataset.py:104-118)."""
        if getattr(self, "_gt_gaussian", None) is None:
            fs = self._file_handler
            path = f"models_z18/{self._config.scene_id}.ply"
            if fs.hasFile(path):
                self._gt_gaussian = RawGaussian(ply_path=fs.getFilePath(path))
            else:
                self._gt_gaussian = None
        return self._gt_gaussian
