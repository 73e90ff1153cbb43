"""COLMAP-style dataset factory (port of
``triangle_splatting_tpu/datasets/colmap.py``).

``ColmapDataset`` maps an index to a port ``Camera`` with its decoded
ground-truth image on the factory's device. ``ColmapDatasetFactory`` reads
the sparse model under ``sparse/0`` (``.bin`` or ``.txt``) and holds out
every ``hold_interval``-th view (default 8) as the test split; subclasses
(NeRF-Synthetic, MatrixCity) supply their own camera records. Point
clouds load from COLMAP ``points3D.bin``, a 3DGS Gaussian PLY or a plain
PLY.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..models.point_cloud import PointCloud
from ..utils.camera import Camera, world_to_view_matrix
from ..utils.config import Config
from ..utils.logger import Logger
from .base import BaseDatasetFactory
from .colmap_loader import CameraInfo, read_points3D_binary, readColmapCameras


def solve_target_res(target_res, orig_w: int, orig_h: int) -> tuple[int, int]:
    """None -> cap long edge at 1600px; int -> divisor; [w, h] -> exact."""
    w, h = orig_w, orig_h
    if target_res is None:
        if w >= h and w > 1600:
            w, h = 1600, 1600 * orig_h // orig_w
        elif w < h and h > 1600:
            w, h = 1600 * orig_w // orig_h, 1600
    elif isinstance(target_res, int):
        d = max(target_res, 1)
        w, h = orig_w // d, orig_h // d
    elif isinstance(target_res, (list, tuple)):
        w, h = target_res
    else:
        raise ValueError("target_res must be None, int divisor, or [w, h]")
    return int(w), int(h)


class ColmapDataset:
    """Map-style dataset: index -> Camera with decoded GT image."""

    def __init__(self, root: Path, cam_infos: list[CameraInfo],
                 target_res=None, background: str | None = None,
                 use_alpha_mask: bool = True, device="cuda"):
        self.root = Path(root)
        self.cam_infos = cam_infos
        self.target_res = target_res
        self.use_alpha_mask = use_alpha_mask
        self.device = device
        if background is None:
            self.bg_color = None
        elif background == "white":
            self.bg_color = np.ones(3, np.float32)
        elif background == "black":
            self.bg_color = np.zeros(3, np.float32)
        else:
            raise ValueError("dataset background must be 'white', 'black' or None")

    def __len__(self):
        return len(self.cam_infos)

    def _get_image(self, image_path: str) -> np.ndarray:
        from PIL import Image
        with Image.open(self.root / image_path) as image:
            w, h = solve_target_res(self.target_res, image.width, image.height)
            image = image.resize((w, h), Image.Resampling.BILINEAR)
            arr = np.asarray(image, np.float32).transpose(2, 0, 1) / 255.0
        return arr

    def __getitem__(self, idx: int) -> Camera:
        info = self.cam_infos[idx]
        img = self._get_image(info.image_path)
        if img.shape[0] == 4:
            alpha = img[3:4]
            img = img[:3]
            if self.bg_color is not None:
                img = img * alpha + self.bg_color.reshape(3, 1, 1) * (1 - alpha)
        else:
            alpha = None
        return Camera.create(
            R=info.R, T=info.T, fovx=info.FovX, fovy=info.FovY,
            gt_image=img, gt_alpha_mask=alpha if self.use_alpha_mask else None,
            image_name=info.image_name, camera_id=info.camera_id, uid=idx,
            device=self.device)


def camera_extent(cam_infos: list[CameraInfo]) -> float:
    """1.1 x max distance from the mean camera center."""
    centers = []
    for c in cam_infos:
        w2v = world_to_view_matrix(c.R, c.T)
        centers.append(np.linalg.inv(w2v)[:3, 3])
    centers = np.stack(centers)
    return float(np.linalg.norm(centers - centers.mean(0, keepdims=True),
                                axis=1).max() * 1.1)


class ColmapDatasetFactory(BaseDatasetFactory):
    def __init__(self, config: Config = None, logger: Logger = None,
                 device="cuda"):
        super().__init__(config, logger, device)
        cfg = self._config
        root = Path(cfg.local_dir) / cfg.scene_id if cfg.scene_id else Path(cfg.local_dir)
        self.root = root

        train_infos, test_infos = self._getCameraInfos()
        if not cfg.hold_test_set:
            train_infos = train_infos + test_infos
            self._logger.info("hold_test_set not set; merged test into train")
        self._logger.info(f"Train set: {len(train_infos)}, test set: {len(test_infos)}")

        self.cameras_extent = camera_extent(train_infos)
        self._logger.info(f"Camera extent: {self.cameras_extent:.2f}")

        self._train_dataset = ColmapDataset(root, train_infos, cfg.train_target_res,
                                            cfg.background, bool(cfg.use_alpha_mask),
                                            device)
        self._test_dataset = ColmapDataset(root, test_infos, cfg.test_target_res,
                                           cfg.background, bool(cfg.use_alpha_mask),
                                           device)

    def _getCameraInfos(self):
        root = self.root
        for images, cameras in [("sparse/0/images.bin", "sparse/0/cameras.bin"),
                                ("sparse/0/images.txt", "sparse/0/cameras.txt")]:
            if (root / images).exists() and (root / cameras).exists():
                infos = readColmapCameras(root / images, root / cameras, "images")
                break
        else:
            raise FileNotFoundError(f"No COLMAP sparse model under {root}/sparse/0")
        infos = sorted(infos, key=lambda x: x.image_name)
        hold = self._config.hold_interval or 8
        train = [c for i, c in enumerate(infos) if i % hold != 0]
        test = [c for i, c in enumerate(infos) if i % hold == 0]
        return train, test

    def getPointCloud(self) -> PointCloud:
        pcd_path = self._config.pcd_path
        if pcd_path is None:
            return PointCloud()
        path = self.root / pcd_path
        self._logger.info(f"Fetching point cloud from {path}")
        if str(path).endswith(".bin"):
            xyz, rgb, _ = read_points3D_binary(path)
            return PointCloud(xyz, rgb)
        if str(path).endswith(".ply"):
            # a 3DGS Gaussian PLY first (colours from its DC band), then a
            # plain point cloud, as the JAX loader does
            try:
                from .raw_gaussian_compat import load_gaussian_as_pointcloud
                return load_gaussian_as_pointcloud(path)
            except Exception:
                return PointCloud().fetchPly(path)
        raise ValueError(f"Unsupported point cloud format: {path}")
