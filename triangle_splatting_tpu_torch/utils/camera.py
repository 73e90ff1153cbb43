"""Camera model as a plain dataclass of tensors.

Port of ``triangle_splatting_tpu/utils/camera.py``. Conventions are the
same:

- ``R`` is the camera-to-world rotation (3x3), ``T`` the world-to-view
  translation, so the world-to-view matrix is ``[[R^T, T], [0, 1]]``;
- the projection maps view space to NDC with z in [0, 1], znear=1,
  zfar=1000;
- ``full_proj = proj @ world_view`` (column vectors);
- ``camera_center = -R @ T``.

The matrices are built on the host in numpy exactly as the JAX package
builds them and then moved to the camera's device. ``tan_fovx`` /
``tan_fovy`` are 0-dim float32 tensors so that every product with them is
float32 arithmetic, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


def world_to_view_matrix(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """4x4 world->view matrix from c2w rotation R and translation T."""
    M = np.zeros((4, 4), dtype=np.float32)
    M[:3, :3] = np.asarray(R, np.float32).T
    M[:3, 3] = np.asarray(T, np.float32)
    M[3, 3] = 1.0
    return M


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style projection with z mapped to [0, 1]."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclass(frozen=True)
class Camera:
    """One view: pose + intrinsics + (optionally) ground-truth image.

    ``gt_image`` is (3, H, W) float32 in [0, 1]; ``alpha_mask`` is
    (1, H, W) or None. All tensors live on one device.
    """

    world_view: torch.Tensor          # (4, 4) world -> view
    full_proj: torch.Tensor           # (4, 4) world -> clip
    camera_center: torch.Tensor       # (3,)
    tan_fovx: torch.Tensor            # () f32
    tan_fovy: torch.Tensor            # () f32
    uid: int = 0
    gt_image: Optional[torch.Tensor] = None
    alpha_mask: Optional[torch.Tensor] = None
    image_width: int = 0
    image_height: int = 0
    image_name: str = ""
    camera_id: int = 0

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    @staticmethod
    def create(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float | None = None,
               image_width: int | None = None, image_height: int | None = None,
               gt_image: np.ndarray | None = None, gt_alpha_mask: np.ndarray | None = None,
               image_name: str = "", camera_id: int = 0, uid: int = 0,
               znear: float = 1.0, zfar: float = 1000.0,
               device: str | torch.device = "cuda") -> "Camera":
        dev = resolve_device(device)
        if gt_image is None and (image_width is None or image_height is None):
            raise ValueError("Either gt_image or image_width/image_height must be provided")
        if gt_image is not None:
            gt_image = np.clip(np.asarray(gt_image, np.float32), 0.0, 1.0)
            if image_width is None:
                image_width = gt_image.shape[2]
            if image_height is None:
                image_height = gt_image.shape[1]
        if fovy is None:
            fovy = math.atan(math.tan(fovx / 2) * (image_height / image_width)) * 2

        w2v = world_to_view_matrix(R, T)
        proj = projection_matrix(znear, zfar, fovx, fovy)
        full = (proj @ w2v).astype(np.float32)
        cam_center = (-np.asarray(R, np.float64) @ np.asarray(T, np.float64)).astype(np.float32)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32)).to(dev)

        return Camera(
            world_view=t(w2v), full_proj=t(full), camera_center=t(cam_center),
            tan_fovx=t(np.float32(math.tan(fovx / 2))),
            tan_fovy=t(np.float32(math.tan(fovy / 2))),
            uid=int(uid),
            gt_image=None if gt_image is None else t(gt_image),
            alpha_mask=None if gt_alpha_mask is None else t(gt_alpha_mask),
            image_width=int(image_width), image_height=int(image_height),
            image_name=image_name, camera_id=int(camera_id))
