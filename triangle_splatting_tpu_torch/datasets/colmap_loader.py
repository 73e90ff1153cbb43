"""Camera records of the COLMAP / Blender loaders (the ``CameraInfo`` part
of ``triangle_splatting_tpu/datasets/colmap_loader.py``; the COLMAP
sparse-model parsers are not ported yet)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class CameraInfo(NamedTuple):
    camera_id: int
    R: np.ndarray            # camera-to-world rotation
    T: np.ndarray            # world-to-view translation
    FovY: float | None
    FovX: float
    image_path: str
    image_name: str
    width: int | None
    height: int | None


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))
