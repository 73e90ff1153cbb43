"""COLMAP sparse-reconstruction parsers (binary and text) and the camera
records of the COLMAP / Blender loaders: the port's own copy of
``triangle_splatting_tpu/datasets/colmap_loader.py``, pure numpy.

Reads the documented COLMAP output format (cameras / images / points3D in
``.bin`` or ``.txt``): the SIMPLE_PINHOLE and PINHOLE camera models, image
extrinsics as (qvec, tvec), and the 3D point cloud. The binary readers
are plain ``struct`` loops (the JAX package first tries an optional
native reader; the port has none).
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


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


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cameras[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cameras


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            width, height = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            cameras[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return cameras


def read_images_binary(path) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, 1)     # skip the 2D points (x, y, point3D_id)
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name.decode("utf-8"))
    return images


def read_images_text(path) -> dict[int, ColmapImage]:
    images = {}
    expect_pose = True
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                continue
            if expect_pose:
                if not line:
                    continue            # blank separator between entries
                parts = line.split()
                image_id = int(parts[0])
                qvec = np.array([float(x) for x in parts[1:5]])
                tvec = np.array([float(x) for x in parts[5:8]])
                camera_id = int(parts[8])
                images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, parts[9])
                expect_pose = False
            else:
                # the 2D-points line; it may be empty (no observations) and
                # still counts, or the pose / points alternation desyncs
                expect_pose = True
    return images


def read_points3D_binary(path):
    """Returns (xyz (N, 3), rgb (N, 3) in [0, 1], error (N,))."""
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty(num)
        for i in range(num):
            vals = _read(f, "<qdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, 1)
    return xyz, rgb.astype(np.float64) / 255.0, err


def read_points3D_text(path):
    """Returns (xyz (N, 3), rgb (N, 3) in [0, 1], error (N,))."""
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz.append([float(x) for x in parts[1:4]])
            rgb.append([float(x) for x in parts[4:7]])
            err.append(float(parts[7]))
    return np.array(xyz), np.array(rgb) / 255.0, np.array(err)


def readColmapCameras(images_path, cameras_path,
                      images_folder: str = "images") -> list[CameraInfo]:
    """Join the extrinsics and intrinsics of a sparse model (``.bin`` or
    ``.txt`` by suffix) into CameraInfo records; pinhole models only."""
    images_path, cameras_path = str(images_path), str(cameras_path)
    extrinsics = (read_images_binary(images_path) if images_path.endswith(".bin")
                  else read_images_text(images_path))
    intrinsics = (read_cameras_binary(cameras_path) if cameras_path.endswith(".bin")
                  else read_cameras_text(cameras_path))

    infos = []
    for img in extrinsics.values():
        cam = intrinsics[img.camera_id]
        R = qvec2rotmat(img.qvec).T           # camera-to-world rotation
        if cam.model == "SIMPLE_PINHOLE":
            focal = cam.params[0]
            fovx = focal2fov(focal, cam.width)
            fovy = focal2fov(focal, cam.height)
        elif cam.model == "PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[1], cam.height)
        else:
            raise ValueError(
                f"Unsupported COLMAP camera model {cam.model}; undistort with "
                "'colmap image_undistorter' to PINHOLE first")
        infos.append(CameraInfo(
            camera_id=img.id, R=R, T=img.tvec, FovY=fovy, FovX=fovx,
            image_path=str(Path(images_folder) / img.name),
            image_name=Path(img.name).stem,
            width=cam.width, height=cam.height))
    return infos
