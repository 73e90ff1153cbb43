"""Debug visualization helpers (port of
``triangle_splatting_tpu/utils/vis_utils.py``, host numpy, the same code).

Polygons are plain (N, 2) numpy arrays, and camera meshes are written
through the port's own PLY writer. ``depth_to_image`` takes OpenCV's
``COLORMAP_JET`` where ``cv2`` imports and a numpy JET map otherwise; both
routes stay, since a GPU machine may have no OpenCV.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def plot_camera(proj_polygon: np.ndarray, tile_polygon: np.ndarray,
                cam_center: np.ndarray | None = None,
                name: str = "cam_polygon", out_dir: str = "outputs") -> str:
    """Top-down plot of a camera's ground-projected frustum vs a tile polygon
    (reference vis_utils.py:12-34). Polygons are (N, 2) xy rings.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    proj = -np.asarray(proj_polygon, np.float64)
    tile = -np.asarray(tile_polygon, np.float64)
    # close the rings
    proj = np.concatenate([proj, proj[:1]], 0)
    tile = np.concatenate([tile, tile[:1]], 0)

    fig = plt.figure()
    plt.plot(proj[:, 0], proj[:, 1], label="Camera", color="orange")
    plt.plot(tile[:, 0], tile[:, 1], label="Tile", color="blue")
    if cam_center is not None:
        c = -np.asarray(cam_center, np.float64)
        plt.scatter(c[0], c[1], color="red", label="Camera Center")
        for p in proj[:-1]:
            plt.plot([c[0], p[0]], [c[1], p[1]], color="orange",
                     linestyle="--")
    plt.gca().set_aspect("equal", adjustable="box")
    plt.legend()
    plt.title(name)
    path = Path(out_dir) / f"{name}.png"
    path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(path)
    plt.close(fig)
    return str(path)


def camera_to_mesh(w2cs: np.ndarray, fovxs: np.ndarray, fovys: np.ndarray,
                   name: str = "camera_mesh", out_dir: str = "outputs") -> str:
    """Export camera frusta as a colored PLY mesh (vis_utils.py:37-80):
    a 5-vertex pyramid per camera, right face blue, up face red.

    w2cs: (N, 4, 4) world-to-camera matrices; fovxs/fovys: (N,) radians.
    """
    from ..models.model_utils import inter_point_distance_np
    from .ply import write_ply

    w2cs = np.asarray(w2cs, np.float64)
    c2ws = np.linalg.inv(w2cs)
    centers = c2ws[:, :3, 3]
    mean_distance = float(np.mean(np.maximum(
        inter_point_distance_np(centers), 1e-10)))
    cam_size = mean_distance * 0.2

    tan_fovx = np.tan(np.asarray(fovxs) / 2)[:, None]
    tan_fovy = np.tan(np.asarray(fovys) / 2)[:, None]
    right, up, forward = c2ws[:, :3, 0], -c2ws[:, :3, 1], c2ws[:, :3, 2]

    v0 = centers
    v1 = centers + cam_size * (right * tan_fovx + up * tan_fovy + forward)
    v2 = centers + cam_size * (right * tan_fovx - up * tan_fovy + forward)
    v3 = centers + cam_size * (-right * tan_fovx - up * tan_fovy + forward)
    v4 = centers + cam_size * (-right * tan_fovx + up * tan_fovy + forward)
    vertices = np.stack([v0, v1, v2, v3, v4], axis=1)          # (N, 5, 3)
    n = len(c2ws)
    faces = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],
                      [1, 2, 3], [1, 3, 4]])                   # (6, 3)
    faces = np.tile(faces[None], (n, 1, 1)) + np.arange(n)[:, None, None] * 5
    face_colors = np.array([[0.0, 0.0, 1.0],    # right: blue
                            [0.5, 0.5, 0.5],
                            [0.5, 0.5, 0.5],
                            [1.0, 0.0, 0.0],    # up: red
                            [0.5, 0.5, 0.5],
                            [0.5, 0.5, 0.5]])
    face_colors = np.tile(face_colors[None], (n, 1, 1)).reshape(-1, 3)

    # Flat-shaded vertex colors: duplicate each face's 3 vertices so the
    # face color is exact (our PLY writer has no face-color element).
    flat_v = vertices.reshape(-1, 3)[faces.reshape(-1, 3)]      # (F, 3, 3)
    F = flat_v.shape[0]
    rec = np.zeros(F * 3, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                                 ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    xyz = flat_v.reshape(-1, 3)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rgb = np.repeat((face_colors * 255).astype(np.uint8), 3, axis=0)
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    out_faces = np.arange(F * 3, dtype=np.int32).reshape(F, 3)

    path = Path(out_dir) / f"{name}.ply"
    write_ply(path, {"vertex": rec}, faces=out_faces)
    return str(path)


def save_image_tensor(image, path: str) -> None:
    """Save a (3, H, W) float array in [0, 1] as an image file
    (vis_utils.py:83-91)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    img = np.asarray(image).transpose(1, 2, 0)
    img = np.clip(img * 255, 0, 255).astype(np.uint8)
    try:
        import cv2
        cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    except ImportError:
        from PIL import Image
        Image.fromarray(img).save(str(path))


def depth_to_image(depth: np.ndarray) -> np.ndarray:
    """Depth (H, W) -> JET-colormapped uint8 BGR image (vis_utils.py:94-104)."""
    depth = np.asarray(depth, np.float32)
    try:
        import cv2
        image = cv2.normalize(depth, None, 0, 255, cv2.NORM_MINMAX)
        return cv2.applyColorMap(image.astype(np.uint8), cv2.COLORMAP_JET)
    except ImportError:
        lo, hi = float(depth.min()), float(depth.max())
        t = (depth - lo) / max(hi - lo, 1e-9)
        r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
        return (np.stack([b, g, r], -1) * 255).astype(np.uint8)


def normal_to_image(normal: np.ndarray) -> np.ndarray:
    """Normals (H, W, 3) in [-1, 1] -> uint8 image (vis_utils.py:107-117)."""
    normal = (np.asarray(normal, np.float32) + 1) / 2
    lo, hi = float(normal.min()), float(normal.max())
    normal = (normal - lo) / max(hi - lo, 1e-9)
    return (normal * 255).astype(np.uint8)
