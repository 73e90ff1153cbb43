"""Synthetic scenes and dataset builder shared by tests, chip_smoke.py and
benchmarks (port of ``triangle_splatting_tpu/utils/testing.py``).

Scenes are numpy arrays made from a seed, identical to the JAX package's
for the same arguments, so both packages can be fed the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import Camera


def make_camera(width: int = 64, height: int = 64, fov_deg: float = 60.0,
                with_image: bool = False, device="cuda") -> Camera:
    """Identity-pose camera at the origin looking down +z."""
    R = np.eye(3, dtype=np.float32)
    T = np.zeros(3, dtype=np.float32)
    fov = np.deg2rad(fov_deg)
    gt = np.zeros((3, height, width), np.float32) if with_image else None
    return Camera.create(R=R, T=T, fovx=fov, fovy=fov, image_width=width,
                         image_height=height, gt_image=gt, device=device)


def make_random_scene(n: int, seed: int = 0, z_range=(3.0, 6.0),
                      xy_extent: float = 1.5, size_range=(0.05, 0.25),
                      opacity_range=(0.3, 0.95)):
    """Random triangles in front of the identity camera.

    Returns dict of numpy arrays: vertex (N,3,3), opacity (N,), rgb (N,3),
    sh_dc (N,1,3).
    """
    rng = np.random.default_rng(seed)
    centers = np.stack([
        rng.uniform(-xy_extent, xy_extent, n),
        rng.uniform(-xy_extent, xy_extent, n),
        rng.uniform(*z_range, n),
    ], axis=-1).astype(np.float32)

    sizes = rng.uniform(*size_range, n).astype(np.float32)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    u = np.cross(np.broadcast_to(up, (n, 3)), normals)
    bad = np.linalg.norm(u, axis=1) < 1e-6
    u[bad] = np.array([1.0, 0.0, 0.0], np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(normals, u)
    v /= np.linalg.norm(v, axis=1, keepdims=True)

    s = sizes[:, None]
    v1 = centers + u * s
    v2 = centers + (-0.5 * u + (np.sqrt(3) / 2) * v) * s
    v3 = centers + (-0.5 * u - (np.sqrt(3) / 2) * v) * s
    vertex = np.stack([v1, v2, v3], axis=1).astype(np.float32)

    opacity = rng.uniform(*opacity_range, n).astype(np.float32)
    rgb = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    return dict(vertex=vertex, opacity=opacity, rgb=rgb,
                sh_dc=((rgb - 0.5) / 0.28209479177387814)[:, None, :].astype(np.float32))


def pose_on_circle(theta: float, radius: float = 4.5, height: float = 0.0):
    """Camera on a circle looking at the origin, as a Blender/OpenGL c2w
    matrix."""
    eye = np.array([radius * np.sin(theta), height, radius * np.cos(theta)])
    forward = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward          # OpenGL: -z is the viewing direction
    c2w[:3, 3] = eye
    return c2w


def _camera_from_c2w_gl(c2w_gl, fovx, res, device) -> Camera:
    c2w = c2w_gl.copy()
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    return Camera.create(R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fovx, fovy=fovx,
                         image_width=res, image_height=res, device=device)


def build_synthetic_nerf_dataset(root, *, res: int = 48, n_tri: int = 120,
                                 n_train: int = 6, n_test: int = 2,
                                 impl: str = "cuda", seed: int = 7,
                                 size_range=(0.15, 0.3),
                                 pcd_noise: float = 0.05,
                                 pcd_points: int | None = None,
                                 device="cuda"):
    """Write a Blender/NeRF-Synthetic-format dataset of a known random
    triangle scene to ``root`` (transforms_{train,test}.json + PNGs +
    point_cloud.ply), rendering the GT images through this package's own
    ``rasterize`` on ``device``. The scene, poses and point cloud are the
    JAX builder's for the same arguments (its "soup" scene). The pair
    budget is sized up front from the demanded pair count and grown until
    no frame drops pairs. Returns ``root``."""
    import json
    import math
    from dataclasses import replace
    from pathlib import Path

    from PIL import Image

    from ..device import resolve_device
    from ..models.point_cloud import PointCloud
    from ..ops.projection import RasterSettings, preprocess_2d
    from ..ops.rasterize import rasterize
    from ..trainers.adc_utils import adapt_pair_budget

    dev = resolve_device(device)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    scene = make_random_scene(n_tri, seed=seed, z_range=(-0.8, 0.8),
                              xy_extent=0.8, size_range=size_range,
                              opacity_range=(0.7, 0.95))
    vertex = torch.as_tensor(scene["vertex"]).to(dev)
    opacity = torch.as_tensor(scene["opacity"]).to(dev)
    rgb = torch.as_tensor(scene["rgb"]).to(dev)
    fovx = math.radians(50)
    settings = RasterSettings(image_width=res, image_height=res, rich_info=False)

    with torch.no_grad():
        if impl == "cuda":
            probe = _camera_from_c2w_gl(pose_on_circle(0.0), fovx, res, dev)
            prep = preprocess_2d(vertex, torch.zeros((n_tri, 2), device=dev), rgb,
                                 probe.world_view, probe.full_proj,
                                 probe.tan_fovx, probe.tan_fovy, settings,
                                 opacity=opacity,
                                 gamma=torch.ones((), device=dev))
            demanded = int(prep.tiles_touched.to(torch.int64).sum())
            ppt = adapt_pair_budget(settings.pairs_per_triangle,
                                    int(demanded * 1.2), n_tri, False,
                                    shrink_if_below=1.0)
            if ppt > settings.pairs_per_triangle:
                settings = replace(settings, pairs_per_triangle=ppt)

        def render(c2w_gl):
            nonlocal settings
            cam = _camera_from_c2w_gl(c2w_gl, fovx, res, dev)
            while True:
                out = rasterize(vertex, opacity, None, cam, settings, gamma=1.0,
                                background=torch.ones(3, device=dev),
                                bg_depth=20.0, colors=rgb, impl=impl)
                # ground truth must never silently drop pairs
                if not bool(out["overflow"]):
                    return out["render"].clamp(0, 1).cpu().numpy()
                settings = replace(settings, pairs_per_triangle=adapt_pair_budget(
                    settings.pairs_per_triangle, None, n_tri, True))

        for split, count in [("train", n_train), ("test", n_test)]:
            frames = []
            for i in range(count):
                theta = 2 * math.pi * (i + (0.5 if split == "test" else 0)) / count
                c2w = pose_on_circle(theta)
                img = render(c2w)
                arr = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
                rgba = np.concatenate(
                    [arr, np.full((res, res, 1), 255, np.uint8)], -1)
                (root / split).mkdir(exist_ok=True)
                Image.fromarray(rgba).save(root / split / f"r_{i}.png")
                frames.append({"file_path": f"./{split}/r_{i}",
                               "transform_matrix": c2w.tolist()})
            with open(root / f"transforms_{split}.json", "w") as f:
                json.dump({"camera_angle_x": fovx, "frames": frames}, f)

    np.savez(root / "gt_scene.npz", vertex=scene["vertex"],
             opacity=scene["opacity"], rgb=scene["rgb"])
    centers = scene["vertex"].mean(1)
    colors = scene["rgb"]
    if pcd_points is not None:
        idx = rng.integers(0, n_tri, pcd_points)
        centers, colors = centers[idx], colors[idx]
    centers = centers + rng.normal(0, pcd_noise, centers.shape)
    PointCloud(centers.astype(np.float32), colors).storePly(
        root / "point_cloud.ply")
    return root
