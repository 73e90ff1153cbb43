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


def make_gs_scene(n: int = 120, seed: int = 0, z_range=(3.0, 6.0),
                  xy_extent: float = 1.5, scale_range=(0.03, 0.15),
                  opacity_range=(0.3, 0.95)):
    """Random Gaussians in front of the identity camera (the scene of the JAX
    package's ``tests/test_gaussian.py``, sized by arguments; the defaults
    give its scene). Returns dict of numpy arrays: xyz (N, 3), scale (N, 3),
    rot (N, 4) unit wxyz quaternions, opacity (N,), rgb (N, 3)."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-xy_extent, xy_extent, n),
                    rng.uniform(-xy_extent, xy_extent, n),
                    rng.uniform(*z_range, n)], -1).astype(np.float32)
    scale = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(*opacity_range, n).astype(np.float32)
    rgb = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    return dict(xyz=xyz, scale=scale, rot=q, opacity=opac, rgb=rgb)


def make_gs_stack_scene(n: int, kill_at: int, opacity: float = 0.03, seed: int = 7):
    """A stack of ``n`` Gaussians over the image center of the identity
    camera, each of opacity ``opacity`` except the one at depth rank
    ``kill_at`` (0.97): T decays slowly until that entry would push it
    below 1e-4 at the center pixels, which makes it their kill entry (the
    JAX package's ``TestGSEarlyTermination`` scene at n=360, kill_at=250,
    opacity 0.03). Same dict as :func:`make_gs_scene`."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n),
                    np.linspace(3.0, 6.0, n)], -1).astype(np.float32)
    opac = np.full(n, opacity, np.float32)
    opac[kill_at] = 0.97
    return dict(xyz=xyz, scale=np.full((n, 3), 0.4, np.float32),
                rot=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)), opacity=opac,
                rgb=rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32))


def make_surface_scene(n_tri: int, seed: int = 0, opacity: float = 0.95):
    """A closed opaque SURFACE as ground truth: a bumpy UV-sphere
    triangulation, the realistic target of mesh training (the random soup
    of semi-transparent triangles has no opaque-surface representation).
    Same dict layout as ``make_random_scene``; the face count is the
    closest UV grid <= n_tri (2 * nu * nv faces). The grid is
    deterministic; ``seed`` is kept for the JAX twin's signature."""
    nv = max(3, int(np.sqrt(n_tri / 4)))
    nu = max(4, n_tri // (2 * nv))
    th = np.linspace(0.0, np.pi, nv + 1)
    ph = np.linspace(0.0, 2 * np.pi, nu + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")           # (nv+1, nu+1)
    # low-frequency radial bumps -> non-trivial geometry
    r = (0.85 + 0.12 * np.sin(3 * T) * np.cos(2 * P)
         + 0.08 * np.cos(5 * P + 1.0) * np.sin(2 * T))
    V = np.stack([r * np.sin(T) * np.cos(P), r * np.cos(T),
                  r * np.sin(T) * np.sin(P)], axis=-1)  # (nv+1, nu+1, 3)
    a, b = V[:-1, :-1], V[:-1, 1:]
    c, d = V[1:, 1:], V[1:, :-1]
    # faces (a, b, c) and (a, c, d) of each quad, in the JAX twin's order
    vertex = np.stack([np.stack([a, b, c], -2), np.stack([a, c, d], -2)], 2)
    vertex = vertex.reshape(-1, 3, 3).astype(np.float32)  # (F, 3, 3)
    n = vertex.shape[0]
    # smooth per-face color from the face centroid direction
    cen = vertex.mean(1)
    cn = cen / np.maximum(np.linalg.norm(cen, axis=1, keepdims=True), 1e-6)
    rgb = np.clip(0.5 + 0.45 * np.stack(
        [cn[:, 0], np.sin(2.0 * cn[:, 1]), cn[:, 2] * cn[:, 0]], axis=1),
        0.05, 0.95).astype(np.float32)
    return dict(vertex=vertex, opacity=np.full((n,), opacity, np.float32), rgb=rgb,
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
                                 scene_kind: str = "soup", device="cuda"):
    """Write a Blender/NeRF-Synthetic-format dataset of a known triangle
    scene to ``root`` (transforms_{train,test}.json + PNGs +
    point_cloud.ply), rendering the GT images through this package's own
    ``rasterize`` on ``device``. ``scene_kind``: "soup" = floating random
    semi-transparent triangles (the photo stress test), "surface" = a
    bumpy opaque closed surface (``make_surface_scene``, the mesh
    recipe's target). The scene, poses and point cloud are the JAX
    builder's for the same arguments. The pair budget is sized up front
    from the demanded pair count and grown until no frame drops pairs.
    Returns ``root``."""
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
    if scene_kind == "surface":
        scene = make_surface_scene(n_tri, seed=seed)
        n_tri = scene["vertex"].shape[0]          # the surface rounds to its grid
    else:
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
                # double at least: a budget sized past the usual cap by the
                # probe frame would otherwise be cut back to it for ever
                settings = replace(settings, pairs_per_triangle=adapt_pair_budget(
                    settings.pairs_per_triangle, None, n_tri, True,
                    max_ppt=max(32.0, 2 * settings.pairs_per_triangle)))

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


# ---------------------------------------------------------------------------
# synthetic city in the MatrixCity layout
# ---------------------------------------------------------------------------

def _quad_grid(origin, eu, ev, nu: int, nv: int) -> np.ndarray:
    """(2 * nu * nv, 3, 3) triangles tiling the parallelogram origin +
    [0, 1] eu + [0, 1] ev, wound so that their normal is eu x ev."""
    s = np.linspace(0.0, 1.0, nu + 1)
    t = np.linspace(0.0, 1.0, nv + 1)
    P = (np.asarray(origin)[None, None] + s[:, None, None] * np.asarray(eu)
         + t[None, :, None] * np.asarray(ev))                    # (nu+1, nv+1, 3)
    a, b = P[:-1, :-1], P[1:, :-1]
    c, d = P[1:, 1:], P[:-1, 1:]
    tri = np.stack([np.stack([a, b, c], -2), np.stack([a, c, d], -2)], 2)
    return tri.reshape(-1, 3, 3)


def make_city_scene(seed: int = 0, extent: float = 3.0, n_buildings: int = 16,
                    cell: float = 0.05):
    """A synthetic city of opaque triangles, z up: a square ground plane of
    side 2 * ``extent`` at z = 0 and ``n_buildings`` boxes of random
    footprints (0.2-0.5) and heights (0.2-0.8) in its middle, each face
    tiled by triangles of about ``cell``. Face colors come from a seeded
    procedural texture: ground blocks, streets and a low-frequency tint;
    per building a facade color with window bands and a roof color.

    Returns dict(vertex (F, 3, 3), rgb (F, 3), normal (F, 3) unit outward
    normals, opacity (F,) 0.99, sh_dc) float32 arrays.
    """
    rng = np.random.default_rng(seed)
    n_g = int(round(2 * extent / cell))
    ground = _quad_grid((-extent, -extent, 0.0), (2 * extent, 0, 0), (0, 2 * extent, 0),
                        n_g, n_g)
    gc = ground.mean(1)
    block = np.floor((gc[:, :2] + extent) / 0.75).astype(np.int64)
    block_tint = rng.uniform(0.25, 0.6, size=(block.max() + 1, block.max() + 1, 3))
    street = (((gc[:, :2] + extent) % 0.75) < 0.12).any(-1)
    g_rgb = block_tint[block[:, 0], block[:, 1]]
    g_rgb = np.where(street[:, None], np.array([0.18, 0.18, 0.2]), g_rgb)
    g_rgb = g_rgb * (0.85 + 0.15 * np.sin(1.3 * gc[:, :1]) * np.cos(0.9 * gc[:, 1:2]))
    parts = [(ground, g_rgb, np.tile([0.0, 0.0, 1.0], (len(ground), 1)))]

    inner = 0.6 * extent
    for _ in range(n_buildings):
        wx, wy = rng.uniform(0.2, 0.5, 2)
        h = rng.uniform(0.2, 0.8)
        x0, y0 = rng.uniform(-inner, inner - wx), rng.uniform(-inner, inner - wy)
        facade = rng.uniform(0.35, 0.9, 3)
        roof = rng.uniform(0.2, 0.5, 3)
        faces = [  # (origin, eu, ev): eu x ev points outward
            ((x0, y0, 0), (wx, 0, 0), (0, 0, h), (0, -1, 0)),
            ((x0 + wx, y0 + wy, 0), (-wx, 0, 0), (0, 0, h), (0, 1, 0)),
            ((x0, y0 + wy, 0), (0, -wy, 0), (0, 0, h), (-1, 0, 0)),
            ((x0 + wx, y0, 0), (0, wy, 0), (0, 0, h), (1, 0, 0)),
            ((x0, y0, h), (wx, 0, 0), (0, wy, 0), (0, 0, 1)),
        ]
        for origin, eu, ev, nrm in faces:
            nu = max(1, int(round(np.linalg.norm(eu) / cell)))
            nv = max(1, int(round(np.linalg.norm(ev) / cell)))
            tri = _quad_grid(origin, eu, ev, nu, nv)
            if nrm[2] == 1:
                rgb = np.tile(roof, (len(tri), 1))
            else:
                z = tri.mean(1)[:, 2]
                window = (np.floor(z / 0.08) % 2 == 1) & (z > 0.06)
                rgb = np.where(window[:, None], 0.5 * facade, facade)
            parts.append((tri, rgb, np.tile(nrm, (len(tri), 1))))

    vertex = np.concatenate([p[0] for p in parts]).astype(np.float32)
    rgb = np.clip(np.concatenate([p[1] for p in parts]), 0.05, 0.95).astype(np.float32)
    normal = np.concatenate([p[2] for p in parts]).astype(np.float32)
    n = len(vertex)
    return dict(vertex=vertex, rgb=rgb, normal=normal,
                opacity=np.full((n,), 0.99, np.float32),
                sh_dc=((rgb - 0.5) / 0.28209479177387814)[:, None, :].astype(np.float32))


def sample_surface_points(scene: dict, n_points: int, seed: int = 0):
    """``n_points`` points drawn uniformly by area on the scene's faces,
    with their face's color and normal (the scene's, else the faces' own
    unit normals): (points, colors, normals)."""
    rng = np.random.default_rng(seed)
    v = scene["vertex"].astype(np.float64)
    cross = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    normal = scene.get("normal")
    if normal is None:
        normal = (cross / np.maximum(2 * area, 1e-30)[:, None]).astype(np.float32)
    face = rng.choice(len(v), size=n_points, p=area / area.sum())
    r1, r2 = rng.uniform(size=(2, n_points))
    s = np.sqrt(r1)
    w = np.stack([1 - s, s * (1 - r2), s * r2], 1)               # uniform barycentrics
    pts = np.einsum("nk,nkd->nd", w, v[face])
    return (pts.astype(np.float32), scene["rgb"][face], normal[face])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion (w, x, y, z), w >= 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R, np.float64).flat
    K = np.array([[Rxx - Ryy - Rzz, 0, 0, 0],
                  [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                  [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                  [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def aerial_pose(theta: float, radius: float = 2.0, height: float = 3.0,
                target=(0.0, 0.0, 0.2)):
    """World-to-camera (R_w2c, t_w2c) of a camera on a circle above a z-up
    scene looking at ``target`` (COLMAP convention: x right, y down, z
    forward)."""
    eye = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])                               # rows: camera axes
    return R, -R @ eye


def write_matrix_city(root, scene: dict, *, width: int = 1600, height: int = 900,
                      fovx_deg: float = 60.0, n_train: int = 8, n_test: int = 2,
                      n_points: int = 4_000_000, seed: int = 0, device="cuda",
                      pairs_per_triangle: float = 6.0, pose=aerial_pose) -> dict:
    """Write ``scene`` to ``root`` in MatrixCity's block_all layout: COLMAP
    text models (one PINHOLE camera, world-to-camera quaternions) under
    ``train/block_all/sparse`` and ``test/block_all_test/sparse``, the
    views as PNGs under ``.../input``, and ``train/block_all/fused.ply``,
    ``n_points`` points with colors and normals drawn on the faces. The
    views are aerial (``pose(theta)`` -> (R_w2c, t_w2c), ``aerial_pose``
    by default; train and test interleaved on one circle), rendered through this package's ``rasterize`` ("3D", gamma 50:
    opaque faces) on ``device`` with black background. Returns host
    seconds of the steps: dict(render, png, ply)."""
    import math
    import time
    from dataclasses import replace
    from pathlib import Path

    from PIL import Image

    from ..datasets.colmap_loader import qvec2rotmat
    from ..device import resolve_device
    from ..models.point_cloud import PointCloud
    from ..ops.projection import RasterSettings
    from ..ops.rasterize import rasterize
    from ..trainers.adc_utils import adapt_pair_budget

    dev = resolve_device(device)
    root = Path(root)
    fovx = math.radians(fovx_deg)
    fx = width / (2 * math.tan(fovx / 2))
    vertex = torch.as_tensor(scene["vertex"]).to(dev)
    opacity = torch.as_tensor(scene["opacity"]).to(dev)
    rgb = torch.as_tensor(scene["rgb"]).to(dev)
    settings = RasterSettings(image_width=width, image_height=height, rich_info=False,
                              rasterizer_type="3D", pairs_per_triangle=pairs_per_triangle)
    secs = dict(render=0.0, png=0.0, ply=0.0)
    n_views = n_train + n_test
    for split, block, count, offset in (("train", "train/block_all", n_train, 0),
                                        ("test", "test/block_all_test", n_test, n_train)):
        (root / block / "sparse").mkdir(parents=True, exist_ok=True)
        (root / block / "input").mkdir(parents=True, exist_ok=True)
        (root / block / "sparse" / "cameras.txt").write_text(
            "# Camera list with one line of data per camera:\n"
            f"1 PINHOLE {width} {height} {fx!r} {fx!r} {width / 2!r} {height / 2!r}\n")
        lines = ["# Image list with two lines of data per image:"]
        for i in range(count):
            k = offset + i
            R_w2c, t = pose(2 * math.pi * (k * 3 % n_views) / n_views + 0.1 * (k % 2))
            q = rotmat2qvec(R_w2c)
            name = f"{split}_{i:04d}.png"
            lines += [f"{i + 1} " + " ".join(repr(float(x)) for x in (*q, *t)) + f" 1 {name}", ""]
            # the camera exactly as the loader rebuilds it from the text
            cam = Camera.create(R=qvec2rotmat(q).T, T=t, fovx=fovx,
                                fovy=2 * math.atan(height / (2 * fx)), image_width=width,
                                image_height=height, device=dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                while True:
                    out = rasterize(vertex, opacity, None, cam, settings, gamma=50.0,
                                    background=torch.zeros(3, device=dev), bg_depth=20.0,
                                    colors=rgb)
                    if not bool(out["overflow"]):        # never drop GT pairs
                        break
                    settings = replace(settings, pairs_per_triangle=adapt_pair_budget(
                        settings.pairs_per_triangle, None, len(vertex), True))
                img = (out["render"].clamp(0, 1) * 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()
            t1 = time.perf_counter()
            Image.fromarray(img).save(root / block / "input" / name)
            secs["render"] += t1 - t0
            secs["png"] += time.perf_counter() - t1
        (root / block / "sparse" / "images.txt").write_text("\n".join(lines) + "\n")
    t0 = time.perf_counter()
    pts, cols, nrm = sample_surface_points(scene, n_points, seed=seed)
    PointCloud(pts, cols, nrm).storePly(root / "train/block_all/fused.ply")
    secs["ply"] = time.perf_counter() - t0
    return secs


# ---------------------------------------------------------------------------
# synthetic capture in the COLMAP layout
# ---------------------------------------------------------------------------

def write_points3d_binary(path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """A COLMAP ``points3D.bin``: per point its id, float64 xyz, uint8 rgb
    (from colors in [0, 1]), reprojection error 0 and an empty track."""
    n = len(xyz)
    rec = np.zeros(n, dtype=np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                                      ("err", "<f8"), ("track", "<u8")]))
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"] = xyz
    rec["rgb"] = np.clip(np.round(np.asarray(rgb) * 255), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(np.uint64(n).tobytes())
        f.write(rec.tobytes())


def write_colmap_scene(root, scene: dict, *, width: int = 1297, height: int = 840,
                       fovx_deg: float = 50.0, n_views: int = 16, n_points: int = 100_000,
                       seed: int = 0, device="cuda", pairs_per_triangle: float = 6.0) -> dict:
    """Write a triangle ``scene`` to ``root`` as a COLMAP capture, the layout
    the COLMAP recipes read: ``sparse/0/cameras.txt`` (one PINHOLE camera),
    ``sparse/0/images.txt`` (world-to-camera quaternions), ``n_views`` views
    on a circle around the scene (``pose_on_circle``) rendered through this
    package's ``rasterize`` ("2D", gamma 1, white background) on ``device``
    as ``images/view_XXX.png``, and ``sparse/0/points3D.bin``: ``n_points``
    points drawn on the faces with their colors. Returns host seconds of
    the steps: dict(render, png, ply)."""
    import math
    import time
    from dataclasses import replace
    from pathlib import Path

    from PIL import Image

    from ..datasets.colmap_loader import qvec2rotmat
    from ..device import resolve_device
    from ..ops.projection import RasterSettings
    from ..ops.rasterize import rasterize
    from ..trainers.adc_utils import adapt_pair_budget

    dev = resolve_device(device)
    root = Path(root)
    (root / "sparse" / "0").mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(parents=True, exist_ok=True)
    fovx = math.radians(fovx_deg)
    fx = width / (2 * math.tan(fovx / 2))
    vertex = torch.as_tensor(scene["vertex"]).to(dev)
    opacity = torch.as_tensor(scene["opacity"]).to(dev)
    rgb = torch.as_tensor(scene["rgb"]).to(dev)
    settings = RasterSettings(image_width=width, image_height=height, rich_info=False,
                              pairs_per_triangle=pairs_per_triangle)
    (root / "sparse" / "0" / "cameras.txt").write_text(
        "# Camera list with one line of data per camera:\n"
        f"1 PINHOLE {width} {height} {fx!r} {fx!r} {width / 2!r} {height / 2!r}\n")
    secs = dict(render=0.0, png=0.0, ply=0.0)
    lines = ["# Image list with two lines of data per image:"]
    for i in range(n_views):
        c2w = pose_on_circle(2 * math.pi * i / n_views, height=0.3 * math.sin(i))
        c2w[:3, 1:3] *= -1                       # OpenGL -> COLMAP camera axes
        w2c = np.linalg.inv(c2w)
        q, t = rotmat2qvec(w2c[:3, :3]), w2c[:3, 3]
        name = f"view_{i:03d}.png"
        lines += [f"{i + 1} " + " ".join(repr(float(x)) for x in (*q, *t)) + f" 1 {name}", ""]
        # the camera exactly as the loader rebuilds it from the text
        cam = Camera.create(R=qvec2rotmat(q).T, T=t, fovx=fovx,
                            fovy=2 * math.atan(height / (2 * fx)), image_width=width,
                            image_height=height, device=dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            while True:
                out = rasterize(vertex, opacity, None, cam, settings, gamma=1.0,
                                background=torch.ones(3, device=dev), bg_depth=20.0,
                                colors=rgb)
                if not bool(out["overflow"]):            # never drop GT pairs
                    break
                settings = replace(settings, pairs_per_triangle=adapt_pair_budget(
                    settings.pairs_per_triangle, None, len(vertex), True,
                    max_ppt=max(32.0, 2 * settings.pairs_per_triangle)))
            img = (out["render"].clamp(0, 1) * 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()
        t1 = time.perf_counter()
        Image.fromarray(img).save(root / "images" / name)
        secs["render"] += t1 - t0
        secs["png"] += time.perf_counter() - t1
    (root / "sparse" / "0" / "images.txt").write_text("\n".join(lines) + "\n")
    t0 = time.perf_counter()
    pts, cols, _ = sample_surface_points(scene, n_points, seed=seed)
    write_points3d_binary(root / "sparse" / "0" / "points3D.bin", pts, cols)
    secs["ply"] = time.perf_counter() - t0
    return secs
