"""Offline BEV / tour / comparison video rendering (port of
``triangle_splatting_tpu/utils/render_utils.py``).

The helpers take a ``render_fn(camera) -> dict`` closure; ``make_render_fn``
builds one from triangle or Gaussian params and state on their device
(rendered without gradients, background black as in the reference). The
poses are the reference's, in MatrixCity's metric units: the BEV camera
1200 above the scene's center, the tour an 800 x 400 orbit 400 above it.
Videos and saved frames go through OpenCV, imported when they are written.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from .camera import Camera

# the reference's field of view of the BEV and tour cameras (radians)
FOVX, FOVY = 0.610, 0.414


def _host(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def image_to_cv(image) -> np.ndarray:
    """(3, H, W) float RGB in [0, 1] -> HWC uint8 BGR."""
    img = _host(image).transpose(1, 2, 0)[..., ::-1]
    return np.ascontiguousarray(np.clip(img * 255, 0, 255)).astype(np.uint8)


def make_render_fn(params, state, cfg, rasterizer_type: str | None = None,
                   impl: str = "cuda", device="cuda"):
    """Closure camera -> forward package for triangle or Gaussian params
    (the JAX keys and ``pairs_needed``: rich info and the contribution
    statistics on, as the JAX cores default them). ``params`` and ``state``
    must lie on ``device``. The closure's frames bin at its own
    ``PairBudget`` (``render_fn.budget``)."""
    from ..models import gaussian_model as MG
    from ..models import triangle as MT
    from ..ops.projection import RasterSettings
    from ..ops.rasterize import PairBudget

    dev = resolve_device(device)
    is_tri = isinstance(params, MT.TriangleParams)
    lead = params.vertex if is_tri else params.xyz
    if lead.device.type != dev.type or (dev.index is not None and lead.device.index != dev.index):
        raise ValueError(f"params lie on {lead.device}, not on {dev}")
    rtype = rasterizer_type or getattr(cfg, "rasterizer_type", "2D") or "2D"
    extra = dict(apply_color_affine=False) if is_tri else {}
    budget = PairBudget()

    @torch.no_grad()
    def render_fn(camera: Camera, background: str = "black"):
        settings = RasterSettings(
            image_width=int(camera.image_width), image_height=int(camera.image_height),
            max_sh_degree=cfg.max_sh_degree, rasterizer_type=rtype)
        bg = (torch.ones if background == "white" else torch.zeros)(
            3, dtype=torch.float32, device=dev)
        mod = MT if is_tri else MG
        return budget.render(
            lambda max_pairs: mod.forward(params, state, camera, bg, cfg, settings,
                                          is_training=False, impl=impl, max_pairs=max_pairs,
                                          need_stats=True, **extra))

    with torch.no_grad():
        xyz = MT.get_xyz(params) if is_tri else params.xyz
        render_fn.center = xyz[state.alive].cpu().numpy().mean(axis=0)
    render_fn.device = dev
    render_fn.budget = budget
    return render_fn


def bev_camera(render_fn, img_size=(2160, 1440), center=None) -> Camera:
    """The top-down bird's-eye camera 1200 above ``center``."""
    R = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float64)
    elevation = 1200
    center = render_fn.center if center is None else np.asarray(center)
    cam_pos = center + np.array([0, 0, elevation])
    T = R.T @ -cam_pos
    return Camera.create(R=R, T=T, fovx=FOVX, fovy=FOVY, image_width=img_size[0],
                         image_height=img_size[1], device=render_fn.device)


def render_BEV_image(render_fn, save_path: str | None = None,
                     img_size=(2160, 1440), center=None) -> np.ndarray:
    """Top-down bird's-eye render; (3, H, W) float on the host."""
    image = render_fn(bev_camera(render_fn, img_size, center))["render"]
    if save_path is not None:
        import cv2
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(save_path), image_to_cv(image))
    return _host(image)


def pos_target_to_RT(pos: np.ndarray, target: np.ndarray):
    """Look-at extrinsics with world +z as up."""
    z = target - pos
    z = z / np.linalg.norm(z)
    x = np.cross(z, [0, 0, 1.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    y = y / np.linalg.norm(y)
    R = np.array([x, y, z]).T
    return R, R.T @ -pos


def _open_video(save_path: str, fps: int, img_size):
    import cv2
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    video = cv2.VideoWriter(str(save_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, img_size)
    if not video.isOpened():    # codec fallback
        alt = str(Path(save_path).with_suffix(".avi"))
        video = cv2.VideoWriter(alt, cv2.VideoWriter_fourcc(*"MJPG"), fps, img_size)
    return video


def _tour_cameras(center, num_cams):
    """Elliptical orbit poses shared by the tour renderers."""
    theta = np.linspace(0, 2 * np.pi, num_cams, endpoint=False)
    coord = np.array([np.cos(theta), np.sin(theta), np.zeros_like(theta)]).T
    cam_pos = coord * np.array([800, 400, 0]) + center + np.array([0, 0, 400])
    target_pos = coord * np.array([200, 100, 0]) + center
    return cam_pos, target_pos


def tour_cameras(render_fn, img_size=(2160, 1440), num_cams: int = 300) -> list[Camera]:
    """The tour's ``num_cams`` cameras around ``render_fn.center``."""
    cam_pos, target_pos = _tour_cameras(render_fn.center, num_cams)
    cams = []
    for i in range(num_cams):
        R, T = pos_target_to_RT(cam_pos[i], target_pos[i])
        cams.append(Camera.create(R=R, T=T, fovx=FOVX, fovy=FOVY, image_width=img_size[0],
                                  image_height=img_size[1], device=render_fn.device))
    return cams


def render_tour(render_fn, save_path: str, img_size=(2160, 1440),
                fps: int = 30, duration: int = 10) -> None:
    """Orbit-tour video around the scene center."""
    video = _open_video(save_path, fps, img_size)
    for cam in tour_cameras(render_fn, img_size, fps * duration):
        video.write(image_to_cv(render_fn(cam)["render"]))
    video.release()


def render_tour_compare(render_fn1, render_fn2, save_path: str,
                        img_size=(2160, 1440), name1="model1",
                        name2="model2", fps: int = 30,
                        duration: int = 10) -> None:
    """Side-by-side split-screen tour of two models (the first's center)."""
    import cv2
    video = _open_video(save_path, fps, img_size)
    half = img_size[0] // 2
    for cam in tour_cameras(render_fn1, img_size, fps * duration):
        im1 = _host(render_fn1(cam)["render"])
        im2 = _host(render_fn2(cam)["render"])
        image = image_to_cv(np.concatenate([im1[..., :half], im2[..., half:]], axis=2))
        cv2.putText(image, name1, (img_size[0] // 20, img_size[1] // 10),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 0, 255), 2)
        cv2.putText(image, name2, (half + img_size[0] // 20, img_size[1] // 10),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 0, 255), 2)
        cv2.line(image, (half, 0), (half, img_size[1]), (255, 255, 255), 2)
        video.write(image)
    video.release()
