"""Independent opaque-triangle ray tracer (port of
``triangle_splatting_tpu/ops/raytrace.py``).

Every other render path of the port (the tile blend, the dense oracles,
MeshRenderer) shares the splatting formulation: barycentric eccentricity
falloff, front-to-back compositing, a per-triangle depth sort. This module
renders the opaque endpoint (gamma to infinity, the solidify / GLB regime)
by another algorithm: per-pixel Moeller-Trumbore ray-triangle
intersection with a true nearest-hit z-buffer. It shares no code with the
rasterizers beyond the camera transform, so a score it gives cannot
inherit a forward fault of that family (``tools/full_run.py --mesh``).

The JAX function scans the triangles one at a time; here a chunk of
triangles is tested at once against every pixel and the chunk's nearest
hit (the first triangle on ties) replaces the running one only when
strictly nearer, which picks the same triangle as the scan.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def raytrace_soup(vertex: torch.Tensor, rgb: torch.Tensor, camera, settings,
                  background=None, znear: float = 0.01, chunk: int = 64) -> dict:
    """Trace camera rays against an opaque triangle soup.

    Args:
        vertex: (N, 3, 3) world-space triangle vertices.
        rgb: (N, 3) flat per-triangle colors.
        camera: utils.camera.Camera (pose + fov); the tensors' device.
        settings: RasterSettings (image size only).
        chunk: triangles tested at once.
    Returns:
        dict(render (3, H, W), depth (H, W): the ray's t, inf where no hit,
        hit (H, W) bool).
    """
    W, H = settings.image_width, settings.image_height
    dev = camera.device
    vertex = torch.as_tensor(vertex, dtype=torch.float32).to(dev)
    rgb = torch.as_tensor(rgb, dtype=torch.float32).to(dev)
    if background is None:
        background = torch.zeros(3)
    background = torch.as_tensor(background, dtype=torch.float32).to(dev)

    # view-space triangles, camera at the origin; pixel-center rays
    # r = (tfx (2 px - W + 1) / W, tfy (2 py - H + 1) / H, 1)
    M = camera.world_view[:3]
    v = vertex.reshape(-1, 3)
    v_view = (v[:, 0:1] * M[:, 0] + v[:, 1:2] * M[:, 1]
              + v[:, 2:3] * M[:, 2] + M[:, 3]).reshape(-1, 3, 3)
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    # divisors on the device: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, an ulp away from the CPU's quotient
    w_, h_ = (torch.tensor(float(x), device=dev) for x in (W, H))
    rx = (camera.tan_fovx * (2.0 * px - W + 1.0) / w_).expand(H, W)
    ry = (camera.tan_fovy * (2.0 * py - H + 1.0) / h_).expand(H, W)

    t_best = torch.full((H, W), float("inf"), device=dev)
    c_best = background[:, None, None].expand(3, H, W).clone()
    for s in range(0, v_view.shape[0], chunk):
        # (T, 1, 1) per-triangle constants against (H, W) rays
        v1, v2, v3 = (v_view[s:s + chunk, i][:, :, None, None] for i in range(3))
        e1 = v2 - v1
        e2 = v3 - v1
        # h = dir x e2 (dir_z == 1)
        hx = ry * e2[:, 2] - e2[:, 1]
        hy = e2[:, 0] - rx * e2[:, 2]
        hz = rx * e2[:, 1] - ry * e2[:, 0]
        a = e1[:, 0] * hx + e1[:, 1] * hy + e1[:, 2] * hz
        ok = torch.abs(a) > 1e-12
        f = 1.0 / torch.where(ok, a, torch.ones_like(a))
        # s = origin - v1 = -v1; q = s x e1; w = f dot(dir, q)
        u = f * (-(v1[:, 0] * hx + v1[:, 1] * hy + v1[:, 2] * hz))
        qx = -(v1[:, 1] * e1[:, 2] - v1[:, 2] * e1[:, 1])
        qy = -(v1[:, 2] * e1[:, 0] - v1[:, 0] * e1[:, 2])
        qz = -(v1[:, 0] * e1[:, 1] - v1[:, 1] * e1[:, 0])
        w = f * (rx * qx + ry * qy + qz)
        t = f * (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz)
        hit = ok & (u >= 0.0) & (w >= 0.0) & (u + w <= 1.0) & (t > znear)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        t_min, first = torch.min(t, dim=0)          # the first triangle on ties
        nearer = t_min < t_best
        t_best = torch.where(nearer, t_min, t_best)
        col = rgb[s:s + chunk][first].permute(2, 0, 1)     # (3, H, W)
        c_best = torch.where(nearer[None], col, c_best)
    return {"render": c_best, "depth": t_best, "hit": torch.isfinite(t_best)}
