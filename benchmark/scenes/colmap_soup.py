"""The synthetic COLMAP capture and the mid-training ScaffoldGS model of the
scaffold configuration.

Geometry: a frozen copy of ``triangle_splatting_tpu_torch/utils/testing.py:
make_random_scene`` as ``chip_smoke.py:build_colmap`` calls it (a "soup" of
100k semi-transparent triangles in a 1.6-unit cube) from a fixed seed.
Views: ``n_views`` cameras on a circle (``pose_on_circle``) at Mip-NeRF
360's ``images_4`` size, COLMAP text under ``sparse/0`` and PNGs under
``images``, rendered by the benchmark's plain renderer on white. The
capture is the same for every seed, so it is built once in a checkout and
found in the cache by every later run.
Model: the anchors of ``n_points`` points drawn on the faces by the seed,
voxelized at the recipe's ``voxel_size`` as ``create_from_points`` does,
at the recipe's capacity, with features and head weights drawn from the
seed (the heads' default initialization) by a ``torch.Generator`` on the
run's device. It is made anew in every run, never cached, so that every
run's set-up does the same work; it is handed to the trainer in the
checkpoint layout (fresh Adam moments) and to the reference as arrays.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from ..reference import tiles as TL
from ..reference import triangles as TR
from . import common as C

LAYOUT_SEED = 7
HEADS = ("offset", "opacity", "cov", "color", "scaling")


def make_soup(n: int, rng: np.random.Generator, z_range=(-0.8, 0.8), xy_extent=0.8,
              size_range=(0.01, 0.05), opacity_range=(0.7, 0.95)) -> dict:
    centers = np.stack([rng.uniform(-xy_extent, xy_extent, n), rng.uniform(-xy_extent, xy_extent, n),
                        rng.uniform(*z_range, n)], -1).astype(np.float32)
    sizes = rng.uniform(*size_range, n).astype(np.float32)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    u = np.cross(np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), (n, 3)), normals)
    bad = np.linalg.norm(u, axis=1) < 1e-6
    u[bad] = np.array([1.0, 0.0, 0.0], np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(normals, u)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    s = sizes[:, None]
    vertex = np.stack([centers + u * s, centers + (-0.5 * u + (np.sqrt(3) / 2) * v) * s,
                       centers + (-0.5 * u - (np.sqrt(3) / 2) * v) * s], 1).astype(np.float32)
    opacity = rng.uniform(*opacity_range, n).astype(np.float32)
    rgb = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    return dict(vertex=vertex, opacity=opacity, rgb=rgb)


def pose_on_circle(theta: float, radius: float = 4.5, height: float = 0.0) -> np.ndarray:
    """An OpenGL camera-to-world matrix on a circle looking at the origin."""
    eye = np.array([radius * np.sin(theta), height, radius * np.cos(theta)])
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, forward), -forward, eye
    return c2w


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit ``torch.Generator`` seed of the run's seed and a stream."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0]) >> 1


def start_model(points: np.ndarray, m: dict, seed: int, device) -> dict:
    """Anchors, features, heads and state of the start, as flat host arrays
    ("p.<leaf>", "s.<field>"); the features and heads are drawn on
    ``device`` in two calls."""
    vs = float(m["voxel_size"])
    anchor = (np.unique(np.round(points / vs), axis=0) * vs).astype(np.float32)
    n = anchor.shape[0]
    cap = (max(int(n * m["capacity_factor"]), n) + 255) // 256 * 256
    F, Hd, k = m["feat_dim"], m["hidden_dim"], m["n_offsets"]
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 4))
    feat = torch.zeros((cap, F), device=device)
    feat[:n].normal_(0.0, 3 * m["feat_init_std"], generator=g)
    dims = {"scaling": 6, "offset": 3 * k, "opacity": k, "cov": 7 * k, "color": 3 * k}
    shapes = [(f"p.mlps.{h}.{leaf}{j}", shape, fan_in) for h in HEADS
              for j, fan_in, fan_out in (("1", F, Hd), ("2", Hd, dims[h]))
              for leaf, shape in (("w", (fan_in, fan_out)), ("b", (fan_out,)))]
    u = torch.rand(sum(math.prod(sh) for _, sh, _ in shapes), device=device, generator=g)
    out = {"p.anchor": np.concatenate([anchor, np.zeros((cap - n, 3), np.float32)]),
           "p.anchor_feat": feat.cpu().numpy()}
    flat = (u * 2.0 - 1.0).cpu().numpy()
    at = 0
    for name, sh, fan_in in shapes:
        size = math.prod(sh)
        out[name] = (flat[at:at + size].reshape(sh) / np.float32(math.sqrt(fan_in))).astype(np.float32)
        at += size
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    out.update({"s.alive": np.arange(cap) < n,
                "s.anchor_scaling": np.full((cap, 3), m["max_offset_scale"], np.float32),
                "s.anchor_rotation": rot, "s.opacity_accum": np.zeros(cap, np.float32),
                "s.anchor_denom": np.zeros(cap, np.float32),
                "s.offset_grad_accum": np.zeros((cap, k), np.float32),
                "s.offset_denom": np.zeros((cap, k), np.float32),
                "s.voxel_size": np.float32(vs),
                "s.opacity_threshold": np.float32(m["anchor_update"]["opacity_threshold_init"])})
    return out


def checkpoint_blob(flat: dict) -> dict:
    """The flat arrays in the trainer's checkpoint layout (params with the
    heads nested by head and leaf, state, zero Adam moments at step 0)."""
    def params(prefix_fn):
        p = {"anchor": prefix_fn("anchor"), "anchor_feat": prefix_fn("anchor_feat"), "mlps": {}}
        for h in HEADS:
            p["mlps"][h] = {leaf: prefix_fn(f"mlps.{h}.{leaf}") for leaf in ("w1", "b1", "w2", "b2")}
        return p
    state = {k[2:]: v for k, v in flat.items() if k.startswith("s.")}
    return dict(params=params(lambda k: flat[f"p.{k}"]),
                opt=dict(m=params(lambda k: np.zeros_like(flat[f"p.{k}"])),
                         v=params(lambda k: np.zeros_like(flat[f"p.{k}"])), step=np.int32(0)),
                state=state, scene_bbox=None)


def _soup(params: dict) -> dict:
    """The capture's triangles (the same for every seed)."""
    return make_soup(params["gt_triangles"], np.random.default_rng(LAYOUT_SEED))


def build(params: dict, seed: int, device, images: bool = True) -> dict:
    """Find (or build once) the capture's cameras and, with ``images``, its
    views (a render cell needs none); make the start model of ``seed``."""
    path = C.scene_dir("colmap_soup", params, "capture",
                       [__file__, TL.__file__, TR.__file__, C.__file__])
    W, H = params["width"], params["height"]
    fx = W / (2 * math.tan(math.radians(params["fovx_deg"]) / 2))
    soup = _soup(params)

    def make(tmp: Path):
        records = []
        for i in range(params["n_views"]):
            c2w = pose_on_circle(2 * math.pi * i / params["n_views"], height=0.3 * math.sin(i))
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            records.append(C.camera_record(C.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], fx, W, H,
                                           f"view_{i:03d}"))
        C.write_colmap_text(tmp / "sparse" / "0", records, W, H, fx)
        (tmp / "scene.json").write_text(json.dumps(records))

    C.build_once(path, make)
    records = json.loads((path / "scene.json").read_text())

    def views(tmp: Path):
        vertex = torch.as_tensor(soup["vertex"], device=device)
        rgb = torch.as_tensor(soup["rgb"], device=device)
        opacity = torch.as_tensor(soup["opacity"], device=device)
        alive = torch.ones(len(vertex), dtype=torch.bool, device=device)
        gamma = torch.tensor(1.0, device=device)
        for rec in records:
            cam = C.camera_tensors(rec, device)
            with torch.no_grad():
                prep = TR.preprocess_3d(vertex, rgb, opacity, cam, alive, gamma)
                q, _ = TR.leaves_of(prep)
                plan = TL.plan_tiles(prep.rect_min, prep.rect_max, prep.valid, prep.depth, W, H)
                img = TL.render(plan, TR.chunk_fn_3d(q, gamma, cam), torch.ones(3, device=device),
                                20.0, params["chunk"], with_normal=False)[0]
            C.save_png(tmp / f"{rec['name']}.png", img)

    if images:
        C.build_once(path / "images", views)
    pts, _ = C.sample_surface_points(soup["vertex"], params["n_points"],
                                     np.random.default_rng([seed, 1]))
    start = start_model(pts.astype(np.float32), params["model"], seed, device)
    hold = params.get("hold_interval", 8)
    ordered = sorted(records, key=lambda r: r["name"])
    train = [r for i, r in enumerate(ordered) if i % hold != 0]
    test = [r for i, r in enumerate(ordered) if i % hold == 0]
    return dict(root=path, start=start, start_blob=checkpoint_blob(start), train=train,
                test=test, orbit=lambda n: orbit(params, n),
                gt=lambda rec: C.load_png(path / "images" / f"{rec['name']}.png", device))


def orbit(params: dict, n: int) -> list:
    """``n`` novel poses on the capture circle, between the captured ones,
    at the capture's size and field of view."""
    W, H = params["width"], params["height"]
    fx = W / (2 * math.tan(math.radians(params["fovx_deg"]) / 2))
    out = []
    for i in range(n):
        theta = 2 * math.pi * (i + 0.5) / n
        c2w = pose_on_circle(theta, height=0.3 * math.sin(theta * params["n_views"] / (2 * math.pi)))
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        out.append(C.camera_record(C.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], fx, W, H, f"orbit_{i:03d}"))
    return out
