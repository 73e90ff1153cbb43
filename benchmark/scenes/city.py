"""The synthetic MatrixCity-style capture and the mid-training model of the
city configuration.

Geometry: a frozen copy of ``triangle_splatting_tpu_torch/utils/testing.py:
make_city_scene`` (a 6 x 6 ground plane and 16 box buildings of opaque
triangles, z up), its layout drawn from a fixed seed so every run does the
same work; the run's seed jitters the face colors. Views: aerial cameras on
a circle (``aerial_pose``), written in MatrixCity's ``block_all`` layout
(COLMAP text models, PNGs), rendered by the benchmark's plain renderer at
gamma 50 on black. Model: ``init_triangles`` equilateral triangles drawn on
the faces from the seed, as the recipe's grid sampling would place them,
with the spread of sizes, colors and opacities of a model in the middle of
training, written as the PLY the trainer resumes from.
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

LAYOUT_SEED = 0


def _quad_grid(origin, eu, ev, nu: int, nv: int) -> np.ndarray:
    s = np.linspace(0.0, 1.0, nu + 1)
    t = np.linspace(0.0, 1.0, nv + 1)
    P = (np.asarray(origin)[None, None] + s[:, None, None] * np.asarray(eu)
         + t[None, :, None] * np.asarray(ev))
    a, b = P[:-1, :-1], P[1:, :-1]
    c, d = P[1:, 1:], P[:-1, 1:]
    return np.stack([np.stack([a, b, c], -2), np.stack([a, c, d], -2)], 2).reshape(-1, 3, 3)


def make_city(extent: float = 3.0, n_buildings: int = 16, cell: float = 0.05) -> dict:
    """The city's faces: vertex (F, 3, 3), rgb (F, 3), normal (F, 3)."""
    rng = np.random.default_rng(LAYOUT_SEED)
    n_g = int(round(2 * extent / cell))
    ground = _quad_grid((-extent, -extent, 0.0), (2 * extent, 0, 0), (0, 2 * extent, 0), n_g, n_g)
    gc = ground.mean(1)
    block = np.floor((gc[:, :2] + extent) / 0.75).astype(np.int64)
    tint = rng.uniform(0.25, 0.6, size=(block.max() + 1, block.max() + 1, 3))
    street = (((gc[:, :2] + extent) % 0.75) < 0.12).any(-1)
    g_rgb = np.where(street[:, None], np.array([0.18, 0.18, 0.2]), tint[block[:, 0], block[:, 1]])
    g_rgb = g_rgb * (0.85 + 0.15 * np.sin(1.3 * gc[:, :1]) * np.cos(0.9 * gc[:, 1:2]))
    parts = [(ground, g_rgb, np.tile([0.0, 0.0, 1.0], (len(ground), 1)))]
    inner = 0.6 * extent
    for _ in range(n_buildings):
        wx, wy = rng.uniform(0.2, 0.5, 2)
        h = rng.uniform(0.2, 0.8)
        x0, y0 = rng.uniform(-inner, inner - wx), rng.uniform(-inner, inner - wy)
        facade = rng.uniform(0.35, 0.9, 3)
        roof = rng.uniform(0.2, 0.5, 3)
        faces = [((x0, y0, 0), (wx, 0, 0), (0, 0, h), (0, -1, 0)),
                 ((x0 + wx, y0 + wy, 0), (-wx, 0, 0), (0, 0, h), (0, 1, 0)),
                 ((x0, y0 + wy, 0), (0, -wy, 0), (0, 0, h), (-1, 0, 0)),
                 ((x0 + wx, y0, 0), (0, wy, 0), (0, 0, h), (1, 0, 0)),
                 ((x0, y0, h), (wx, 0, 0), (0, wy, 0), (0, 0, 1))]
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
    return dict(vertex=np.concatenate([p[0] for p in parts]).astype(np.float32),
                rgb=np.concatenate([p[1] for p in parts]).astype(np.float32),
                normal=np.concatenate([p[2] for p in parts]).astype(np.float32))


def init_model(city: dict, n: int, n_large: int, grid: float, rng: np.random.Generator) -> dict:
    """``n`` triangles on the faces (``n_large`` of them too large for the
    recipe's scale pruning), each an equilateral triangle of circumradius
    about ``grid`` in its face's plane, turned at random and lifted off it
    a little; colors near the face's, opacity logits N(0, 1.6)."""
    pts, face = C.sample_surface_points(city["vertex"], n, rng)
    nrm = city["normal"][face].astype(np.float64)
    pts = pts + nrm * rng.normal(0.0, 0.1 * grid, (n, 1))
    helper = np.where(np.abs(nrm[:, 2:3]) > 0.9, [[1.0, 0.0, 0.0]], [[0.0, 0.0, 1.0]])
    u = np.cross(helper, nrm)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(nrm, u)
    ang = rng.uniform(0, 2 * np.pi, (n, 1))
    u, v = np.cos(ang) * u + np.sin(ang) * v, -np.sin(ang) * u + np.cos(ang) * v
    s = grid * rng.uniform(0.6, 1.4, (n, 1))
    s[:n_large] = rng.uniform(0.07, 0.12, (n_large, 1))
    k = math.sqrt(3) / 2
    vertex = np.stack([pts + u * s, pts + (-0.5 * u + k * v) * s, pts + (-0.5 * u - k * v) * s], 1)
    rgb = np.clip(city["rgb"][face] + rng.normal(0, 0.08, (n, 3)), 0.02, 0.98)
    return dict(vertex=vertex.astype(np.float32),
                opacity=rng.normal(0.0, 1.6, (n, 1)).astype(np.float32),
                f_dc=((rgb - 0.5) / TR.SH_C0)[:, None, :].astype(np.float32))


def build(params: dict, seed: int, device) -> dict:
    """Build (or find in the cache) the capture and the model of ``seed``.
    Returns dict(root, start_ply, train (camera records), test, ...)."""
    path = C.scene_dir("city", params, seed, [__file__, TL.__file__, TR.__file__, C.__file__])

    def make(tmp: Path):
        rng = np.random.default_rng([seed, 1])
        city = make_city(cell=params.get("cell", 0.05))
        city["rgb"] = np.clip(city["rgb"] + rng.normal(0, 0.03, city["rgb"].shape),
                              0.05, 0.95).astype(np.float32)
        W, H = params["width"], params["height"]
        fx = W / (2 * math.tan(math.radians(params["fovx_deg"]) / 2))
        n_train, n_test = params["n_train"], params["n_test"]
        n_views = n_train + n_test
        vertex = torch.as_tensor(city["vertex"], device=device)
        rgb = torch.as_tensor(city["rgb"], device=device)
        opacity = torch.full((len(vertex),), 0.99, device=device)
        alive = torch.ones(len(vertex), dtype=torch.bool, device=device)
        gamma = torch.tensor(50.0, device=device)
        records = {"train": [], "test": []}
        for split, block, count, offset in (("train", "train/block_all", n_train, 0),
                                            ("test", "test/block_all_test", n_test, n_train)):
            (tmp / block / "input").mkdir(parents=True, exist_ok=True)
            for i in range(count):
                k = offset + i
                R, t = C.aerial_pose(2 * math.pi * (k * 3 % n_views) / n_views + 0.1 * (k % 2))
                rec = C.camera_record(C.rotmat2qvec(R), t, fx, W, H, f"{split}_{i:04d}")
                cam = C.camera_tensors(rec, device)
                with torch.no_grad():
                    prep = TR.preprocess_3d(vertex, rgb, opacity, cam, alive, gamma)
                    q, _ = TR.leaves_of(prep)
                    plan = TL.plan_tiles(prep.rect_min, prep.rect_max, prep.valid, prep.depth,
                                         W, H)
                    img = TL.render(plan, TR.chunk_fn_3d(q, gamma, cam),
                                    torch.zeros(3, device=device), 20.0, params["chunk"],
                                    with_normal=False)[0]
                C.save_png(tmp / block / "input" / f"{rec['name']}.png", img)
                records[split].append(rec)
            C.write_colmap_text(tmp / block / "sparse", records[split], W, H, fx)
        model = init_model(city, params["init_triangles"], params["init_large"],
                           params["grid"], rng)
        v = model["vertex"].reshape(-1, 9)
        cols = {f"{a}{i}": v[:, 3 * (i - 1) + j] for i in (1, 2, 3) for j, a in enumerate("xyz")}
        cols = {k: cols[k] for k in ("x1", "y1", "z1", "x2", "y2", "z2", "x3", "y3", "z3")}
        cols["opacity"] = model["opacity"][:, 0]
        for j in range(3):
            cols[f"f_dc_{j}"] = model["f_dc"][:, 0, j]
        (tmp / "model").mkdir()
        C.write_ply(tmp / "model" / "start.ply", cols)
        np.savez(tmp / "model" / "start.npz", **{f"p.{k}": v for k, v in model.items()})
        (tmp / "scene.json").write_text(json.dumps(records))

    C.build_once(path, make)
    records = json.loads((path / "scene.json").read_text())
    return dict(root=path, start_ply=path / "model" / "start.ply",
                start_npz=path / "model" / "start.npz", train=records["train"],
                test=records["test"], gt=lambda rec: C.load_png(
                    path / "train/block_all/input" / f"{rec['name']}.png", device))
