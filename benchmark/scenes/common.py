"""Helpers shared by the scene generators: the scene cache inside the
checkout, COLMAP camera text, PLY writing and the reference camera.

Frozen copies (from ``triangle_splatting_tpu_torch/utils/testing.py`` and
``datasets/colmap_loader.py``): ``rotmat2qvec``, ``qvec2rotmat``,
``aerial_pose``, ``pose_on_circle``, ``sample_surface_points``. The GT
images are rendered by the benchmark's own plain renderer, never by the
program.
"""

from __future__ import annotations

import hashlib
import json
import math
import shutil
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parents[1]
CACHE = BENCH / "cache"


def scene_dir(kind: str, params: dict, seed: int, sources) -> Path:
    """The fixed cache directory of one scene: keyed by the generator's
    source files, its parameters and the seed."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(json.dumps(params, sort_keys=True).encode())
    return CACHE / "scenes" / f"{kind}-{h.hexdigest()[:12]}-{seed}"


def build_once(path: Path, build) -> Path:
    """Run ``build(tmp)`` into a sibling directory and rename it into
    place, unless ``path`` is already complete."""
    if (path / "COMPLETE").exists():
        return path
    tmp = path.with_name(path.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    build(tmp)
    (tmp / "COMPLETE").write_text("ok\n")
    shutil.rmtree(path, ignore_errors=True)
    tmp.rename(path)
    return path


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


def qvec2rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


def aerial_pose(theta: float, radius: float = 2.0, height: float = 3.0, target=(0.0, 0.0, 0.2)):
    """World-to-camera (R, t) of a camera on a circle above a z-up scene
    looking at ``target`` (x right, y down, z forward)."""
    eye = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ eye


def sample_surface_points(vertex: np.ndarray, n_points: int, rng: np.random.Generator):
    """Points drawn uniformly by area on the faces: (points, face index,
    barycentrics)."""
    v = vertex.astype(np.float64)
    area = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=1)
    face = rng.choice(len(v), size=n_points, p=area / area.sum())
    r1, r2 = rng.uniform(size=(2, n_points))
    s = np.sqrt(r1)
    w = np.stack([1 - s, s * (1 - r2), s * r2], 1)
    return np.einsum("nk,nkd->nd", w, v[face]), face


def camera_record(q, t, fx: float, width: int, height: int, name: str) -> dict:
    return dict(q=[float(x) for x in q], t=[float(x) for x in t], fx=float(fx),
                width=int(width), height=int(height), name=name)


def camera_tensors(rec: dict, device) -> dict:
    """World-to-view, projection (znear 1, zfar 1000, z in [0, 1]), center
    and half-angle tangents of a camera record, float32, as a COLMAP
    PINHOLE camera with fx = fy defines them."""
    W, H, fx = rec["width"], rec["height"], rec["fx"]
    fovx, fovy = 2 * math.atan(W / (2 * fx)), 2 * math.atan(H / (2 * fx))
    Rw2c = qvec2rotmat(np.asarray(rec["q"], np.float64))
    T = np.asarray(rec["t"], np.float64)
    wv = np.zeros((4, 4), np.float32)
    wv[:3, :3] = Rw2c.astype(np.float32)
    wv[:3, 3] = T.astype(np.float32)
    wv[3, 3] = 1.0
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    P = np.zeros((4, 4), np.float32)
    znear, zfar = 1.0, 1000.0
    P[0, 0] = 1.0 / tx
    P[1, 1] = 1.0 / ty
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    full = (P @ wv).astype(np.float32)
    center = (-(Rw2c.T.astype(np.float64)) @ T).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return dict(world_view=t(wv), full_proj=t(full), camera_center=t(center),
                tan_fovx=t(np.float32(tx)), tan_fovy=t(np.float32(ty)), width=W, height=H,
                name=rec["name"])


def write_colmap_text(folder: Path, records: list, width: int, height: int, fx: float) -> None:
    """cameras.txt (one PINHOLE camera) and images.txt of ``records``."""
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "cameras.txt").write_text(
        "# Camera list with one line of data per camera:\n"
        f"1 PINHOLE {width} {height} {fx!r} {fx!r} {width / 2!r} {height / 2!r}\n")
    lines = ["# Image list with two lines of data per image:"]
    for i, r in enumerate(records):
        lines += [f"{i + 1} " + " ".join(repr(float(x)) for x in (*r["q"], *r["t"]))
                  + f" 1 {r['name']}.png", ""]
    (folder / "images.txt").write_text("\n".join(lines) + "\n")


def write_ply(path: Path, columns: dict) -> None:
    """A binary little-endian PLY with one ``vertex`` element of float32
    columns."""
    names = list(columns)
    n = len(next(iter(columns.values())))
    rec = np.zeros(n, dtype=[(k, "<f4") for k in names])
    for k in names:
        rec[k] = columns[k]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {k}" for k in names] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def save_png(path: Path, img: torch.Tensor) -> None:
    from PIL import Image
    arr = (img.clamp(0, 1) * 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()
    Image.fromarray(arr).save(path)


def load_png(path: Path, device) -> torch.Tensor:
    from PIL import Image
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32).transpose(2, 0, 1) / 255.0
    return torch.as_tensor(arr, device=device)
