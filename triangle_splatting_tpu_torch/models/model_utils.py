"""Model-layer helpers (port of ``triangle_splatting_tpu/models/model_utils.py``,
the parts the photo and mesh training paths use: the host-side numpy
initialization helpers, grid sampling included, and the torch masks)."""

from __future__ import annotations

import numpy as np
import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def inverse_sigmoid_np(x):
    return np.log(x / (1.0 - x))


def inter_point_distance_np(points: np.ndarray, k: int = 3) -> np.ndarray:
    """sqrt(mean squared distance to the k nearest neighbors), mean-square
    clamped at 1e-7 (host cKDTree: at initialization and for the sparsity
    retention of contribution pruning)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    dist, _ = tree.query(points, k=k + 1)     # includes self at distance 0
    mean_sq = (dist[:, 1:] ** 2).mean(axis=1)
    return np.sqrt(np.maximum(mean_sq, 1e-7)).astype(np.float32)


def resize_linear(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(..., h, w) -> (..., H, W) as ``jax.image.resize(..., "linear")``:
    half-pixel bilinear whose triangle filter is widened by the scale
    along an axis that shrinks (``antialias=True``; along an axis that
    grows it is the plain bilinear filter). A plain bilinear or
    average-pool shrink misses it by ~0.1."""
    lead = x.shape[:-2]
    y = torch.nn.functional.interpolate(
        x.reshape((1, -1) + x.shape[-2:]), size=(H, W), mode="bilinear",
        align_corners=False, antialias=True)
    return y.reshape(lead + (H, W))


def get_inside_mask(points: torch.Tensor, bbox) -> torch.Tensor:
    """(N,) bool: points inside bbox = [xmin, ymin, (zmin,) xmax, ymax,
    (zmax)]; a 4-value box ignores z; no box (None) keeps every point."""
    if bbox is None:
        return torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    bbox = torch.as_tensor(np.asarray(bbox, np.float32).reshape(-1)).to(points.device)
    if bbox.numel() == 4:
        lo, hi, pts = bbox[:2], bbox[2:], points[:, :2]
    else:
        lo, hi, pts = bbox[:3], bbox[3:], points
    return ((pts >= lo) & (pts <= hi)).all(dim=-1)


def get_color_tensor(background: str, rng: np.random.Generator | None = None) -> np.ndarray:
    """'white' | 'black' | 'random' -> (3,) float32."""
    if background == "white":
        return np.ones(3, np.float32)
    if background == "black":
        return np.zeros(3, np.float32)
    if background == "random":
        rng = rng or np.random.default_rng()
        return rng.uniform(size=3).astype(np.float32)
    raise ValueError(f"Unknown background: {background}")


def _flat_voxel_keys(points: np.ndarray, grid_size: float) -> np.ndarray:
    """1-D int64 voxel key per point, floor(points / grid) from the world
    origin encoded in a mixed radix over the occupied extent; packed-byte
    record keys when that radix would overflow int64."""
    voxel = np.floor(points / grid_size).astype(np.int64)
    key = voxel - voxel.min(axis=0)
    dims = key.max(axis=0) + 1
    if float(dims[0]) * float(dims[1]) * float(dims[2]) < 2.0**62:
        return (key[:, 0] * dims[1] + key[:, 1]) * dims[2] + key[:, 2]
    rec = np.ascontiguousarray(key)
    return rec.view([("", rec.dtype)] * 3).ravel()


def grid_sampling(points: np.ndarray, colors: np.ndarray, normals: np.ndarray,
                  grid_size: float):
    """Voxel-average downsampling: one point per occupied voxel of side
    ``grid_size``, the mean of its points, colors and normals (float64
    sums, float32 results), in voxel-key order."""
    uniq, inverse = np.unique(_flat_voxel_keys(points, grid_size), return_inverse=True)
    m = uniq.shape[0]
    counts = np.bincount(inverse, minlength=m).astype(np.float64)

    def scatter_mean(x):
        cols = [np.bincount(inverse, weights=x[:, j], minlength=m)
                for j in range(x.shape[1])]
        return (np.stack(cols, axis=1) / counts[:, None]).astype(np.float32)

    return scatter_mean(points), scatter_mean(colors), scatter_mean(normals)


def grid_size_search(points: np.ndarray, n_sample: int,
                     tolerance: float = 0.1, max_iter: int = 30) -> float:
    """Bisect the voxel size whose occupied-voxel count is within
    ``tolerance`` of ``n_sample`` (the last probe after ``max_iter``)."""
    lo, hi = 1e-6, float(np.ptp(points, axis=0).max())
    for _ in range(max_iter):
        mid = (lo + hi) / 2
        count = np.unique(_flat_voxel_keys(points, mid)).shape[0]
        if abs(count - n_sample) <= tolerance * n_sample:
            return mid
        if count > n_sample:
            lo = mid
        else:
            hi = mid
    return mid
