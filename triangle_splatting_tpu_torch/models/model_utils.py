"""Model-layer helpers (port of ``triangle_splatting_tpu/models/model_utils.py``,
the parts the photo and mesh training paths use)."""

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
