"""Geometric mesh-quality metrics: chamfer distance and F-score (port of
``triangle_splatting_tpu/models/mesh_metrics.py``).

The synthetic datasets carry their ground-truth triangle soup
(``gt_scene.npz``), so an exported mesh can be scored geometrically:
area-weighted surface samples of both soups (host numpy, the JAX
function's draws for the same seed) and the two nearest-neighbor sweeps of
``ops/knn.py`` on the device, in one kNN call over the concatenation with
``group_size`` masking.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_triangle_soup(vertex: np.ndarray, n_samples: int,
                         seed: int = 0) -> np.ndarray:
    """(n_samples, 3) float32 area-weighted uniform surface samples of an
    (N, 3, 3) triangle soup (triangles drawn uniformly when every one is
    degenerate)."""
    v = np.asarray(vertex, np.float64)
    if v.shape[0] == 0:
        raise ValueError("cannot sample an empty triangle soup")
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    total = area.sum()
    probs = np.full(v.shape[0], 1.0 / v.shape[0]) if total <= 0 else area / total
    rng = np.random.default_rng(seed)
    tri = rng.choice(v.shape[0], size=n_samples, p=probs)
    # uniform barycentric via the sqrt trick
    r1 = np.sqrt(rng.random(n_samples))
    r2 = rng.random(n_samples)
    w0 = 1.0 - r1
    w1 = r1 * (1.0 - r2)
    w2 = r1 * r2
    pts = (w0[:, None] * v[tri, 0] + w1[:, None] * v[tri, 1]
           + w2[:, None] * v[tri, 2])
    return pts.astype(np.float32)


def nn_dists_cross(pts_a: np.ndarray, pts_b: np.ndarray, block: int = 1024,
                   device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Euclidean nearest-neighbor distances A->B and B->A (host arrays):
    one kNN over the concatenation, each query's own set excluded by
    ``group_size`` (so |A| must equal |B|)."""
    from ..ops.knn import knn

    n = pts_a.shape[0]
    if pts_b.shape[0] != n:
        raise ValueError(f"need equal sample counts, got {n} vs {pts_b.shape[0]}")
    both = np.concatenate([np.asarray(pts_a, np.float32), np.asarray(pts_b, np.float32)])
    d2, _ = knn(both, k=1, group_size=n, block=block, device=device)
    d = torch.sqrt(torch.clamp_min(d2[:, 0], 0.0)).cpu().numpy()
    return d[:n], d[n:]


def chamfer_and_fscore(pts_a: np.ndarray, pts_b: np.ndarray, tau: float = 0.05,
                       block: int = 1024, device="cuda") -> dict:
    """Chamfer distance and F-score between two sampled point sets:
    ``chamfer`` = mean_a min_b |a - b| + mean_b min_a |a - b| (euclidean),
    ``precision`` the share of A within ``tau`` of B, ``recall`` of B
    within ``tau`` of A, ``fscore`` their harmonic mean."""
    d_ab, d_ba = nn_dists_cross(pts_a, pts_b, block=block, device=device)
    precision = float((d_ab <= tau).mean())
    recall = float((d_ba <= tau).mean())
    f = (2.0 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return {"chamfer": float(d_ab.mean() + d_ba.mean()),
            "chamfer_a2b": float(d_ab.mean()), "chamfer_b2a": float(d_ba.mean()),
            "precision": precision, "recall": recall, "fscore": f, "tau": float(tau)}


def mesh_geometry_scores(vertex_pred: np.ndarray, vertex_gt: np.ndarray,
                         n_samples: int = 100_000, tau: float = 0.05, seed: int = 0,
                         block: int = 1024, device="cuda") -> dict:
    """Score a predicted triangle soup against the GT soup geometrically."""
    pa = sample_triangle_soup(vertex_pred, n_samples, seed=seed)
    pb = sample_triangle_soup(vertex_gt, n_samples, seed=seed + 1)
    return chamfer_and_fscore(pa, pb, tau=tau, block=block, device=device)
