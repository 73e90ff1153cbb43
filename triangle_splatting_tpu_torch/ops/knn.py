"""Exact k-nearest-neighbor queries on the device (port of
``triangle_splatting_tpu/ops/knn.py``).

- ``mean_sq_dist(points)``: mean squared distance to the 3 nearest
  neighbors (the ``simple-knn`` ``distCUDA2`` of the reference);
- ``nearest_neighbor(points, group_size)``: the index of the nearest point
  outside the query's own group of ``group_size`` consecutive points.

A blocked brute force: squared distances as ``|q|^2 + |p|^2 - 2 q.p^T``
(float32, the JAX function's formula), one (block, 8 * block) tile at a
time, and a running sorted top-k per query merged from each tile's k
smallest entries, as the JAX function merges them. The formula cancels,
so its rounding is kept that of the JAX function on the CPU and the same
on every device: the squared norms and the dot product as chains of fused
multiply-adds over the three coordinates in order (each step exact in
float64 and rounded to float32; a library matmul's order differs by
device). The answer is the k
smallest distances with ties going to the lower index, whatever the block
size. Invalid and padded points are masked with +inf; a query with fewer
than k valid targets gets inf and index -1 in the missing places.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

_INF = float("inf")


def _as_points(points, device) -> torch.Tensor:
    if isinstance(points, torch.Tensor):
        return points.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(points, np.float32)).to(resolve_device(device))


def _dot_fma(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., 3) x (..., 3) -> float32 fma(q2, p2, fma(q1, p1, q0 p0)),
    each step rounded to float32 (broadcasting over the leading dims)."""
    q64, p64 = q.to(torch.float64), p.to(torch.float64)
    acc = (q64[..., 0] * p64[..., 0]).to(torch.float32)
    for i in (1, 2):
        acc = (q64[..., i] * p64[..., i] + acc.to(torch.float64)).to(torch.float32)
    return acc


def _merge_tile(best_d, best_i, d, pi, k: int):
    """Merge the k smallest entries of tile ``d`` (B, T) into the running
    sorted (B, k) lists: k times extract the tile's minimum (the first
    column on ties), insert it with a stable sort (earlier entries first
    on ties) and knock its column out."""
    for _ in range(k):
        dmin, amin = torch.min(d, dim=1)
        d_cat = torch.cat([best_d, dmin[:, None]], dim=1)
        i_cat = torch.cat([best_i, pi[amin][:, None]], dim=1)
        order = torch.argsort(d_cat, dim=1, stable=True)[:, :k]
        best_d = torch.gather(d_cat, 1, order)
        best_i = torch.gather(i_cat, 1, order)
        d = d.scatter(1, amin[:, None], _INF)
    return best_d, best_i


@torch.no_grad()
def knn(points, valid=None, *, k: int = 3, group_size: int | None = None,
        block: int = 1024, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN among the valid points.

    Args:
        points: (N, 3) positions, a tensor (its device is used) or an
            array (moved to ``device``).
        valid: optional (N,) bool; invalid points are no one's neighbor
            (their own rows are garbage: mask them downstream).
        k: neighbors per query (the query itself is excluded).
        group_size: if set, exclude the targets in the query's own group
            of ``group_size`` consecutive indices.
        block: rows of a query tile; a tile spans 8 * block targets.

    Returns:
        (d2, idx): (N, k) float32 squared distances (inf where fewer than k
        valid targets) and (N, k) int64 indices (-1 where inf).
    """
    pts = _as_points(points, device)
    dev = pts.device
    n0 = pts.shape[0]
    block = min(block, max(8, 1 << (n0 - 1).bit_length()))
    n = -(-n0 // block) * block
    pts = torch.cat([pts, pts.new_zeros((n - n0, 3))])
    ids = torch.arange(n, device=dev)
    val = ids < n0
    if valid is not None:
        val[:n0] &= torch.as_tensor(valid).to(dev, torch.bool)
    sq = _dot_fma(pts, pts)
    tile = min(8 * block, n)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    for r0 in range(0, n, block):
        q, qi, qsq = pts[r0:r0 + block], ids[r0:r0 + block], sq[r0:r0 + block]
        bd = torch.full((q.shape[0], k), _INF, device=dev)
        bi = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
        for c0 in range(0, n, tile):
            p, pi, psq = pts[c0:c0 + tile], ids[c0:c0 + tile], sq[c0:c0 + tile]
            d = qsq[:, None] + psq[None, :] - 2.0 * _dot_fma(q[:, None], p[None])
            d = torch.clamp_min(d, 0.0)
            ok = val[c0:c0 + tile][None, :] & (qi[:, None] != pi[None, :])
            if group_size is not None:
                ok &= (qi[:, None] // group_size) != (pi[None, :] // group_size)
            d = torch.where(ok, d, torch.full_like(d, _INF))
            bd, bi = _merge_tile(bd, bi, d, pi, k)
        d2[r0:r0 + block], idx[r0:r0 + block] = bd, bi
    return d2[:n0], idx[:n0]


def mean_sq_dist(points, valid=None, k: int = 3, block: int = 1024, device="cuda"):
    """Mean squared distance to the k nearest neighbors, clamped at 1e-7
    (missing neighbors count 0)."""
    d2, _ = knn(points, valid, k=k, block=block, device=device)
    d2 = torch.where(torch.isfinite(d2), d2, torch.zeros_like(d2))
    return torch.clamp_min(d2.mean(dim=1), 1e-7)


def inter_point_distance(points, valid=None, k: int = 3, block: int = 1024, device="cuda"):
    """sqrt of ``mean_sq_dist``."""
    return torch.sqrt(mean_sq_dist(points, valid, k=k, block=block, device=device))


def nearest_neighbor(points, group_size: int, valid=None, block: int = 1024, device="cuda"):
    """Index of each point's nearest neighbor outside its own group of
    ``group_size`` consecutive points; (N,) int64, -1 when no valid
    target."""
    _, idx = knn(points, valid, k=1, group_size=group_size, block=block, device=device)
    return idx[:, 0]
