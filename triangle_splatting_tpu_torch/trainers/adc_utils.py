"""ADC cadence helpers (port of ``triangle_splatting_tpu/trainers/adc_utils.py``:
the pair-budget adaptation, the contribution-pruning schedule and the
sparsity distances; ``grow_capacity`` waits for densification)."""

from __future__ import annotations

import numpy as np
import torch


def resolve_contribution_pruning(cp, iteration: int):
    """Apply the downsample schedule to the contribution-pruning knobs:
    each crossed ``downsample_iteration`` sets its target, halves
    contrib_max_ratio, moves the sparsity retain ratio halfway to 0.8 and
    rebalances prune_ratio so that the effective prune rate is unchanged
    by the larger retention.

    Returns ``(target_point_num, contrib_max_ratio, prune_ratio, retain)``.
    """
    target = cp.target_point_num
    ratio = cp.contrib_max_ratio if cp.contrib_max_ratio is not None else 0.1
    prune_ratio = cp.prune_ratio if cp.prune_ratio is not None else 0.15
    retain = cp.sparsity_retain_ratio or 0.0
    if cp.downsample_iteration:
        for it, pnum in zip(cp.downsample_iteration, cp.downsample_point_num):
            if iteration > it:
                target = pnum
                ratio *= 0.5
                new_retain = retain + (0.8 - retain) * 0.5
                prune_ratio *= (1 - retain) / (1 - new_retain)
                retain = new_retain
    return target, ratio, prune_ratio, retain


def adapt_pair_budget(ppt: float, used: int | None, count: int,
                      overflow: bool, *, max_ppt: float = 32.0,
                      margin: float = 1.3,
                      shrink_if_below: float = 0.5) -> float:
    """Need-based pair-budget adaptation shared by the trainer and benches.

    The pair buffer has a fixed budget per frame, re-quantized with
    hysteresis exactly as the JAX package does: grow 2x on overflow, and
    shrink directly to ``margin`` x the measured per-primitive need when
    that frees at least ``1 - shrink_if_below`` of the buffer (eighth
    steps). Pass ``used=None`` when the measured pair count is unknown:
    adaptation is then grow-only.

    Returns the new pairs-per-primitive budget (may equal ``ppt``).
    """
    if overflow:
        return min(ppt * 2.0, max_ppt)
    if used is None:
        return ppt
    need = margin * float(used) / max(count, 1)
    new = max(2.0, round(need * 8.0) / 8.0)   # eighth steps
    if new < ppt * shrink_if_below:
        return new
    return ppt


def alive_inter_point_dist(xyz: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(C,) sparsity distances among the alive rows only (dead capacity
    slots hold stale positions that would corrupt the kNN ranking): a host
    cKDTree over the alive centroids, zeros for dead rows, returned on
    ``xyz``'s device."""
    from ..models.model_utils import inter_point_distance_np
    pts = xyz.detach().cpu().numpy()
    keep = alive.detach().cpu().numpy()
    full = np.zeros(len(pts), np.float32)
    if keep.any():
        full[keep] = inter_point_distance_np(pts[keep])
    return torch.as_tensor(full).to(xyz.device)
