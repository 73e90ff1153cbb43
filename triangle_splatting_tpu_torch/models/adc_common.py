"""Adaptive-density-control code shared by the models: the fixed-shape
argsort ranking of the lowest-contribution rows toward a target count
(port of ``triangle_splatting_tpu/models/adc_common.py``), and the slot
placement of densification (the JAX ``densify`` functions' assignment)."""

from __future__ import annotations

from dataclasses import replace

import torch


def _rank(score: torch.Tensor) -> torch.Tensor:
    """Position of each row in the stable ascending order of ``score``."""
    order = torch.argsort(score, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(score.shape[0], device=score.device)
    return rank


@torch.no_grad()
def contribution_prune_mask(state, inside, *, min_view_count,
                            target_point_num, prune_ratio, max_prune_ratio,
                            contrib_max_ratio, inter_point_dist=None,
                            sparsity_retain_ratio=0.0):
    """Rows to prune toward ``target_point_num``, ranked by contribution.

    ``state`` needs alive / contrib_{sum,max,denom}; ``inside`` is the (C,)
    bbox(-and-STE) filtered alive mask. Returns ``(prune_mask, select)``:
    the rows to prune, and the rows whose contribution statistics the
    caller resets (every selected row, pruned or not).

    The counts are float32 in the JAX function's order and truncated to
    int32 as it truncates them: a count off by one prunes another set.
    """
    dev = state.alive.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    alive = state.alive
    valid_count = inside.sum().to(torch.float32)
    total = alive.sum().to(torch.float32)
    select = (state.contrib_denom >= min_view_count) & alive
    select_count = select.sum().to(torch.float32)

    diff = torch.clamp_min(valid_count - f32(target_point_num) * f32(0.99), 0.0) \
        * total / torch.clamp_min(valid_count, 1.0)
    prune_count = torch.minimum(diff * f32(prune_ratio),
                                select_count * f32(max_prune_ratio))
    n_by_max = (prune_count * f32(contrib_max_ratio)).to(torch.int32)
    n_by_sum = (prune_count * (f32(1.0) - f32(contrib_max_ratio))).to(torch.int32)

    inf = torch.full_like(state.contrib_max, float("inf"))

    def rank_mask(values, n_prune):
        return (_rank(torch.where(select, values, inf)) < n_prune) & select

    prune_mask = rank_mask(state.contrib_max, n_by_max) | \
        rank_mask(state.contrib_sum, n_by_sum)

    if sparsity_retain_ratio > 0 and inter_point_dist is not None:
        n_pruned = prune_mask.sum().to(torch.float32)
        retain = (f32(sparsity_retain_ratio) * n_pruned).to(torch.int32)
        # the sparsest of the rows to prune (largest kNN distance) stay
        rank = _rank(torch.where(prune_mask, -inter_point_dist, inf))
        prune_mask = prune_mask & ~(rank < retain)

    return prune_mask, select


def reset_contribution_stats(state, select):
    """Zero the selected rows' contribution statistics."""
    def zero(x):
        return torch.where(select, torch.zeros_like(x), x)
    return replace(state, contrib_sum=zero(state.contrib_sum),
                   contrib_max=zero(state.contrib_max),
                   contrib_denom=zero(state.contrib_denom))


def place_candidates(alive: torch.Tensor, new_valid: torch.Tensor, split_mask: torch.Tensor):
    """Slot assignment of densification (shared by triangles and Gaussians).

    ``new_valid`` (2C,) marks candidate rows: 2i the clone copy or split
    half 1 of row i, 2i+1 split half 2. The k-th valid candidate (stable,
    valid first) goes to the k-th dead slot (stable, dead first); at the
    capacity boundary a split's half 1 is held back when its half 2 does
    not fit (a lone half would duplicate geometry, the original is kept).

    Returns ``(take, dst, placed, both_placed, overflow)``: (C,) candidate
    index of the k-th placement, (C,) its slot (C = dropped), (C,) the
    slots filled, (C,) the rows whose two candidates were both placed,
    and whether candidates were left over.
    """
    C = alive.shape[0]
    dev = alive.device
    k = torch.arange(C, device=dev)
    new_order = torch.argsort((~new_valid).to(torch.uint8), stable=True)    # valid first
    dead_order = torch.argsort(alive.to(torch.uint8), stable=True)          # dead first
    n_new = new_valid.sum()
    n_dead = (~alive).sum()
    n_place = torch.minimum(n_new, n_dead)
    overflow = n_new > n_dead
    inv = torch.empty_like(new_order)                                     # cand -> rank
    inv[new_order] = torch.arange(2 * C, device=dev)
    last = new_order[torch.clamp(n_place - 1, 0, 2 * C - 1)]
    orphan = ((n_place > 0) & (last % 2 == 0) & split_mask[last // 2]
              & (inv[torch.clamp_max(last + 1, 2 * C - 1)] >= n_place))
    n_place = n_place - orphan.to(n_place.dtype)
    take = new_order[:C]
    dst = torch.where(k < n_place, dead_order, torch.full_like(dead_order, C))
    placed = torch.zeros(C + 1, dtype=torch.bool, device=dev)
    placed[dst] = k < n_place
    placed_cand = (inv < n_place) & new_valid
    return take, dst, placed[:C], placed_cand.reshape(C, 2).all(dim=1), overflow


def put_rows(leaf: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``leaf`` with ``rows[k]`` written to slot ``dst[k]``; slots equal to
    the capacity are dropped (a scatter into one spare row)."""
    out = torch.cat([leaf, leaf.new_zeros((1,) + leaf.shape[1:])])
    out[dst] = rows
    return out[:-1]
