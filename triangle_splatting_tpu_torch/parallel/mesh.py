"""Camera data parallelism over ``torch.distributed`` (port of
``triangle_splatting_tpu/parallel/mesh.py``).

Parameters are replicated: every rank renders its own share of a step's
camera batch, sums its views' gradients, and one SUM all-reduce of the
gradients and the loss precedes a replicated Adam step, which equals
accumulating all the batch's views on one device. A rank that holds a
batch of B views renders them one after the other (the JAX package's
per-device scan). A world of one process (no ``torch.distributed`` job)
runs the whole batch on its device with every collective the identity:
``data_parallel: N`` on one card is N views accumulated a step.

Densification statistics keep per-VIEW semantics: per-view screen-space
gradient norms and view counts are SUMMED, contribution and radius maxima
are MAX-reduced, which equals running the batch's views through
sequential ``update_statistics`` calls (the statistics are non-negative).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Optional, Sequence

import torch

from ..utils import tracing
from .multihost import DataGroup, world, world_group


def make_mesh(n_devices: Optional[int] = None) -> DataGroup:
    """The data group over the first ``n_devices`` ranks of the job (all of
    them by default). Raises when fewer ranks exist: a requested mesh never
    shrinks."""
    _, n_ranks = world()
    n = n_devices or n_ranks
    if n_ranks < n:
        raise RuntimeError(
            f"make_mesh({n}) requires {n} ranks but the job has {n_ranks}. Launch "
            f"{n} processes (TS_COORDINATOR / TS_NUM_PROCESSES / TS_PROCESS_ID or "
            "the trainer.distributed block), or ask for a batch that dp_layout "
            "fits on fewer ranks; a requested mesh is never silently shrunk.")
    return world_group(n)


def dp_layout(dp_n: int, n_devices: Optional[int] = None) -> tuple[int, int]:
    """Split a ``trainer.data_parallel: N`` camera batch into
    (ranks, cameras_per_rank).

    Uses the largest divisor of ``dp_n`` that fits the rank pool, so
    ``data_parallel: 16`` on 8 ranks runs 8-way with 2 cameras a rank
    (accumulated: gradients identical to 16-way).

    Raises when the best layout would leave more than half the pool idle
    (e.g. a prime ``dp_n`` larger than the rank count serializes the whole
    batch onto one rank): a silently degenerate "data-parallel" run is
    worse than an error naming a good batch size.
    """
    if n_devices is None:
        n_devices = world()[1]
    if dp_n < 1:
        raise ValueError(f"data_parallel must be >= 1, got {dp_n}")
    for d in range(min(dp_n, n_devices), 0, -1):
        if dp_n % d == 0:
            if dp_n > d and d <= n_devices // 2:
                raise ValueError(
                    f"data_parallel={dp_n} has no divisor using more than "
                    f"{d} of the {n_devices} available devices — the batch "
                    f"would serialize {dp_n // d} cameras per chip while "
                    f"{n_devices - d} chips idle. Pick a batch size with a "
                    f"divisor near {n_devices} (e.g. "
                    f"{n_devices * max(1, round(dp_n / n_devices))}).")
            return d, dp_n // d
    raise AssertionError("unreachable: 1 divides dp_n")


def stack_dp_cameras(cameras: Sequence) -> list:
    """Validate a data-parallel camera batch: one RasterSettings renders
    every view of a step, so mixed resolutions (raw COLMAP captures) fail
    here with an actionable error. The port renders the views one after
    the other, so the batch stays a list (the JAX package stacks it)."""
    sizes = {(c.image_width, c.image_height) for c in cameras}
    if len(sizes) > 1:
        raise ValueError(
            "trainer.data_parallel requires all cameras in a step's batch "
            f"to share one resolution; got {sorted(sizes)}. Set the "
            "dataset's target_res to a fixed [W, H] to equalize them.")
    return list(cameras)


def dp_views(group: DataGroup, cameras: Sequence, one_view: Callable,
             idle_camera=None) -> tuple[dict, dict]:
    """Run ``one_view(camera) -> (sums, maxes)`` (dicts of tensors) over
    this rank's cameras, sum / max them over the views, then over the
    group: one SUM and one MAX all-reduce per dtype. A rank with no camera
    renders ``idle_camera`` for the shapes and adds zeros."""
    sums = maxes = None
    for camera in cameras:
        with tracing.span("view"):
            s, m = one_view(camera)
        if sums is None:
            sums, maxes = dict(s), dict(m)
        else:
            sums = {k: sums[k] + s[k] for k in sums}
            maxes = {k: torch.maximum(maxes[k], m[k]) for k in maxes}
    if sums is None:
        s, m = one_view(idle_camera)
        sums = {k: torch.zeros_like(v) for k, v in s.items()}
        maxes = {k: torch.zeros_like(v) for k, v in m.items()}
    return group.reduce_dict(sums, "sum"), group.reduce_dict(maxes, "max")


def dp_eval_scores(group: DataGroup, score_fn: Callable, cameras: Sequence,
                   cameras_per_device: int = 1, n_images: int = 0):
    """Score a test-view list over the group.

    ``score_fn(camera) -> (img, scores)`` renders and scores one view
    (``scores`` a 1-D tensor: PSNR, SSIM, ...). Views go ``B =
    cameras_per_device`` to a rank, so one pass scores ``group.size * B``
    views; the final chunk is padded by repetition and the padding is
    dropped. The scores (and the images of views ``< n_images``, the few
    that are logged) are all-gathered in view order. Yields ``(index,
    camera, img or None, scores)`` per real view on every rank."""
    B = int(cameras_per_device)
    n = group.size * B
    for c0 in range(0, len(cameras), n):
        chunk = list(cameras[c0:c0 + n])
        real = len(chunk)
        chunk = chunk + [chunk[-1]] * (n - real)
        # a rank beyond the data group scores the first views, discarded
        r = group.rank if group.takes_cameras else 0
        mine = [score_fn(c) for c in chunk[r * B:(r + 1) * B]]
        scores = group.all_gather(torch.stack([s for _, s in mine]))
        scores = scores[:group.size].reshape(n, -1)
        imgs = None
        if c0 < n_images:
            imgs = group.all_gather(torch.stack([im for im, _ in mine]))
            imgs = imgs[:group.size].reshape((n,) + tuple(mine[0][0].shape))
        for j in range(real):
            yield c0 + j, chunk[j], (imgs[j] if imgs is not None and c0 + j < n_images
                                     else None), scores[j]


# -- per-view statistics -----------------------------------------------------

@torch.no_grad()
def view_stat_locals(vis, per_view_gnorm, contrib_sum, contrib_max, radii):
    """One view's visibility-gated statistic contribution, the 5-tuple
    ``(d_acc, d_den, cs, cm, rad)`` (sums for the first two, maxima for
    the rest)."""
    zero = torch.zeros((), dtype=torch.float32, device=per_view_gnorm.device)
    return (torch.where(vis, per_view_gnorm, zero), vis.to(torch.float32),
            torch.where(vis, contrib_sum, zero), torch.where(vis, contrib_max, zero),
            torch.where(vis, radii.to(torch.float32), zero))


def zero_view_stat_locals(capacity: int, device=None):
    z = torch.zeros((capacity,), dtype=torch.float32, device=device)
    return (z, z, z, z, z)


def accumulate_view_stat_locals(acc, new):
    """Fold another view into accumulated locals (sum / sum / max / max /
    max): a rank's view minibatch."""
    return (acc[0] + new[0], acc[1] + new[1], torch.maximum(acc[2], new[2]),
            torch.maximum(acc[3], new[3]), torch.maximum(acc[4], new[4]))


@torch.no_grad()
def apply_view_statistics(state, locals_):
    """Add reduced locals to a TriangleState / GaussianState."""
    d_acc, d_den, cs, cm, rad = locals_
    return replace(
        state,
        gradient_accum=state.gradient_accum + d_acc,
        gradient_denom=state.gradient_denom + d_den,
        contrib_sum=torch.maximum(state.contrib_sum, cs),
        contrib_max=torch.maximum(state.contrib_max, cm),
        contrib_denom=state.contrib_denom + d_den,
        max_radii2d=torch.maximum(state.max_radii2d, rad))


def reduce_view_statistics_local(state, locals_, group: DataGroup):
    """Apply accumulated per-rank statistic locals to the replicated state,
    reduced over ``group`` (SUM of the gradient norms and view counts, MAX
    of the contribution and radius maxima)."""
    d_acc, d_den = group.all_reduce(locals_[:2], "sum")
    cs, cm, rad = group.all_reduce(locals_[2:], "max")
    return apply_view_statistics(state, (d_acc, d_den, cs, cm, rad))


def reduce_view_statistics(state, vis, per_view_gnorm, contrib_sum, contrib_max,
                           radii, group: DataGroup):
    """One-view-per-rank form of ``reduce_view_statistics_local``."""
    return reduce_view_statistics_local(
        state, view_stat_locals(vis, per_view_gnorm, contrib_sum, contrib_max, radii),
        group)


# -- stat-slot names shared by the trainers' steps ---------------------------

STAT_SUMS = ("stat.d_acc", "stat.d_den")
STAT_MAXES = ("stat.cs", "stat.cm", "stat.rad")


def stat_entries(locals_) -> tuple[dict, dict]:
    """A view's locals as the (sums, maxes) entries of a ``dp_views`` view."""
    return dict(zip(STAT_SUMS, locals_[:2])), dict(zip(STAT_MAXES, locals_[2:]))


def stat_locals_of(sums: dict, maxes: dict):
    return tuple(sums[k] for k in STAT_SUMS) + tuple(maxes[k] for k in STAT_MAXES)


def make_dp_train_step(group: DataGroup, settings, model_cfg, loss_fn: Callable,
                       impl: str = "cuda", cameras_per_device: int = 1):
    """A data-parallel train step of the triangle model.

    Args:
        loss_fn: ``(render_pkg, camera, params, state, weights) -> scalar``
            for ONE camera; the views' losses are summed over the group.
        cameras_per_device: this rank's local minibatch size B; the global
            batch is ``group.size * B`` views.
    Returns:
        ``step(params, opt, state, cameras, background, lrs, weights,
        idle_camera=None) -> (params, opt, state, loss, center2d_grad)``,
        ``cameras`` this rank's B views (none on a rank beyond the group's
        size, which renders ``idle_camera`` for the shapes): the gradients, the centroid gradient and the loss
        summed over the views and the group (one SUM all-reduce), then one
        replicated Adam step.
    """
    from ..models import triangle as M
    B = int(cameras_per_device)

    def step(params, opt, state, cameras, background, lrs, weights, idle_camera=None):
        if group.takes_cameras and len(cameras) != B:
            raise ValueError(f"expected {B} local cameras, got {len(cameras)}")
        names = list(params.tensors())

        def one_view(camera):
            leaves = {k: t.detach().requires_grad_(True) for k, t in params.tensors().items()}
            c2d = torch.zeros((params.capacity, 2), dtype=torch.float32,
                              device=params.vertex.device, requires_grad=True)
            pkg = M.forward(M.TriangleParams(**leaves), state, camera, background, model_cfg,
                            settings, is_training=True, center2d_offset=c2d, impl=impl)
            loss = loss_fn(pkg, camera, M.TriangleParams(**leaves), state, weights)
            gs = torch.autograd.grad(loss, [leaves[n] for n in names] + [c2d],
                                     allow_unused=True)
            gs = [torch.zeros_like(x) if g is None else g
                  for x, g in zip([leaves[n] for n in names] + [c2d], gs)]
            sums = {"loss": loss.detach(), "c2d": gs[-1],
                    **{f"g.{n}": g for n, g in zip(names, gs[:-1])}}
            return sums, {}

        sums, _ = dp_views(group, cameras, one_view, idle_camera)
        grads = M.TriangleParams(**{n: sums[f"g.{n}"] for n in names})
        params, opt = M.adam_update(params, opt, grads, lrs)
        return params, opt, state, sums["loss"], sums["c2d"]

    return step
