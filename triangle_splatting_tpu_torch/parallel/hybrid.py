"""Hybrid 2-D parallelism: camera data parallelism x depth-sharded
rendering in one step (port of ``triangle_splatting_tpu/parallel/hybrid.py``).

The D x K ranks form a grid, rank ``d * K + k`` at row d and column k:

- the **data** axis: the D ranks of a column (one per row) each render
  their own camera of the batch, as in ``parallel/mesh.py``;
- the **model** axis: the K ranks of a row split that row's camera into
  contiguous depth slabs, as in ``parallel/depth_sharded.py``, whose
  over-composite is exact.

Parameters stay replicated; the model axis divides the rasterizer's
working set (pairs, packed fields, images). Every rank of a row evaluates
the same loss on the replicated composite. The step's gather sums the
ranks' cotangents in its backward (``gather_slabs(..., reduce="sum")``, the
JAX transpose), so it counts each slab's image cotangent once per column
(a factor K), and the direct paths (regularizers, bg_depth) are computed
on every column (a factor K too). Scaling the local loss by 1/(D*K) and
summing the gradients over all D*K ranks cancels both:

    sum_{d,k} [ K * slab_grad_{d,k} + reg_grad_d ] / (D*K)
      = sum_d [ full_grad_d + reg_grad_d ] / D          (the camera-mean)

(The render's default gather, the MEAN of the cotangents, would give the
slab paths their single count but leave the direct paths K times over.)

Densification statistics keep per-view semantics: slab-local per-triangle
values go to their canonical rows of (C,) zeros, a SUM over the model axis
assembles each view's vectors, and the per-view deltas reduce over the
data axis (``parallel/mesh.py``).

KNOWN DEVIATION (statistics only, as in the JAX package): a slab starts at
transmittance 1 and cannot see the occlusion of nearer slabs, so
``contrib_sum`` / ``contrib_max`` of occluded triangles are overstated
against the single pass: occluded triangles look more important and are
pruned later, never earlier. ``gradient_accum`` and ``max_radii2d`` are
unaffected. Slabs are keyed by the whole scene's quantized depths
(``binning_depth_key``), so the blend order is the single pass's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..models import triangle as M
from ..ops.projection import RasterSettings
from ..ops.rasterize import rasterize
from .depth_sharded import binning_depth_key, composite_over, gather_slabs, partition_by_depth
from .mesh import reduce_view_statistics
from .multihost import DataGroup, world


@dataclass(frozen=True)
class HybridMesh:
    """This rank's three groups: ``data`` (the D ranks of its column,
    ranked by row), ``model`` (the K ranks of its row, ranked by column)
    and ``both`` (all D*K ranks)."""
    data: DataGroup
    model: DataGroup
    both: DataGroup

    @property
    def shape(self) -> tuple[int, int]:
        return self.data.size, self.model.size


def make_hybrid_mesh(n_data: int, n_model: int) -> HybridMesh:
    """The D x K grid over a job of exactly D*K ranks. ``dist.new_group``
    is collective: every rank creates every row and column group, in one
    order (columns, then rows)."""
    import torch.distributed as dist
    rank, n_ranks = world()
    n = n_data * n_model
    if n_ranks != n:
        raise ValueError(f"a {n_data} x {n_model} hybrid mesh needs {n} ranks, the job has "
                         f"{n_ranks}")
    d, k = divmod(rank, n_model)
    if not dist.is_initialized():
        one = DataGroup(size=1, rank=0, world=1)
        return HybridMesh(data=one, model=one, both=one)
    backend = dist.get_backend()
    cols = [dist.new_group([r * n_model + c for r in range(n_data)]) for c in range(n_model)]
    rows = [dist.new_group([r * n_model + c for c in range(n_model)]) for r in range(n_data)]
    return HybridMesh(
        data=DataGroup(size=n_data, rank=d, world=n_data, group=cols[k], backend=backend),
        model=DataGroup(size=n_model, rank=k, world=n_model, group=rows[d], backend=backend),
        both=DataGroup(size=n, rank=rank, world=n, group=dist.group.WORLD, backend=backend))


def make_hybrid_train_step(mesh: HybridMesh, settings: RasterSettings, loss_fn: Callable,
                           impl: str = "cuda", track_stats: bool = True):
    """A data x depth-sharded train step over TriangleParams.

    Args:
        loss_fn: ``(pkg, camera, params, state, weights) -> scalar`` for ONE
            camera; ``pkg`` holds the fused replicated render / depth /
            normal / final_T. The step averages it over the camera batch.
    Returns:
        ``step(params, opt, state, camera, background, lrs, weights) ->
        (params, opt, state, loss, aux)``, ``camera`` this rank's row's view.

    The rasterization is the facade-level one (SH colors, alive masking; no
    STE, up-scale or color affine: ``trainer.data_parallel`` runs the
    trainer's full step).
    """
    D, K = mesh.shape

    def step(params, opt, state, camera, background, lrs, weights):
        C = params.capacity
        if C % K != 0:
            raise ValueError(f"capacity {C} not divisible by model axis {K}")
        slab_len = C // K
        k = mesh.model.rank
        key = binning_depth_key(params.vertex.detach(), M.get_opacity(params)[:, 0].detach(),
                                camera, settings, state.gamma, state.alive)
        order = partition_by_depth(key, K, alive=state.alive)
        slab = order[k * slab_len:(k + 1) * slab_len]

        names = list(params.tensors())
        leaves = {n: t.detach().requires_grad_(True) for n, t in params.tensors().items()}
        p = M.TriangleParams(**leaves)
        c2d = torch.zeros((C, 2), dtype=torch.float32, device=p.vertex.device,
                          requires_grad=True)
        out = rasterize(p.vertex[slab], M.get_opacity(p)[slab, 0], M.get_features(p)[slab],
                        camera, settings, gamma=state.gamma,
                        background=torch.zeros(3, device=p.vertex.device), bg_depth=0.0,
                        active_sh_degree=state.active_sh_degree, center2d_offset=c2d[slab],
                        alive_mask=state.alive[slab], impl=impl, depth_key=key[slab],
                        need_stats=track_stats)
        # bg_depth from the full replicated params (models/triangle.py:forward)
        dist_ = M.safe_norm(camera.camera_center[None, None, :] - p.vertex)
        bg_depth = torch.where(state.alive[:, None], dist_, torch.zeros_like(dist_)).amax()
        packed = torch.cat([out["render"], out["normal"], out["depth"][None],
                            out["final_T"][None]], dim=0)                    # (8, H, W)
        gathered = gather_slabs(packed, mesh.model, reduce="sum")            # (K, 8, H, W)
        color, depth, normal, final_t = composite_over(
            gathered[:, 0:3], gathered[:, 6], gathered[:, 3:6], gathered[:, 7],
            background=background, bg_depth=bg_depth)
        pkg = dict(render=color, depth=depth, normal=normal, final_T=final_t)
        loss = loss_fn(pkg, camera, p, state, weights) / (D * K)
        wrt = [leaves[n] for n in names] + [c2d]
        gs = torch.autograd.grad(loss, wrt, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, gs)]

        *g_list, loss_sum = mesh.both.all_reduce(gs[:-1] + [loss.detach()], "sum")
        params, opt = M.adam_update(params, opt, M.TriangleParams(**dict(zip(names, g_list))),
                                    lrs)

        if track_stats:
            # this view's full vectors over the model axis, then the
            # per-view deltas over the data axis (mesh.py rules)
            zC = torch.zeros((C,), dtype=torch.float32, device=c2d.device)
            g_c2d, vis, radii, c_sum, c_max = mesh.model.all_reduce([
                gs[-1], zC.index_copy(0, slab, out["visible_mask"].to(torch.float32)),
                zC.index_copy(0, slab, out["radii"].to(torch.float32)),
                zC.index_copy(0, slab, out["contrib_sum"]),
                zC.index_copy(0, slab, out["contrib_max"])], "sum")
            state = reduce_view_statistics(
                state, vis > 0, torch.linalg.vector_norm(g_c2d * D, dim=-1), c_sum, c_max,
                radii, mesh.data)

        flags = mesh.both.all_reduce([torch.stack([out["overflow"].to(torch.int64),
                                                   out["num_pairs"].to(torch.int64)])],
                                     "max")[0]
        return params, opt, state, loss_sum, dict(overflow=flags[0] > 0, num_pairs=flags[1])

    return step
