"""Depth-sharded (triangle model-parallel) rendering over ranks (port of
``triangle_splatting_tpu/parallel/depth_sharded.py``).

Front-to-back blending factors exactly across any partition that respects
the per-pixel blend order:

    C = sum_k (prod_{j<k} T_j) * C_k        T = prod_k T_k

where rank k renders its slab of triangles alone (no background) into a
premultiplied color C_k and a transmittance T_k. The blend order is the
binning's sort key, the quantized centroid depth with ties in index
order, so contiguous slabs of that key give every pixel the single pass's
order. The port keys each slab by the whole scene's quantized depths
(``binning_depth_key``; the JAX package re-quantizes each shard over its
own range, which can swap tied triangles): the composite then differs
from one ``rasterize`` only by early termination. A slab does not see the
transmittance arriving from nearer slabs, so it keeps blending pixels the
single pass stops at T <= 1e-4; those contributions are weighted by the
small incoming transmittance in the composite. ``n_contrib`` is summed and
bounds the single pass's count from above.

Collectives: one all-gather of the (9, H, W) image pack a camera. Its
gradient is :class:`GatherSlabs`: the backward all-reduces the stacked
cotangent over the ranks and keeps this rank's slab. Every rank
back-propagates the same replicated loss, so the render's backward takes
the MEAN of the ranks' cotangents: a loss computed on all K ranks gives
each slab one pass's gradient, as one ``rasterize`` would. The hybrid step
asks for the SUM (the JAX transpose), which its 1/(D*K) loss scale
cancels (``parallel/hybrid.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.binning import depth_bits_for, quantize_depth
from ..ops.projection import RasterSettings, preprocess_2d, preprocess_3d
from ..ops.rasterize import rasterize
from .multihost import DataGroup


def partition_by_depth(depth_key: torch.Tensor, n_shards: int, alive=None) -> torch.Tensor:
    """Shard assignment: order triangles by the single pass's quantized
    centroid depth (``depth_key``, from :func:`binning_depth_key`), ties
    in index order (a stable sort), and split into equal contiguous slabs.
    Dead triangles sort last.

    Returns ``order`` (P,) int64 such that ``x[order].reshape(K, P/K, ...)``
    gives shard k the k-th nearest slab. P must be divisible by
    ``n_shards``.
    """
    P = depth_key.shape[0]
    if P % n_shards != 0:
        raise ValueError(f"triangle count {P} not divisible by {n_shards}")
    key = depth_key.to(torch.int32)
    if alive is not None:
        key = torch.where(alive, key, torch.full_like(key, 2 ** 30))
    return torch.argsort(key, stable=True)


@torch.no_grad()
def binning_depth_key(vertex: torch.Tensor, opacity: torch.Tensor, camera,
                      settings: RasterSettings, gamma=1.0, alive=None) -> torch.Tensor:
    """(P,) int32: the quantized depths one ``rasterize`` of all P
    triangles sorts its pairs by (the preprocess's centroid depth over its
    surviving triangles), for ``partition_by_depth`` and each slab's
    ``rasterize(..., depth_key=)``."""
    P = vertex.shape[0]
    dev, dt = vertex.device, vertex.dtype
    pre_fn = preprocess_2d if settings.rasterizer_type == "2D" else preprocess_3d
    prep = pre_fn(vertex, torch.zeros((P, 2), dtype=dt, device=dev),
                  torch.zeros((P, 3), dtype=dt, device=dev), camera.world_view,
                  camera.full_proj, camera.tan_fovx, camera.tan_fovy, settings,
                  alive_mask=alive, opacity=opacity,
                  gamma=torch.as_tensor(gamma, dtype=dt, device=dev))
    return quantize_depth(prep.depth, prep.valid, depth_bits_for(settings.num_tiles))


def composite_over(color, depth, normal, final_t, background=None, bg_depth=None):
    """Front-to-back over-composite of per-shard premultiplied renders.

    Args: (K, 3, H, W), (K, H, W), (K, 3, H, W), (K, H, W) stacked in
    near-to-far shard order. Returns the fused (color, depth, normal, T).
    """
    t_excl = torch.cumprod(torch.cat([torch.ones_like(final_t[:1]), final_t[:-1]], dim=0),
                           dim=0)                                    # (K, H, W)
    out_c = (color * t_excl[:, None]).sum(dim=0)
    out_d = (depth * t_excl).sum(dim=0)
    out_n = (normal * t_excl[:, None]).sum(dim=0)
    out_t = t_excl[-1] * final_t[-1]
    if background is not None:
        out_c = out_c + out_t * background[:, None, None]
    if bg_depth is not None:
        out_d = out_d + out_t * bg_depth
    return out_c, out_d, out_n, out_t


class GatherSlabs(torch.autograd.Function):
    """All-gather of every rank's slab pack, (K, ...); backward: this
    rank's slab of the stacked cotangent's MEAN over the ranks (one
    pass's gradient when every rank back-propagates the same loss), or
    its SUM with ``reduce="sum"`` (the JAX transpose)."""

    @staticmethod
    def forward(ctx, x, group: DataGroup, reduce: str):
        ctx.group, ctx.reduce = group, reduce
        out = group.all_gather(x)
        return out if group.group is not None else out.clone()

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group.all_reduce([grad.contiguous()], "sum")[0][ctx.group.rank]
        return (g / ctx.group.world if ctx.reduce == "mean" else g), None, None


def gather_slabs(x: torch.Tensor, group: DataGroup, reduce: str = "mean") -> torch.Tensor:
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")
    return GatherSlabs.apply(x, group, reduce)


def make_depth_sharded_render(group: DataGroup, settings: RasterSettings,
                              impl: str = "cuda", max_pairs: Optional[int] = None):
    """A render function over depth-slab-sharded triangles: rank k passes
    its slab (the k-th of ``partition_by_depth``, nearest first) and gets
    the fused render package, the same on every rank. ``max_pairs`` is
    each slab's pair budget (a near slab's triangles cover more tiles
    than a far one's: give it the single pass's budget). A loss of the
    fused render back-propagated on every rank gives each slab the single
    pass's gradient."""

    def render(vertex, opacity, rgb, alive, camera, background, bg_depth, gamma,
               depth_key: Optional[torch.Tensor] = None) -> dict:
        """vertex (P/K, 3, 3), opacity (P/K,), rgb (P/K, 3), alive (P/K,);
        ``depth_key`` the slab's part of ``binning_depth_key``."""
        dev = vertex.device
        out = rasterize(vertex, opacity, None, camera, settings, gamma=gamma,
                        background=torch.zeros(3, device=dev), bg_depth=0.0, colors=rgb,
                        alive_mask=alive, impl=impl, max_pairs=max_pairs,
                        depth_key=depth_key)
        packed = torch.cat([out["render"], out["normal"], out["depth"][None],
                            out["final_T"][None],
                            out["n_contrib"].to(torch.float32)[None]], dim=0)  # (9, H, W)
        gathered = gather_slabs(packed, group)                                 # (K, 9, H, W)
        color, depth, normal, final_t = composite_over(
            gathered[:, 0:3], gathered[:, 6], gathered[:, 3:6], gathered[:, 7],
            background=torch.as_tensor(background, dtype=torch.float32, device=dev),
            bg_depth=torch.as_tensor(bg_depth, dtype=torch.float32, device=dev))
        n_contrib = gathered[:, 8].detach().sum(dim=0).to(torch.int32)
        flags = group.all_reduce([torch.stack([out["overflow"].to(torch.int64),
                                               out["num_pairs"].to(torch.int64)])], "max")[0]
        return dict(render=color, depth=depth, normal=normal, final_T=final_t,
                    n_contrib=n_contrib, radii=out["radii"],
                    contrib_sum=out["contrib_sum"], contrib_max=out["contrib_max"],
                    overflow=flags[0] > 0, num_pairs=flags[1])

    return render
