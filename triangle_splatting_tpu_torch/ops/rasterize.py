"""Differentiable triangle-splat rasterization — the public op.

Port of ``triangle_splatting_tpu/ops/rasterize.py`` (variant "2D"):

  1. SH -> per-triangle color               PyTorch, autograd   (sh.py)
  2. screen-space preprocess                PyTorch, autograd   (projection.py)
  3. tile binning (sort + ranges)           no grad, kernel B3  (binning.py)
  4. gather + pack per-pair fields          autograd.Function   (backward:
                                            owner sort + kernel B4)
  5. per-tile blend                         autograd.Function   (kernels B1/B2)

The two ``torch.autograd.Function``s take the place of the JAX package's
two ``custom_vjp``s; every other gradient comes from autograd.
``impl="oracle"`` swaps stages 3-5 for the dense oracle.

On CUDA tensors stages 3-5 launch the hand-written kernels; on CPU tensors
the kernels' plain PyTorch versions run instead (the tests).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import sh as sh_mod
from .binning import Binning, bin_triangles
from .cuda.blend import ALIGN, LIVE_GRAD_ROWS, blend_backward, blend_forward
from .cuda.streams import segment_reduce_pairs
from .oracle import blend_oracle
from .projection import Preprocessed, RasterSettings, preprocess_2d
from ..utils.camera import Camera


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def triangle_field_matrix(prep: Preprocessed, opacity: torch.Tensor) -> torch.Tensor:
    """Per-triangle packed kernel fields (P, 16), differentiable.

    The barycentrics are affine in pixel coordinates,
    ``a1 = cross(v2 - pix, v3 - pix) / area2 = f0 + f1*px + f2*py``, so the
    kernel's inner loop is a few multiply-adds per (pair, pixel).
    """
    v1, v2, v3 = prep.v1_2d, prep.v2_2d, prep.v3_2d
    area2 = torch.where(prep.valid, prep.area2, torch.ones_like(prep.area2))
    inv = 1.0 / area2
    f0 = (v2[:, 0] * v3[:, 1] - v2[:, 1] * v3[:, 0]) * inv
    f1 = (v2[:, 1] - v3[:, 1]) * inv
    f2 = (v3[:, 0] - v2[:, 0]) * inv
    f3 = (v3[:, 0] * v1[:, 1] - v3[:, 1] * v1[:, 0]) * inv
    f4 = (v3[:, 1] - v1[:, 1]) * inv
    f5 = (v1[:, 0] - v3[:, 0]) * inv
    rgb, vd, nrm = prep.rgb, prep.v_depth, prep.normal_view
    fields = torch.stack([
        f0, f1, f2, f3, f4, f5, opacity,
        rgb[:, 0], rgb[:, 1], rgb[:, 2],
        vd[:, 2],                                  # d0
        nrm[:, 0], nrm[:, 1], nrm[:, 2],
        vd[:, 0] - vd[:, 2], vd[:, 1] - vd[:, 2],  # d1, d2
    ], dim=1)                                      # (P, 16)
    return torch.where(prep.valid[:, None], fields, torch.zeros_like(fields))


class PackPairFields(torch.autograd.Function):
    """ONE gather of the per-triangle field matrix into the aligned pair
    order, (P, 16) -> (16, MA).

    Backward (``rasterize.py:_pack_bwd`` of the JAX package): sort the live
    gradient rows by owning triangle (empty slots get the sentinel P and
    sort to the tail), after which triangle t's pairs occupy exactly
    [tri_offsets[t], tri_offsets[t+1]); then kernel B4 sums each segment.
    Only the ``live_rows`` leading rows can be nonzero (the blend backward
    writes structural zeros below them), so only those ride the sort.
    """

    @staticmethod
    def forward(ctx, field_matrix, pair_tri, tri_offsets, num_pairs, live_rows):
        valid = pair_tri >= 0
        rows = field_matrix[pair_tri.clamp_min(0).long()]         # (MA, 16)
        rows = torch.where(valid[:, None], rows, torch.zeros_like(rows))
        ctx.save_for_backward(pair_tri, tri_offsets, num_pairs)
        ctx.live_rows = live_rows
        return rows.t().contiguous()                              # (16, MA)

    @staticmethod
    def backward(ctx, d):
        pair_tri, tri_offsets, num_pairs = ctx.saved_tensors
        p = tri_offsets.shape[0] - 1
        key = torch.where(pair_tri >= 0, pair_tri, torch.full_like(pair_tri, p))
        order = torch.sort(key, stable=True).indices
        cols = d[:ctx.live_rows].index_select(1, order).contiguous()
        starts = torch.minimum(tri_offsets[:-1], num_pairs).contiguous()
        ends = torch.minimum(tri_offsets[1:], num_pairs).contiguous()
        d16 = segment_reduce_pairs(cols, starts, ends, nvalid=num_pairs)
        return d16.t(), None, None, None, None


def pack_pair_fields(field_matrix: torch.Tensor, binning: Binning,
                     live_rows: int = 16) -> torch.Tensor:
    return PackPairFields.apply(field_matrix, binning.pair_tri,
                                binning.tri_offsets, binning.num_pairs,
                                live_rows)


class BlendTiles(torch.autograd.Function):
    """Kernels B1 (forward) and B2 (backward) around the packed fields.

    Outputs color, depth, normal, final_T, n_contrib; gradients flow to
    ``fields`` from the cotangents of color and final_T (depth and normal
    carry none with rich info off, as in the JAX kernel)."""

    @staticmethod
    def forward(ctx, fields, tile_starts, tile_counts, params, cfg):
        width, height, tile_h, tile_w = cfg
        color, depth, normal, final_T, n_contrib = blend_forward(
            fields, tile_starts, tile_counts, params, image_width=width,
            image_height=height, tile_h=tile_h, tile_w=tile_w)
        ctx.save_for_backward(fields, tile_starts, tile_counts, params,
                              final_T, n_contrib)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(n_contrib)
        return color, depth, normal, final_T, n_contrib

    @staticmethod
    def backward(ctx, g_color, g_depth, g_normal, g_final_T, g_nc):
        fields, tile_starts, tile_counts, params, final_T, n_contrib = ctx.saved_tensors
        width, height, tile_h, tile_w = ctx.cfg
        if g_color is None:
            g_color = torch.zeros((3, height, width), dtype=fields.dtype,
                                  device=fields.device)
        if g_final_T is None:
            g_final_T = torch.zeros_like(final_T)
        pair_grads = blend_backward(
            fields, tile_starts, tile_counts, params, final_T, n_contrib,
            g_color.contiguous(), g_final_T.contiguous(), image_width=width,
            image_height=height, tile_h=tile_h, tile_w=tile_w)
        return pair_grads, None, None, None, None


def rasterize(vertex: torch.Tensor, opacity: torch.Tensor,
              shs: Optional[torch.Tensor], camera: Camera,
              settings: RasterSettings, *, gamma=1.0,
              background=None, bg_depth=5000.0, active_sh_degree=0,
              center2d_offset: Optional[torch.Tensor] = None,
              colors: Optional[torch.Tensor] = None,
              alive_mask: Optional[torch.Tensor] = None,
              impl: str = "cuda", max_pairs: Optional[int] = None,
              need_stats: bool = False) -> dict:
    """Render triangles through a camera; differentiable w.r.t. vertex /
    opacity / shs (or colors) / center2d_offset.

    Returns a dict with render (3,H,W), depth (H,W), normal (3,H,W),
    radii (P,), visible_mask, contrib_sum / contrib_max (P,), final_T,
    n_contrib, overflow, num_pairs. ``impl="cuda"`` runs the tile pipeline
    through the kernel wrappers (the CUDA kernels for CUDA tensors, their
    plain versions for CPU tensors); ``impl="oracle"`` the dense oracle.

    Only the photo-training variant is ported: ``rasterizer_type`` "2D" with
    ``rich_info`` off. The contribution statistics (kernel B5) are not
    ported yet: ``need_stats=True`` raises, and contrib_sum/contrib_max are
    zeros on the kernel path.
    """
    if settings.rasterizer_type != "2D":
        raise NotImplementedError("rasterize: only rasterizer_type '2D' is ported")
    if impl not in ("cuda", "oracle"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "cuda" and settings.rich_info:
        raise NotImplementedError("rasterize: rich_info (depth/normal) kernels "
                                  "are not ported yet; use rich_info=False")
    if impl == "cuda" and need_stats:
        raise NotImplementedError("rasterize: need_stats=True needs kernel B5 "
                                  "(segment_reduce_stats), not ported yet")
    dev, dt = vertex.device, vertex.dtype
    P = vertex.shape[0]
    if background is None:
        background = torch.zeros(3, dtype=dt, device=dev)
    background = torch.as_tensor(background, dtype=dt, device=dev)
    gamma = torch.as_tensor(gamma, dtype=dt, device=dev)
    bg_depth = torch.as_tensor(bg_depth, dtype=dt, device=dev)
    if center2d_offset is None:
        center2d_offset = torch.zeros((P, 2), dtype=dt, device=dev)

    if colors is not None:
        rgb = colors
    else:
        center = vertex.mean(dim=1)
        rgb = sh_mod.eval_sh(shs, center, camera.camera_center,
                             active_sh_degree, settings.max_sh_degree)

    opac1 = opacity[..., 0] if opacity.dim() == 2 else opacity
    prep = preprocess_2d(vertex, center2d_offset, rgb, camera.world_view,
                         camera.full_proj, camera.tan_fovx, camera.tan_fovy,
                         settings, alive_mask=alive_mask, opacity=opac1,
                         gamma=gamma)

    if impl == "oracle":
        out = blend_oracle(prep, opac1, gamma, background, bg_depth, settings)
        return dict(render=out.color, depth=out.depth, normal=out.normal,
                    radii=prep.radii, visible_mask=prep.radii > 0,
                    contrib_sum=out.contrib_sum, contrib_max=out.contrib_max,
                    final_T=out.final_T, n_contrib=out.n_contrib,
                    overflow=torch.zeros((), dtype=torch.bool, device=dev),
                    num_pairs=torch.zeros((), dtype=torch.int32, device=dev))

    if max_pairs is None:
        max_pairs = _round_up(int(settings.pairs_per_triangle * P), ALIGN)

    binning = bin_triangles(prep.detach(), settings, max_pairs, align=ALIGN)
    fmat = triangle_field_matrix(prep, opac1)
    fields = pack_pair_fields(fmat, binning, LIVE_GRAD_ROWS[("2D", False)])
    zero = torch.zeros(1, dtype=dt, device=dev)
    params = torch.cat([gamma.reshape(1), background, bg_depth.reshape(1),
                        zero, zero, zero]).detach()
    cfg = (settings.image_width, settings.image_height, settings.tile_h,
           settings.tile_w)
    color, depth, normal, final_T, n_contrib = BlendTiles.apply(
        fields, binning.tile_starts, binning.tile_counts, params, cfg)
    zeros_p = torch.zeros((P,), dtype=dt, device=dev)
    return dict(render=color, depth=depth, normal=normal,
                radii=prep.radii, visible_mask=prep.radii > 0,
                contrib_sum=zeros_p, contrib_max=zeros_p.clone(),
                final_T=final_T, n_contrib=n_contrib,
                overflow=binning.overflow, num_pairs=binning.num_pairs)
