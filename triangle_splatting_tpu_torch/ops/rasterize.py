"""Differentiable triangle- and Gaussian-splat rasterization — the public ops.

Port of ``triangle_splatting_tpu/ops/rasterize.py``: ``rasterize``
(triangles, variants "2D" and "3D") and ``rasterize_gaussian`` (variant
"GS", the EWA preprocess of ``gaussian.py`` in stage 2):

  1. SH -> per-triangle color               PyTorch, autograd   (sh.py)
  2. screen-space preprocess (2D or 3D)     PyTorch, autograd   (projection.py)
  3. tile binning (sort + ranges)           no grad, kernel B3  (binning.py)
  4. gather + pack per-pair fields          autograd.Function   (backward:
                                            owner sort + kernel B4)
  5. per-tile blend                         autograd.Function   (kernels B1/B2)
  6. contribution statistics (need_stats)   no grad: B1's per-pair stream,
                                            owner sort + kernel B5

The two ``torch.autograd.Function``s take the place of the JAX package's
two ``custom_vjp``s; every other gradient comes from autograd.
``impl="oracle"`` swaps stages 3-6 for the dense oracle.

On CUDA tensors stages 3-5 launch the hand-written kernels; on CPU tensors
the kernels' plain PyTorch versions run instead (the tests).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import sh as sh_mod
from .binning import Binning, bin_triangles
from .cuda.blend import ALIGN, LIVE_GRAD_ROWS, blend_backward, blend_forward, tile_order
from .cuda.streams import segment_reduce_pairs, segment_reduce_stats
from .gaussian import blend_oracle_gs, gaussian_field_matrix, preprocess_gaussian
from .oracle import blend_oracle, blend_oracle_3d
from .projection import (Preprocessed, Preprocessed3D, RasterSettings,
                         preprocess_2d, preprocess_3d)
from ..utils.camera import Camera


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def triangle_field_matrix(prep: Preprocessed, opacity: torch.Tensor) -> torch.Tensor:
    """Per-triangle packed kernel fields (P, 16) of the 2D variant,
    differentiable.

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


def triangle_field_matrix_3d(prep: Preprocessed3D, opacity: torch.Tensor,
                             tan_fovx, tan_fovy, width: int,
                             height: int) -> torch.Tensor:
    """Per-triangle packed kernel fields (P, 16) of the 3D variant,
    differentiable.

    The ray-plane barycentrics are ratios of affine forms in pixel
    coordinates: with the pixel ray r, D = r.n, a1 = (r.u1) / D and
    a2 = (r.u2) / D, where u1 = (C23*n - k*(n x (v2 - v3))) / n.n,
    k = v1.n and C23 = (v2 x v3).n. Each 3-vector w becomes the affine
    coefficients (c0, cx, cy) of r.w over the pixel grid. Fields: D 0..2,
    A1 3..5, A2 6..8, opacity 9, rgb 10..12, K = k 13, zeros 14..15.
    """
    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    n = prep.normal_view
    v1, v2, v3 = prep.v1_view, prep.v2_view, prep.v3_view
    nn = torch.sum(n * n, -1)
    inv_nn = 1.0 / torch.where(prep.valid, torch.clamp_min(nn, 1e-20),
                               torch.ones_like(nn))
    k = torch.sum(v1 * n, -1)
    C23 = torch.sum(cross(v2, v3) * n, -1)
    C31 = torch.sum(cross(v3, v1) * n, -1)
    u1 = (C23[:, None] * n - k[:, None] * cross(n, v2 - v3)) * inv_nn[:, None]
    u2 = (C31[:, None] * n - k[:, None] * cross(n, v3 - v1)) * inv_nn[:, None]

    def affine(w):
        c0 = (w[:, 2] + w[:, 0] * tan_fovx * (1.0 - width) / width
              + w[:, 1] * tan_fovy * (1.0 - height) / height)
        cx = 2.0 * tan_fovx * w[:, 0] / width
        cy = 2.0 * tan_fovy * w[:, 1] / height
        return c0, cx, cy

    rgb = prep.rgb
    zero = torch.zeros_like(k)
    fields = torch.stack([
        *affine(n), *affine(u1), *affine(u2), opacity,
        rgb[:, 0], rgb[:, 1], rgb[:, 2], k, zero, zero,
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


def step_order(tile_counts: torch.Tensor) -> Optional[torch.Tensor]:
    """B1's and B2's tile order for one step: ``tile_order`` on the card;
    None on the CPU, whose plain versions read no order."""
    return tile_order(tile_counts) if tile_counts.is_cuda else None


class BlendTiles(torch.autograd.Function):
    """Kernels B1 (forward) and B2 (backward) around the packed fields.

    Outputs color, depth, normal, final_T, n_contrib and the per-pair
    contribution stream (2, MA) (an empty (2, 0) tensor when ``cfg``'s
    stats flag is off); gradients flow to ``fields`` from the cotangents
    of color and final_T, and with ``cfg``'s rich flag of depth and normal
    (which carry none with rich info off, as in the JAX kernel; n_contrib
    and the stream are not differentiable). The order in which the
    kernels' blocks take the tiles is computed once a step, here
    (``step_order``), and handed to both."""

    @staticmethod
    def forward(ctx, fields, tile_starts, tile_counts, params, cfg):
        width, height, tile_h, tile_w, variant, stats, rich = cfg
        order = step_order(tile_counts)
        outs = blend_forward(
            fields, tile_starts, tile_counts, params, image_width=width,
            image_height=height, tile_h=tile_h, tile_w=tile_w, variant=variant,
            stats=stats, rich=rich, order=order)
        color, depth, normal, final_T, n_contrib = outs[:5]
        pair_contrib = outs[5] if stats else fields.new_zeros((2, 0))
        ctx.save_for_backward(fields, tile_starts, tile_counts, params,
                              final_T, n_contrib, order)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(n_contrib, pair_contrib)
        return color, depth, normal, final_T, n_contrib, pair_contrib

    @staticmethod
    def backward(ctx, g_color, g_depth, g_normal, g_final_T, g_nc, g_pc):
        fields, tile_starts, tile_counts, params, final_T, n_contrib, order = ctx.saved_tensors
        width, height, tile_h, tile_w, variant, _, rich = ctx.cfg

        def cotangent(g, shape):
            if g is None:
                return torch.zeros(shape, dtype=fields.dtype, device=fields.device)
            return g.contiguous()

        g_color = cotangent(g_color, (3, height, width))
        g_final_T = cotangent(g_final_T, (height, width))
        if rich:
            g_depth = cotangent(g_depth, (height, width))
            g_normal = cotangent(g_normal, (3, height, width))
        else:
            g_depth = g_normal = None
        pair_grads = blend_backward(
            fields, tile_starts, tile_counts, params, final_T, n_contrib,
            g_color, g_final_T, g_depth, g_normal, image_width=width,
            image_height=height, tile_h=tile_h, tile_w=tile_w, rich=rich,
            variant=variant, order=order)
        return pair_grads, None, None, None, None


@torch.no_grad()
def _contrib_stats(pair_contrib: torch.Tensor, binning: Binning, P: int):
    """Per-triangle (contrib_sum, contrib_max) from B1's per-pair stream
    (``ops/rasterize.py:_contrib_stats`` of the JAX package): one stable
    sort of the owner key (empty slots get P and sort to the tail), both
    rows gathered by its indices, after which triangle t owns columns
    [tri_offsets[t], tri_offsets[t+1]) clipped to num_pairs; then kernel
    B5. No gradient: the statistics only feed the ADC decisions."""
    key = torch.where(binning.pair_valid, binning.pair_tri,
                      torch.full_like(binning.pair_tri, P))
    order = torch.sort(key, stable=True).indices
    cols = pair_contrib.index_select(1, order)
    starts = torch.minimum(binning.tri_offsets[:-1], binning.num_pairs).contiguous()
    ends = torch.minimum(binning.tri_offsets[1:], binning.num_pairs).contiguous()
    return segment_reduce_stats(cols[0], cols[1], starts, ends,
                                nvalid=binning.num_pairs)


def _oracle_result(out, prep) -> dict:
    """The ``rasterize`` dict of a dense oracle's outputs."""
    dev = out.color.device
    return dict(render=out.color, depth=out.depth, normal=out.normal,
                radii=prep.radii, visible_mask=prep.radii > 0,
                contrib_sum=out.contrib_sum, contrib_max=out.contrib_max,
                final_T=out.final_T, n_contrib=out.n_contrib,
                overflow=torch.zeros((), dtype=torch.bool, device=dev),
                num_pairs=torch.zeros((), dtype=torch.int32, device=dev))


def _tile_pipeline(prep, fmat: torch.Tensor, params: torch.Tensor,
                   settings: RasterSettings, variant: str, need_stats: bool,
                   max_pairs: Optional[int]) -> dict:
    """Stages 3-6 on a preprocess and its per-primitive field matrix
    (P, 16): binning (B3), the pack (B4 in its backward), the blend (B1/B2
    in ``variant``) and with ``need_stats`` the per-primitive statistics
    (owner sort + B5). Returns the ``rasterize`` dict."""
    P = fmat.shape[0]
    dev, dt = fmat.device, fmat.dtype
    if max_pairs is None:
        max_pairs = _round_up(int(settings.pairs_per_triangle * P), ALIGN)
    binning = bin_triangles(prep.detach(), settings, max_pairs, align=ALIGN)
    fields = pack_pair_fields(fmat, binning, LIVE_GRAD_ROWS[(variant, settings.rich_info)])
    cfg = (settings.image_width, settings.image_height, settings.tile_h,
           settings.tile_w, variant, need_stats, settings.rich_info)
    color, depth, normal, final_T, n_contrib, pair_contrib = BlendTiles.apply(
        fields, binning.tile_starts, binning.tile_counts, params, cfg)
    if need_stats:
        contrib_sum, contrib_max = _contrib_stats(pair_contrib, binning, P)
    else:
        contrib_sum = torch.zeros((P,), dtype=dt, device=dev)
        contrib_max = torch.zeros((P,), dtype=dt, device=dev)
    return dict(render=color, depth=depth, normal=normal,
                radii=prep.radii, visible_mask=prep.radii > 0,
                contrib_sum=contrib_sum, contrib_max=contrib_max,
                final_T=final_T, n_contrib=n_contrib,
                overflow=binning.overflow, num_pairs=binning.num_pairs)


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

    The kernel path serves ``rasterizer_type`` "2D" (photo training) and
    "3D" (mesh training), with ``rich_info`` off or on (depth and normal
    composited and differentiable; off, depth is final_T * bg_depth and
    normal zeros, without gradient). ``need_stats=True`` (the ADC
    statistic window) runs B1 with its per-pair contribution stream and
    reduces it per triangle (owner sort + kernel B5) into contrib_sum /
    contrib_max, without gradient; with ``need_stats=False`` they are
    zeros and B5 does not run. Rich info and statistics together run B1's
    rich form with the stream in one launch (the renderer facade's form).
    """
    variant = settings.rasterizer_type
    if variant not in ("2D", "3D"):
        raise NotImplementedError(
            f"rasterize: rasterizer_type {variant!r} is not ported ('2D', '3D')")
    if impl not in ("cuda", "oracle"):
        raise ValueError(f"unknown impl {impl!r}")
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
    pre_fn = preprocess_2d if variant == "2D" else preprocess_3d
    prep = pre_fn(vertex, center2d_offset, rgb, camera.world_view,
                  camera.full_proj, camera.tan_fovx, camera.tan_fovy,
                  settings, alive_mask=alive_mask, opacity=opac1, gamma=gamma)

    if impl == "oracle":
        if variant == "2D":
            out = blend_oracle(prep, opac1, gamma, background, bg_depth, settings)
        else:
            out = blend_oracle_3d(prep, opac1, gamma, background, bg_depth,
                                  camera.tan_fovx, camera.tan_fovy, settings)
        return _oracle_result(out, prep)

    zero = torch.zeros(1, dtype=dt, device=dev)
    if variant == "2D":
        fmat = triangle_field_matrix(prep, opac1)
        sx = sy = zero
    else:
        fmat = triangle_field_matrix_3d(prep, opac1, camera.tan_fovx,
                                        camera.tan_fovy, settings.image_width,
                                        settings.image_height)
        # normal reconstruction scales at the rendered size (rich info)
        sx = (settings.image_width / (2.0 * camera.tan_fovx)).reshape(1)
        sy = (settings.image_height / (2.0 * camera.tan_fovy)).reshape(1)
    params = torch.cat([gamma.reshape(1), background, bg_depth.reshape(1),
                        sx.to(dt), sy.to(dt), zero]).detach()
    return _tile_pipeline(prep, fmat, params, settings, variant, need_stats, max_pairs)


def rasterize_gaussian(xyz: torch.Tensor, scale: torch.Tensor,
                       rotation: torch.Tensor, opacity: torch.Tensor,
                       shs: Optional[torch.Tensor], camera: Camera,
                       settings: RasterSettings, *, gamma=1.0,
                       background=None, bg_depth=5000.0, active_sh_degree=0,
                       colors: Optional[torch.Tensor] = None,
                       alive_mask: Optional[torch.Tensor] = None,
                       mean2d_offset: Optional[torch.Tensor] = None,
                       scale_modifier=1.0, impl: str = "cuda",
                       max_pairs: Optional[int] = None,
                       need_stats: bool = True) -> dict:
    """Render 3D Gaussians through a camera; differentiable w.r.t. xyz /
    scale / rotation / opacity / shs (or colors) / mean2d_offset (the
    densification-statistics hook: a zeros (P, 2) input whose gradient is
    the screen-space center gradient).

    Returns the dict of ``rasterize``. ``impl="cuda"`` runs the tile
    pipeline (binning with B3, the pack with B4 in its backward, B1/B2 in
    variant "GS"; with ``need_stats``, the default, B1's contribution
    stream, the owner sort and B5); ``impl="oracle"`` the dense oracle.
    ``settings.rich_info`` composites the depth (the normal is zero), and
    rich info and statistics run together.
    """
    if impl not in ("cuda", "oracle"):
        raise ValueError(f"unknown impl {impl!r}")
    dev, dt = xyz.device, xyz.dtype
    if background is None:
        background = torch.zeros(3, dtype=dt, device=dev)
    background = torch.as_tensor(background, dtype=dt, device=dev)
    gamma = torch.as_tensor(gamma, dtype=dt, device=dev)
    bg_depth = torch.as_tensor(bg_depth, dtype=dt, device=dev)

    if colors is not None:
        rgb = colors
    else:
        rgb = sh_mod.eval_sh(shs, xyz, camera.camera_center, active_sh_degree,
                             settings.max_sh_degree)

    opac1 = opacity[..., 0] if opacity.dim() == 2 else opacity
    prep = preprocess_gaussian(xyz, scale, rotation, rgb, camera.world_view,
                               camera.full_proj, camera.tan_fovx, camera.tan_fovy,
                               settings, alive_mask=alive_mask, opacity=opac1,
                               gamma=gamma, scale_modifier=scale_modifier,
                               mean2d_offset=mean2d_offset)

    if impl == "oracle":
        return _oracle_result(
            blend_oracle_gs(prep, opac1, gamma, background, bg_depth, settings), prep)

    params = torch.cat([gamma.reshape(1), background, bg_depth.reshape(1),
                        torch.zeros(3, dtype=dt, device=dev)]).detach()
    return _tile_pipeline(prep, gaussian_field_matrix(prep, opac1), params, settings, "GS",
                          need_stats, max_pairs)
