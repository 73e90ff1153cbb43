"""VanillaTS triangle model in PyTorch.

Port of ``triangle_splatting_tpu/models/triangle.py`` for the photo and
mesh training paths: the parameter / state / Adam containers, the derived
quantities, ``forward`` (STE, gamma rescale, background depth and
``render_up_scale`` as the JAX function does them), ``adam_update`` (eps
1e-15), ``create_from_points``, and the adaptive density control: the
statistics update, densification (clone / split into dead capacity
slots), scale, contribution and opacity pruning, scale and opacity
clipping, and opacity reset.

Parameters stay plain dataclasses of tensors at a fixed capacity C with an
``alive`` mask, the layout the JAX package uses, so weights convert one to
one (``convert.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import sh as sh_mod
from ..ops.projection import RasterSettings, safe_norm
from ..ops.rasterize import rasterize
from ..utils.camera import Camera
from .adc_common import (contribution_prune_mask, place_candidates, put_rows,
                         reset_contribution_stats)
from .model_utils import (get_inside_mask, inter_point_distance_np, inverse_sigmoid,
                          inverse_sigmoid_np, resize_linear)


@dataclass
class TriangleParams:
    """Learnable parameters at fixed capacity C."""
    vertex: torch.Tensor        # (C, 3, 3)
    opacity: torch.Tensor       # (C, 1) logits
    f_dc: torch.Tensor          # (C, 1, 3)
    f_rest: torch.Tensor        # (C, K-1, 3)
    affine_weight: Optional[torch.Tensor] = None   # (V, 3, 3)
    affine_bias: Optional[torch.Tensor] = None     # (V, 3)

    @property
    def capacity(self) -> int:
        return self.vertex.shape[0]

    def tensors(self) -> dict:
        """Non-None fields by name."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) is not None}


@dataclass
class TriangleState:
    """Non-learnable model state (densification statistics + schedules)."""
    alive: torch.Tensor           # (C,) bool
    gradient_accum: torch.Tensor  # (C,)
    gradient_denom: torch.Tensor  # (C,)
    max_radii2d: torch.Tensor     # (C,)
    contrib_sum: torch.Tensor     # (C,)
    contrib_max: torch.Tensor     # (C,)
    contrib_denom: torch.Tensor   # (C,)
    gamma: torch.Tensor           # () f32
    active_sh_degree: torch.Tensor  # () i32

    @staticmethod
    def create(capacity: int, gamma: float = 1.0, device="cuda") -> "TriangleState":
        dev = resolve_device(device)

        def z():
            return torch.zeros((capacity,), dtype=torch.float32, device=dev)
        return TriangleState(
            alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            gradient_accum=z(), gradient_denom=z(), max_radii2d=z(),
            contrib_sum=z(), contrib_max=z(), contrib_denom=z(),
            gamma=torch.tensor(gamma, dtype=torch.float32, device=dev),
            active_sh_degree=torch.tensor(0, dtype=torch.int32, device=dev))


@dataclass
class AdamState:
    m: TriangleParams
    v: TriangleParams
    step: int = 0

    @staticmethod
    def create(params: TriangleParams) -> "AdamState":
        def zeros():
            return TriangleParams(**{k: torch.zeros_like(t)
                                     for k, t in params.tensors().items()})
        return AdamState(m=zeros(), v=zeros(), step=0)


@dataclass(frozen=True)
class ModelConfig:
    """Static model switches."""
    max_sh_degree: int = 3
    use_color_affine: bool = False
    back_culling: bool = False
    back_culling_prob: float = 1.0
    ste_threshold: Optional[float] = None
    gamma_rescale: bool = False
    render_up_scale: Optional[int] = None
    rasterizer_type: str = "2D"


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------

def get_xyz(params: TriangleParams) -> torch.Tensor:
    return params.vertex.mean(dim=1)


def get_scaling(params: TriangleParams) -> torch.Tensor:
    """Mean side length per triangle (safe_norm: dead slots are zero
    triangles and a plain norm's gradient would be NaN)."""
    v = params.vertex
    l1 = safe_norm(v[:, 2] - v[:, 1])
    l2 = safe_norm(v[:, 0] - v[:, 2])
    l3 = safe_norm(v[:, 1] - v[:, 0])
    return (l1 + l2 + l3) / 3.0


def get_opacity(params: TriangleParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def get_features(params: TriangleParams) -> torch.Tensor:
    return torch.cat([params.f_dc, params.f_rest], dim=1)


def rescale_triangles(vertex: torch.Tensor, ratio) -> torch.Tensor:
    """Scale triangles about their centroid."""
    center = vertex.mean(dim=1, keepdim=True)
    ratio = torch.as_tensor(ratio, dtype=vertex.dtype, device=vertex.device)
    if ratio.dim() == 1:
        ratio = ratio[:, None, None]
    return (vertex - center) * ratio + center


def gamma_rescale_ratio(gamma) -> torch.Tensor:
    """Keep the integrated splat opacity invariant across gamma:
    1/sqrt(2^b * b * Gamma(b)), b = 1/gamma."""
    b = 1.0 / torch.as_tensor(gamma, dtype=torch.float32)
    log_val = b * math.log(2.0) + torch.log(b) + torch.lgamma(b)
    return torch.exp(-0.5 * log_val)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: TriangleParams, state: TriangleState, camera: Camera,
            background: torch.Tensor, cfg: ModelConfig,
            settings: RasterSettings, *, is_training: bool = True,
            center2d_offset: Optional[torch.Tensor] = None,
            impl: str = "cuda", max_pairs: Optional[int] = None,
            need_stats: bool = False,
            apply_color_affine: Optional[bool] = None) -> dict:
    """Render the scene through one camera.

    ``center2d_offset`` (C, 2) zeros is the densification-statistics hook;
    its gradient is the screen-space centroid gradient.

    With ``cfg.render_up_scale`` = up > 1 the scene is rasterized at up
    times the camera's size, and render, depth and normal come back at the
    camera's size through an antialiased bilinear resize (``F.interpolate``
    with ``antialias=True``, which matches ``jax.image.resize(...,
    "linear")``; a plain bilinear or average-pool downsample does not);
    radii are divided by up.

    With ``cfg.use_color_affine`` (and ``apply_color_affine`` not False)
    the render goes through the camera's 3x3 color transform and bias
    (``params.affine_weight[camera.uid]``) and is clipped to [0, 1]; the
    untransformed render is kept as ``render_original``.
    """
    vertex = params.vertex
    opacity = get_opacity(params)[:, 0]
    shs = get_features(params)
    alive = state.alive

    if cfg.gamma_rescale:
        vertex = rescale_triangles(vertex, gamma_rescale_ratio(state.gamma))

    if cfg.ste_threshold is not None:
        # straight-through estimator: binary opacity forward, identity grad
        hard = (opacity > cfg.ste_threshold).to(opacity.dtype)
        opacity = (hard - opacity).detach() + opacity

    # background depth: farthest vertex distance from the camera, dead
    # slots excluded
    dist = safe_norm(camera.camera_center[None, None, :] - vertex)
    bg_depth = torch.where(alive[:, None], dist, torch.zeros_like(dist)).amax()

    up = cfg.render_up_scale if (cfg.render_up_scale or 0) > 1 else 1
    H, W = settings.image_height, settings.image_width
    if up > 1:
        settings = replace(settings, image_width=W * up, image_height=H * up)

    out = rasterize(vertex, opacity, shs, camera, settings,
                    gamma=state.gamma, background=background,
                    bg_depth=bg_depth,
                    active_sh_degree=state.active_sh_degree,
                    center2d_offset=center2d_offset, alive_mask=alive,
                    impl=impl, max_pairs=max_pairs, need_stats=need_stats)

    if up > 1:
        out["render"] = resize_linear(out["render"], H, W)
        out["depth"] = resize_linear(out["depth"], H, W)
        out["normal"] = resize_linear(out["normal"], H, W)
        out["radii"] = out["radii"] // up

    render_pkg = dict(out)
    render_pkg.update(
        scaling=get_scaling(params), opacity=get_opacity(params),
        vertex=params.vertex,
        visible_mask=(out["radii"] > 0) & alive,
    )

    use_affine = cfg.use_color_affine if apply_color_affine is None else apply_color_affine
    if cfg.use_color_affine and use_affine and params.affine_weight is not None:
        img = render_pkg["render"]
        W3 = params.affine_weight[camera.uid]
        b3 = params.affine_bias[camera.uid]
        transformed = torch.einsum("chw,cd->dhw", img, W3) + b3[:, None, None]
        render_pkg["render_original"] = img
        render_pkg["render"] = transformed.clamp(0.0, 1.0)
    return render_pkg


# ---------------------------------------------------------------------------
# Adam (torch semantics, per-group learning rates)
# ---------------------------------------------------------------------------

PARAM_GROUPS = ("vertex", "opacity", "f_dc", "f_rest",
                "affine_weight", "affine_bias")


@torch.no_grad()
def adam_update(params: TriangleParams, opt: AdamState,
                grads: TriangleParams, lrs: dict,
                beta1: float = 0.9, beta2: float = 0.999,
                eps: float = 1e-15):
    """One Adam step with per-group lrs (eps 1e-15, as the reference).

    Returns new (params, opt); the inputs are not modified. The bias
    corrections are float32, as the JAX function computes them.
    """
    step = opt.step + 1
    bc1 = float(np.float32(1.0) - np.float32(beta1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(beta2) ** np.float32(step))

    new_p, new_m, new_v = {}, {}, {}
    for name in PARAM_GROUPS:
        p = getattr(params, name)
        if p is None:
            new_p[name], new_m[name], new_v[name] = None, None, None
            continue
        if name in lrs:
            lr_name = name
        elif name in ("affine_weight", "affine_bias"):
            lr_name = "affine"      # both affine tensors share one schedule
        else:
            raise KeyError(f"no learning rate for parameter group {name!r}")
        g = getattr(grads, name)
        m = getattr(opt.m, name)
        v = getattr(opt.v, name)
        m2 = beta1 * m + (1 - beta1) * g
        v2 = beta2 * v + (1 - beta2) * g * g
        update = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        new_p[name] = p - lrs[lr_name] * update
        new_m[name] = m2
        new_v[name] = v2

    return (TriangleParams(**new_p),
            AdamState(m=TriangleParams(**new_m), v=TriangleParams(**new_v),
                      step=step))


def _mask_rows(leaf: torch.Tensor, mask: torch.Tensor, value=0.0) -> torch.Tensor:
    """Set the rows of a (C, ...) leaf where mask is True to ``value``."""
    m = mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
    return torch.where(m, torch.full_like(leaf, value), leaf)


@torch.no_grad()
def zero_moments(opt: AdamState, mask: torch.Tensor,
                 groups=("vertex", "opacity", "f_dc", "f_rest")) -> AdamState:
    """Reset the Adam moments of the selected rows (the reference's state
    surgery on pruned rows)."""
    def fix(tp: TriangleParams) -> TriangleParams:
        kw = {}
        for name in PARAM_GROUPS:
            leaf = getattr(tp, name)
            kw[name] = leaf if leaf is None or name not in groups else _mask_rows(leaf, mask)
        return TriangleParams(**kw)
    return AdamState(m=fix(opt.m), v=fix(opt.v), step=opt.step)


# ---------------------------------------------------------------------------
# Initialization (host side)
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def setup_color_affine(params: TriangleParams, view_count: int) -> TriangleParams:
    """Identity per-view color transforms: (V, 3, 3) weights and (V, 3)
    biases on the device of the params."""
    dev = params.vertex.device
    w = torch.eye(3, dtype=torch.float32, device=dev)[None].repeat(view_count, 1, 1)
    return replace(params, affine_weight=w,
                   affine_bias=torch.zeros((view_count, 3), dtype=torch.float32, device=dev))


def create_from_points(points: np.ndarray, colors: np.ndarray,
                       normals: Optional[np.ndarray], cfg: ModelConfig,
                       init_opacity=0.1, capacity: Optional[int] = None,
                       capacity_factor: float = 1.0, seed: int = 0,
                       duplicate_count: int = 1, device="cuda"):
    """Build equilateral triangles around points, on the host with the JAX
    function's numpy code (same seed -> same triangles), then move them to
    ``device``. Returns (params, state) at capacity >= number of triangles.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    n0 = points.shape[0]
    if normals is None or not np.any(normals):
        normals = rng.normal(size=(n0, 3)).astype(np.float32)
    normals = normals / np.linalg.norm(normals, axis=1, keepdims=True)

    shs = ((colors - 0.5) / sh_mod.SH_C0).astype(np.float32)
    scaling = inter_point_distance_np(points)[:, None]

    if duplicate_count > 1:
        reps_p, reps_s, reps_n = [points], [shs], [normals]
        for _ in range(duplicate_count - 1):
            offset = (rng.uniform(size=(n0, 3)).astype(np.float32) * 2 - 1) * 0.5 * scaling
            reps_p.append(points + offset)
            reps_s.append(shs)
            reps_n.append(normals)
        points = np.concatenate(reps_p, 0)
        shs = np.concatenate(reps_s, 0)
        normals = np.concatenate(reps_n, 0)
        scaling = inter_point_distance_np(points)[:, None]

    n = points.shape[0]
    up = np.array([0, 0, 1], np.float32)
    u = np.cross(np.broadcast_to(up, (n, 3)), normals)
    bad = np.linalg.norm(u, axis=1) < 1e-10
    u[bad] = np.array([1, 0, 0], np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(normals, u)
    badv = np.linalg.norm(v, axis=1) < 1e-10
    v[badv] = np.array([0, 1, 0], np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)

    v1 = points + u * scaling
    v2 = points + (-0.5 * u + (math.sqrt(3) / 2) * v) * scaling
    v3 = points + (-0.5 * u - (math.sqrt(3) / 2) * v) * scaling
    vertex = np.stack([v1, v2, v3], axis=1)

    if init_opacity == "random":
        opacities = inverse_sigmoid_np(rng.uniform(size=(n, 1)).astype(np.float32))
    else:
        opacities = np.full((n, 1), inverse_sigmoid_np(float(init_opacity)), np.float32)

    K = (cfg.max_sh_degree + 1) ** 2
    f_dc = shs[:, None, :]
    f_rest = np.zeros((n, K - 1, 3), np.float32)

    if cfg.back_culling:
        # duplicate every triangle with flipped winding so both sides exist
        vertex = np.concatenate([vertex, vertex[:, ::-1, :]], axis=0)
        opacities = np.concatenate([opacities, opacities], axis=0)
        f_dc = np.concatenate([f_dc, f_dc], axis=0)
        f_rest = np.concatenate([f_rest, f_rest], axis=0)
        n *= 2

    cap = capacity if capacity is not None else _round_up(
        max(int(n * capacity_factor), n), 256)

    def pad(x):
        x = np.concatenate([x, np.zeros((cap - n,) + x.shape[1:], x.dtype)], axis=0)
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    params = TriangleParams(vertex=pad(vertex), opacity=pad(opacities),
                            f_dc=pad(f_dc), f_rest=pad(f_rest))
    state = TriangleState.create(cap, device=dev)
    state.alive = torch.as_tensor(np.arange(cap) < n).to(dev)
    return params, state


# ---------------------------------------------------------------------------
# Adaptive density control (fixed shape: rows die, the capacity stays)
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_statistics(state: TriangleState, center2d_grad: torch.Tensor,
                      radii: torch.Tensor, contrib_sum: torch.Tensor,
                      contrib_max: torch.Tensor,
                      visible: torch.Tensor) -> TriangleState:
    """Accumulate the ADC statistics of one view over its visible rows: the
    screen-space centroid gradient norm and a view count, the running max
    of the per-view contribution sum and max, and of the radius."""
    vis = visible
    visf = vis.to(torch.float32)
    gnorm = torch.linalg.vector_norm(center2d_grad, dim=-1)

    def running_max(old, new):
        return torch.where(vis, torch.maximum(old, new), old)

    return replace(
        state,
        gradient_accum=state.gradient_accum + torch.where(vis, gnorm, torch.zeros_like(gnorm)),
        gradient_denom=state.gradient_denom + visf,
        contrib_sum=running_max(state.contrib_sum, contrib_sum),
        contrib_max=running_max(state.contrib_max, contrib_max),
        contrib_denom=state.contrib_denom + visf,
        max_radii2d=running_max(state.max_radii2d, radii.to(torch.float32)),
    )


@torch.no_grad()
def prune(params: TriangleParams, opt: AdamState, state: TriangleState,
          prune_mask: torch.Tensor):
    """Deactivate rows: their statistics and Adam moments are cleared so a
    later reuse of the slot starts clean. Returns (params, opt, state)."""
    prune_mask = prune_mask & state.alive

    def zero(x):
        return torch.where(prune_mask, torch.zeros_like(x), x)

    state = replace(
        state, alive=state.alive & ~prune_mask,
        gradient_accum=zero(state.gradient_accum),
        gradient_denom=zero(state.gradient_denom),
        max_radii2d=zero(state.max_radii2d),
        contrib_sum=zero(state.contrib_sum),
        contrib_max=zero(state.contrib_max),
        contrib_denom=zero(state.contrib_denom),
    )
    return params, zero_moments(opt, prune_mask), state


@torch.no_grad()
def opacity_pruning(params, opt, state, threshold):
    """Prune alive rows whose opacity is below ``threshold``. Returns
    (params, opt, state, count)."""
    mask = (get_opacity(params)[:, 0] < threshold) & state.alive
    return prune(params, opt, state, mask) + (mask.sum(),)


@torch.no_grad()
def opacity_clipping(params, opt, state, threshold):
    """Push the opacity logit of alive rows above ``threshold`` to 10 and
    zero their ``opacity`` Adam moments (the other groups keep theirs).
    Returns (params, opt, state, count)."""
    mask = (get_opacity(params)[:, 0] > threshold) & state.alive
    params = replace(params, opacity=_mask_rows(params.opacity, mask, 10.0))
    return params, zero_moments(opt, mask, groups=("opacity",)), state, mask.sum()


@torch.no_grad()
def scale_pruning(params, opt, state, radii_threshold, scale_threshold):
    """Prune rows whose largest screen radius or mean side length exceeds
    its threshold. Returns (params, opt, state, count)."""
    mask = ((state.max_radii2d > radii_threshold)
            | (get_scaling(params) > scale_threshold)) & state.alive
    return prune(params, opt, state, mask) + (mask.sum(),)


@torch.no_grad()
def contribution_pruning(params, opt, state, *, min_view_count,
                         target_point_num, prune_ratio, max_prune_ratio,
                         contrib_max_ratio, scene_bbox=None,
                         ste_threshold=None, inter_point_dist=None,
                         sparsity_retain_ratio=0.0):
    """Prune the lowest-contribution rows toward ``target_point_num``
    (``adc_common.contribution_prune_mask``) and reset the contribution
    statistics of every row the ranking considered. ``inter_point_dist``
    (C,), if given, retains the sparsest rows of those to prune. Returns
    (params, opt, state, count)."""
    alive = state.alive
    inside = get_inside_mask(get_xyz(params), scene_bbox) & alive
    if ste_threshold is not None:
        inside = inside & (get_opacity(params)[:, 0] > ste_threshold)
    prune_mask, select = contribution_prune_mask(
        state, inside, min_view_count=min_view_count,
        target_point_num=target_point_num, prune_ratio=prune_ratio,
        max_prune_ratio=max_prune_ratio, contrib_max_ratio=contrib_max_ratio,
        inter_point_dist=inter_point_dist,
        sparsity_retain_ratio=sparsity_retain_ratio)
    state = reset_contribution_stats(state, select)
    return prune(params, opt, state, prune_mask) + (prune_mask.sum(),)


@torch.no_grad()
def scale_clipping(params, opt, state, scale_max):
    """Shrink alive rows whose mean side length exceeds ``scale_max``
    about their centroid down to it and zero their ``vertex`` moments.
    Returns (params, opt, state, count)."""
    scaling = get_scaling(params)
    mask = (scaling > scale_max) & state.alive
    # a tensor numerator: a Python scalar over a tensor is a reciprocal
    # times the scalar in PyTorch, an ulp away from the division
    num = torch.full_like(scaling, float(np.float32(scale_max)))
    ratio = torch.where(mask, num / torch.clamp_min(scaling, 1e-12), torch.ones_like(scaling))
    new_v = rescale_triangles(params.vertex, ratio)
    params = replace(params, vertex=torch.where(mask[:, None, None], new_v, params.vertex))
    return params, zero_moments(opt, mask, groups=("vertex",)), state, mask.sum()


@torch.no_grad()
def opacity_reset(params, opt, state, reset_value):
    """Clamp every opacity down to ``reset_value`` and zero the whole
    ``opacity`` moments. Returns (params, opt, state)."""
    op = get_opacity(params)
    cap = torch.full_like(op, float(np.float32(reset_value)))
    params = replace(params, opacity=inverse_sigmoid(torch.minimum(op, cap)))
    every = torch.ones(params.capacity, dtype=torch.bool, device=op.device)
    return params, zero_moments(opt, every, groups=("opacity",)), state


def _side_lengths(v: torch.Tensor) -> torch.Tensor:
    """(C, 3) lengths of the sides opposite each vertex. The squares are
    accumulated as fused multiply-adds rounded to float32 after each step
    (x0^2, then + x1^2, then + x2^2), which is how the JAX reference's norm
    rounds on the CPU: densify splits along the longest side, and the
    initial triangles are equilateral, so the argmax hangs on the last
    ulp. The steps run in float64 (each product exact), and so does the
    square root, rounded once to float32: PyTorch's vectorized float32
    sqrt on the CPU is not always correctly rounded, the card's is."""
    def norm(d):
        x = d.to(torch.float64)
        acc = (x[:, 0] * x[:, 0]).to(torch.float32)
        for i in (1, 2):
            acc = (x[:, i] * x[:, i] + acc.to(torch.float64)).to(torch.float32)
        return torch.sqrt(acc.to(torch.float64)).to(torch.float32)
    return torch.stack([norm(v[:, 2] - v[:, 1]), norm(v[:, 0] - v[:, 2]),
                        norm(v[:, 1] - v[:, 0])], dim=1)


@torch.no_grad()
def densify(params: TriangleParams, opt: AdamState, state: TriangleState,
            grad_threshold, min_view_count, split_scale_threshold):
    """Clone small and split large high-gradient triangles into dead
    capacity slots (fixed shape, the JAX function's semantics).

    A row grows when it was seen in at least ``min_view_count`` views and
    its mean screen-space gradient exceeds ``grad_threshold``; it is cloned
    (a copy) when its mean side length is at most ``split_scale_threshold``
    and otherwise split along its longest side into two halves. New rows
    get zero Adam moments and cleared statistics; every selected row's
    gradient statistics are reset; a split's original is pruned only when
    both halves were placed. Returns (params, opt, state, grown, overflow).
    """
    C = params.capacity
    select = state.gradient_denom >= min_view_count
    grow = select & (state.gradient_accum > grad_threshold * state.gradient_denom) & state.alive
    large = get_scaling(params) > split_scale_threshold
    clone_mask = grow & ~large       # original kept + 1 copy
    split_mask = grow & large        # original pruned + 2 halves

    v = params.vertex
    lside = torch.argmax(_side_lengths(v), dim=1)
    r = torch.arange(C, device=v.device)
    p1 = (lside + 1) % 3
    p2 = (lside + 2) % 3
    mid = (v[r, p1] + v[r, p2]) / 2
    tri1 = torch.stack([v[r, lside], v[r, p1], mid], dim=1)
    tri2 = torch.stack([v[r, lside], mid, v[r, p2]], dim=1)
    new_vertex = torch.stack([torch.where(split_mask[:, None, None], tri1, v), tri2],
                             dim=1).reshape(2 * C, 3, 3)
    new_valid = torch.stack([clone_mask | split_mask, split_mask], dim=1).reshape(2 * C)

    take, dst, placed, both_placed, overflow = place_candidates(state.alive, new_valid,
                                                                split_mask)
    src = take // 2
    params = replace(params, vertex=put_rows(v, dst, new_vertex[take]),
                     opacity=put_rows(params.opacity, dst, params.opacity[src]),
                     f_dc=put_rows(params.f_dc, dst, params.f_dc[src]),
                     f_rest=put_rows(params.f_rest, dst, params.f_rest[src]))
    opt = zero_moments(opt, placed)

    def zero(x, where):
        return torch.where(where, torch.zeros_like(x), x)
    clear = placed | select
    state = replace(
        state, alive=state.alive | placed,
        gradient_accum=zero(state.gradient_accum, clear),
        gradient_denom=zero(state.gradient_denom, clear),
        max_radii2d=zero(state.max_radii2d, placed),
        contrib_sum=zero(state.contrib_sum, placed),
        contrib_max=zero(state.contrib_max, placed),
        contrib_denom=zero(state.contrib_denom, placed))
    params, opt, state = prune(params, opt, state, split_mask & both_placed)
    return params, opt, state, grow.sum(), overflow


@torch.no_grad()
def densify_stats(state, min_view_count) -> torch.Tensor:
    """[p50, p99, max, n_eligible] of the mean screen-space gradient that
    ``densify`` compares with its threshold, over the alive rows seen in at
    least ``min_view_count`` views (the JAX trainer's log of them, taken
    before densify resets them): the order statistics at 0.5 and 0.01 of
    the eligible count from the top of the sorted (C,) means."""
    ok = state.alive & (state.gradient_denom >= min_view_count)
    mean = state.gradient_accum / torch.clamp_min(state.gradient_denom, 1.0)
    g = torch.where(ok, mean, torch.zeros_like(mean))
    srt = torch.sort(g).values
    cnt = ok.sum()
    C = g.shape[0]

    def at(q):
        i = C - 1 - (cnt.to(torch.float32) * q).to(torch.int64)
        return srt[torch.clamp(i, 0, C - 1)]
    return torch.stack([at(0.5), at(0.01), srt[-1], cnt.to(torch.float32)])
