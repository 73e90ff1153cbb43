"""VanillaTS triangle model in PyTorch.

Port of ``triangle_splatting_tpu/models/triangle.py`` for the photo and
mesh training paths: the parameter / state / Adam containers, the derived
quantities, ``forward`` (STE, gamma rescale, background depth and
``render_up_scale`` as the JAX function does them), ``adam_update`` (eps
1e-15), ``create_from_points``, and the adaptive density control the mesh
recipe runs (statistics update, scale and contribution pruning). The
other ADC operations (densify, opacity pruning / clipping, scale
clipping, opacity reset) are not ported yet.

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
from .adc_common import contribution_prune_mask, reset_contribution_stats
from .model_utils import get_inside_mask, inter_point_distance_np, inverse_sigmoid_np


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

def _downsample(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(..., h, w) -> (..., H, W), antialiased bilinear (the triangle
    filter widened by the scale, as ``jax.image.resize`` "linear")."""
    lead = x.shape[:-2]
    y = torch.nn.functional.interpolate(
        x.reshape((1, -1) + x.shape[-2:]), size=(H, W), mode="bilinear",
        align_corners=False, antialias=True)
    return y.reshape(lead + (H, W))


def forward(params: TriangleParams, state: TriangleState, camera: Camera,
            background: torch.Tensor, cfg: ModelConfig,
            settings: RasterSettings, *, is_training: bool = True,
            center2d_offset: Optional[torch.Tensor] = None,
            impl: str = "cuda", max_pairs: Optional[int] = None,
            need_stats: bool = False) -> dict:
    """Render the scene through one camera.

    ``center2d_offset`` (C, 2) zeros is the densification-statistics hook;
    its gradient is the screen-space centroid gradient.

    With ``cfg.render_up_scale`` = up > 1 the scene is rasterized at up
    times the camera's size, and render, depth and normal come back at the
    camera's size through an antialiased bilinear resize (``F.interpolate``
    with ``antialias=True``, which matches ``jax.image.resize(...,
    "linear")``; a plain bilinear or average-pool downsample does not);
    radii are divided by up.
    """
    if cfg.use_color_affine:
        raise NotImplementedError("color affine is not ported yet")
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
        out["render"] = _downsample(out["render"], H, W)
        out["depth"] = _downsample(out["depth"], H, W)
        out["normal"] = _downsample(out["normal"], H, W)
        out["radii"] = out["radii"] // up

    render_pkg = dict(out)
    render_pkg.update(
        scaling=get_scaling(params), opacity=get_opacity(params),
        vertex=params.vertex,
        visible_mask=(out["radii"] > 0) & alive,
    )
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
