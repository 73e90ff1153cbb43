"""VanillaGS Gaussian model in PyTorch.

Port of ``triangle_splatting_tpu/models/gaussian_model.py``: the parameter,
state and Adam containers at a fixed capacity C with an ``alive`` mask (the
JAX layout, so weights convert one to one, ``convert.py``), the getters,
``forward`` through ``rasterize_gaussian``, ``adam_update`` (eps 1e-15),
``create_from_points``, and the adaptive density control the VanillaGS
trainer runs: the statistics update, ``densify`` (clone / split into dead
capacity slots, the split's noise drawn from a ``torch.Generator`` or
given), ``prune``, the opacity, scale and contribution pruning, scale and
opacity clipping, and opacity reset.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import sh as sh_mod
from ..ops.projection import RasterSettings, safe_norm
from ..ops.rasterize import rasterize_gaussian
from ..utils.camera import Camera
from .adc_common import (contribution_prune_mask, place_candidates, put_rows,
                         reset_contribution_stats)
from .model_utils import (get_inside_mask, inter_point_distance_np, inverse_sigmoid,
                          inverse_sigmoid_np)

GS_PARAM_GROUPS = ("xyz", "scaling", "rotation", "opacity", "f_dc", "f_rest")


@dataclass
class GaussianParams:
    """Learnable parameters at fixed capacity C."""
    xyz: torch.Tensor          # (C, 3)
    scaling: torch.Tensor      # (C, 3) log-scales
    rotation: torch.Tensor     # (C, 4) unnormalized quaternions (wxyz)
    opacity: torch.Tensor      # (C, 1) logits
    f_dc: torch.Tensor         # (C, 1, 3)
    f_rest: torch.Tensor       # (C, K-1, 3)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class GaussianState:
    """Non-learnable model state (ADC statistics, gamma, SH degree)."""
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
    def create(capacity: int, gamma: float = 1.0, device="cuda") -> "GaussianState":
        dev = resolve_device(device)

        def z():
            return torch.zeros((capacity,), dtype=torch.float32, device=dev)
        return GaussianState(
            alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            gradient_accum=z(), gradient_denom=z(), max_radii2d=z(),
            contrib_sum=z(), contrib_max=z(), contrib_denom=z(),
            gamma=torch.tensor(gamma, dtype=torch.float32, device=dev),
            active_sh_degree=torch.tensor(0, dtype=torch.int32, device=dev))


@dataclass(frozen=True)
class GSModelConfig:
    max_sh_degree: int = 3


@dataclass
class GSAdamState:
    m: GaussianParams
    v: GaussianParams
    step: int = 0

    @staticmethod
    def create(params: GaussianParams) -> "GSAdamState":
        def zeros():
            return GaussianParams(**{k: torch.zeros_like(t) for k, t in params.tensors().items()})
        return GSAdamState(m=zeros(), v=zeros(), step=0)


def get_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def get_rotation(params: GaussianParams) -> torch.Tensor:
    return params.rotation / safe_norm(params.rotation)[:, None]


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def get_features(params: GaussianParams) -> torch.Tensor:
    return torch.cat([params.f_dc, params.f_rest], dim=1)


@torch.no_grad()
def adam_update(params: GaussianParams, opt: GSAdamState, grads: GaussianParams,
                lrs: dict, beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-15):
    """One Adam step with per-group lrs; the bias corrections in float32, as
    the JAX function computes them. Returns new (params, opt)."""
    step = opt.step + 1
    bc1 = float(np.float32(1.0) - np.float32(beta1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(beta2) ** np.float32(step))
    new_p, new_m, new_v = {}, {}, {}
    for name in GS_PARAM_GROUPS:
        g = getattr(grads, name)
        m = beta1 * getattr(opt.m, name) + (1 - beta1) * g
        v = beta2 * getattr(opt.v, name) + (1 - beta2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[name] = getattr(params, name) - lrs[name] * update
        new_m[name], new_v[name] = m, v
    return (GaussianParams(**new_p),
            GSAdamState(m=GaussianParams(**new_m), v=GaussianParams(**new_v), step=step))


def _mask_rows(leaf: torch.Tensor, mask: torch.Tensor, value=0.0) -> torch.Tensor:
    m = mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
    return torch.where(m, torch.full_like(leaf, value), leaf)


@torch.no_grad()
def zero_moments(opt: GSAdamState, mask: torch.Tensor, groups=GS_PARAM_GROUPS) -> GSAdamState:
    """Reset the Adam moments of the selected rows in ``groups``."""
    def fix(tp: GaussianParams) -> GaussianParams:
        return GaussianParams(**{name: _mask_rows(leaf, mask) if name in groups else leaf
                                 for name, leaf in tp.tensors().items()})
    return GSAdamState(m=fix(opt.m), v=fix(opt.v), step=opt.step)


def forward(params: GaussianParams, state: GaussianState, camera: Camera,
            background: torch.Tensor, cfg: GSModelConfig, settings: RasterSettings, *,
            is_training: bool = True, mean2d_offset: Optional[torch.Tensor] = None,
            impl: str = "cuda", max_pairs: Optional[int] = None,
            need_stats: bool = True) -> dict:
    """Render the Gaussians through one camera; the background depth is the
    farthest alive center's distance from the camera."""
    dist = safe_norm(camera.camera_center[None, :] - params.xyz)
    bg_depth = torch.where(state.alive, dist, torch.zeros_like(dist)).amax()
    out = rasterize_gaussian(
        params.xyz, get_scaling(params), get_rotation(params),
        get_opacity(params)[:, 0], get_features(params), camera, settings,
        gamma=state.gamma, background=background, bg_depth=bg_depth,
        active_sh_degree=state.active_sh_degree, alive_mask=state.alive,
        mean2d_offset=mean2d_offset, impl=impl, max_pairs=max_pairs, need_stats=need_stats)
    out.update(scaling=get_scaling(params), opacity=get_opacity(params),
               xyz=params.xyz, visible_mask=(out["radii"] > 0) & state.alive)
    return out


def create_from_points(points: np.ndarray, colors: np.ndarray, cfg: GSModelConfig,
                       init_opacity: float = 0.1, capacity: Optional[int] = None,
                       capacity_factor: float = 1.0, device="cuda"):
    """Gaussians on a point cloud, on the host with the JAX function's numpy
    code: isotropic log-scale of the root mean squared 3-NN distance,
    identity rotations (also in the dead capacity slots, so their
    covariances stay regular). Returns (params, state)."""
    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    dist = inter_point_distance_np(points)
    scales = np.log(np.maximum(dist, 1e-7))[:, None].repeat(3, axis=1)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    opac = np.full((n, 1), inverse_sigmoid_np(init_opacity), np.float32)
    K = (cfg.max_sh_degree + 1) ** 2
    f_dc = ((np.asarray(colors, np.float32) - 0.5) / sh_mod.SH_C0)[:, None, :]
    f_rest = np.zeros((n, K - 1, 3), np.float32)

    cap = capacity if capacity is not None else int(
        (max(int(n * capacity_factor), n) + 255) // 256 * 256)

    def pad(x):
        return np.concatenate([x, np.zeros((cap - n,) + x.shape[1:], x.dtype)])

    pad_rots = pad(rots)
    pad_rots[n:, 0] = 1.0

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    params = GaussianParams(xyz=t(pad(points)), scaling=t(pad(scales)),
                            rotation=t(pad_rots), opacity=t(pad(opac)),
                            f_dc=t(pad(f_dc)), f_rest=t(pad(f_rest)))
    state = GaussianState.create(cap, device=dev)
    state.alive = torch.as_tensor(np.arange(cap) < n).to(dev)
    return params, state


# ---------------------------------------------------------------------------
# Adaptive density control (fixed shape: rows die, the capacity stays)
# ---------------------------------------------------------------------------

@torch.no_grad()
def update_statistics(state: GaussianState, mean2d_grad: torch.Tensor, radii: torch.Tensor,
                      contrib_sum: torch.Tensor, contrib_max: torch.Tensor,
                      visible: torch.Tensor) -> GaussianState:
    """Accumulate one view's statistics over its visible rows: the
    screen-space center gradient norm and a view count, the running max of
    the per-view contribution sum and max, and of the radius."""
    vis = visible
    visf = vis.to(torch.float32)
    gnorm = safe_norm(mean2d_grad)

    def running_max(old, new):
        return torch.where(vis, torch.maximum(old, new), old)

    return replace(
        state,
        gradient_accum=state.gradient_accum + torch.where(vis, gnorm, torch.zeros_like(gnorm)),
        gradient_denom=state.gradient_denom + visf,
        contrib_sum=running_max(state.contrib_sum, contrib_sum),
        contrib_max=running_max(state.contrib_max, contrib_max),
        contrib_denom=state.contrib_denom + visf,
        max_radii2d=running_max(state.max_radii2d, radii.to(torch.float32)))


@torch.no_grad()
def prune(params: GaussianParams, opt: GSAdamState, state: GaussianState,
          prune_mask: torch.Tensor):
    """Deactivate rows, clearing their statistics and Adam moments. Returns
    (params, opt, state)."""
    prune_mask = prune_mask & state.alive

    def zero(x):
        return torch.where(prune_mask, torch.zeros_like(x), x)

    state = replace(
        state, alive=state.alive & ~prune_mask,
        gradient_accum=zero(state.gradient_accum), gradient_denom=zero(state.gradient_denom),
        max_radii2d=zero(state.max_radii2d), contrib_sum=zero(state.contrib_sum),
        contrib_max=zero(state.contrib_max), contrib_denom=zero(state.contrib_denom))
    return params, zero_moments(opt, prune_mask), state


@torch.no_grad()
def opacity_pruning(params, opt, state, threshold):
    """Prune alive rows with opacity below ``threshold``. Returns (params,
    opt, state, count)."""
    mask = (get_opacity(params)[:, 0] < threshold) & state.alive
    return prune(params, opt, state, mask) + (mask.sum(),)


@torch.no_grad()
def opacity_clipping(params, opt, state, threshold):
    """Push the opacity logit of alive rows above ``threshold`` to 10 and
    zero their ``opacity`` moments. Returns (params, opt, state, count)."""
    mask = (get_opacity(params)[:, 0] > threshold) & state.alive
    params = replace(params, opacity=_mask_rows(params.opacity, mask, 10.0))
    return params, zero_moments(opt, mask, groups=("opacity",)), state, mask.sum()


@torch.no_grad()
def scale_pruning(params, opt, state, radii_threshold, scale_threshold):
    """Prune rows whose largest screen radius or largest world scale exceeds
    its threshold. Returns (params, opt, state, count)."""
    mask = ((state.max_radii2d > radii_threshold)
            | (get_scaling(params).amax(dim=1) > scale_threshold)) & state.alive
    return prune(params, opt, state, mask) + (mask.sum(),)


@torch.no_grad()
def contribution_pruning(params, opt, state, *, min_view_count, target_point_num,
                         prune_ratio, max_prune_ratio, contrib_max_ratio,
                         scene_bbox=None, inter_point_dist=None,
                         sparsity_retain_ratio=0.0):
    """Prune the lowest-contribution rows toward ``target_point_num``
    (``adc_common.contribution_prune_mask`` over the Gaussian state) and
    reset the contribution statistics of every row the ranking considered.
    Returns (params, opt, state, count)."""
    inside = get_inside_mask(params.xyz, scene_bbox) & state.alive
    prune_mask, select = contribution_prune_mask(
        state, inside, min_view_count=min_view_count,
        target_point_num=target_point_num, prune_ratio=prune_ratio,
        max_prune_ratio=max_prune_ratio, contrib_max_ratio=contrib_max_ratio,
        inter_point_dist=inter_point_dist, sparsity_retain_ratio=sparsity_retain_ratio)
    state = reset_contribution_stats(state, select)
    return prune(params, opt, state, prune_mask) + (prune_mask.sum(),)


@torch.no_grad()
def opacity_reset(params, opt, state, reset_value):
    """Clamp every opacity down to ``reset_value`` and zero the whole
    ``opacity`` moments. Returns (params, opt, state)."""
    op = get_opacity(params)
    cap = torch.full_like(op, float(np.float32(reset_value)))
    params = replace(params, opacity=inverse_sigmoid(torch.minimum(op, cap)))
    every = torch.ones(params.capacity, dtype=torch.bool, device=op.device)
    return params, zero_moments(opt, every, groups=("opacity",)), state


@torch.no_grad()
def scale_clipping(params, opt, state, scale_max):
    """Clamp the per-axis log-scales of alive rows to log(scale_max) and
    zero the ``scaling`` moments of the rows clipped. Returns (params, opt,
    state, count)."""
    log_max = torch.log(torch.tensor(float(np.float32(scale_max)), dtype=torch.float32,
                                     device=params.scaling.device))
    clip = (params.scaling > log_max) & state.alive[:, None]
    params = replace(params, scaling=torch.where(clip, log_max, params.scaling))
    rows = clip.any(dim=1)
    return params, zero_moments(opt, rows, groups=("scaling",)), state, rows.sum()


def densify_noise(capacity: int, generator: torch.Generator, device) -> tuple:
    """The split's two (C, 3) standard normal draws from ``generator``."""
    return tuple(torch.randn((capacity, 3), generator=generator, dtype=torch.float32,
                             device=device) for _ in range(2))


@torch.no_grad()
def densify(params: GaussianParams, opt: GSAdamState, state: GaussianState,
            grad_threshold, min_view_count, split_scale_threshold, split_num: int = 2, *,
            generator: Optional[torch.Generator] = None, noise=None):
    """Clone small and split large high-gradient Gaussians into dead
    capacity slots (fixed shape, the JAX function's semantics and slot
    assignment, ``adc_common.place_candidates``).

    A split's two halves move to centers sampled from the Gaussian itself
    (``xyz + R (eps * scale)``) and take the scale shrunk by 0.8 *
    ``split_num``; a clone copies its row. ``noise`` is the pair of (C, 3)
    standard normal draws (eps of half 1 and half 2); without it they are
    drawn from ``generator``. Returns (params, opt, state, grown,
    overflow)."""
    from ..ops.gaussian import quat_to_rotmat
    C = params.capacity
    dev = params.xyz.device
    select = state.gradient_denom >= min_view_count
    grow = select & (state.gradient_accum > grad_threshold * state.gradient_denom) & state.alive
    scaling = get_scaling(params)
    large = scaling.amax(dim=1) > split_scale_threshold
    clone_mask = grow & ~large
    split_mask = grow & large

    if noise is None:
        noise = densify_noise(C, generator, dev)
    R = quat_to_rotmat(get_rotation(params))

    def offset(eps):
        e = eps.to(device=dev, dtype=torch.float32) * scaling
        return R[:, :, 0] * e[:, 0:1] + R[:, :, 1] * e[:, 1:2] + R[:, :, 2] * e[:, 2:3]
    shrink = torch.full_like(scaling, float(np.float32(0.8 * split_num)))
    new_scaling = torch.log(torch.clamp_min(scaling / shrink, 1e-7))
    split_col = split_mask[:, None]

    def cand(xyz_off):
        # clones copy the original verbatim; split halves move to a sampled
        # center and take the shrunken scale
        return dict(xyz=torch.where(split_col, params.xyz + xyz_off, params.xyz),
                    scaling=torch.where(split_col, new_scaling, params.scaling),
                    rotation=params.rotation, opacity=params.opacity,
                    f_dc=params.f_dc, f_rest=params.f_rest)
    c1, c2 = cand(offset(noise[0])), cand(offset(noise[1]))
    new_valid = torch.stack([clone_mask | split_mask, split_mask], dim=1).reshape(2 * C)

    take, dst, placed, both_placed, overflow = place_candidates(state.alive, new_valid,
                                                                split_mask)
    src, first = take // 2, take % 2 == 0

    def place(name):
        leaf = getattr(params, name)
        sel = first.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return put_rows(leaf, dst, torch.where(sel, c1[name][src], c2[name][src]))
    params = GaussianParams(**{name: place(name) for name in GS_PARAM_GROUPS})
    opt = zero_moments(opt, placed)
    clear = placed | select
    state = replace(state, alive=state.alive | placed,
                    gradient_accum=torch.where(clear, torch.zeros_like(state.gradient_accum),
                                               state.gradient_accum),
                    gradient_denom=torch.where(clear, torch.zeros_like(state.gradient_denom),
                                               state.gradient_denom))
    params, opt, state = prune(params, opt, state, split_mask & both_placed)
    return params, opt, state, grow.sum(), overflow
