"""VanillaGS Gaussian model in PyTorch.

Port of ``triangle_splatting_tpu/models/gaussian_model.py``: the parameter,
state and Adam containers at a fixed capacity C with an ``alive`` mask (the
JAX layout, so weights convert one to one, ``convert.py``), the getters,
``forward`` through ``rasterize_gaussian``, ``adam_update`` (eps 1e-15),
``create_from_points``, and the adaptive density control the VanillaGS
trainer runs: the statistics update, ``prune`` and the opacity, scale and
contribution pruning and opacity clipping stages. ``densify``,
``scale_clipping`` and ``opacity_reset`` are not ported yet.
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
from .adc_common import contribution_prune_mask, reset_contribution_stats
from .model_utils import get_inside_mask, inter_point_distance_np, inverse_sigmoid_np

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
