"""Scaffold-GS model in PyTorch (port of ``triangle_splatting_tpu/models/scaffold.py``).

Anchors on a sparse voxel grid carry a learned feature; five small MLP
heads (scaling, offset, opacity, cov, color) decode ``n_offsets`` neural
Gaussians per anchor. The layout is the JAX package's, so weights carry
across one to one (``convert.scaffold_from_numpy`` / ``scaffold_to_numpy``):

- fixed-capacity anchors with an ``alive`` mask; the Adam moments are
  plain leaves masked in lockstep;
- the heads run over ALL C anchors as ``x @ W + b`` products in float32
  (the trainer keeps TF32 off); visibility is a mask into the rasterizer
  (``alive_mask``), not a gather;
- anchor growth voxelizes the candidate Gaussians per hierarchy level and
  dedups them against the existing anchors with a sort-based join (three
  stable argsorts, a segment max) at fixed shapes; new anchors go into
  dead slots, the k-th emitted voxel into the k-th dead slot. The coin
  flips come from a ``torch.Generator`` or are given (``coins=``).

``forward`` renders through ``rasterize_gaussian`` (B1/B2 in variant
"GS") without the contribution statistics: the anchor statistics read
only visibility and the screen-space center gradient.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.projection import RasterSettings, safe_norm
from ..ops.rasterize import rasterize_gaussian
from ..utils import tracing
from ..utils.camera import Camera
from .model_utils import get_inside_mask, inter_point_distance_np, inverse_sigmoid_np

MLP_HEADS = ("scaling", "offset", "opacity", "cov", "color")
MLP_LEAVES = ("w1", "b1", "w2", "b2")
I32_SENTINEL = 2 ** 31 - 1


@dataclass(frozen=True)
class ScaffoldConfig:
    """Static hyperparameters (the anchor update's hierarchy included)."""
    feat_dim: int = 32
    hidden_dim: int = 32
    n_offsets: int = 10
    max_offset_scale: float = 1.0
    max_scaling_scale: float = 1.0
    feat_init_std: float = 0.1
    outside_boundary_ratio: float = 4.0
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4


@dataclass
class ScaffoldParams:
    """Learnable leaves: per-anchor tensors at capacity C and the 5 heads
    (head -> {"w1", "b1", "w2", "b2"})."""
    anchor: torch.Tensor        # (C, 3)
    anchor_feat: torch.Tensor   # (C, F)
    mlps: dict

    @property
    def capacity(self) -> int:
        return self.anchor.shape[0]

    def leaves(self) -> dict:
        """Every tensor by flat name: anchor, anchor_feat, mlps.<head>.<leaf>."""
        out = {"anchor": self.anchor, "anchor_feat": self.anchor_feat}
        for head in MLP_HEADS:
            for leaf in MLP_LEAVES:
                out[f"mlps.{head}.{leaf}"] = self.mlps[head][leaf]
        return out

    @staticmethod
    def from_leaves(flat: dict) -> "ScaffoldParams":
        return ScaffoldParams(
            anchor=flat["anchor"], anchor_feat=flat["anchor_feat"],
            mlps={h: {leaf: flat[f"mlps.{h}.{leaf}"] for leaf in MLP_LEAVES}
                  for h in MLP_HEADS})

    def map(self, fn) -> "ScaffoldParams":
        return ScaffoldParams.from_leaves({k: fn(t) for k, t in self.leaves().items()})


@dataclass
class ScaffoldState:
    alive: torch.Tensor              # (C,) bool
    anchor_scaling: torch.Tensor     # (C, 3) prefilter extent (not learned)
    anchor_rotation: torch.Tensor    # (C, 4) identity quaternions (not learned)
    opacity_accum: torch.Tensor      # (C,)
    anchor_denom: torch.Tensor       # (C,)
    offset_grad_accum: torch.Tensor  # (C, k)
    offset_denom: torch.Tensor       # (C, k)
    voxel_size: torch.Tensor         # () f32
    opacity_threshold: torch.Tensor  # () f32 (scheduled)

    @staticmethod
    def create(capacity: int, n_offsets: int, voxel_size: float = 0.001,
               device="cuda") -> "ScaffoldState":
        dev = resolve_device(device)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        rot = z(capacity, 4)
        rot[:, 0] = 1.0
        return ScaffoldState(
            alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            anchor_scaling=z(capacity, 3), anchor_rotation=rot,
            opacity_accum=z(capacity), anchor_denom=z(capacity),
            offset_grad_accum=z(capacity, n_offsets), offset_denom=z(capacity, n_offsets),
            voxel_size=torch.tensor(voxel_size, dtype=torch.float32, device=dev),
            opacity_threshold=torch.tensor(0.0, dtype=torch.float32, device=dev))


@dataclass
class ScaffoldAdamState:
    m: ScaffoldParams
    v: ScaffoldParams
    step: int = 0

    @staticmethod
    def create(params: ScaffoldParams) -> "ScaffoldAdamState":
        return ScaffoldAdamState(m=params.map(torch.zeros_like),
                                 v=params.map(torch.zeros_like), step=0)


# -- MLP heads ---------------------------------------------------------------

def _linear_init(rng: np.random.Generator, fan_in: int, fan_out: int):
    """torch nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return (rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
            rng.uniform(-bound, bound, (fan_out,)).astype(np.float32))


def init_mlps(cfg: ScaffoldConfig, seed: int = 0, device="cuda") -> dict:
    """The 5 two-layer heads from numpy ``default_rng(seed)`` draws (the JAX
    function's). Output dims: scaling 6, offset 3k, opacity k, cov 7k,
    color 3k."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    k = cfg.n_offsets
    out_dims = {"scaling": 6, "offset": 3 * k, "opacity": k, "cov": 7 * k, "color": 3 * k}
    mlps = {}
    for head in MLP_HEADS:
        w1, b1 = _linear_init(rng, cfg.feat_dim, cfg.hidden_dim)
        w2, b2 = _linear_init(rng, cfg.hidden_dim, out_dims[head])
        mlps[head] = {n: torch.as_tensor(x).to(dev)
                      for n, x in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))}
    return mlps


def _mlp_apply(head: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ head["w1"] + head["b1"])
    return h @ head["w2"] + head["b2"]


# -- decoding ----------------------------------------------------------------

def anchor_scaling_heads(params: ScaffoldParams, state: ScaffoldState, cfg: ScaffoldConfig):
    """(offset_scale (C, 3), scaling_scale (C, 3)): the exp head times the
    voxel size, each half clamped."""
    s6 = torch.exp(_mlp_apply(params.mlps["scaling"], params.anchor_feat)) * state.voxel_size
    return (torch.clamp_max(s6[:, :3], cfg.max_offset_scale),
            torch.clamp_max(s6[:, 3:], cfg.max_scaling_scale))


def generate_gaussians(params: ScaffoldParams, state: ScaffoldState,
                       cfg: ScaffoldConfig) -> dict:
    """Decode k neural Gaussians per anchor, for all C anchors: (C, k, ...)
    tensors xyz, scale, rot (unit quaternions), opacity, color."""
    feat = params.anchor_feat
    C, k = params.capacity, cfg.n_offsets
    offset_scale, scaling_scale = anchor_scaling_heads(params, state, cfg)

    g_off = torch.tanh(_mlp_apply(params.mlps["offset"], feat)).reshape(C, k, 3)
    xyz = params.anchor[:, None] + offset_scale[:, None] * g_off

    cov = _mlp_apply(params.mlps["cov"], feat).reshape(C, k, 7)
    scale = scaling_scale[:, None] * torch.sigmoid(cov[..., :3])
    rot = cov[..., 3:7] / safe_norm(cov[..., 3:7])[..., None]

    opacity = torch.sigmoid(_mlp_apply(params.mlps["opacity"], feat)).reshape(C, k)
    color = torch.sigmoid(_mlp_apply(params.mlps["color"], feat)).reshape(C, k, 3)
    return dict(xyz=xyz, scale=scale, rot=rot, opacity=opacity, color=color)


@torch.no_grad()
def prefilter_voxel(params: ScaffoldParams, state: ScaffoldState, camera: Camera,
                    settings: RasterSettings) -> torch.Tensor:
    """(C,) bool: alive anchors the EWA preprocess keeps (radius > 0) at
    their prefilter extent, unit opacity and gamma 1."""
    from ..ops.gaussian import preprocess_gaussian
    anchor = params.anchor.detach()
    prep = preprocess_gaussian(
        anchor, state.anchor_scaling, state.anchor_rotation, torch.zeros_like(anchor),
        camera.world_view, camera.full_proj, camera.tan_fovx, camera.tan_fovy, settings,
        alive_mask=state.alive, opacity=torch.ones_like(anchor[:, 0]),
        gamma=torch.ones((), dtype=anchor.dtype, device=anchor.device))
    return (prep.radii > 0) & state.alive


def forward(params: ScaffoldParams, state: ScaffoldState, camera: Camera,
            background, cfg: ScaffoldConfig, settings: RasterSettings, *,
            is_training: bool = True, mean2d_offset: Optional[torch.Tensor] = None,
            scene_bbox=None, impl: str = "cuda", max_pairs: Optional[int] = None,
            need_stats: bool = False) -> dict:
    """Render the scaffold scene: the C*k decoded Gaussians through
    ``rasterize_gaussian`` with the selection mask (opacity above the
    threshold, visible and alive anchor, inside the scene box) as the
    alive mask. ``need_stats`` stays False on the training path (the
    anchor statistics never read the contribution products). Returns the
    rasterizer's dict plus gaussian_opacity (C, k, before selection),
    scaling (C, k, 3), selection_mask (C, k), anchor_visible_mask (C,) and
    gaussian_visible_mask (C, k)."""
    C, k = params.capacity, cfg.n_offsets
    with tracing.span("scaffold.prefilter"):
        anchor_visible = prefilter_voxel(params, state, camera, settings)
    with tracing.span("scaffold.decode"):
        dec = generate_gaussians(params, state, cfg)
        sel = (dec["opacity"] > state.opacity_threshold) \
            & anchor_visible[:, None] & state.alive[:, None]
        if scene_bbox is not None:
            sel = sel & get_inside_mask(dec["xyz"].detach().reshape(-1, 3),
                                        scene_bbox).reshape(C, k)
    N = C * k
    if tracing.active():
        tracing.count("scaffold.slots", N)
        tracing.count("scaffold.selected", sel.sum())
        tracing.count("scaffold.visible", anchor_visible.sum())
        tracing.count("scaffold.alive", state.alive.sum())
    out = rasterize_gaussian(
        dec["xyz"].reshape(N, 3), dec["scale"].reshape(N, 3), dec["rot"].reshape(N, 4),
        dec["opacity"].reshape(N), None, camera, settings, colors=dec["color"].reshape(N, 3),
        background=background, alive_mask=sel.reshape(N), mean2d_offset=mean2d_offset,
        impl=impl, max_pairs=max_pairs, need_stats=need_stats)
    out.update(gaussian_opacity=dec["opacity"], scaling=dec["scale"], selection_mask=sel,
               anchor_visible_mask=anchor_visible,
               gaussian_visible_mask=(out["radii"] > 0).reshape(C, k) & sel)
    return out


# -- optimizer ---------------------------------------------------------------

def _group_of(name: str) -> str:
    """The lr group of a flat leaf name: anchor, anchor_feat, mlp_<head>."""
    return f"mlp_{name.split('.')[1]}" if name.startswith("mlps.") else name


@torch.no_grad()
def adam_update(params: ScaffoldParams, opt: ScaffoldAdamState, grads: ScaffoldParams,
                lrs: dict, beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-15):
    """Adam with one lr per group (a missing group gets lr 0), the bias
    corrections in float32 and the update in the JAX function's order."""
    step = opt.step + 1
    bc1 = float(np.float32(1.0) - np.float32(beta1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(beta2) ** np.float32(step))
    g, m0, v0 = grads.leaves(), opt.m.leaves(), opt.v.leaves()
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.leaves().items():
        lr = lrs.get(_group_of(name), 0.0)
        m = beta1 * m0[name] + (1 - beta1) * g[name]
        v = beta2 * v0[name] + (1 - beta2) * g[name] * g[name]
        new_p[name] = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_m[name], new_v[name] = m, v
    return (ScaffoldParams.from_leaves(new_p),
            ScaffoldAdamState(m=ScaffoldParams.from_leaves(new_m),
                              v=ScaffoldParams.from_leaves(new_v), step=step))


def _where_rows(mask: torch.Tensor, value, leaf: torch.Tensor) -> torch.Tensor:
    m = mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
    return torch.where(m, torch.as_tensor(value, dtype=leaf.dtype, device=leaf.device), leaf)


@torch.no_grad()
def zero_anchor_moments(opt: ScaffoldAdamState, mask: torch.Tensor) -> ScaffoldAdamState:
    """Clear the per-anchor Adam moments at masked rows (the MLP moments
    stay)."""
    def fix(tp: ScaffoldParams) -> ScaffoldParams:
        return replace(tp, anchor=_where_rows(mask, 0.0, tp.anchor),
                       anchor_feat=_where_rows(mask, 0.0, tp.anchor_feat))
    return replace(opt, m=fix(opt.m), v=fix(opt.v))


# -- init --------------------------------------------------------------------

def create_from_points(points: np.ndarray, cfg: ScaffoldConfig, voxel_size: float = 0.001,
                       scene_bbox=None, capacity: Optional[int] = None,
                       capacity_factor: float = 4.0, seed: int = 0, logger=None,
                       device="cuda"):
    """Voxel-downsample the point cloud into anchors on the host (the JAX
    function's numpy code): ``voxel_size`` <= 0 takes the median
    inter-point distance, points outside the scene box use a grid coarser
    by ``outside_boundary_ratio``, features from ``default_rng(seed)``,
    capacity rounded up to 256. Returns (params, state)."""
    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    if voxel_size <= 0:
        voxel_size = float(np.median(inter_point_distance_np(points)))
    outside_size = voxel_size * cfg.outside_boundary_ratio
    if logger is not None:
        logger.info(f"Initial voxel_size: {voxel_size}, outside boundary "
                    f"voxel_size: {outside_size}")

    inside = get_inside_mask(torch.as_tensor(points), scene_bbox).numpy()
    a_in = np.unique(np.round(points[inside] / voxel_size), axis=0) * voxel_size
    a_out = np.unique(np.round(points[~inside] / outside_size), axis=0) * outside_size
    anchor = np.concatenate([a_in, a_out], 0).astype(np.float32)
    n = anchor.shape[0]

    rng = np.random.default_rng(seed)
    feat = rng.normal(0, cfg.feat_init_std, (n, cfg.feat_dim)).astype(np.float32)
    cap = capacity if capacity is not None else int(
        (max(int(n * capacity_factor), n) + 255) // 256 * 256)

    def pad(x):
        x = np.concatenate([x, np.zeros((cap - n,) + x.shape[1:], x.dtype)])
        return torch.as_tensor(x).to(dev)

    params = ScaffoldParams(anchor=pad(anchor), anchor_feat=pad(feat),
                            mlps=init_mlps(cfg, seed, device=dev))
    state = ScaffoldState.create(cap, cfg.n_offsets, voxel_size, device=dev)
    state.alive = torch.arange(cap, device=dev) < n
    state.anchor_scaling = torch.full((cap, 3), cfg.max_offset_scale, dtype=torch.float32,
                                      device=dev)
    return params, state


# -- training statistics -----------------------------------------------------

@torch.no_grad()
def update_statistics(state: ScaffoldState, mean2d_grad: torch.Tensor, pkg: dict,
                      n_offsets: int, gate: bool = True) -> ScaffoldState:
    """Accumulate, inside the anchor-update window (``gate``), each visible
    anchor's max offset opacity and each visible Gaussian's screen-space
    center-gradient norm (``mean2d_grad`` is (C*k, 2), anchor-major)."""
    if not gate:
        return state
    C = state.alive.shape[0]
    vis_anchor = pkg["anchor_visible_mask"]
    max_op = pkg["gaussian_opacity"].amax(dim=1)
    g_vis = pkg["gaussian_visible_mask"]
    gnorm = safe_norm(mean2d_grad[:, :2]).reshape(C, n_offsets)
    zero = torch.zeros((), dtype=max_op.dtype, device=max_op.device)
    return replace(
        state,
        opacity_accum=state.opacity_accum + torch.where(vis_anchor, max_op, zero),
        anchor_denom=state.anchor_denom + vis_anchor.to(torch.float32),
        offset_grad_accum=state.offset_grad_accum + torch.where(g_vis, gnorm, zero),
        offset_denom=state.offset_denom + g_vis.to(torch.float32))


# -- anchor update: grow + prune ----------------------------------------------

def _lexsort3(coords: torch.Tensor) -> torch.Tensor:
    """Order that lex-sorts int32 (N, 3) rows (x major), stable."""
    order = torch.argsort(coords[:, 2], stable=True)
    order = order[torch.argsort(coords[order, 1], stable=True)]
    return order[torch.argsort(coords[order, 0], stable=True)]


def _segment_max(values: torch.Tensor, seg: torch.Tensor, num: int, fill) -> torch.Tensor:
    """Max of ``values`` rows per segment id (``fill`` in empty segments)."""
    idx = seg.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    out = torch.full((num,) + values.shape[1:], fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, idx, values, "amax", include_self=False)


def _put_rows(base: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``base`` with rows ``dst`` set to ``rows``; a dst of C (= len(base))
    drops its row (JAX ``.at[dst].set(..., mode="drop")``)."""
    pad = torch.cat([base, base[:1]], 0)
    return pad.index_put((dst,), rows.to(base.dtype))[:-1]


@torch.no_grad()
def _grow_level(params: ScaffoldParams, opt: ScaffoldAdamState, state: ScaffoldState,
                coins: torch.Tensor, grad: torch.Tensor, offset_mask: torch.Tensor,
                g_xyz: torch.Tensor, level: int, cfg: ScaffoldConfig, grad_threshold):
    """One hierarchy level of anchor growth: the threshold scales by
    (hier / 2)^level and the voxel shrinks by hier^level; candidates survive
    a coin flip (``coins`` (C, k) uniform) with p = 0.5^(level + 1); their
    voxels are deduped against the alive anchors' by lex-sorting both sets
    of int32 voxel coordinates (invalid rows at the sentinel), and each new
    voxel takes the max of its candidates' parent features. The k-th
    emitted voxel goes into the k-th dead slot. Returns (params, opt, state,
    n_new, n_new > n_dead) with the counts as 0-d tensors."""
    C, k = params.capacity, cfg.n_offsets
    N = C * k
    dev = params.anchor.device
    thr = float(np.float32(grad_threshold) * np.float32((cfg.update_hierachy_factor // 2) ** level))
    size_factor = cfg.update_init_factor // (cfg.update_hierachy_factor ** level)
    cur_size = state.voxel_size * max(size_factor, 1)

    cand = (grad >= thr) & offset_mask & state.alive[:, None]
    cand = (cand & (coins > 0.5 ** (level + 1))).reshape(N)

    coords = torch.round(g_xyz / cur_size).to(torch.int32)                 # (N, 3)
    a_coords = torch.round(params.anchor / cur_size).to(torch.int32)

    all_coords = torch.cat([coords, a_coords], 0)
    valid = torch.cat([cand, state.alive], 0)
    is_anchor = torch.cat([torch.zeros(N, dtype=torch.bool, device=dev), state.alive], 0)
    all_coords = torch.where(valid[:, None], all_coords,
                             torch.full_like(all_coords, I32_SENTINEL))

    order = _lexsort3(all_coords)
    sc, sv, sa = all_coords[order], valid[order], is_anchor[order]
    M = N + C
    prev_ne = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         (sc[1:] != sc[:-1]).any(dim=1)])
    seg = torch.cumsum(prev_ne.to(torch.int64), 0) - 1
    has_anchor = _segment_max(sa.to(torch.int32), seg, M, 0)
    blocked = has_anchor[seg] > 0
    emit = prev_ne & sv & ~sa & ~blocked

    # the feature of a new voxel: the max over its candidates' parent features
    feat_all = torch.cat([params.anchor_feat.repeat_interleave(k, dim=0),
                          torch.zeros_like(params.anchor_feat)], 0)[order]
    feat_masked = torch.where((sv & ~sa)[:, None], feat_all,
                              torch.full_like(feat_all, -math.inf))
    seg_feat = _segment_max(feat_masked, seg, M, -math.inf)
    new_feat = torch.nan_to_num(seg_feat[seg], neginf=0.0)
    new_pos = sc.to(torch.float32) * cur_size

    # emitted voxels into dead slots (argsort of uint8 copies, stable)
    emit_order = torch.argsort((~emit).to(torch.uint8), stable=True)
    dead_order = torch.argsort(state.alive.to(torch.uint8), stable=True)
    n_new = emit.sum()
    n_dead = (~state.alive).sum()
    n_place = torch.clamp_max(torch.minimum(n_new, n_dead), C)
    kk = torch.arange(C, device=dev)
    src = emit_order[:C]
    dst = torch.where(kk < n_place, dead_order, torch.full_like(dead_order, C))

    params = replace(params, anchor=_put_rows(params.anchor, dst, new_pos[src]),
                     anchor_feat=_put_rows(params.anchor_feat, dst, new_feat[src]))
    placed = _put_rows(torch.zeros(C, dtype=torch.bool, device=dev), dst, kk < n_place)
    rot = torch.zeros((1, 4), dtype=torch.float32, device=dev)
    rot[0, 0] = 1.0
    state = replace(
        state, alive=state.alive | placed,
        anchor_scaling=_where_rows(placed, cfg.max_offset_scale, state.anchor_scaling),
        anchor_rotation=torch.where(placed[:, None], rot, state.anchor_rotation),
        opacity_accum=_where_rows(placed, 0.0, state.opacity_accum),
        anchor_denom=_where_rows(placed, 0.0, state.anchor_denom),
        offset_grad_accum=_where_rows(placed, 0.0, state.offset_grad_accum),
        offset_denom=_where_rows(placed, 0.0, state.offset_denom))
    opt = zero_anchor_moments(opt, placed)
    return params, opt, state, n_new, n_new > n_dead


@torch.no_grad()
def grow_anchors(params, opt, state, cfg: ScaffoldConfig, grad_threshold,
                 grad_min_view_count, *, generator: Optional[torch.Generator] = None,
                 coins: Optional[list] = None):
    """Every hierarchy level of anchor growth, then the gradient statistics
    of the examined offsets reset. The coin flips are ``coins`` (one (C, k)
    tensor per level) or drawn from ``generator``. Returns (params, opt,
    state, total emitted (0-d int), overflow (0-d bool: capacity ran
    out))."""
    C, k = params.capacity, cfg.n_offsets
    offset_mask = state.offset_denom > grad_min_view_count
    grad = state.offset_grad_accum / (1e-15 + state.offset_denom)
    g_xyz = generate_gaussians(params, state, cfg)["xyz"].reshape(-1, 3)

    total = torch.zeros((), dtype=torch.int64, device=params.anchor.device)
    overflow = torch.zeros((), dtype=torch.bool, device=params.anchor.device)
    for level in range(cfg.update_depth):
        if coins is not None:
            c = torch.as_tensor(coins[level], dtype=torch.float32).to(params.anchor.device)
        else:
            c = torch.rand((C, k), generator=generator, device=params.anchor.device)
        params, opt, state, n, ov = _grow_level(params, opt, state, c, grad, offset_mask,
                                                g_xyz, level, cfg, grad_threshold)
        total = total + n
        overflow = overflow | ov
    state = replace(state,
                    offset_grad_accum=torch.where(offset_mask, 0.0, state.offset_grad_accum),
                    offset_denom=torch.where(offset_mask, 0.0, state.offset_denom))
    return params, opt, state, total, overflow


@torch.no_grad()
def prune_anchors(params, opt, state, opacity_threshold, opacity_min_view_count):
    """Prune the alive anchors seen more than ``opacity_min_view_count``
    times whose mean max-opacity fell below the threshold; the opacity
    statistics of every examined anchor reset. Returns (params, opt,
    state, pruned count)."""
    anchor_mask = state.anchor_denom > opacity_min_view_count
    opacity = state.opacity_accum / (1e-15 + state.anchor_denom)
    prune = anchor_mask & (opacity < opacity_threshold) & state.alive
    state = replace(
        state, alive=state.alive & ~prune,
        opacity_accum=torch.where(anchor_mask, 0.0, state.opacity_accum),
        anchor_denom=torch.where(anchor_mask, 0.0, state.anchor_denom),
        offset_grad_accum=_where_rows(prune, 0.0, state.offset_grad_accum),
        offset_denom=_where_rows(prune, 0.0, state.offset_denom))
    return params, zero_anchor_moments(opt, prune), state, prune.sum()


# -- IO / pretrain helpers -----------------------------------------------------

def get_raw_output(params: ScaffoldParams, cfg: ScaffoldConfig) -> dict:
    """The heads' outputs the distillation pretrain loss compares: anchor,
    scaling (raw), g_offset (tanh), g_opacity (sigmoid), g_cov (raw),
    g_color (sigmoid)."""
    feat = params.anchor_feat
    C, k = params.capacity, cfg.n_offsets
    return {
        "anchor": params.anchor,
        "scaling": _mlp_apply(params.mlps["scaling"], feat),
        "g_offset": torch.tanh(_mlp_apply(params.mlps["offset"], feat)).reshape(C, k, 3),
        "g_opacity": torch.sigmoid(_mlp_apply(params.mlps["opacity"], feat)).reshape(C, k, 1),
        "g_cov": _mlp_apply(params.mlps["cov"], feat).reshape(C, k, 7),
        "g_color": torch.sigmoid(_mlp_apply(params.mlps["color"], feat)).reshape(C, k, 3),
    }


def gt_gaussian_to_gt_pkg(gt_xyz, gt_opacity, gt_scale, gt_rot, gt_shs, voxel_size: float,
                          n_offsets: int, logger=None) -> dict:
    """Voxelize a GT Gaussian set into anchor-formatted targets (host numpy,
    the JAX function's code): the k most important Gaussians of each voxel
    as offsets normalized by the voxel's largest, scales as logits of the
    voxel's largest, colors from the SH DC."""
    from ..ops.sh import SH_C0

    xyz = np.asarray(gt_xyz, np.float32)
    opacity = 1.0 / (1.0 + np.exp(-np.asarray(gt_opacity, np.float32)))
    scaling = np.exp(np.asarray(gt_scale, np.float32))
    rot = np.asarray(gt_rot, np.float32)
    rgb = np.asarray(gt_shs, np.float32)[:, :3] * SH_C0 + 0.5

    # by importance, so that the k slots of a full voxel keep the biggest
    importance = scaling.prod(axis=1) * opacity[:, 0]
    order = np.argsort(-importance, kind="stable")
    xyz, opacity, scaling = xyz[order], opacity[order], scaling[order]
    rot, rgb = rot[order], rgb[order]

    grid = np.round(xyz / voxel_size).astype(np.int64)
    uniq, inverse = np.unique(grid, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    anchor = uniq.astype(np.float32) * voxel_size
    A = anchor.shape[0]

    vox_order = np.argsort(inverse, kind="stable")
    xyz, opacity, scaling, rot, rgb, inverse = (
        xyz[vox_order], opacity[vox_order], scaling[vox_order], rot[vox_order],
        rgb[vox_order], inverse[vox_order])
    counts = np.bincount(inverse, minlength=A)
    if logger is not None:
        logger.info(f"Max point per voxel: {counts.max()}")
        if counts.max() > n_offsets:
            logger.warning(f"Some points are discarded because n_offsets: "
                           f"{n_offsets} is less than {counts.max()}!")
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])

    g_offset = np.zeros((A, n_offsets, 3), np.float32)
    g_opacity = np.zeros((A, n_offsets, 1), np.float32)
    g_cov = np.zeros((A, n_offsets, 7), np.float32)
    g_color = np.zeros((A, n_offsets, 3), np.float32)
    for i in range(n_offsets):
        m = np.nonzero(counts > i)[0]
        sel = offsets[m] + i
        g_offset[m, i] = xyz[sel] - anchor[m]
        g_opacity[m, i, 0] = opacity[sel, 0]
        g_cov[m, i, :3] = scaling[sel]
        g_cov[m, i, 3:] = rot[sel]
        g_color[m, i] = rgb[sel]

    eps, margin = 1e-10, 0.05
    max_off = np.abs(g_offset).max(axis=1, keepdims=True) * (1 + margin) + eps
    g_offset = g_offset / max_off
    max_scale = g_cov[:, :, :3].max(axis=1, keepdims=True) * (1 + margin) + eps
    g_cov[:, :, :3] = inverse_sigmoid_np(np.clip(g_cov[:, :, :3] / max_scale, eps, 1 - eps))
    anchor_scale = np.log(np.concatenate([max_off, max_scale], -1)[:, 0])
    return {"anchor": anchor, "scaling": anchor_scale,
            "g_offset": g_offset, "g_opacity": np.clip(g_opacity, 0, 1),
            "g_cov": g_cov, "g_color": np.clip(g_color, 0, 1)}
