"""Plain reference of one ScaffoldGS training iteration
(config/Colmap_ScaffoldGS.yaml): the anchors' decode by the five MLP heads
into k neural Gaussians each, the prefilter of visible anchors, the
selection, the Gaussian render, L1 + SSIM + the scaling and opacity
regularizers, autograd gradients of every leaf, Adam with one schedule per
group, the anchor statistics inside the update window, then the opacity
threshold's schedule and, on the update cadence, anchor growth (three
levels of voxel candidates deduplicated against the alive anchors, coin
flips from a ``torch.Generator`` seeded as the trainer's) and pruning.

The decode follows the model's definition (Scaffold-GS, Lu et al. 2024, as
``triangle_splatting_tpu_torch/models/scaffold.py`` states it); the growth
is restated with ``torch.unique`` instead of the program's lexsort and
segment scatter. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from ..counts import steps as CS
from . import gaussians as GS
from . import losses as LS
from . import tiles as TL
from .triangles import safe_norm
from .schedules import exp_schedule, f32

HEADS = ("offset", "opacity", "cov", "color", "scaling")
GROUPS = ("anchor", "anchor_feat", "mlp_offset", "mlp_opacity", "mlp_cov", "mlp_color",
          "mlp_scaling")


def check_recipe(recipe: dict) -> None:
    t = recipe["trainer"]
    if (t.get("data_parallel") or 1) != 1:
        raise NotImplementedError("reference: data parallelism")
    if (recipe["dataset"].get("background") or "white") != "white" or \
            (t.get("train_background") or "white") != "white":
        raise NotImplementedError("reference: a background other than white")


def mlp(leaves, head, x):
    h = torch.relu(x @ leaves[f"mlps.{head}.w1"] + leaves[f"mlps.{head}.b1"])
    return h @ leaves[f"mlps.{head}.w2"] + leaves[f"mlps.{head}.b2"]


def decode(p: dict, voxel_size, cfg: dict) -> dict:
    """The k neural Gaussians of every anchor: xyz (C, k, 3), scale, rot,
    opacity (C, k), color (C, k, 3)."""
    feat = p["anchor_feat"]
    C, k = feat.shape[0], cfg["n_offsets"]
    s6 = torch.exp(mlp(p, "scaling", feat)) * voxel_size
    off_s = torch.clamp_max(s6[:, :3], cfg["max_offset_scale"])
    sc_s = torch.clamp_max(s6[:, 3:], cfg["max_scaling_scale"])
    xyz = p["anchor"][:, None] + off_s[:, None] * torch.tanh(mlp(p, "offset", feat)).reshape(C, k, 3)
    cov = mlp(p, "cov", feat).reshape(C, k, 7)
    scale = sc_s[:, None] * torch.sigmoid(cov[..., :3])
    rot = cov[..., 3:7] / safe_norm(cov[..., 3:7])[..., None]
    return dict(xyz=xyz, scale=scale, rot=rot,
                opacity=torch.sigmoid(mlp(p, "opacity", feat)).reshape(C, k),
                color=torch.sigmoid(mlp(p, "color", feat)).reshape(C, k, 3))


class ScaffoldModel:
    def __init__(self, recipe: dict, start: dict, device):
        check_recipe(recipe)
        self.recipe = recipe
        mc = recipe["model"]
        self.cfg = dict(n_offsets=mc.get("n_offsets") or 10,
                        max_offset_scale=mc.get("max_offset_scale", 1.0),
                        max_scaling_scale=mc.get("max_scaling_scale", 1.0),
                        update_depth=mc["anchor_update"].get("update_depth") or 3,
                        init_factor=mc["anchor_update"].get("update_init_factor") or 16,
                        hier_factor=mc["anchor_update"].get("update_hierachy_factor") or 4)

        def t(x, dt=torch.float32):
            return torch.as_tensor(np.asarray(x), device=device).to(dt)
        self.p = {k[2:]: t(v) for k, v in start.items() if k.startswith("p.")}
        self.s = {k[2:]: t(v, torch.bool if k == "s.alive" else torch.float32)
                  for k, v in start.items() if k.startswith("s.")}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.step_count = 0
        oc = mc["optimizer"]
        self.lr = {g: exp_schedule(**oc[g]) for g in GROUPS if oc.get(g)}
        u = mc["anchor_update"]
        self.u = u
        n = u["end_iter"] - u["start_iter"]
        self.grad_thr = exp_schedule(u["grad_threshold_init"], u["grad_threshold_final"], n)
        self.op_thr = exp_schedule(u["opacity_threshold_init"], u["opacity_threshold_final"], n)
        self.gen = torch.Generator(device=device).manual_seed(int(recipe["trainer"]["seed"]))

    @property
    def alive(self):
        return self.s["alive"]

    def group(self, name):
        return f"mlp_{name.split('.')[1]}" if name.startswith("mlps.") else name


def forward(model: ScaffoldModel, leaves: dict, cam: dict, m2d, background, budget):
    """The render of one view and what the loss and statistics read."""
    cfg, s = model.cfg, model.s
    C, k = leaves["anchor"].shape[0], cfg["n_offsets"]
    with torch.no_grad():
        a = leaves["anchor"].detach()
        pf = GS.preprocess(a, s["anchor_scaling"], s["anchor_rotation"], torch.zeros_like(a),
                           torch.ones_like(a[:, 0]), cam, s["alive"])
        anchor_vis = (pf.radii > 0) & s["alive"]
    dec = decode(leaves, s["voxel_size"], cfg)
    sel = (dec["opacity"] > s["opacity_threshold"]) & anchor_vis[:, None] & s["alive"][:, None]
    N = C * k
    prep = GS.preprocess(dec["xyz"].reshape(N, 3), dec["scale"].reshape(N, 3),
                         dec["rot"].reshape(N, 4), dec["color"].reshape(N, 3),
                         dec["opacity"].reshape(N), cam, sel.reshape(N), 1.0, m2d)
    return dec, sel, anchor_vis, prep


def train_step(model: ScaffoldModel, it: int, cam: dict, gt, background, budget: int):
    """One iteration: loss, gradients, Adam, statistics, then the update."""
    t = model.recipe["trainer"]
    w_ssim = t.get("w_ssim") or 0.0
    k = model.cfg["n_offsets"]
    leaves = {n: v.detach().requires_grad_(True) for n, v in model.p.items()}
    C = leaves["anchor"].shape[0]
    m2d = torch.zeros((C * k, 2), device=gt.device, requires_grad=True)
    dec, sel, anchor_vis, prep = forward(model, leaves, cam, m2d, background, budget)
    q, src = GS.leaves_of(prep)
    plan = TL.plan_tiles(prep.rect_min, prep.rect_max, prep.valid, prep.depth.detach(),
                         cam["width"], cam["height"])
    fn = GS.chunk_fn(q)
    color = TL.render(plan, fn, background, 0.0, budget, False, kill_rule=True)[0]
    img = color.requires_grad_(True)
    loss_img = f32(1.0 - w_ssim) * LS.l1(img, gt) + f32(w_ssim) * (1.0 - LS.ssim(img, gt))
    (g_img,) = torch.autograd.grad(loss_img, [img])
    TL.backward(plan, fn, background, 0.0, budget, g_img, torch.zeros_like(gt[0]), None,
                kill_rule=True)
    self_f = sel.to(torch.float32)
    n_sel = torch.clamp_min(self_f.sum(), 1.0)
    scaling_reg = (dec["scale"] * self_f[..., None]).sum() / (3.0 * n_sel)
    vis = anchor_vis[:, None].to(torch.float32)
    n_vis = torch.clamp_min(vis.sum() * k, 1.0)
    op = dec["opacity"]
    opacity_reg = ((0.25 - (op - 0.5) ** 2) * vis).sum() / n_vis
    reg = f32(t.get("w_scaling_reg") or 0.0) * scaling_reg + f32(t.get("w_opacity_reg") or 0.0) * opacity_reg
    outs = [src["mean"], src["conic"], src["rgb"], src["op"], reg]
    cots = [q[n].grad if q[n].grad is not None else torch.zeros_like(q[n])
            for n in ("mean", "conic", "rgb", "op")] + [torch.ones_like(reg)]
    torch.autograd.backward(outs, cots)
    grads = {n: v.grad if v.grad is not None else torch.zeros_like(v) for n, v in leaves.items()}
    loss = float(loss_img.detach()) + float(reg.detach())

    adam(model, grads, it)
    u = model.u
    if u["start_iter"] < it <= u["end_iter"]:
        with torch.no_grad():
            gnorm = safe_norm(m2d.grad).reshape(C, k)
            g_vis = (prep.radii > 0).reshape(C, k) & sel
            s = model.s
            zero = torch.zeros((), device=gnorm.device)
            s["opacity_accum"] = s["opacity_accum"] + torch.where(anchor_vis, op.detach().amax(1), zero)
            s["anchor_denom"] = s["anchor_denom"] + anchor_vis.to(torch.float32)
            s["offset_grad_accum"] = s["offset_grad_accum"] + torch.where(g_vis, gnorm, zero)
            s["offset_denom"] = s["offset_denom"] + g_vis.to(torch.float32)
    fired = model_update(model, it)
    return loss, grads, fired


@torch.no_grad()
def adam(model: ScaffoldModel, grads: dict, it: int, beta1=0.9, beta2=0.999, eps=1e-15):
    model.step_count += 1
    n = model.step_count
    bc1 = float(np.float32(1.0) - np.float32(beta1) ** np.float32(n))
    bc2 = float(np.float32(1.0) - np.float32(beta2) ** np.float32(n))
    for name, g in grads.items():
        fn = model.lr.get(model.group(name))
        lr = f32(fn(it)) if fn is not None else 0.0
        model.m[name] = beta1 * model.m[name] + (1 - beta1) * g
        model.v[name] = beta2 * model.v[name] + (1 - beta2) * g * g
        model.p[name] = model.p[name] - lr * (model.m[name] / bc1) / (torch.sqrt(model.v[name] / bc2) + eps)


@torch.no_grad()
def model_update(model: ScaffoldModel, it: int) -> dict:
    u, s = model.u, model.s
    s["opacity_threshold"] = torch.tensor(f32(model.op_thr(it - u["start_iter"])),
                                          device=s["alive"].device)
    if not (u["start_iter"] < it <= u["end_iter"] and it % u["interval_iter"] == 0):
        return {}
    added = grow(model, f32(model.grad_thr(it - u["start_iter"])), f32(u["grad_min_view_count"]))
    pruned = prune(model, f32(model.op_thr(it - u["start_iter"])), f32(u["opacity_min_view_count"]))
    return dict(added=added, pruned=pruned, alive=int(s["alive"].sum()))


def _zero_anchor_moments(model, mask):
    for name in ("anchor", "anchor_feat"):
        model.m[name] = torch.where(mask[:, None], torch.zeros_like(model.m[name]), model.m[name])
        model.v[name] = torch.where(mask[:, None], torch.zeros_like(model.v[name]), model.v[name])


@torch.no_grad()
def grow(model: ScaffoldModel, threshold: float, min_views: float) -> int:
    """Anchor growth: at each level, offsets whose mean screen gradient
    passes the level's threshold (and a coin flip) propose the voxel of
    their decoded position; every proposed voxel no alive anchor occupies
    becomes an anchor in a dead slot (lowest slots first, voxels in
    lexicographic order) with the max of its proposers' parent features."""
    cfg, s, p = model.cfg, model.s, model.p
    C, k = p["anchor"].shape[0], cfg["n_offsets"]
    seen = s["offset_denom"] > min_views
    grad = s["offset_grad_accum"] / (1e-15 + s["offset_denom"])
    g_xyz = decode(p, s["voxel_size"], cfg)["xyz"].reshape(-1, 3)
    total = 0
    for level in range(cfg["update_depth"]):
        thr = float(np.float32(threshold) * np.float32((cfg["hier_factor"] // 2) ** level))
        size = s["voxel_size"] * max(cfg["init_factor"] // (cfg["hier_factor"] ** level), 1)
        coins = torch.rand((C, k), generator=model.gen, device=p["anchor"].device)
        cand = ((grad >= thr) & seen & s["alive"][:, None] & (coins > 0.5 ** (level + 1))).reshape(-1)
        idx = torch.nonzero(cand).flatten()
        coords = torch.round(g_xyz[idx] / size).to(torch.int32)
        a_coords = torch.round(p["anchor"][s["alive"]] / size).to(torch.int32)
        vox, inv = torch.unique(coords, dim=0, return_inverse=True)
        if vox.shape[0]:
            both = torch.cat([vox, torch.unique(a_coords, dim=0)], 0)
            _, binv, bcnt = torch.unique(both, dim=0, return_inverse=True, return_counts=True)
            free = bcnt[binv[:vox.shape[0]]] == 1
        else:
            free = torch.zeros(0, dtype=torch.bool, device=vox.device)
        feat = torch.full((vox.shape[0], p["anchor_feat"].shape[1]), -float("inf"),
                          device=vox.device)
        feat = feat.scatter_reduce(0, inv[:, None].expand(-1, feat.shape[1]),
                                   p["anchor_feat"][idx // k], "amax", include_self=True)
        new_pos, new_feat = vox[free].to(torch.float32) * size, feat[free]
        n_new = int(new_pos.shape[0])
        dead = torch.nonzero(~s["alive"]).flatten()
        n_place = min(n_new, int(dead.shape[0]))
        dst = dead[:n_place]
        p["anchor"][dst] = new_pos[:n_place]
        p["anchor_feat"][dst] = new_feat[:n_place]
        placed = torch.zeros(C, dtype=torch.bool, device=dst.device)
        placed[dst] = True
        s["alive"] = s["alive"] | placed
        s["anchor_scaling"][dst] = cfg["max_offset_scale"]
        s["anchor_rotation"][dst] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dst.device)
        for name in ("opacity_accum", "anchor_denom", "offset_grad_accum", "offset_denom"):
            s[name][dst] = 0.0
        _zero_anchor_moments(model, placed)
        total += n_new
    s["offset_grad_accum"] = torch.where(seen, 0.0, s["offset_grad_accum"])
    s["offset_denom"] = torch.where(seen, 0.0, s["offset_denom"])
    return total


@torch.no_grad()
def prune(model: ScaffoldModel, threshold: float, min_views: float) -> int:
    s = model.s
    examined = s["anchor_denom"] > min_views
    mean_op = s["opacity_accum"] / (1e-15 + s["anchor_denom"])
    mask = examined & (mean_op < threshold) & s["alive"]
    s["alive"] = s["alive"] & ~mask
    s["opacity_accum"] = torch.where(examined, 0.0, s["opacity_accum"])
    s["anchor_denom"] = torch.where(examined, 0.0, s["anchor_denom"])
    s["offset_grad_accum"] = torch.where(mask[:, None], 0.0, s["offset_grad_accum"])
    s["offset_denom"] = torch.where(mask[:, None], 0.0, s["offset_denom"])
    _zero_anchor_moments(model, mask)
    return int(mask.sum())


@torch.no_grad()
def row_keys(leaves: dict, state: dict) -> np.ndarray:
    """Each row's anchor voxel, (C, 3) integers at the voxel size: what
    identifies an anchor whichever row holds it."""
    vs = torch.as_tensor(state["voxel_size"]).to(torch.float32)
    return torch.round(leaves["anchor"].detach() / vs).to(torch.int64).cpu().numpy()


class Follower:
    def __init__(self, recipe: dict, start: dict, device, budget: int):
        self.model = ScaffoldModel(recipe, start, device)
        self.budget = budget

    def step(self, it, cam, gt, background):
        return train_step(self.model, it, cam, gt, background, self.budget)

    def masked(self) -> dict:
        a = self.model.alive
        return {n: torch.where(a.reshape((-1,) + (1,) * (v.dim() - 1)), v, torch.zeros_like(v))
                if v.shape[0] == a.shape[0] else v.clone() for n, v in self.model.p.items()}

    @staticmethod
    def start_masked(start: dict, device) -> dict:
        a = torch.as_tensor(np.asarray(start["s.alive"]), device=device)
        out = {}
        for k, v in start.items():
            if k.startswith("p."):
                v = torch.as_tensor(np.asarray(v), device=device)
                if v.shape[0] == a.shape[0]:
                    v = torch.where(a.reshape((-1,) + (1,) * (v.dim() - 1)), v, torch.zeros_like(v))
                out[k[2:]] = v
        return out


@torch.no_grad()
def frame_counts(recipe: dict, leaves: dict, state: dict, cam: dict, budget: int) -> dict:
    """The work of one frame of the program's state: pairs, tiles,
    evaluated (pair, pixel) up to each pixel's last composite, selected
    Gaussians, alive anchors and their parameters."""
    model = ScaffoldModel.__new__(ScaffoldModel)
    model.recipe, model.s = recipe, state
    mc = recipe["model"]
    model.cfg = dict(n_offsets=mc.get("n_offsets") or 10,
                     max_offset_scale=mc.get("max_offset_scale", 1.0),
                     max_scaling_scale=mc.get("max_scaling_scale", 1.0))
    dec, sel, anchor_vis, prep = forward(model, leaves, cam, None, None, budget)
    q, _ = GS.leaves_of(prep)
    plan = TL.plan_tiles(prep.rect_min, prep.rect_max, prep.valid, prep.depth,
                         cam["width"], cam["height"])
    n_contrib = TL.render(plan, GS.chunk_fn(q), torch.ones(3, device=prep.depth.device), 0.0,
                          budget, False, kill_rule=True)[4]
    C, k = leaves["anchor"].shape[0], model.cfg["n_offsets"]
    alive = int(state["alive"].sum())
    heads = sum(v.numel() for n, v in leaves.items() if n.startswith("mlps."))
    c = dict(variant="GS", rich=False, gamma1=True, evals=float(n_contrib.sum()),
             pairs=plan.num_pairs, tiles=plan.grid_w * plan.grid_h,
             pixels=cam["width"] * cam["height"], prims=int(prep.valid.sum()),
             slots=C * k, anchors=C, alive=alive, feat_dim=leaves["anchor_feat"].shape[1],
             hidden=leaves["mlps.offset.w1"].shape[1], head_out=sum(
                 leaves[f"mlps.{h}.w2"].shape[1] for h in HEADS),
             params=C * (3 + leaves["anchor_feat"].shape[1]) + heads)
    c["step_ops"] = CS.scaffold_train_step(c)
    return c


@torch.no_grad()
def render_frame(recipe: dict, start: dict, cam: dict, background, budget: int) -> torch.Tensor:
    """The image (3, H, W) of the start model through ``cam``: the decode,
    prefilter, selection and Gaussian blend of one training iteration's
    forward, with no gradient."""
    model = ScaffoldModel(recipe, start, background.device)
    leaves = dict(model.p)
    _, _, _, prep = forward(model, leaves, cam, None, background, budget)
    q, _ = GS.leaves_of(prep)
    plan = TL.plan_tiles(prep.rect_min, prep.rect_max, prep.valid, prep.depth, cam["width"],
                         cam["height"])
    return TL.render(plan, GS.chunk_fn(q), background, 0.0, budget, False, kill_rule=True)[0]


@torch.no_grad()
def render_counts(recipe: dict, start: dict, cam: dict, budget: int) -> dict:
    """The work of one rendered frame of the start model: the heads and
    decode over the alive anchors, the preprocess, and B1 at every
    evaluated (pair, pixel)."""
    dev = cam["world_view"].device
    model = ScaffoldModel(recipe, start, dev)
    c = frame_counts(recipe, dict(model.p), model.s, cam, budget)
    c["rich"] = True
    c["step_ops"] = CS.scaffold_render_frame(c)
    return c
