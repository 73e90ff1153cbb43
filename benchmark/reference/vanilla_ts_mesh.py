"""Plain reference of one VanillaTS training iteration on the "3D" mesh
recipe (config/MatrixCity_VanillaTS_mesh.yaml): the render with depth and
normal, L1 + SSIM + the depth-normal term + the opacity regularizer,
autograd gradients, Adam (eps 1e-15) with the recipe's learning-rate
schedules, then the recipe's ADC blocks and schedules after the step.

It reads the recipe as data and refuses any block it does not implement,
so a configuration it cannot follow fails loudly instead of being compared
wrongly. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from ..counts import steps as CS
from . import losses as LS
from . import tiles as TL
from . import triangles as TR
from .schedules import exp_schedule, f32

LEAVES = ("vertex", "opacity", "f_dc")
SUPPORTED_BLOCKS = {"opacity_pruning", "opacity_clipping", "scale_pruning", "gamma_schedule",
                    "sh_schedule"}


def check_recipe(recipe: dict) -> None:
    m = recipe["model"]
    if (m.get("rasterizer_type") or "2D") != "3D":
        raise NotImplementedError("reference: only the 3D rasterizer")
    if (m.get("max_sh_degree") or 0) != 0:
        raise NotImplementedError("reference: SH degree 0 only")
    for key in ("back_culling", "use_color_affine", "ste_threshold"):
        if m.get(key):
            raise NotImplementedError(f"reference: model.{key}")
    if (m.get("render_up_scale") or 1) > 1:
        raise NotImplementedError("reference: render_up_scale")
    blocks = {k for k, v in (m.get("model_update") or {}).items() if v is not None}
    if blocks - SUPPORTED_BLOCKS:
        raise NotImplementedError(f"reference: model_update blocks {sorted(blocks - SUPPORTED_BLOCKS)}")
    t = recipe["trainer"]
    for key in ("w_dog", "w_smoothness", "w_affine_reg"):
        if t.get(key):
            raise NotImplementedError(f"reference: trainer.{key}")
    if (t.get("vertex_reg") or {}).get("w_vertex_reg"):
        raise NotImplementedError("reference: the vertex regularizer")


class MeshModel:
    """Parameters, Adam moments, alive mask and schedules of one run."""

    def __init__(self, recipe: dict, vertex, opacity, f_dc, capacity: int, device):
        check_recipe(recipe)
        self.recipe = recipe
        n = vertex.shape[0]

        def pad(x):
            out = torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=torch.float32, device=device)
            out[:n] = torch.as_tensor(x, dtype=torch.float32, device=device)
            return out
        self.p = {"vertex": pad(vertex), "opacity": pad(opacity), "f_dc": pad(f_dc)}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.step_count = 0
        self.alive = torch.arange(capacity, device=device) < n
        self.gamma = torch.tensor(1.0, dtype=torch.float32, device=device)
        oc = recipe["model"]["optimizer"]
        self.lr = {k: exp_schedule(**oc[k]) for k in LEAVES}
        mu = recipe["model"].get("model_update") or {}
        self.mu = {k: v for k, v in mu.items() if v is not None}
        self.sched = {}
        for name, key in (("opacity_pruning", "opacity_threshold"),
                          ("opacity_clipping", "opacity_threshold")):
            b = self.mu.get(name)
            if b is not None:
                self.sched[name] = exp_schedule(b[f"{key}_init"], b[f"{key}_final"],
                                                b["end_iter"] - b["start_iter"])
        g = self.mu.get("gamma_schedule")
        if g is not None:
            if g.get("step_scheduler"):
                raise NotImplementedError("reference: a stepped gamma schedule")
            self.sched["gamma"] = exp_schedule(g["gamma_init"], g["gamma_final"],
                                               g["end_iter"] - g["start_iter"])

    def weights(self, it: int) -> dict:
        t = self.recipe["trainer"]
        geo = t.get("geometry_loss") or {}
        w_geo = (geo.get("w_geometry") or 0.0) if it > (geo.get("start_iter") or 0) else 0.0
        oreg = t.get("w_opacity_reg") or {}
        w_quad = w_lin = 0.0
        if oreg:
            if it > (oreg.get("linear_start_iter") or 0):
                w_lin = oreg.get("linear_reg") or 0.0
            elif it > (oreg.get("quad_start_iter") or 0):
                w_quad = oreg.get("quad_reg") or 0.0
        w_ssim = t.get("w_ssim") or 0.0
        return dict(l1=f32(1.0 - w_ssim), ssim=f32(w_ssim), geometry=f32(w_geo),
                    geo_scale=geo.get("scale_factor", 0.5), scaling=f32(t.get("w_scaling_reg") or 0.0),
                    quad=f32(w_quad), lin=f32(w_lin))


def loss_and_grads(model: MeshModel, it: int, cam: dict, gt: torch.Tensor, background,
                   budget: int):
    """The loss of one view and the gradient of every leaf (a dict), with
    the frame's plan (for counting) and its images."""
    w = model.weights(it)
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.p.items()}
    vertex = TR.rescale_about_centroid(leaves["vertex"], TR.gamma_rescale_ratio(model.gamma))
    opacity = torch.sigmoid(leaves["opacity"])[:, 0]
    rgb = TR.sh_color_dc(leaves["f_dc"])
    with torch.no_grad():
        dist = TR.safe_norm(cam["camera_center"][None, None, :] - vertex)
        bg_depth = torch.where(model.alive[:, None], dist, torch.zeros_like(dist)).amax()
    prep = TR.preprocess_3d(vertex, rgb, opacity, cam, model.alive, model.gamma)
    q, src = TR.leaves_of(prep)
    plan = TL.plan_tiles(prep.rect_min, prep.rect_max, prep.valid, prep.depth.detach(),
                         cam["width"], cam["height"])
    fn = TR.chunk_fn_3d(q, model.gamma, cam)
    color, depth, normal, final_t, n_contrib = TL.render(plan, fn, background, bg_depth, budget,
                                                         with_normal=True)
    img = color.requires_grad_(True)
    dep = depth.requires_grad_(True)
    nrm = normal.requires_grad_(True)
    loss_img = w["l1"] * LS.l1(img, gt) + w["ssim"] * (1.0 - LS.ssim(img, gt))
    if w["geometry"] > 0:
        loss_img = loss_img + w["geometry"] * LS.depth_normal_loss(
            dep, nrm, cam["tan_fovx"], cam["tan_fovy"], w["geo_scale"])
    g_img, g_dep, g_nrm = torch.autograd.grad(loss_img, [img, dep, nrm], allow_unused=True)
    g_dep = torch.zeros_like(dep) if g_dep is None else g_dep
    TL.backward(plan, fn, background, bg_depth, budget, g_img, g_dep, g_nrm)

    alive_f = model.alive.to(torch.float32)
    n_alive = torch.clamp_min(alive_f.sum(), 1.0)
    op = torch.sigmoid(leaves["opacity"])[:, 0]
    v = leaves["vertex"]
    scaling = (TR.safe_norm(v[:, 2] - v[:, 1]) + TR.safe_norm(v[:, 0] - v[:, 2])
               + TR.safe_norm(v[:, 1] - v[:, 0])) / 3.0
    reg = (w["scaling"] * (scaling * alive_f).sum() / n_alive
           + w["quad"] * ((0.25 - (op - 0.5) ** 2) * alive_f).sum() / n_alive
           + w["lin"] * ((1.0 - op) * alive_f).sum() / n_alive)
    outs = [src[k] for k in ("v1", "v2", "v3", "n", "rgb", "op")]
    cots = [q[k].grad if q[k].grad is not None else torch.zeros_like(q[k])
            for k in ("v1", "v2", "v3", "n", "rgb", "op")]
    torch.autograd.backward(outs + [reg], cots + [torch.ones_like(reg)])
    grads = {k: leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(leaves[k])
             for k in LEAVES}
    loss = float(loss_img.detach()) + float(reg.detach())
    return loss, grads, dict(plan=plan, n_contrib=n_contrib)


@torch.no_grad()
def adam(model: MeshModel, grads: dict, it: int, beta1=0.9, beta2=0.999, eps=1e-15):
    model.step_count += 1
    s = model.step_count
    bc1 = float(np.float32(1.0) - np.float32(beta1) ** np.float32(s))
    bc2 = float(np.float32(1.0) - np.float32(beta2) ** np.float32(s))
    for k in LEAVES:
        g = grads[k]
        model.m[k] = beta1 * model.m[k] + (1 - beta1) * g
        model.v[k] = beta2 * model.v[k] + (1 - beta2) * g * g
        lr = f32(model.lr[k](it))
        model.p[k] = model.p[k] - lr * (model.m[k] / bc1) / (torch.sqrt(model.v[k] / bc2) + eps)


def _fires(block, it, hold=False):
    last = (block.get("hold_iter") if hold else None) or block["end_iter"]
    return block["start_iter"] < it <= last and it % block["interval_iter"] == 0


@torch.no_grad()
def model_update(model: MeshModel, it: int) -> dict:
    """The recipe's ADC blocks and schedules after the step at ``it``.
    Returns the rows each firing changed."""
    fired = {}
    mu = model.mu

    def zero_rows(mask, names):
        for k in names:
            shape = (-1,) + (1,) * (model.m[k].dim() - 1)
            model.m[k] = torch.where(mask.reshape(shape), torch.zeros_like(model.m[k]), model.m[k])
            model.v[k] = torch.where(mask.reshape(shape), torch.zeros_like(model.v[k]), model.v[k])

    def opacity():
        return torch.sigmoid(model.p["opacity"])[:, 0]

    b = mu.get("opacity_pruning")
    if b is not None and _fires(b, it, hold=True):
        thr = f32(model.sched["opacity_pruning"](it - b["start_iter"]))
        mask = (opacity() < thr) & model.alive
        model.alive = model.alive & ~mask
        zero_rows(mask, LEAVES)
        fired["opacity_pruning"] = int(mask.sum())
    b = mu.get("opacity_clipping")
    if b is not None and _fires(b, it, hold=True):
        thr = f32(model.sched["opacity_clipping"](it - b["start_iter"]))
        mask = (opacity() > thr) & model.alive
        model.p["opacity"] = torch.where(mask[:, None], torch.full_like(model.p["opacity"], 10.0),
                                         model.p["opacity"])
        zero_rows(mask, ("opacity",))
        fired["opacity_clipping"] = int(mask.sum())
    b = mu.get("scale_pruning")
    if b is not None and _fires(b, it):
        v = model.p["vertex"]
        scaling = (TR.safe_norm(v[:, 2] - v[:, 1]) + TR.safe_norm(v[:, 0] - v[:, 2])
                   + TR.safe_norm(v[:, 1] - v[:, 0])) / 3.0
        # the screen radii statistic is zero: this recipe renders without
        # a statistic window, so only the world-space size can fire
        mask = (scaling > f32(b["scale_threshold"])) & model.alive
        model.alive = model.alive & ~mask
        zero_rows(mask, LEAVES)
        fired["scale_pruning"] = int(mask.sum())
    g = mu.get("gamma_schedule")
    if g is not None and g["start_iter"] < it <= g["end_iter"]:
        model.gamma = torch.tensor(model.sched["gamma"](it - g["start_iter"]), dtype=torch.float32,
                                   device=model.gamma.device)
    return fired


def train_step(model: MeshModel, it: int, cam: dict, gt, background, budget: int):
    """One iteration: loss, gradients, Adam, then the model update.
    Returns (loss, grads, fired, info)."""
    loss, grads, info = loss_and_grads(model, it, cam, gt, background, budget)
    adam(model, grads, it)
    fired = model_update(model, it)
    return loss, grads, fired, info


class Follower:
    """The reference run beside the program's: the same start (the
    benchmark's own arrays), views, backgrounds and iterations."""

    def __init__(self, recipe: dict, start: dict, device, budget: int):
        n = start["p.vertex"].shape[0]
        self.model = MeshModel(recipe, start["p.vertex"], start["p.opacity"], start["p.f_dc"], n,
                               device)
        self.budget = budget

    def step(self, it, cam, gt, background):
        loss, grads, fired, _ = train_step(self.model, it, cam, gt, background, self.budget)
        return loss, grads, fired

    def masked(self) -> dict:
        """Every leaf with the rows the model no longer keeps set to 0."""
        a = self.model.alive
        return {k: torch.where(a.reshape((-1,) + (1,) * (v.dim() - 1)), v, torch.zeros_like(v))
                for k, v in self.model.p.items()}

    @staticmethod
    def start_masked(start: dict, device) -> dict:
        """The start's leaves (every row alive)."""
        return {k[2:]: torch.as_tensor(np.asarray(v), device=device)
                for k, v in start.items() if k.startswith("p.")}


@torch.no_grad()
def frame_counts(recipe: dict, leaves: dict, state: dict, cam: dict, budget: int) -> dict:
    """The work of one frame of the program's state (``leaves`` vertex,
    opacity, f_dc; ``state`` alive and gamma) through ``cam``: pairs, tiles,
    evaluated (pair, pixel) up to each pixel's stop, valid triangles and
    live parameters."""
    alive = state["alive"]
    model_gamma = state["gamma"].to(torch.float32)
    vertex = TR.rescale_about_centroid(leaves["vertex"], TR.gamma_rescale_ratio(model_gamma))
    opacity = torch.sigmoid(leaves["opacity"])[:, 0]
    rgb = TR.sh_color_dc(leaves["f_dc"])
    dist = TR.safe_norm(cam["camera_center"][None, None, :] - vertex)
    bg_depth = torch.where(alive[:, None], dist, torch.zeros_like(dist)).amax()
    prep = TR.preprocess_3d(vertex, rgb, opacity, cam, alive, model_gamma)
    q, _ = TR.leaves_of(prep)
    plan = TL.plan_tiles(prep.rect_min, prep.rect_max, prep.valid, prep.depth,
                         cam["width"], cam["height"])
    n_contrib = TL.render(plan, TR.chunk_fn_3d(q, model_gamma, cam),
                          torch.zeros(3, device=vertex.device), bg_depth, budget, True)[4]
    t = recipe["trainer"]
    n_alive = int(alive.sum())
    c = dict(variant="3D", rich=True, gamma1=bool(float(model_gamma) == 1.0),
                evals=float(n_contrib.sum()), pairs=plan.num_pairs,
                tiles=plan.grid_w * plan.grid_h, pixels=cam["width"] * cam["height"],
                prims=int(prep.valid.sum()), params=n_alive * 13,
                geometry=bool((t.get("geometry_loss") or {}).get("w_geometry")))
    c["step_ops"] = CS.mesh_train_step(c)
    return c
