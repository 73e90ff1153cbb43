"""Scaffold-GS trainer (port of ``triangle_splatting_tpu/trainers/scaffold_gs.py``).

One iteration: decode the neural Gaussians of every anchor, render one
training camera through ``rasterize_gaussian`` (B1/B2 in variant "GS"
without statistics, B3, B4), L1 + w_ssim * (1 - SSIM) + the scaling
regularizer over the selected Gaussians + the opacity regularizer over
the visible anchors' offsets, autograd backward (the heads' products in
float32, TF32 off), Adam (eps 1e-15) with one lr schedule per group (the
anchors, their features, each head by ``mlp_<head>``) and, inside the
``anchor_update`` window, the anchor statistics from the gradient of a
zero (C*k, 2) screen-space center offset. After the step the opacity
threshold follows its schedule, and on the update cadence anchors grow
(coin flips from the trainer's ``torch.Generator``, seeded by
``trainer.seed``) and are pruned. The pair budget is re-sized at log
steps against C*k. ``mlp_pretrain`` distills the heads onto a GT Gaussian
PLY; ``savePLY`` writes the selected neural Gaussians as a 3DGS PLY;
``save_ckpt`` / ``load_ckpt`` keep the whole model in the JAX trainer's
pickle layout.

``trainer.data_parallel`` > 1 and the orbax checkpoint format raise
``NotImplementedError``, naming the block.
"""

from __future__ import annotations

import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..convert import scaffold_from_numpy, scaffold_to_numpy
from ..models import scaffold as S
from ..models.model_utils import get_color_tensor, inverse_sigmoid_np
from ..models.raw_gaussian import RawGaussian
from ..ops.projection import RasterSettings
from ..utils.camera import Camera
from ..utils.checkpoint import load_ckpt, model_blob, save_ckpt
from ..utils.config import Config
from ..utils.scheduler import exponential_scheduler
from . import losses as L
from .base import BaseTrainer

LR_GROUPS = ("anchor", "anchor_feat", "mlp_offset", "mlp_opacity", "mlp_cov", "mlp_color",
             "mlp_scaling")


def _f32(x) -> float:
    return float(np.float32(x))


class ScaffoldGSTrainer(BaseTrainer):
    def __init__(self, config: str | Config, exp_name: str | None = None,
                 log_file: bool = True, impl: str = "cuda", device="cuda"):
        super().__init__(config, exp_name, log_file, device)
        self._check_supported()
        # float32 products for the heads (the voxel rounding of decoded
        # positions in the growth), the SSIM convolutions and LPIPS
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        mc = self.config.model
        au = mc.anchor_update

        def pick(v, default):
            return v if v is not None else default
        self.model_cfg = S.ScaffoldConfig(
            feat_dim=mc.feat_dim or 32, hidden_dim=mc.hidden_dim or 32,
            n_offsets=mc.n_offsets or 10,
            max_offset_scale=pick(mc.max_offset_scale, 1.0),
            max_scaling_scale=pick(mc.max_scaling_scale, 1.0),
            feat_init_std=pick(mc.feat_init_std, 0.1),
            outside_boundary_ratio=pick(mc.outside_boundary_ratio, 4.0),
            update_depth=(au.update_depth or 3) if au is not None else 3,
            update_init_factor=(au.update_init_factor or 16) if au is not None else 16,
            update_hierachy_factor=(au.update_hierachy_factor or 4) if au is not None else 4)
        self.impl = impl
        self.params: S.ScaffoldParams | None = None
        self.state: S.ScaffoldState | None = None
        self.opt: S.ScaffoldAdamState | None = None
        self.scene_bbox = None
        info = self.dataset.getSceneInfo()
        if info is not None:
            self.scene_bbox = info.get("bbox_xyz")
        self._rng = np.random.default_rng(self.seed)
        # the anchor growth's coin flips
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._setup_schedulers()
        # per-step losses of the last train() as device scalars
        self.loss_history: list[torch.Tensor] = []
        # one dict per anchor update: iteration, threshold, added (emitted
        # voxels, as logged), placed (new alive rows), removed, overflow
        self.anchor_history: list[dict] = []

    def _check_supported(self):
        t = self.config.trainer

        def refuse(what):
            raise NotImplementedError(f"{what} is not ported to triangle_splatting_tpu_torch yet")
        if int(t.data_parallel or 0) > 1:
            refuse("trainer.data_parallel")
        if t.ckpt_format == "orbax":
            refuse("trainer.ckpt_format 'orbax' (it needs JAX)")

    def _setup_schedulers(self):
        oc = self.config.model.optimizer
        self.lr_schedulers = {}
        if oc is not None:
            for name in LR_GROUPS:
                sub = getattr(oc, name)
                if sub is None and name == "anchor_feat":
                    sub = oc.ancho_feat      # the reference config's typo, kept
                if sub is not None:
                    self.lr_schedulers[name] = exponential_scheduler(**vars(sub))
        u = self.config.model.anchor_update
        self._u = u
        self._track_stats = u is not None
        if u is not None:
            if u.start_iter is None or u.end_iter is None:
                raise ValueError(
                    "model.anchor_update requires start_iter and end_iter (the statistics "
                    "window and grow/prune cadence both derive from them)")
            steps = u.end_iter - u.start_iter
            self.grad_threshold_scheduler = exponential_scheduler(
                v_init=u.grad_threshold_init, v_final=u.grad_threshold_final, max_steps=steps)
            self.opacity_threshold_scheduler = exponential_scheduler(
                v_init=u.opacity_threshold_init, v_final=u.opacity_threshold_final,
                max_steps=steps)

    def _lrs(self, iteration: int) -> dict:
        lrs = {n: _f32(fn(iteration)) for n, fn in self.lr_schedulers.items()}
        for n in LR_GROUPS:
            lrs.setdefault(n, 0.0)
        return lrs

    def _loss_weights(self, iteration: int) -> dict:
        t = self.config.trainer
        return {k: _f32(v) for k, v in dict(
            l1=1.0 - (t.w_ssim or 0.0), ssim=t.w_ssim or 0.0,
            scaling=t.w_scaling_reg or 0.0, opacity=t.w_opacity_reg or 0.0).items()}

    def _settings_for(self, camera: Camera) -> RasterSettings:
        # no loss or statistic of the recipe reads depth or normal
        return RasterSettings(image_width=camera.image_width, image_height=camera.image_height,
                              max_sh_degree=0, rich_info=False, rasterizer_type="GS",
                              pairs_per_triangle=self._ppt)

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------
    def _camera_loss(self, settings, p: S.ScaffoldParams, m2d, state: S.ScaffoldState,
                     camera: Camera, background, weights: dict):
        """Per-camera loss: L1 + SSIM on the (alpha-masked) render, the
        scaling regularizer over the selected Gaussians and the opacity
        regularizer over every offset of the visible anchors."""
        k = self.model_cfg.n_offsets
        pkg = S.forward(p, state, camera, background, self.model_cfg, settings,
                        mean2d_offset=m2d, impl=self.impl)
        img, gt = pkg["render"], camera.gt_image
        if camera.alpha_mask is not None:
            img = img * camera.alpha_mask
            gt = gt * camera.alpha_mask
        sel = pkg["selection_mask"]
        n_sel = torch.clamp_min(sel.sum().to(img.dtype), 1.0)
        scaling_reg = (pkg["scaling"] * sel[..., None]).sum() / (3.0 * n_sel)
        vis = pkg["anchor_visible_mask"][:, None]
        n_vis = torch.clamp_min(vis.sum().to(img.dtype) * k, 1.0)
        op = pkg["gaussian_opacity"]
        opacity_reg = ((0.25 - (op - 0.5) ** 2) * vis).sum() / n_vis
        loss = weights["l1"] * L.l1(img, gt) + weights["ssim"] * L.ssim_loss(img, gt) \
            + weights["scaling"] * scaling_reg + weights["opacity"] * opacity_reg
        aux = dict(pkg=dict(anchor_visible_mask=pkg["anchor_visible_mask"],
                            gaussian_visible_mask=pkg["gaussian_visible_mask"],
                            gaussian_opacity=pkg["gaussian_opacity"].detach()),
                   n_gaussians=sel.sum(), overflow=pkg["overflow"], num_pairs=pkg["num_pairs"])
        return loss, aux

    def _loss_and_grads(self, settings, params, state, camera, background, weights):
        """Loss, gradients (a ScaffoldParams) and aux; while statistics are
        tracked, the gradient of a zero (C*k, 2) center offset is
        ``aux["mean2d_grad"]``."""
        leaves = {n: t.detach().requires_grad_(True) for n, t in params.leaves().items()}
        wrt = list(leaves.values())
        m2d = None
        if self._track_stats:
            m2d = torch.zeros((params.capacity * self.model_cfg.n_offsets, 2),
                              dtype=torch.float32, device=params.anchor.device,
                              requires_grad=True)
            wrt.append(m2d)
        loss, aux = self._camera_loss(settings, S.ScaffoldParams.from_leaves(leaves), m2d,
                                      state, camera, background, weights)
        gs = torch.autograd.grad(loss, wrt, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, gs)]
        if m2d is not None:
            aux["mean2d_grad"] = gs.pop()
        return loss.detach(), S.ScaffoldParams.from_leaves(dict(zip(leaves, gs))), aux

    def _stat_gate(self, iteration: int) -> bool:
        """The anchor-update statistics window (start_iter, end_iter]."""
        u = self._u
        return u is None or (u.start_iter or 0) < iteration <= (u.end_iter or 0)

    def _train_step(self, settings, params, opt, state, camera, weights, lrs, background,
                    iteration: int):
        """One iteration: forward, loss, backward, Adam and the statistics.
        Returns (params, opt, state, loss, aux)."""
        loss, grads, aux = self._loss_and_grads(settings, params, state, camera, background,
                                                weights)
        params, opt = S.adam_update(params, opt, grads, lrs)
        if self._track_stats:
            state = S.update_statistics(state, aux["mean2d_grad"], aux["pkg"],
                                        self.model_cfg.n_offsets,
                                        gate=self._stat_gate(iteration))
        return params, opt, state, loss, aux

    # ------------------------------------------------------------------
    # loop
    # ------------------------------------------------------------------
    def _init_model(self):
        if self.params is not None:
            return
        pcd = self.dataset.getPointCloud()
        mc = self.config.model
        self.params, self.state = S.create_from_points(
            pcd.points, self.model_cfg,
            voxel_size=mc.voxel_size if mc.voxel_size is not None else 0.001,
            scene_bbox=self.scene_bbox, seed=self.seed,
            capacity_factor=mc.capacity_factor or 4.0, logger=self.logger, device=self.device)
        self.opt = S.ScaffoldAdamState.create(self.params)
        self.logger.info(f"Initialized {int(self.state.alive.sum())} anchors (capacity "
                         f"{self.params.capacity}, {self.model_cfg.n_offsets} offsets each)")

    def _maintain_constraints(self, iteration: int):
        """The scheduled opacity threshold of the selection."""
        u = self._u
        if u is None:
            return
        thr = self.opacity_threshold_scheduler(iteration - (u.start_iter or 0))
        self.state = replace(self.state, opacity_threshold=torch.tensor(
            _f32(thr), dtype=torch.float32, device=self.device))

    def _anchor_update(self, iteration: int, coins=None):
        """Grow and prune anchors on the cadence inside (start_iter,
        end_iter]; ``coins`` (one (C, k) tensor per level) replaces the
        generator's draws."""
        u = self._u
        if u is None:
            return
        inside = (u.start_iter or 0) < iteration <= (u.end_iter or 0)
        if not (inside and (u.interval_iter or 0) > 0 and iteration % u.interval_iter == 0):
            return
        thr = self.grad_threshold_scheduler(iteration - (u.start_iter or 0))
        grad_stat = self._grad_stat(u.grad_min_view_count or 0)
        alive0 = self.state.alive.clone()
        self.params, self.opt, self.state, n_add, overflow = S.grow_anchors(
            self.params, self.opt, self.state, self.model_cfg, _f32(thr),
            _f32(u.grad_min_view_count or 0), generator=self._gen, coins=coins)
        placed = int((self.state.alive & ~alive0).sum())
        if bool(overflow):
            self.logger.warning("anchor capacity full; raise capacity_factor")
        opacity_thr = self.opacity_threshold_scheduler(iteration - (u.start_iter or 0))
        self.params, self.opt, self.state, n_rm = S.prune_anchors(
            self.params, self.opt, self.state, _f32(opacity_thr),
            _f32(u.opacity_min_view_count or 0))
        self.anchor_history.append(dict(
            iteration=iteration, grad_threshold=float(thr), added=int(n_add), placed=placed,
            removed=int(n_rm), overflow=bool(overflow), alive=int(self.state.alive.sum()),
            grad_stat=grad_stat))
        self.logger.info(f"[ITER {iteration}] grad threshold: {thr:.5f}, added {int(n_add)} "
                         f"anchors, removed {int(n_rm)}")

    @torch.no_grad()
    def _grad_stat(self, min_view_count) -> dict:
        """p50, p99 and max of the mean center-gradient norm of the offsets
        an anchor update examines (alive, seen more than
        ``min_view_count`` times), and their count: the growth threshold's
        scale, logged with each update."""
        st = self.state
        examined = st.alive[:, None] & (st.offset_denom > min_view_count)
        g = torch.sort((st.offset_grad_accum / (1e-15 + st.offset_denom))[examined]).values
        n = int(g.numel())
        if n == 0:
            return dict(p50=0.0, p99=0.0, max=0.0, examined=0)
        at = lambda q: float(g[min(int(q * n), n - 1)])  # noqa: E731
        return dict(p50=at(0.5), p99=at(0.99), max=float(g[-1]), examined=n)

    def _model_update(self, iteration: int):
        """The host work after a step, evaluation aside: the opacity
        threshold's schedule, then the anchor update."""
        self._maintain_constraints(iteration)
        self._anchor_update(iteration)

    def train(self):
        try:
            self._train()
        except Exception as e:
            self.logger.error(f"Training failed: {e}")
            raise

    def _train(self):
        cfgt = self.config.trainer
        self._init_model()
        if cfgt.initial_eval:
            self._evaluate(0)
        self.logger.info("Training started")
        self.loss_history = []
        t_start = time.perf_counter()
        for iteration in range(1, (cfgt.iterations or 30000) + 1):
            camera = self.dataset.nextTrainData()
            settings = self._settings_for(camera)
            background = torch.as_tensor(get_color_tensor(
                cfgt.train_background or "black", self._rng)).to(self.device)
            # the primitive count the step's pair budget was sized against
            n_prim_step = self.params.capacity * self.model_cfg.n_offsets
            self.params, self.opt, self.state, loss, aux = self._train_step(
                settings, self.params, self.opt, self.state, camera,
                self._loss_weights(iteration), self._lrs(iteration), background, iteration)
            self.loss_history.append(loss)
            self._note_overflow(aux["overflow"])
            self._maintain_constraints(iteration)
            if cfgt.eval_interval_iter and iteration % cfgt.eval_interval_iter == 0:
                self._evaluate(iteration)
            self._anchor_update(iteration)
            if cfgt.log_interval_iter and iteration % cfgt.log_interval_iter == 0:
                loss_val = float(loss)
                anchors = int(self.state.alive.sum())
                num_pairs, overflow = int(aux["num_pairs"]), bool(aux["overflow"])
                self.logger.info(f"[ITER {iteration}] Loss: {loss_val:.5f}, Anchor Count: "
                                 f"{anchors}, Gaussian Count: {int(aux['n_gaussians'])}, "
                                 f"pairs: {num_pairs}")
                self.logger.add_scalar("Loss", loss_val, iteration)
                self.logger.add_scalar("Anchor Count", anchors, iteration)
                self.logger.add_scalar("Training Time (min)",
                                       (time.perf_counter() - t_start) / 60, iteration)
                self._resize_pair_budget(num_pairs, n_prim_step, overflow)
            if iteration in (cfgt.save_iterations or []):
                self.savePLY(f"{self.output_dir}/point_cloud/{iteration}.ply")
            if iteration in (cfgt.checkpoint_iterations or []):
                self.save_ckpt(f"{self.output_dir}/ckpt/{iteration}.ckpt")
        self.dataset.close()
        self.logger.info("Training finished")

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _evaluate(self, iteration: int, log_name: str = ""):
        """Mean PSNR and SSIM over the test views."""
        cfgt = self.config.trainer
        background = torch.as_tensor(get_color_tensor(
            cfgt.eval_background or "black", self._rng)).to(self.device)
        psnrs, ssims = [], []
        for camera in self.dataset.getTestDataset():
            pkg = S.forward(self.params, self.state, camera, background, self.model_cfg,
                            self._settings_for(camera), is_training=False, impl=self.impl)
            img = pkg["render"]
            psnrs.append(float(L.psnr(img, camera.gt_image)))
            ssims.append(float(L.ssim(img.clamp(0, 1), camera.gt_image)))
        self.logger.info(f"[ITER {iteration}] {log_name} Eval PSNR: {np.mean(psnrs):.3f}, "
                         f"SSIM: {np.mean(ssims):.3f}")
        self.logger.add_scalar(f"{log_name} Average PSNR", float(np.mean(psnrs)), iteration)
        return float(np.mean(psnrs))

    # ------------------------------------------------------------------
    # MLP pretraining
    # ------------------------------------------------------------------
    def _pretrain_step(self, params, opt, gt_pkg: dict, alive, lrs: dict):
        """One distillation step: masked L1 of the heads' raw outputs
        against the GT package over the alive anchors, then Adam. Returns
        (params, opt, loss)."""
        leaves = {n: t.detach().requires_grad_(True) for n, t in params.leaves().items()}
        raw = S.get_raw_output(S.ScaffoldParams.from_leaves(leaves), self.model_cfg)
        m = alive.to(torch.float32).reshape(-1, 1, 1)
        n = torch.clamp_min(alive.sum().to(torch.float32), 1.0)
        k = self.model_cfg.n_offsets

        def masked_l1(a, b, dims):
            return ((a - b).abs() * m).sum() / (n * dims)
        loss = (masked_l1(raw["g_offset"], gt_pkg["g_offset"], 3 * k)
                + masked_l1(raw["g_opacity"], gt_pkg["g_opacity"], k)
                + masked_l1(raw["g_cov"], gt_pkg["g_cov"], 7 * k)
                + masked_l1(raw["g_color"], gt_pkg["g_color"], 3 * k))
        gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = S.ScaffoldParams.from_leaves({
            name: torch.zeros_like(x) if g is None else g
            for (name, x), g in zip(leaves.items(), gs)})
        params, opt = S.adam_update(params, opt, grads, lrs)
        return params, opt, loss.detach()

    def mlp_pretrain(self):
        """Distill the heads onto the dataset's GT Gaussian set: anchors at
        its voxels (capacity rounded up to 256), fresh features and heads
        from the seed, ``trainer.pretrain.iterations`` steps."""
        gt = self.dataset.getGTGaussian()
        voxel_size = self.config.model.voxel_size or 0.001
        cfg = self.model_cfg
        pkg = S.gt_gaussian_to_gt_pkg(gt.xyz, gt.opacity, gt.scale, gt.rotation, gt.shs,
                                      voxel_size, cfg.n_offsets, logger=self.logger)
        n = pkg["anchor"].shape[0]
        cap = (n + 255) // 256 * 256

        def pad(x):
            x = np.asarray(x, np.float32)
            x = np.concatenate([x, np.zeros((cap - n,) + x.shape[1:], x.dtype)])
            return torch.as_tensor(x).to(self.device)

        rng = np.random.default_rng(self.seed)
        feat = rng.normal(0, cfg.feat_init_std, (cap, cfg.feat_dim)).astype(np.float32)
        self.params = S.ScaffoldParams(anchor=pad(pkg["anchor"]),
                                       anchor_feat=torch.as_tensor(feat).to(self.device),
                                       mlps=S.init_mlps(cfg, self.seed, device=self.device))
        self.state = S.ScaffoldState.create(cap, cfg.n_offsets, voxel_size, device=self.device)
        self.state.alive = torch.arange(cap, device=self.device) < n
        self.state.anchor_scaling = torch.full((cap, 3), cfg.max_offset_scale,
                                               dtype=torch.float32, device=self.device)
        self.opt = S.ScaffoldAdamState.create(self.params)

        gt_dev = {key: pad(val) for key, val in pkg.items() if key.startswith("g_")}
        pc = self.config.trainer.pretrain or Config()
        self.pretrain_losses: list[torch.Tensor] = []
        self.logger.info("Pretraining started")
        for iteration in range(1, (pc.iterations or 1000) + 1):
            self.params, self.opt, loss = self._pretrain_step(
                self.params, self.opt, gt_dev, self.state.alive, self._lrs(iteration))
            self.pretrain_losses.append(loss)
            if pc.log_interval_iter and iteration % pc.log_interval_iter == 0:
                self.logger.info(f"[ITER {iteration}] Loss: {float(loss):.5f}")
                self.logger.add_scalar("Pretrain Loss", float(loss), iteration)
            if iteration in (pc.save_iterations or []):
                self.savePLY(f"{self.output_dir}/point_cloud/pt_{iteration}.ply")
            if iteration in (pc.checkpoint_iterations or []):
                self.save_ckpt(f"{self.output_dir}/ckpt/pt_{iteration}.ckpt")
        self.logger.info("Pretraining finished")

    # ------------------------------------------------------------------
    # IO
    # ------------------------------------------------------------------
    @torch.no_grad()
    def toRawGaussian(self, tile_filtering: bool = True) -> RawGaussian:
        """The selected neural Gaussians (opacity above the threshold, alive
        anchor, inside the scene box) in the 3DGS PLY schema."""
        dec = S.generate_gaussians(self.params, self.state, self.model_cfg)
        sel = ((dec["opacity"] > self.state.opacity_threshold)
               & self.state.alive[:, None]).reshape(-1).cpu().numpy()
        host = {k: v.cpu().numpy() for k, v in dec.items()}
        xyz = host["xyz"].reshape(-1, 3)
        if tile_filtering and self.scene_bbox is not None:
            from ..models.model_utils import get_inside_mask
            sel &= get_inside_mask(torch.as_tensor(xyz), self.scene_bbox).numpy()
        eps = 1e-10
        opacity = host["opacity"].reshape(-1, 1)[sel]
        scale = host["scale"].reshape(-1, 3)[sel]
        color = host["color"].reshape(-1, 3)[sel]
        from ..ops.sh import SH_C0
        return RawGaussian(xyz=xyz[sel],
                           opacity=inverse_sigmoid_np(np.clip(opacity, eps, 1 - eps)),
                           shs=(color - 0.5) / SH_C0, scale=np.log(np.maximum(scale, eps)),
                           rotation=host["rot"].reshape(-1, 4)[sel])

    def savePLY(self, path, tile_filtering: bool = True):
        g = self.toRawGaussian(tile_filtering)
        self.logger.info(f"Saving {len(g)} gaussians to {path}")
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        g.savePLY(path)

    def save_ckpt(self, path):
        """The whole model (params with the heads as mlps.<head>.<leaf>, Adam
        moments and step, state) and the scene box as host arrays, the JAX
        trainer's blob layout (``utils.checkpoint``)."""
        self.logger.info(f"Saving checkpoint to {path}")
        p, st, o = scaffold_to_numpy(self.params, self.state, self.opt)
        save_ckpt(path, model_blob(p, st, o, self.scene_bbox),
                  self.config.trainer.ckpt_format or "pickle")

    def load_ckpt(self, path):
        blob = load_ckpt(path)
        self.params, self.state, self.opt = scaffold_from_numpy(
            blob["params"], blob["state"], blob["opt"], device=self.device)
        self.scene_bbox = blob.get("scene_bbox")
        self.logger.info(f"Restored checkpoint {path} "
                         f"({int(self.state.alive.sum())} anchors)")

