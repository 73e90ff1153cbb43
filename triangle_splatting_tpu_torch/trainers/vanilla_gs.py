"""VanillaGS trainer (port of ``triangle_splatting_tpu/trainers/vanilla_gs.py``).

One iteration: render one training camera through the Gaussian pipeline
(``rasterize_gaussian``: the EWA preprocess, binning, B1/B2 in variant
"GS"; never with rich info, as the JAX trainer), L1 + w_ssim * (1 - SSIM),
autograd backward, Adam (eps 1e-15) with per-group learning-rate
schedules; SH bands come on along ``sh_schedule``. With a ``statistic``
block every step renders with the contribution statistics (B1-GS's stats
form, owner sort, B5) and, inside the block's window, accumulates them
with the screen-space center gradient. Opacity pruning and clipping,
scale pruning and contribution pruning fire on their cadences.

Config blocks this port does not serve raise ``NotImplementedError`` at
construction, naming the block: densification, scale clipping, opacity
reset, data parallelism, PLY / checkpoint saving at an iteration the run
reaches, ``start_checkpoint`` and LPIPS.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import gaussian_model as G
from ..models.model_utils import get_color_tensor
from ..ops.projection import RasterSettings
from ..utils.camera import Camera
from ..utils.config import Config
from ..utils.scheduler import exponential_scheduler
from . import losses as L
from .adc_utils import alive_inter_point_dist, resolve_contribution_pruning
from .base import BaseTrainer

# ADC blocks of the JAX trainer this port does not run yet
_ADC_BLOCKS = ("densification", "scale_clipping", "opacity_reset")


def _f32(x) -> float:
    return float(np.float32(x))


class VanillaGSTrainer(BaseTrainer):
    def __init__(self, config: str | Config, exp_name: str | None = None,
                 log_file: bool = True, impl: str = "cuda", device="cuda"):
        super().__init__(config, exp_name, log_file, device)
        self._check_supported()
        # full float32 for the SSIM convolutions and any matmul
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.logger.info("TF32 disabled for cuDNN convolutions and matmuls")
        mc = self.config.model
        self.model_cfg = G.GSModelConfig(
            max_sh_degree=mc.max_sh_degree if mc.max_sh_degree is not None else 3)
        self.impl = impl
        self.scene_bbox = None
        info = self.dataset.getSceneInfo()
        if info is not None:
            self.scene_bbox = info.get("bbox_xyz")
        self.params: G.GaussianParams | None = None
        self.state: G.GaussianState | None = None
        self.opt: G.GSAdamState | None = None
        self._setup_schedulers()
        self._rng = np.random.default_rng(self.seed)
        self._sh_degree_host = 0
        # per-step losses of the last train() as device scalars
        self.loss_history: list[torch.Tensor] = []

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _check_supported(self):
        t = self.config.trainer
        mu = self.config.model.model_update
        iters = t.iterations or 30000

        def refuse(what):
            raise NotImplementedError(
                f"{what} is not ported to triangle_splatting_tpu_torch yet")

        for name in _ADC_BLOCKS:
            if mu is not None and getattr(mu, name) is not None:
                refuse(f"model.model_update.{name}")
        if self.config.model.use_color_affine:
            refuse("model.use_color_affine")
        if int(t.data_parallel or 0) > 1:
            refuse("trainer.data_parallel")
        if t.eval_lpips:
            refuse("trainer.eval_lpips")
        if t.start_checkpoint:
            refuse("trainer.start_checkpoint")
        for key in ("save_iterations", "checkpoint_iterations"):
            if any(0 < int(it) <= iters for it in (getattr(t, key) or [])):
                refuse(f"trainer.{key} (PLY/checkpoint saving)")
        for key in ("save_interval_iter", "ckpt_interval_iter"):
            if (getattr(t, key) or 0) and getattr(t, key) <= iters:
                refuse(f"trainer.{key} (PLY/checkpoint saving)")

    def _setup_schedulers(self):
        oc = self.config.model.optimizer
        self.lr_schedulers = {}
        if oc is not None:
            for name in G.GS_PARAM_GROUPS:
                sub = getattr(oc, name)
                if sub is not None:
                    self.lr_schedulers[name] = exponential_scheduler(**vars(sub))
        self._mu = self.config.model.model_update
        # every step renders with the statistics while a statistic block exists
        self._track_stats = self._mu is not None and self._mu.statistic is not None
        for name in ("opacity_pruning", "opacity_clipping"):
            b = getattr(self._mu, name) if self._mu is not None else None
            if b is not None:
                setattr(self, f"{name}_scheduler", exponential_scheduler(
                    v_init=b.opacity_threshold_init, v_final=b.opacity_threshold_final,
                    max_steps=b.end_iter - b.start_iter))

    def _lrs(self, iteration: int) -> dict:
        lrs = {n: _f32(fn(iteration)) for n, fn in self.lr_schedulers.items()}
        for n in G.GS_PARAM_GROUPS:
            lrs.setdefault(n, 0.0)
        return lrs

    def _settings_for(self, camera: Camera) -> RasterSettings:
        # no loss or statistic of the VanillaGS recipe reads depth or normal
        return RasterSettings(
            image_width=camera.image_width, image_height=camera.image_height,
            max_sh_degree=self.model_cfg.max_sh_degree, rich_info=False,
            rasterizer_type="GS", pairs_per_triangle=self._ppt)

    def _loss_weights(self, iteration: int) -> dict:
        w_ssim = self.config.trainer.w_ssim or 0.0
        return {"l1": _f32(1.0 - w_ssim), "ssim": _f32(w_ssim)}

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------
    def _camera_loss(self, settings, p: G.GaussianParams, m2d, state: G.GaussianState,
                     camera: Camera, background, weights: dict):
        """Per-camera L1 + SSIM loss. ``m2d`` is the (C, 2) center-offset
        leaf or None."""
        pkg = G.forward(p, state, camera, background, self.model_cfg, settings,
                        mean2d_offset=m2d, impl=self.impl, need_stats=self._track_stats)
        img, gt = pkg["render"], camera.gt_image
        if camera.alpha_mask is not None:
            img = img * camera.alpha_mask
            gt = gt * camera.alpha_mask
        loss = weights["l1"] * L.l1(img, gt) + weights["ssim"] * L.ssim_loss(img, gt)
        aux = dict(overflow=pkg["overflow"], num_pairs=pkg["num_pairs"])
        if self._track_stats:
            aux.update(radii=pkg["radii"], contrib_sum=pkg["contrib_sum"],
                       contrib_max=pkg["contrib_max"], visible_mask=pkg["visible_mask"])
        return loss, aux

    def _loss_and_grads(self, settings, params, state, camera, background, weights):
        """Loss, per-parameter gradients (a GaussianParams) and aux. While
        statistics are tracked, the gradient of a zero (C, 2) center offset
        is returned as ``aux["mean2d_grad"]``."""
        leaves = {k: t.detach().requires_grad_(True) for k, t in params.tensors().items()}
        wrt = [leaves[n] for n in G.GS_PARAM_GROUPS]
        m2d = None
        if self._track_stats:
            m2d = torch.zeros((params.capacity, 2), dtype=params.xyz.dtype,
                              device=params.xyz.device, requires_grad=True)
            wrt.append(m2d)
        loss, aux = self._camera_loss(settings, G.GaussianParams(**leaves), m2d, state,
                                      camera, background, weights)
        gs = torch.autograd.grad(loss, wrt, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, gs)]
        if m2d is not None:
            aux["mean2d_grad"] = gs.pop()
        return loss.detach(), G.GaussianParams(**dict(zip(G.GS_PARAM_GROUPS, gs))), aux

    def _stat_gate(self, iteration: int) -> bool:
        st = self._mu.statistic
        return st.start_iter < iteration <= st.end_iter

    def _train_step(self, settings, params, opt, state, camera, weights, lrs,
                    background, iteration: int):
        """One iteration: forward, loss, backward, Adam and, inside the
        statistic window, the statistics update. Returns (params, opt,
        state, loss, aux)."""
        loss, grads, aux = self._loss_and_grads(settings, params, state, camera,
                                                background, weights)
        params, opt = G.adam_update(params, opt, grads, lrs)
        if self._track_stats and self._stat_gate(iteration):
            state = G.update_statistics(state, aux["mean2d_grad"], aux["radii"],
                                        aux["contrib_sum"], aux["contrib_max"],
                                        aux["visible_mask"])
        return params, opt, state, loss, aux

    # ------------------------------------------------------------------
    # loop
    # ------------------------------------------------------------------
    def _init_model(self):
        if self.params is None:
            pcd = self.dataset.getPointCloud()
            sampling = self.config.model.sampling or Config()
            self.params, self.state = G.create_from_points(
                pcd.points, pcd.colors, self.model_cfg,
                init_opacity=sampling.init_opacity if sampling.init_opacity is not None else 0.1,
                capacity_factor=1.0, device=self.device)
            self.opt = G.GSAdamState.create(self.params)
            self.logger.info(f"Initialized {int(self.state.alive.sum())} gaussians "
                             f"(capacity {self.params.capacity})")
        return 0

    def _model_update(self, iteration: int):
        """Opacity pruning, opacity clipping, scale pruning and contribution
        pruning on their cadences, then the SH schedule (the JAX trainer's
        order). Opacity pruning and clipping fire through ``hold_iter``
        (default ``end_iter``)."""
        mu = self._mu
        if mu is None:
            return
        active = lambda block, hold=False: self._fires(block, iteration, hold)  # noqa: E731

        op = mu.opacity_pruning
        if active(op, hold=True):
            thr = self.opacity_pruning_scheduler(iteration - op.start_iter)
            self.params, self.opt, self.state, n = G.opacity_pruning(
                self.params, self.opt, self.state, _f32(thr))
            self._log_prune(iteration, "opacity", int(n), f", threshold {thr:.5f}")
        oc = mu.opacity_clipping
        if active(oc, hold=True):
            thr = self.opacity_clipping_scheduler(iteration - oc.start_iter)
            self.params, self.opt, self.state, n = G.opacity_clipping(
                self.params, self.opt, self.state, _f32(thr))
            self._log_prune(iteration, "clipping", int(n), f", threshold {thr:.5f}")
        sp = mu.scale_pruning
        if active(sp):
            self.params, self.opt, self.state, n = G.scale_pruning(
                self.params, self.opt, self.state, _f32(sp.radii_threshold),
                _f32(sp.scale_threshold))
            self._log_prune(iteration, "scale", int(n))
        cp = mu.contribution_pruning
        if active(cp):
            target, ratio, prune_ratio, retain = resolve_contribution_pruning(cp, iteration)
            if target is None:
                raise ValueError(
                    "model.model_update.contribution_pruning.target_point_num is null — "
                    "set it or add a downsample schedule before contribution pruning "
                    "activates.")
            ipd = alive_inter_point_dist(self.params.xyz, self.state.alive) if retain > 0 else None
            self.params, self.opt, self.state, n = G.contribution_pruning(
                self.params, self.opt, self.state,
                min_view_count=cp.min_view_count if cp.min_view_count is not None else 1,
                target_point_num=int(target), prune_ratio=_f32(prune_ratio),
                max_prune_ratio=_f32(cp.max_prune_ratio
                                     if cp.max_prune_ratio is not None else 0.2),
                contrib_max_ratio=_f32(ratio), scene_bbox=self.scene_bbox,
                inter_point_dist=ipd, sparsity_retain_ratio=retain)
            self._log_prune(iteration, "contribution", int(n))
        shs = mu.sh_schedule
        if shs is not None:
            deg = min(sum(1 for it in shs.one_up_iters if iteration > it),
                      self.model_cfg.max_sh_degree)
            if deg != self._sh_degree_host:
                self._sh_degree_host = deg
                self.state.active_sh_degree = torch.tensor(deg, dtype=torch.int32,
                                                           device=self.device)

    def train(self):
        try:
            self._train()
        except Exception as e:
            self.logger.error(f"Training failed: {e}")
            raise

    def _train(self):
        cfgt = self.config.trainer
        first_iter = self._init_model()
        if cfgt.initial_eval:
            self._evaluate(first_iter)
        self.logger.info("Training started")
        self.loss_history = []
        t_start = time.perf_counter()
        for iteration in range(first_iter + 1, (cfgt.iterations or 30000) + 1):
            camera = self.dataset.nextTrainData()
            settings = self._settings_for(camera)
            background = torch.as_tensor(get_color_tensor(
                cfgt.train_background or "random", self._rng)).to(self.device)
            cap_step = self.params.capacity
            self.params, self.opt, self.state, loss, aux = self._train_step(
                settings, self.params, self.opt, self.state, camera,
                self._loss_weights(iteration), self._lrs(iteration), background, iteration)
            self.loss_history.append(loss)
            if cfgt.eval_interval_iter and iteration % cfgt.eval_interval_iter == 0:
                self._evaluate(iteration)
            self._model_update(iteration)

            if cfgt.log_interval_iter and iteration % cfgt.log_interval_iter == 0:
                loss_val = float(loss)
                count = int(self.state.alive.sum())
                num_pairs, overflow = int(aux["num_pairs"]), bool(aux["overflow"])
                self.logger.info(f"[ITER {iteration}] Loss: {loss_val:.5f}, Gaussians: {count}, "
                                 f"SH: {self._sh_degree_host}, pairs: {num_pairs}")
                self.logger.add_scalar("Loss", loss_val, iteration)
                self.logger.add_scalar("Gaussian Count", count, iteration)
                self.logger.add_scalar("Training Time (min)",
                                       (time.perf_counter() - t_start) / 60, iteration)
                self._resize_pair_budget(num_pairs, cap_step, overflow)
        self.dataset.close()
        self.logger.info("Training finished")

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _evaluate(self, iteration: int):
        """Mean PSNR and SSIM over the test views (no statistics)."""
        cfgt = self.config.trainer
        background = torch.as_tensor(get_color_tensor(
            cfgt.eval_background or "black", self._rng)).to(self.device)
        psnrs, ssims = [], []
        for camera in self.dataset.getTestDataset():
            pkg = G.forward(self.params, self.state, camera, background, self.model_cfg,
                            self._settings_for(camera), is_training=False, impl=self.impl,
                            need_stats=False)
            img = pkg["render"]
            psnrs.append(float(L.psnr(img, camera.gt_image)))
            ssims.append(float(L.ssim(img.clamp(0, 1), camera.gt_image)))
        self.logger.info(f"[ITER {iteration}] Eval PSNR: {np.mean(psnrs):.3f}, "
                         f"SSIM: {np.mean(ssims):.3f}, views: {len(psnrs)}, "
                         f"gaussians: {int(self.state.alive.sum())}")
        self.logger.add_scalar("Average PSNR", float(np.mean(psnrs)), iteration)
        self.logger.add_scalar("Average SSIM", float(np.mean(ssims)), iteration)
        return float(np.mean(psnrs))

    def evaluate(self):
        return self._evaluate(0)
