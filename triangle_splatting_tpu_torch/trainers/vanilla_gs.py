"""VanillaGS trainer (port of ``triangle_splatting_tpu/trainers/vanilla_gs.py``).

One iteration: render one training camera through the Gaussian pipeline
(``rasterize_gaussian``: the EWA preprocess, binning, B1/B2 in variant
"GS"; never with rich info, as the JAX trainer), L1 + w_ssim * (1 - SSIM),
autograd backward, Adam (eps 1e-15) with per-group learning-rate
schedules; SH bands come on along ``sh_schedule``. With a ``statistic``
block every step renders with the contribution statistics (B1-GS's stats
form, the map gather, B5) and, inside the block's window, accumulates them
with the screen-space center gradient. Densification (its splits' noise
from the trainer's ``torch.Generator``, seeded by ``trainer.seed``),
opacity pruning and clipping, scale pruning and clipping, contribution
pruning and opacity reset fire on their cadences, in the JAX trainer's
order; a densification that runs out of dead slots grows the capacity by
half and restores the new dead slots' identity quaternions. With a
densification block the capacity starts at four times the point count.
The alive Gaussians are saved as a 3DGS PLY (``models/raw_gaussian.py``)
at ``save_iterations`` and the whole model as a checkpoint at
``checkpoint_iterations``; a run resumes from ``start_checkpoint``.
``save_interval_iter``, ``ckpt_interval_iter``, ``start_pointcloud``,
``model.use_color_affine`` and ``trainer.eval_lpips`` are left unread, as
the JAX VanillaGS trainer leaves them.

With ``trainer.data_parallel`` N > 1 a step averages N views' gradients
over the ranks of a ``torch.distributed`` job (``_train_step_dp``, the
VanillaTS trainer's semantics), and evaluation scores the test views over
the ranks. The orbax checkpoint format raises ``NotImplementedError`` at
construction.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..convert import gaussian_from_numpy, gaussian_to_numpy
from ..models import gaussian_model as G
from ..models.model_utils import get_color_tensor
from ..models.raw_gaussian import RawGaussian, pack_sh_features, unpack_sh_features
from ..ops.projection import RasterSettings, safe_norm
from ..parallel.mesh import (apply_view_statistics, dp_views, stat_entries, stat_locals_of,
                             view_stat_locals)
from ..parallel.multihost import LOCAL
from ..utils.camera import Camera
from ..utils.checkpoint import load_ckpt, model_blob, save_ckpt
from ..utils.config import Config
from ..utils import tracing
from ..utils.scheduler import exponential_scheduler
from ..utils.timer import Timer
from . import losses as L
from .adc_utils import alive_inter_point_dist, grow_capacity, resolve_contribution_pruning
from .base import BaseTrainer


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
        # the densification splits' normal draws
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._sh_degree_host = 0
        # per-step losses of the last train() as device scalars
        self.loss_history: list[torch.Tensor] = []

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _check_supported(self):
        t = self.config.trainer

        def refuse(what):
            raise NotImplementedError(
                f"{what} is not ported to triangle_splatting_tpu_torch yet")

        if t.ckpt_format == "orbax":
            refuse("trainer.ckpt_format 'orbax' (it needs JAX)")

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
        self._setup_adc_schedulers(self._mu)

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
        with tracing.span("loss"):
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

    def _loss_and_grads(self, settings, params, state, camera, background, weights,
                        n_views: int = 1):
        """Loss, per-parameter gradients (a GaussianParams) and aux. While
        statistics are tracked, the gradient of a zero (C, 2) center offset
        is returned as ``aux["mean2d_grad"]``. With ``n_views`` > 1 both are
        those of loss / n_views (one view of a data-parallel batch)."""
        leaves = {k: t.detach().requires_grad_(True) for k, t in params.tensors().items()}
        wrt = [leaves[n] for n in G.GS_PARAM_GROUPS]
        m2d = None
        if self._track_stats:
            m2d = torch.zeros((params.capacity, 2), dtype=params.xyz.dtype,
                              device=params.xyz.device, requires_grad=True)
            wrt.append(m2d)
        loss, aux = self._camera_loss(settings, G.GaussianParams(**leaves), m2d, state,
                                      camera, background, weights)
        if n_views != 1:
            loss = loss / n_views
        with tracing.span("backward"):
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
        """One single-view iteration: ``_train_step_dp`` over ``[camera]``
        in a world of one. Returns (params, opt, state, loss, aux)."""
        return self._train_step_dp(settings, params, opt, state, [camera], weights, lrs,
                                   background, iteration, group=LOCAL, n_views=1)

    def _train_step_dp(self, settings, params, opt, state, cameras, weights, lrs,
                       background, iteration: int, idle_camera=None, group=None,
                       n_views=None):
        """One iteration over ``group`` (``self._dp_group``) and ``n_views``
        (``data_parallel``), the VanillaTS trainer's semantics: the views'
        gradients of loss / n_views summed over the views and the ranks,
        one replicated Adam step, per-VIEW statistics inside the statistic
        window (center-gradient norms and counts summed, contribution and
        radius maxima maxed), the batch's max ``overflow`` and
        ``num_pairs``. One view in a world of one is the single-view
        step."""
        tracing.set_step(iteration)
        with tracing.span("step"):
            group = self._dp_group if group is None else group
            n_views = self._dp_n if n_views is None else n_views
            gate = self._track_stats and self._stat_gate(iteration)

            def one_view(camera):
                loss, grads, aux = self._loss_and_grads(settings, params, state, camera,
                                                        background, weights, n_views=n_views)
                sums = {"loss": loss, **{f"g.{n}": getattr(grads, n) for n in G.GS_PARAM_GROUPS}}
                maxes = {"overflow": aux["overflow"].to(torch.int64),
                         "num_pairs": aux["num_pairs"].to(torch.int64)}
                if gate:
                    with tracing.span("stats"):
                        s, m = stat_entries(view_stat_locals(
                            aux["visible_mask"], safe_norm(aux["mean2d_grad"] * n_views),
                            aux["contrib_sum"], aux["contrib_max"], aux["radii"]))
                        sums.update(s)
                        maxes.update(m)
                return sums, maxes

            sums, maxes = dp_views(group, cameras, one_view, idle_camera)
            grads = G.GaussianParams(**{n: sums[f"g.{n}"] for n in G.GS_PARAM_GROUPS})
            with tracing.span("adam"):
                params, opt = G.adam_update(params, opt, grads, lrs)
            if gate:
                with tracing.span("stats"):
                    state = apply_view_statistics(state, stat_locals_of(sums, maxes))
            return params, opt, state, sums["loss"], dict(overflow=maxes["overflow"] > 0,
                                                          num_pairs=maxes["num_pairs"])

    # ------------------------------------------------------------------
    # loop
    # ------------------------------------------------------------------
    def _init_model(self):
        """Resume from ``start_checkpoint`` or, on the first call,
        initialize from the point cloud. Returns the iteration the run
        continues after."""
        cfgt = self.config.trainer
        first_iter = 0
        if cfgt.start_checkpoint:
            self.load_ckpt(f"{self.output_dir}/ckpt/{cfgt.start_checkpoint}.ckpt")
            first_iter = int(cfgt.start_checkpoint)
        if self.params is None:
            pcd = self.dataset.getPointCloud()
            sampling = self.config.model.sampling or Config()
            has_densify = self._mu is not None and self._mu.densification is not None
            self.params, self.state = G.create_from_points(
                pcd.points, pcd.colors, self.model_cfg,
                init_opacity=sampling.init_opacity if sampling.init_opacity is not None else 0.1,
                capacity_factor=4.0 if has_densify else 1.0, device=self.device)
            self.opt = G.GSAdamState.create(self.params)
            self.logger.info(f"Initialized {int(self.state.alive.sum())} gaussians "
                             f"(capacity {self.params.capacity})")
        return first_iter

    @tracing.spanned("update")
    def _model_update(self, iteration: int):
        """Densification, opacity pruning, opacity clipping, scale pruning,
        scale clipping, contribution pruning and opacity reset on their
        cadences, then the SH schedule (the JAX trainer's order). Opacity
        pruning and clipping and scale clipping fire through ``hold_iter``
        (default ``end_iter``)."""
        mu = self._mu
        if mu is None:
            return
        active = lambda block, hold=False: self._fires(block, iteration, hold)  # noqa: E731

        d = mu.densification
        if active(d):
            with tracing.span("adc.densification"):
                thr = self.grad_threshold_scheduler(iteration - d.start_iter)
                self._densify(iteration, thr, d.min_view_count, lambda: G.densify(
                    self.params, self.opt, self.state, _f32(thr), d.min_view_count,
                    _f32(d.split_scale_threshold), d.split_num or 2, generator=self._gen))

        op = mu.opacity_pruning
        if active(op, hold=True):
            with tracing.span("adc.opacity_pruning"):
                thr = self.opacity_pruning_scheduler(iteration - op.start_iter)
                self.params, self.opt, self.state, n = G.opacity_pruning(
                    self.params, self.opt, self.state, _f32(thr))
                self._log_prune(iteration, "opacity", int(n), f", threshold {thr:.5f}")
        oc = mu.opacity_clipping
        if active(oc, hold=True):
            with tracing.span("adc.opacity_clipping"):
                thr = self.opacity_clipping_scheduler(iteration - oc.start_iter)
                self.params, self.opt, self.state, n = G.opacity_clipping(
                    self.params, self.opt, self.state, _f32(thr))
                self._log_prune(iteration, "clipping", int(n), f", threshold {thr:.5f}")
        sp = mu.scale_pruning
        if active(sp):
            with tracing.span("adc.scale_pruning"):
                self.params, self.opt, self.state, n = G.scale_pruning(
                    self.params, self.opt, self.state, _f32(sp.radii_threshold),
                    _f32(sp.scale_threshold))
                self._log_prune(iteration, "scale", int(n))
        sc = mu.scale_clipping
        if active(sc, hold=True):
            with tracing.span("adc.scale_clipping"):
                mx = self.scale_max_scheduler(iteration - sc.start_iter)
                self.params, self.opt, self.state, n = G.scale_clipping(
                    self.params, self.opt, self.state, _f32(mx))
                self._log_prune(iteration, "scale clipping", int(n), f", max {mx:.4f}")
        cp = mu.contribution_pruning
        if active(cp):
            with tracing.span("adc.contribution_pruning"):
                target, ratio, prune_ratio, retain = resolve_contribution_pruning(cp, iteration)
                if target is None:
                    raise ValueError(
                        "model.model_update.contribution_pruning.target_point_num is null — "
                        "set it or add a downsample schedule before contribution pruning "
                        "activates.")
                ipd = (alive_inter_point_dist(self.params.xyz, self.state.alive)
                       if retain > 0 else None)
                self.params, self.opt, self.state, n = G.contribution_pruning(
                    self.params, self.opt, self.state,
                    min_view_count=cp.min_view_count if cp.min_view_count is not None else 1,
                    target_point_num=int(target), prune_ratio=_f32(prune_ratio),
                    max_prune_ratio=_f32(cp.max_prune_ratio
                                         if cp.max_prune_ratio is not None else 0.2),
                    contrib_max_ratio=_f32(ratio), scene_bbox=self.scene_bbox,
                    inter_point_dist=ipd, sparsity_retain_ratio=retain)
                self._log_prune(iteration, "contribution", int(n))
        orr = mu.opacity_reset
        if active(orr):
            with tracing.span("adc.opacity_reset"):
                self.params, self.opt, self.state = G.opacity_reset(
                    self.params, self.opt, self.state, _f32(orr.reset_value))
                self.logger.info(f"[ITER {iteration}, opacity reset] -> {orr.reset_value}")
        shs = mu.sh_schedule
        if shs is not None:
            deg = min(sum(1 for it in shs.one_up_iters if iteration > it),
                      self.model_cfg.max_sh_degree)
            if deg != self._sh_degree_host:
                self._sh_degree_host = deg
                self.state.active_sh_degree = torch.tensor(deg, dtype=torch.int32,
                                                           device=self.device)

    def _grow_capacity(self):
        """Zero-pad params, moments and state by half the capacity, then
        give the new dead slots identity quaternions (their covariances
        stay regular, as ``create_from_points`` leaves dead slots)."""
        old = self.params.capacity
        self.params, self.opt, self.state = grow_capacity(
            self.params, self.opt, self.state, self.logger)
        rot = self.params.rotation.clone()
        rot[old:, 0] = 1.0
        self.params = replace(self.params, rotation=rot)

    def train(self):
        try:
            self._train()
        except Exception as e:
            self.logger.error(f"Training failed: {e}")
            raise

    def _train(self):
        cfgt = self.config.trainer
        first_iter = self._init_model()
        if self._dp_n > 1:
            self._setup_data_parallel()
        if cfgt.initial_eval:
            self._evaluate(first_iter)
        self.logger.info("Training started")
        self.loss_history = []
        timer = self.timer = Timer("Training")
        for iteration in range(first_iter + 1, (cfgt.iterations or 30000) + 1):
            timer.log("data loading")
            camera, local_views, idle_camera = self._next_batch()
            settings = self._settings_for(camera)
            self._profile_hooks(iteration)
            timer.log("train step")
            background = torch.as_tensor(get_color_tensor(
                cfgt.train_background or "random", self._rng)).to(self.device)
            cap_step = self.params.capacity
            self.params, self.opt, self.state, loss, aux = self._train_step_dp(
                settings, self.params, self.opt, self.state, local_views,
                self._loss_weights(iteration), self._lrs(iteration), background,
                iteration, idle_camera)
            self.loss_history.append(loss)
            self._note_overflow(aux["overflow"])
            if cfgt.eval_interval_iter and iteration % cfgt.eval_interval_iter == 0:
                timer.log("evaluation")
                self._evaluate(iteration)
            timer.log("model update")
            self._model_update(iteration)

            if cfgt.log_interval_iter and iteration % cfgt.log_interval_iter == 0:
                # the loss read waits for every queued step: device time
                timer.log("device drain")
                loss_val = float(loss)
                timer.log("logging")
                count = int(self.state.alive.sum())
                num_pairs, overflow = int(aux["num_pairs"]), bool(aux["overflow"])
                self.logger.info(f"[ITER {iteration}] Loss: {loss_val:.5f}, Gaussians: {count}, "
                                 f"SH: {self._sh_degree_host}, pairs: {num_pairs}")
                self.logger.add_scalar("Loss", loss_val, iteration)
                self.logger.add_scalar("Gaussian Count", count, iteration)
                self.logger.add_scalar("Training Time (min)",
                                       timer.total_duration() / 60, iteration)
                self._resize_pair_budget(num_pairs, cap_step, overflow)
            if iteration in (cfgt.save_iterations or []):
                timer.log("saving")
                self.savePLY(f"{self.output_dir}/point_cloud/{iteration}.ply")
            if iteration in (cfgt.checkpoint_iterations or []):
                self.save_ckpt(f"{self.output_dir}/ckpt/{iteration}.ckpt")
            timer.stop()
        self.dataset.close()
        self.logger.info(timer.message())
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

        def score(camera):
            pkg = G.forward(self.params, self.state, camera, background, self.model_cfg,
                            self._settings_for(camera), is_training=False, impl=self.impl,
                            need_stats=False)
            img = pkg["render"]
            return img, torch.stack([L.psnr(img, camera.gt_image),
                                     L.ssim(img.clamp(0, 1), camera.gt_image)])

        for _, _, _, vals in self._scored_test_views(score, 0):
            psnrs.append(float(vals[0]))
            ssims.append(float(vals[1]))
        self.logger.info(f"[ITER {iteration}] Eval PSNR: {np.mean(psnrs):.3f}, "
                         f"SSIM: {np.mean(ssims):.3f}, views: {len(psnrs)}, "
                         f"gaussians: {int(self.state.alive.sum())}")
        self.logger.add_scalar("Average PSNR", float(np.mean(psnrs)), iteration)
        self.logger.add_scalar("Average SSIM", float(np.mean(ssims)), iteration)
        return float(np.mean(psnrs))

    def evaluate(self):
        return self._evaluate(0)

    # ------------------------------------------------------------------
    # IO (the 3DGS PLY schema)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def toRawGaussian(self) -> RawGaussian:
        """The alive Gaussians as a RawGaussian (SH in the 3DGS layout)."""
        alive = self.state.alive
        host = lambda x: x[alive].cpu().numpy()  # noqa: E731
        return RawGaussian(xyz=host(self.params.xyz), opacity=host(self.params.opacity),
                           shs=pack_sh_features(host(G.get_features(self.params))),
                           scale=host(self.params.scaling), rotation=host(self.params.rotation))

    def savePLY(self, path):
        g = self.toRawGaussian()
        self.logger.info(f"Saving {len(g)} gaussians to {path}")
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        g.savePLY(path)

    def loadPLY(self, path):
        """Replace the model by the Gaussians of a 3DGS PLY (fresh moments
        and statistics, capacity rounded up to 256, dead slots zero as the
        JAX trainer loads them)."""
        g = RawGaussian(ply_path=str(path))
        n = len(g)
        feats = unpack_sh_features(g.shs, (self.model_cfg.max_sh_degree + 1) ** 2)
        cap = (n + 255) // 256 * 256

        def pad(x):
            x = np.concatenate([x, np.zeros((cap - n,) + x.shape[1:], x.dtype)])
            return torch.as_tensor(x).to(self.device)
        self.params = G.GaussianParams(
            xyz=pad(g.xyz), scaling=pad(g.scale), rotation=pad(g.rotation),
            opacity=pad(g.opacity), f_dc=pad(feats[:, :1]), f_rest=pad(feats[:, 1:]))
        self.state = G.GaussianState.create(cap, device=self.device)
        self.state.alive = torch.arange(cap, device=self.device) < n
        self.opt = G.GSAdamState.create(self.params)
        self.logger.info(f"Loaded {n} gaussians from {path}")

    def save_ckpt(self, path):
        """The whole model (params, Adam moments and step, state) as host
        arrays (``utils.checkpoint``; no scene box, as the JAX trainer)."""
        self.logger.info(f"Saving checkpoint to {path}")
        blob = model_blob(*gaussian_to_numpy(self.params, self.state, self.opt))
        del blob["scene_bbox"]
        save_ckpt(path, blob, self.config.trainer.ckpt_format or "pickle")

    def load_ckpt(self, path):
        blob = load_ckpt(path)
        self.params, self.state, self.opt = gaussian_from_numpy(
            blob["params"], blob["state"], blob["opt"], device=self.device)
        self.logger.info(f"Restored checkpoint {path} "
                         f"({int(self.state.alive.sum())} gaussians)")
