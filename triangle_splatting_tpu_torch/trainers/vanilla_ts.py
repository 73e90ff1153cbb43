"""VanillaTS trainer, photo and mesh paths (port of
``triangle_splatting_tpu/trainers/vanilla_ts.py``).

One iteration: render one training camera through the kernel pipeline
(the 2D or the 3D rasterizer, optionally at ``render_up_scale`` times the
camera's size, optionally through the camera's color affine transform),
w_l1 * L1 + w_ssim * (1 - SSIM) (+ the DoG and smoothness terms, whose
weights come out of L1's, the scaling / opacity regularizers, the vertex
regularizer toward each vertex's nearest neighbor outside its triangle,
the affine regularizer, and with a ``geometry_loss`` block the
depth-normal consistency term, for which every render carries depth and
normal), autograd backward, Adam (eps 1e-15) with per-group learning-rate
schedules; SH bands come on along ``sh_schedule`` and gamma along
``gamma_schedule`` (the mesh recipes' solidify anneal). With a
``statistic`` block every step renders with the contribution statistics
and, inside the block's window, accumulates them with the screen-space
centroid gradient. Densification, opacity pruning and clipping, scale
pruning and clipping, contribution pruning and opacity reset fire on their
cadences, in the JAX trainer's order; a densification that runs out of
dead slots grows the capacity by half (``adc_utils.grow_capacity``). The
initial point cloud is split at the scene's bounding box and each part
used directly, randomly subsampled or grid-sampled (capacity twice the
count with a densification block). The alive triangles are saved as a
PLY at ``save_iterations`` / ``save_interval_iter`` and as a GLB mesh at
``save_glb_iterations`` (``toRawTriangle``: bounding-box filtering and the
STE threshold, as the JAX trainer exports), the whole model as a
checkpoint at ``checkpoint_iterations`` / ``ckpt_interval_iter``; a run
resumes from ``start_checkpoint`` (moments and statistics restored) or
``start_pointcloud`` (a saved PLY, fresh moments), its iterations
numbered on from there.

Evaluation reports PSNR and SSIM, and with ``eval_lpips`` LPIPS
(``trainers/lpips.py``; without a weights file it logs "LPIPS unavailable"
once and reports NaN). Config blocks this port does not serve raise
``NotImplementedError`` at construction: data parallelism and the orbax
checkpoint format.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from ..models import triangle as M
from ..models.model_utils import get_color_tensor, grid_sampling, grid_size_search
from ..models.raw_triangle import RawTriangle
from ..ops.projection import RasterSettings
from ..utils.camera import Camera
from ..convert import triangle_from_numpy, triangle_to_numpy
from ..utils.checkpoint import load_ckpt, model_blob, save_ckpt
from ..utils.config import Config
from ..utils.scheduler import exponential_scheduler, exponential_step_scheduler
from . import losses as L
from .adc_utils import alive_inter_point_dist, grow_capacity, resolve_contribution_pruning
from .base import BaseTrainer


def _f32(x) -> float:
    return float(np.float32(x))


class VanillaTSTrainer(BaseTrainer):
    def __init__(self, config: str | Config, exp_name: str | None = None,
                 log_file: bool = True, impl: str = "cuda", device="cuda"):
        super().__init__(config, exp_name, log_file, device)
        self._check_supported()
        # Full float32 for the SSIM convolutions and any matmul: TF32 keeps
        # ~3 decimal digits, too few for SSIM's cancelling variance terms.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.logger.info("TF32 disabled for cuDNN convolutions and matmuls")
        mc = self.config.model
        self.model_cfg = M.ModelConfig(
            max_sh_degree=mc.max_sh_degree if mc.max_sh_degree is not None else 0,
            use_color_affine=bool(mc.use_color_affine),
            back_culling=bool(mc.back_culling),
            back_culling_prob=mc.back_culling_prob if mc.back_culling_prob is not None else 1.0,
            ste_threshold=mc.ste_threshold,
            gamma_rescale=bool(mc.gamma_rescale),
            render_up_scale=mc.render_up_scale,
            rasterizer_type=mc.rasterizer_type or "2D",
        )
        self.impl = impl
        self.scene_bbox = None
        scene_info = self.dataset.getSceneInfo()
        if scene_info is not None:
            self.scene_bbox = scene_info.get("bbox_xyz")
        self.params: M.TriangleParams | None = None
        self.state: M.TriangleState | None = None
        self.opt: M.AdamState | None = None
        # Depth and normal (rich info) are rendered only for the
        # depth-normal consistency term, as the JAX trainer decides it:
        # static per run, in training and evaluation alike.
        geo = self.config.trainer.geometry_loss
        self._w_geometry = (geo.w_geometry or 0.0) if geo is not None else 0.0
        self._rich = self._w_geometry > 0
        self._geo_scale_factor = (geo.scale_factor if geo is not None
                                  and geo.scale_factor is not None else 0.5)
        t = self.config.trainer
        self._w_dog = t.w_dog or 0.0
        self._w_smooth = t.w_smoothness or 0.0
        self._dog_freq = 90
        self._w_vertex = (t.vertex_reg.w_vertex_reg or 0.0) if t.vertex_reg is not None else 0.0
        self._w_affine = t.w_affine_reg or 0.0
        # the vertex regularizer's nearest-neighbor indices, refreshed on its
        # cadence and after the capacity grows
        self._nearest_idx = None
        self._nearest_stale = False
        # the iterations at which the nearest neighbors were recomputed
        self.nearest_history: list[int] = []
        self._setup_schedulers()
        self._rng = np.random.default_rng(self.seed)
        self._sh_degree_host = 0
        # per-step losses of the last train() as device scalars (read them
        # after training: no host sync inside the loop)
        self.loss_history: list[torch.Tensor] = []
        # the geometry term of each step of the last train(), as device
        # scalars (0 without a geometry_loss block)
        self.geo_history: list[torch.Tensor] = []

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _check_supported(self):
        cfg = self.config
        mc, t = cfg.model, cfg.trainer

        def refuse(what):
            raise NotImplementedError(
                f"{what} is not ported to triangle_splatting_tpu_torch yet")

        if (mc.rasterizer_type or "2D") not in ("2D", "3D"):
            refuse(f"model.rasterizer_type {mc.rasterizer_type!r}")
        sampling = mc.sampling or Config()
        if (sampling.sample_method or "direct") not in ("direct", "random", "grid"):
            refuse(f"model.sampling.sample_method {sampling.sample_method!r}")
        if int(t.data_parallel or 0) > 1:
            refuse("trainer.data_parallel")
        if t.ckpt_format == "orbax":
            refuse("trainer.ckpt_format 'orbax' (it needs JAX)")

    def _setup_schedulers(self):
        oc = self.config.model.optimizer
        self.lr_schedulers = {}
        if oc is not None:
            for name in ("vertex", "opacity", "f_dc", "f_rest"):
                sub = getattr(oc, name)
                if sub is not None:
                    self.lr_schedulers[name] = exponential_scheduler(**vars(sub))
            if oc.color_affine is not None:
                self.lr_schedulers["affine"] = exponential_scheduler(**vars(oc.color_affine))
            if oc.vertex_scale_up_iter is not None and oc.vertex_scale_up is not None:
                base = self.lr_schedulers["vertex"]
                it0, mult = oc.vertex_scale_up_iter, oc.vertex_scale_up
                self.lr_schedulers["vertex"] = (
                    lambda it, base=base, it0=it0, mult=mult:
                    base(it) * (1.0 if it <= it0 else mult))
        self._mu = self.config.model.model_update
        # every step renders with the statistics while a statistic block
        # exists (the JAX trainer's need_stats gating)
        self._track_stats = self._mu is not None and self._mu.statistic is not None
        self._setup_adc_schedulers(self._mu)
        g = self._mu.gamma_schedule if self._mu is not None else None
        if g is not None:
            mk = exponential_step_scheduler if g.step_scheduler else exponential_scheduler
            kw = dict(v_init=g.gamma_init, v_final=g.gamma_final,
                      max_steps=g.end_iter - g.start_iter)
            if g.step_scheduler:
                kw["n_stage"] = g.n_stage
            self.gamma_scheduler = mk(**kw)

    def _lrs(self, iteration: int) -> dict:
        lrs = {name: _f32(fn(iteration)) for name, fn in self.lr_schedulers.items()}
        lrs.setdefault("affine", 0.0)
        return lrs

    def _settings_for(self, camera: Camera) -> RasterSettings:
        return RasterSettings(
            image_width=camera.image_width, image_height=camera.image_height,
            max_sh_degree=self.model_cfg.max_sh_degree,
            back_culling=self.model_cfg.back_culling,
            rasterizer_type=self.model_cfg.rasterizer_type,
            rich_info=self._rich,
            pairs_per_triangle=self._ppt)

    def _loss_weights(self, iteration: int) -> dict:
        t = self.config.trainer
        w_ssim = t.w_ssim or 0.0
        geo = t.geometry_loss
        w_geo = self._w_geometry if (geo is not None
                                     and iteration > (geo.start_iter or 0)) else 0.0
        oreg = t.w_opacity_reg
        w_quad = w_lin = 0.0
        if oreg is not None:
            if iteration > (oreg.linear_start_iter or 0):
                w_lin = oreg.linear_reg or 0.0
            elif iteration > (oreg.quad_start_iter or 0):
                w_quad = oreg.quad_reg or 0.0
        vr = t.vertex_reg
        w_v = self._w_vertex if (vr is not None and iteration > (vr.start_iter or 0)) else 0.0
        return {k: _f32(v) for k, v in dict(
            l1=1.0 - w_ssim - self._w_dog - self._w_smooth, ssim=w_ssim, dog=self._w_dog,
            smooth=self._w_smooth, geometry=w_geo, scaling=t.w_scaling_reg or 0.0,
            opacity_quad=w_quad, opacity_linear=w_lin, vertex=w_v,
            affine=self._w_affine).items()}

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------
    def _camera_loss(self, settings: RasterSettings, p: M.TriangleParams,
                     c2d, state: M.TriangleState, camera: Camera, background,
                     weights: dict, nearest_idx=None):
        """Per-camera training loss (the JAX twin's). ``c2d`` is the (C, 2)
        centroid-offset leaf or None; ``nearest_idx`` the (3C,) nearest
        neighbor of each vertex (the vertex regularizer) or None."""
        pkg = M.forward(p, state, camera, background, self.model_cfg, settings,
                        is_training=True, center2d_offset=c2d, impl=self.impl,
                        need_stats=self._track_stats)
        img = pkg["render"]
        gt = camera.gt_image
        if camera.alpha_mask is not None:
            img = img * camera.alpha_mask
            gt = gt * camera.alpha_mask
        w = weights
        loss = w["l1"] * L.l1(img, gt)
        loss = loss + w["ssim"] * L.ssim_loss(img, gt)
        if self._w_dog > 0:
            loss = loss + w["dog"] * L.dog_loss(img, gt, freq=self._dog_freq)
        if self._w_smooth > 0:
            loss = loss + w["smooth"] * L.smoothness_loss(img, gt)
        if self._w_geometry > 0:
            geo = L.depth_normal_loss(pkg["depth"], pkg["normal"], camera.tan_fovx,
                                      camera.tan_fovy, self._geo_scale_factor)
            loss = loss + w["geometry"] * geo
        else:
            geo = torch.zeros((), dtype=img.dtype, device=img.device)

        alive_f = state.alive.to(img.dtype)
        n_alive = torch.clamp_min(alive_f.sum(), 1.0)
        loss = loss + w["scaling"] * ((pkg["scaling"] * alive_f).sum() / n_alive)
        op = pkg["opacity"][:, 0]
        quad = ((0.25 - (op - 0.5) ** 2) * alive_f).sum() / n_alive
        lin = ((1.0 - op) * alive_f).sum() / n_alive
        loss = loss + (w["opacity_quad"] * quad + w["opacity_linear"] * lin)

        if self._w_vertex > 0 and nearest_idx is not None:
            pts = p.vertex.reshape(-1, 3)
            d2 = ((pts - pts[nearest_idx]) ** 2).sum(-1)
            mask3 = alive_f.repeat_interleave(3)
            vloss = (d2 * mask3).sum() / torch.clamp_min(mask3.sum(), 1.0)
            loss = loss + w["vertex"] * vloss
        else:
            vloss = torch.zeros((), dtype=img.dtype, device=img.device)

        if "render_original" in pkg and self._w_affine > 0:
            orig = pkg["render_original"]
            if camera.alpha_mask is not None:
                orig = orig * camera.alpha_mask
            loss = loss + w["affine"] * L.l1(img, orig)
        aux = dict(overflow=pkg["overflow"], num_pairs=pkg["num_pairs"],
                   geo_loss=geo.detach(), vertex_loss=vloss.detach())
        if self._track_stats:
            aux.update(radii=pkg["radii"], contrib_sum=pkg["contrib_sum"],
                       contrib_max=pkg["contrib_max"],
                       visible_mask=pkg["visible_mask"])
        return loss, aux

    def _loss_and_grads(self, settings, params, state, camera, background,
                        weights, nearest_idx=None):
        """Loss, per-parameter gradients (a TriangleParams) and aux. While
        statistics are tracked, the gradient of a zero (C, 2) centroid
        offset is taken too and returned as ``aux["center2d_grad"]``."""
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in params.tensors().items()}
        names = list(leaves)
        wrt = [leaves[n] for n in names]
        c2d = None
        if self._track_stats:
            c2d = torch.zeros((params.capacity, 2), dtype=params.vertex.dtype,
                              device=params.vertex.device, requires_grad=True)
            wrt.append(c2d)
        loss, aux = self._camera_loss(settings, M.TriangleParams(**leaves), c2d,
                                      state, camera, background, weights, nearest_idx)
        gs = torch.autograd.grad(loss, wrt, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, gs)]
        if c2d is not None:
            aux["center2d_grad"] = gs.pop()
        grads = M.TriangleParams(**dict(zip(names, gs)))
        return loss.detach(), grads, aux

    def _stat_gate(self, iteration: int) -> bool:
        st = self._mu.statistic
        return st.start_iter < iteration <= st.end_iter

    def _train_step(self, settings, params, opt, state, camera, weights, lrs,
                    background, iteration: int, nearest_idx=None):
        """One iteration: forward, loss, backward, Adam and, inside the
        statistic window, the statistics update. Returns (params, opt,
        state, loss, aux)."""
        loss, grads, aux = self._loss_and_grads(settings, params, state, camera,
                                                background, weights, nearest_idx)
        params, opt = M.adam_update(params, opt, grads, lrs)
        if self._track_stats and self._stat_gate(iteration):
            state = M.update_statistics(state, aux["center2d_grad"], aux["radii"],
                                        aux["contrib_sum"], aux["contrib_max"],
                                        aux["visible_mask"])
        return params, opt, state, loss, aux

    # ------------------------------------------------------------------
    # loop
    # ------------------------------------------------------------------
    def _init_model(self):
        """Resume from ``start_checkpoint`` / ``start_pointcloud`` or, on
        the first call, initialize from the point cloud. Returns the
        iteration the run continues after."""
        cfgt = self.config.trainer
        first_iter = 0
        if cfgt.start_checkpoint:
            self.load_ckpt(f"{self.output_dir}/ckpt/{cfgt.start_checkpoint}.ckpt")
            first_iter = int(cfgt.start_checkpoint)
        elif cfgt.start_pointcloud:
            self.loadPLY(f"{self.output_dir}/point_cloud/{cfgt.start_pointcloud}.ply")
            first_iter = int(cfgt.start_pointcloud)
        if self.params is None:
            self.logger.info("Initializing triangles from point cloud")
            pcd = self.dataset.getPointCloud()
            sampling = self.config.model.sampling or Config()
            pts, cols, nrm = self._sample_points(pcd)
            has_densify = self._mu is not None and self._mu.densification is not None
            self.params, self.state = M.create_from_points(
                pts, cols, nrm, self.model_cfg,
                init_opacity=sampling.init_opacity if sampling.init_opacity is not None else 0.1,
                capacity_factor=2.0 if has_densify else 1.0,
                duplicate_count=sampling.duplicate_count or 1,
                seed=self.seed, device=self.device)
            if self.model_cfg.use_color_affine:
                self.params = M.setup_color_affine(
                    self.params, self.dataset.getTrainDatasetSize())
            self.opt = M.AdamState.create(self.params)
            self.logger.info(
                f"Initialized {int(self.state.alive.sum())} triangles "
                f"(capacity {self.params.capacity})")
        return first_iter

    def _sample_points(self, pcd):
        """The point cloud split at the scene's bounding box (if it has
        one) into inside and outside points, each part used directly,
        randomly subsampled to ``n_sample_<part>`` or grid-sampled at
        ``grid_size_<part>`` (searched to ~``n_sample_<part>`` voxels when
        unset) with unit normals; the JAX trainer's sampling."""
        sampling = self.config.model.sampling or Config()
        pts = np.asarray(pcd.points, np.float32)
        cols = np.asarray(pcd.colors, np.float32)
        nrm = np.asarray(pcd.normals, np.float32)
        if len(pts) == 0:
            raise ValueError("Empty point cloud and no random_init support yet")
        if self.scene_bbox is None:
            groups = [(pts, cols, nrm, "inside")]
        else:
            bbox = np.asarray(self.scene_bbox, np.float32).reshape(-1)
            if bbox.size == 4:
                inside = np.all((pts[:, :2] >= bbox[:2]) & (pts[:, :2] <= bbox[2:]), -1)
            else:
                inside = np.all((pts >= bbox[:3]) & (pts <= bbox[3:]), -1)
            groups = [(pts[inside], cols[inside], nrm[inside], "inside"),
                      (pts[~inside], cols[~inside], nrm[~inside], "outside")]
        method = sampling.sample_method or "direct"
        out_p, out_c, out_n = [], [], []
        for p, c, n, name in groups:
            n_sample = getattr(sampling, f"n_sample_{name}", None)
            grid_size = getattr(sampling, f"grid_size_{name}", None)
            if method == "random" and n_sample and 0 < n_sample < len(p):
                idx = self._rng.permutation(len(p))[:n_sample]
                p, c, n = p[idx], c[idx], n[idx]
            elif method == "grid" and len(p):
                gs = grid_size or grid_size_search(p, n_sample)
                p, c, n = grid_sampling(p, c, n, gs)
                n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
            self.logger.info(f"Sampled {len(p)} {name} points ({method})")
            out_p.append(p)
            out_c.append(c)
            out_n.append(n)
        return np.concatenate(out_p), np.concatenate(out_c), np.concatenate(out_n)

    def _model_update(self, iteration: int):
        """Densification, opacity pruning, opacity clipping, scale pruning,
        scale clipping, contribution pruning and opacity reset on their
        cadences, then the gamma and SH schedules (the JAX trainer's
        order). Opacity pruning and clipping and scale clipping fire
        through ``hold_iter`` (default ``end_iter``), their thresholds held
        at the final value past ``end_iter``."""
        mu = self._mu
        if mu is None:
            return
        active = lambda block, hold=False: self._fires(block, iteration, hold)  # noqa: E731

        d = mu.densification
        if active(d):
            thr = self.grad_threshold_scheduler(iteration - d.start_iter)
            self._densify(iteration, thr, d.min_view_count, lambda: M.densify(
                self.params, self.opt, self.state, _f32(thr), d.min_view_count,
                _f32(d.split_scale_threshold)))

        op = mu.opacity_pruning
        if active(op, hold=True):
            thr = self.opacity_pruning_scheduler(iteration - op.start_iter)
            self.params, self.opt, self.state, n = M.opacity_pruning(
                self.params, self.opt, self.state, _f32(thr))
            self._log_prune(iteration, "opacity", int(n), f", threshold {thr:.5f}")

        oc = mu.opacity_clipping
        if active(oc, hold=True):
            thr = self.opacity_clipping_scheduler(iteration - oc.start_iter)
            self.params, self.opt, self.state, n = M.opacity_clipping(
                self.params, self.opt, self.state, _f32(thr))
            self._log_prune(iteration, "clipping", int(n), f", threshold {thr:.5f}")

        sp = mu.scale_pruning
        if active(sp):
            self.params, self.opt, self.state, n = M.scale_pruning(
                self.params, self.opt, self.state, _f32(sp.radii_threshold),
                _f32(sp.scale_threshold))
            self._log_prune(iteration, "scale", int(n))

        sc = mu.scale_clipping
        if active(sc, hold=True):
            mx = self.scale_max_scheduler(iteration - sc.start_iter)
            self.params, self.opt, self.state, n = M.scale_clipping(
                self.params, self.opt, self.state, _f32(mx))
            self._log_prune(iteration, "scale clipping", int(n), f", max {mx:.4f}")

        cp = mu.contribution_pruning
        if active(cp):
            target, ratio, prune_ratio, retain = resolve_contribution_pruning(cp, iteration)
            if target is None:
                raise ValueError(
                    "model.model_update.contribution_pruning.target_point_"
                    "num is null — set it (run_experiments.py mesh presets "
                    "provide per-scene targets, e.g. --point_num) or add a "
                    "downsample schedule before contribution pruning "
                    "activates.")
            ipd = None
            if retain > 0:
                ipd = alive_inter_point_dist(M.get_xyz(self.params), self.state.alive)
            self.params, self.opt, self.state, n = M.contribution_pruning(
                self.params, self.opt, self.state,
                min_view_count=cp.min_view_count if cp.min_view_count is not None else 1,
                target_point_num=int(target), prune_ratio=_f32(prune_ratio),
                max_prune_ratio=_f32(cp.max_prune_ratio
                                     if cp.max_prune_ratio is not None else 0.2),
                contrib_max_ratio=_f32(ratio), scene_bbox=self.scene_bbox,
                ste_threshold=self.model_cfg.ste_threshold,
                inter_point_dist=ipd, sparsity_retain_ratio=retain)
            self._log_prune(iteration, "contribution", int(n))

        orr = mu.opacity_reset
        if active(orr):
            self.params, self.opt, self.state = M.opacity_reset(
                self.params, self.opt, self.state, _f32(orr.reset_value))
            self.logger.info(f"[ITER {iteration}, opacity reset] -> {orr.reset_value}")

        g = mu.gamma_schedule
        if g is not None and g.start_iter < iteration <= g.end_iter:
            gamma = self.gamma_scheduler(iteration - g.start_iter)
            self.state.gamma = torch.tensor(gamma, dtype=torch.float32,
                                            device=self.device)
        shs = mu.sh_schedule
        if shs is not None:
            deg = sum(1 for it in shs.one_up_iters if iteration > it)
            deg = min(deg, self.model_cfg.max_sh_degree)
            if deg != self._sh_degree_host:
                self._sh_degree_host = deg
                self.state.active_sh_degree = torch.tensor(
                    deg, dtype=torch.int32, device=self.device)

    def _grow_capacity(self):
        """Zero-pad params, moments and state by half the capacity (the
        vertex regularizer's nearest neighbors are then recomputed)."""
        self.params, self.opt, self.state = grow_capacity(
            self.params, self.opt, self.state, self.logger)
        self._nearest_stale = True

    def _refresh_nearest(self, iteration: int):
        """The vertex regularizer's nearest neighbors over the alive
        triangles' vertices (``ops/knn.py``), recomputed every
        ``interval_iter`` steps after ``start_iter``, on the first step and
        after the capacity grew."""
        vr = self.config.trainer.vertex_reg
        if not (self._w_vertex > 0 and iteration > (vr.start_iter or 0)):
            return
        if ((iteration - 1) % (vr.interval_iter or 10) == 0 or self._nearest_idx is None
                or self._nearest_stale):
            from ..ops.knn import nearest_neighbor
            self._nearest_stale = False
            self._nearest_idx = nearest_neighbor(
                self.params.vertex.detach().reshape(-1, 3), 3,
                self.state.alive.repeat_interleave(3))
            self.nearest_history.append(iteration)

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
        self.geo_history = []
        self._nearest_idx = None
        t_start = time.perf_counter()
        for iteration in range(first_iter + 1, (cfgt.iterations or 30000) + 1):
            camera = self.dataset.nextTrainData()
            settings = self._settings_for(camera)
            if self.model_cfg.back_culling and self.model_cfg.back_culling_prob < 1.0:
                settings = replace(settings, back_culling=bool(
                    self._rng.random() < self.model_cfg.back_culling_prob))
            bg_name = cfgt.train_background or "random"
            background = torch.as_tensor(get_color_tensor(bg_name, self._rng)).to(self.device)
            cap_step = self.params.capacity
            self._refresh_nearest(iteration)
            self.params, self.opt, self.state, loss, aux = self._train_step(
                settings, self.params, self.opt, self.state, camera,
                self._loss_weights(iteration), self._lrs(iteration), background,
                iteration, self._nearest_idx)
            self.loss_history.append(loss)
            self.geo_history.append(aux["geo_loss"])
            self._note_overflow(aux["overflow"])

            if cfgt.eval_interval_iter and iteration % cfgt.eval_interval_iter == 0:
                self._evaluate(iteration)
            self._model_update(iteration)

            if cfgt.log_interval_iter and iteration % cfgt.log_interval_iter == 0:
                loss_val = float(loss)
                count = self.triangle_count()
                num_pairs, overflow = int(aux["num_pairs"]), bool(aux["overflow"])
                geo_txt = ""
                if self._w_geometry > 0:
                    geo_val = float(aux["geo_loss"])
                    geo_txt = f", Geometry: {geo_val:.5f}"
                    self.logger.add_scalar("Geometry Loss", geo_val, iteration)
                self.logger.info(
                    f"[ITER {iteration}] Loss: {loss_val:.5f}{geo_txt}, Triangles: {count}, "
                    f"Gamma: {float(self.state.gamma):.3f}, SH: {self._sh_degree_host}, "
                    f"pairs: {num_pairs}")
                self.logger.add_scalar("Loss", loss_val, iteration)
                self.logger.add_scalar("Triangle Count", count, iteration)
                self.logger.add_scalar("Training Time (min)",
                                       (time.perf_counter() - t_start) / 60, iteration)
                self._resize_pair_budget(num_pairs, cap_step, overflow)

            if cfgt.histogram_interval_iter and iteration % cfgt.histogram_interval_iter == 0:
                alive = self.state.alive
                self.logger.add_histogram(
                    "Opacity", M.get_opacity(self.params)[alive, 0].cpu().numpy(), iteration)
                self.logger.add_histogram(
                    "Scaling", M.get_scaling(self.params)[alive].cpu().numpy(), iteration)

            if iteration in (cfgt.save_iterations or []) or (
                    cfgt.save_interval_iter and iteration % cfgt.save_interval_iter == 0):
                self.savePLY(f"{self.output_dir}/point_cloud/{iteration}.ply")
            if iteration in (cfgt.checkpoint_iterations or []) or (
                    cfgt.ckpt_interval_iter and iteration % cfgt.ckpt_interval_iter == 0):
                self.save_ckpt(f"{self.output_dir}/ckpt/{iteration}.ckpt")
            if iteration in (cfgt.save_glb_iterations or []):
                self.saveGLB(f"{self.output_dir}/glb/{iteration}.glb")
        self.dataset.close()
        self.logger.info("Training finished")

    @torch.no_grad()
    def triangle_count(self) -> int:
        """Triangles logged as the count: those whose opacity passes the
        STE threshold when one is set (mesh configs), else the alive ones."""
        alive = self.state.alive
        ste = self.model_cfg.ste_threshold
        if ste is not None:
            alive = alive & (M.get_opacity(self.params)[:, 0] > ste)
        return int(alive.sum())

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    @torch.no_grad()
    def psnr_views(self, cameras, background, use_mask: bool = True) -> list[float]:
        """PSNR of the current model on each camera's GT image."""
        out = []
        for camera in cameras:
            pkg = M.forward(self.params, self.state, camera, background,
                            self.model_cfg, self._settings_for(camera),
                            is_training=False, impl=self.impl, apply_color_affine=False)
            mask = camera.alpha_mask if use_mask else None
            out.append(float(L.psnr(pkg["render"], camera.gt_image, mask)))
        return out

    @torch.no_grad()
    def _evaluate(self, iteration: int, compute_lpips: bool | None = None):
        """Mean PSNR and SSIM over the test views (the color affine not
        applied), and LPIPS with ``eval_lpips`` (or ``compute_lpips``) while
        its weights are found. Returns the mean PSNR."""
        cfgt = self.config.trainer
        bg_name = cfgt.eval_background or "black"
        background = torch.as_tensor(get_color_tensor(bg_name, self._rng)).to(self.device)
        eval_mask = True if cfgt.eval_alpha_mask is None else bool(cfgt.eval_alpha_mask)
        if compute_lpips is None:
            compute_lpips = bool(cfgt.eval_lpips)
        n_img = cfgt.eval_save_img_count or 3
        psnrs, ssims, lpips_vals = [], [], []
        for i, camera in enumerate(self.dataset.getTestDataset()):
            pkg = M.forward(self.params, self.state, camera, background,
                            self.model_cfg, self._settings_for(camera),
                            is_training=False, impl=self.impl, apply_color_affine=False)
            img = pkg["render"]
            mask = camera.alpha_mask if eval_mask else None
            psnrs.append(float(L.psnr(img, camera.gt_image, mask)))
            ssims.append(float(L.ssim(img.clamp(0, 1), camera.gt_image)))
            if compute_lpips:
                lpips_vals.append(self._lpips(img, camera.gt_image))
            if i < n_img:
                self.logger.add_image(f"Pred {i}", img.cpu().numpy(), iteration)
        msg = f"[ITER {iteration}] Eval PSNR: {np.mean(psnrs):.3f}, SSIM: {np.mean(ssims):.3f}"
        if lpips_vals:
            msg += f", LPIPS: {np.mean(lpips_vals):.3f}"
        self.logger.info(msg + f", views: {len(psnrs)}, "
                         f"triangles: {int(self.state.alive.sum())}")
        self.logger.add_scalar("Average PSNR", float(np.mean(psnrs)), iteration)
        self.logger.add_scalar("Average SSIM", float(np.mean(ssims)), iteration)
        if lpips_vals:
            self.logger.add_scalar("Average LPIPS", float(np.mean(lpips_vals)), iteration)
        self.last_eval = dict(psnr=float(np.mean(psnrs)), ssim=float(np.mean(ssims)),
                              lpips=float(np.mean(lpips_vals)) if lpips_vals else None)
        return float(np.mean(psnrs))

    def _lpips(self, img: torch.Tensor, gt: torch.Tensor) -> float:
        """LPIPS of one view (``trainers/lpips.py``); NaN, with a warning
        logged once, when no weights file is found. Any other fault
        raises."""
        from .lpips import lpips
        try:
            return float(lpips(img.clamp(0, 1), gt))
        except FileNotFoundError as e:
            self.logger.warnOnce(f"LPIPS unavailable: {e}")
            return float("nan")

    def evaluate(self):
        return self._evaluate(0)

    # ------------------------------------------------------------------
    # IO
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _alive_arrays(self):
        alive = self.state.alive
        vertex = self.params.vertex[alive].cpu().numpy()
        opacity = self.params.opacity[alive].cpu().numpy()
        shs = M.get_features(self.params)[alive].cpu().numpy()
        return vertex, opacity, shs.reshape(len(vertex), -1)

    def toRawTriangle(self, bbox_filtering: bool = True) -> RawTriangle:
        """The alive triangles as a RawTriangle: with ``bbox_filtering``
        those whose centroid lies inside the scene's bounding box, and with
        an STE threshold those whose opacity passes it, saved opaque
        (logit 10)."""
        vertex, opacity, shs = self._alive_arrays()
        if bbox_filtering and self.scene_bbox is not None:
            bbox = np.asarray(self.scene_bbox, np.float32).reshape(-1)
            xyz = vertex.mean(1)
            if bbox.size == 4:
                keep = np.all((xyz[:, :2] >= bbox[:2]) & (xyz[:, :2] <= bbox[2:]), -1)
            else:
                keep = np.all((xyz >= bbox[:3]) & (xyz <= bbox[3:]), -1)
            vertex, opacity, shs = vertex[keep], opacity[keep], shs[keep]
        thr = self.model_cfg.ste_threshold
        if thr is not None:
            sig = 1 / (1 + np.exp(-opacity[:, 0]))
            keep = sig > thr
            vertex, shs = vertex[keep], shs[keep]
            opacity = np.full((keep.sum(), 1), 10.0, np.float32)
        return RawTriangle(vertex, opacity, shs)

    def savePLY(self, path, bbox_filtering: bool = True):
        self.logger.info(f"Saving triangles to {path}")
        self.toRawTriangle(bbox_filtering).savePLY(path, save_extra=True)

    def saveGLB(self, path, bbox_filtering: bool = True):
        self.logger.info(f"Saving mesh to {path}")
        self.toRawTriangle(bbox_filtering).saveGLB(
            path, save_back=not self.model_cfg.back_culling)

    def loadPLY(self, path):
        """Replace the model by the triangles of a PLY (fresh Adam moments
        and statistics, capacity rounded up to 256)."""
        raw = RawTriangle(ply_path=path)
        n = len(raw)
        K = (self.model_cfg.max_sh_degree + 1) ** 2
        shs = raw.shs.reshape(n, -1, 3)
        feats = np.zeros((n, K, 3), np.float32)
        take = min(K, shs.shape[1])
        feats[:, :take] = shs[:, :take]
        cap = M._round_up(n, 256)

        def pad(x):
            x = np.concatenate([x, np.zeros((cap - n,) + x.shape[1:], x.dtype)])
            return torch.as_tensor(x).to(self.device)

        self.params = M.TriangleParams(vertex=pad(raw.vertex), opacity=pad(raw.opacity),
                                       f_dc=pad(feats[:, :1]), f_rest=pad(feats[:, 1:]))
        if self.model_cfg.use_color_affine:
            self.params = M.setup_color_affine(self.params, self.dataset.getTrainDatasetSize())
        self.state = M.TriangleState.create(cap, device=self.device)
        self.state.alive = torch.arange(cap, device=self.device) < n
        self.opt = M.AdamState.create(self.params)
        self.logger.info(f"Loaded {n} triangles from {path}")

    def save_ckpt(self, path):
        """The whole model (params, Adam moments and step, state) and the
        scene's bounding box as host arrays (``utils.checkpoint``)."""
        self.logger.info(f"Saving checkpoint to {path}")
        p, st, o = triangle_to_numpy(self.params, self.state, self.opt)
        save_ckpt(path, model_blob(p, st, o, self.scene_bbox),
                  self.config.trainer.ckpt_format or "pickle")

    def load_ckpt(self, path):
        blob = load_ckpt(path)
        self.params, self.state, self.opt = triangle_from_numpy(
            blob["params"], blob["state"], blob["opt"], device=self.device)
        self.scene_bbox = blob.get("scene_bbox")
        self.logger.info(f"Restored checkpoint {path} "
                         f"({int(self.state.alive.sum())} triangles)")
