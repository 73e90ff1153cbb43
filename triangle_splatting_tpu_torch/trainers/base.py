"""Trainer base: output dir, logging, seeding, device, dataset construction
(port of ``triangle_splatting_tpu/trainers/base.py``)."""

from __future__ import annotations

import random
import shutil
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..utils import tracing
from ..utils.config import Config, loadConfig
from ..utils.logger import Logger
from ..utils.scheduler import exponential_scheduler
from .adc_utils import adapt_pair_budget

# the threshold schedule of each ADC block that has one: (block, the prefix
# of its _init / _final keys, the trainer attribute holding the schedule)
ADC_SCHEDULES = (("densification", "grad_threshold", "grad_threshold_scheduler"),
                 ("opacity_pruning", "opacity_threshold", "opacity_pruning_scheduler"),
                 ("opacity_clipping", "opacity_threshold", "opacity_clipping_scheduler"),
                 ("scale_clipping", "scale_max", "scale_max_scheduler"))

# the ADC block of each kind ``_log_prune`` logs
PRUNE_BLOCKS = {"opacity": "opacity_pruning", "clipping": "opacity_clipping",
                "scale": "scale_pruning", "scale clipping": "scale_clipping",
                "contribution": "contribution_pruning"}


def build_dataset(config: Config, logger: Logger, device):
    dtype = config.type
    if dtype == "NerfSynthetic":
        from ..datasets.nerf_synthetic import NerfSyntheticDatasetFactory
        return NerfSyntheticDatasetFactory(config, logger, device)
    if dtype in ("Colmap", "MipNerf360", "TanksAndBlending", "TanksAndTemples"):
        from ..datasets.colmap import ColmapDatasetFactory
        return ColmapDatasetFactory(config, logger, device)
    if dtype == "MatrixCity":
        from ..datasets.matrix_city import MatrixCityDatasetFactory
        return MatrixCityDatasetFactory(config, logger, device)
    if dtype == "Qijing":
        from ..datasets.qijing import QijingDatasetFactory
        return QijingDatasetFactory(config, logger, device)
    raise ValueError(f"Unknown dataset type: {dtype}")


class BaseTrainer:
    def __init__(self, config: str | Config, exp_name: str | None = None,
                 log_file: bool = True, device="cuda"):
        if isinstance(config, (str, Path)):
            config = loadConfig(config)
        self.config = config
        self.device = resolve_device(device)

        out_root = config.trainer.output_dir or "outputs/exp"
        self.output_dir = str(Path(out_root) / exp_name) if exp_name else out_root
        if config.trainer.clean_output_dir and Path(self.output_dir).exists():
            shutil.rmtree(self.output_dir)
        Path(self.output_dir).mkdir(parents=True, exist_ok=True)
        self.logger = Logger("trainer", output_dir=self.output_dir, log_file=log_file,
                             use_tensorboard=bool(config.trainer.use_tensorboard))
        self._profiler = None

        # Multi-process: join the torch.distributed job (the
        # trainer.distributed block or the TS_* environment) before the first
        # CUDA use; a CUDA rank then works on its own card
        # (parallel/multihost.py), and the data group the trainers build
        # spans the ranks.
        from ..parallel.multihost import distributed_settings, maybe_initialize, rank_device
        dist_settings = distributed_settings(config)
        if dist_settings is not None:
            maybe_initialize(config, self.logger, device=self.device)
            if self.device.type == "cuda":
                self.device = rank_device(dist_settings[2])

        seed = config.trainer.seed
        if seed is not None:
            random.seed(seed)
            np.random.seed(seed)
            torch.manual_seed(seed)
        self.seed = seed if seed is not None else 0

        if config.trainer.detect_anomaly:
            torch.autograd.set_detect_anomaly(True)
            self.logger.warning("detect_anomaly: torch.autograd anomaly mode on (slow)")

        self.dataset = build_dataset(config.dataset, self.logger, self.device)
        # pair budget per primitive, re-sized to measured need at log steps
        self._ppt = config.model.pairs_per_triangle or 6
        self._ppt_sized = False
        # (iteration, "opacity" | "clipping" | "scale" | "scale clipping" |
        # "contribution", rows pruned or clipped) per firing
        self.prune_history: list[tuple[int, str, int]] = []
        # one dict per densification firing: iteration, grown (rows selected),
        # placed (new rows), split_pruned (split originals removed),
        # overflow (candidates left over: the capacity grew), capacity after
        self.densify_history: list[dict] = []
        # steps since the last log step whose frame overflowed the pair
        # budget (a device counter, read at log steps)
        self._overflow_steps = 0
        # camera data parallelism: views a step, the data group over the
        # ranks (built when training starts; a world of one without data
        # parallelism) and the views of each rank
        from ..parallel.multihost import LOCAL
        self._dp_n = int(config.trainer.data_parallel or 1)
        self._dp_group = LOCAL
        self._dp_b = 1

    def _setup_data_parallel(self):
        """The data group of ``trainer.data_parallel`` > 1: ``dp_layout``
        over the job's ranks, and a check that every rank starts from the
        same model."""
        from ..parallel.mesh import dp_layout, make_mesh
        from ..parallel.multihost import check_replicated
        n_dev, self._dp_b = dp_layout(self._dp_n)
        self._dp_group = make_mesh(n_dev)
        check_replicated(self._dp_group, self.params, self.opt, self.state,
                         what="the initial models")
        self.logger.info(
            f"Camera-batch data parallelism: {self._dp_n} views per step over "
            f"{n_dev} rank(s) ({self._dp_b} per rank, mean-gradient all-reduce, "
            f"backend {self._dp_group.backend or 'none (one process)'})")

    @tracing.spanned("data")
    def _next_batch(self):
        """The step's cameras: one, or the ``data_parallel`` views every
        rank draws in the same order, and this rank's share of them
        (``global_dp_inputs``). Returns (first camera, local views, idle
        camera)."""
        camera = self.dataset.nextTrainData()
        if self._dp_n == 1:
            return camera, [camera], None
        from ..parallel.mesh import stack_dp_cameras
        from ..parallel.multihost import global_dp_inputs
        batch = stack_dp_cameras(
            [camera] + [self.dataset.nextTrainData() for _ in range(self._dp_n - 1)])
        return camera, global_dp_inputs(self._dp_group, batch)[0], batch[0]

    def _scored_test_views(self, score, n_img: int):
        """``(index, camera, img, scores)`` of every test view, ``score(camera)
        -> (img, scores)``: over the data group's ranks
        (``dp_eval_scores``, images gathered for the first ``n_img``) when
        data parallelism is on and the test views share one resolution,
        else one after the other on this rank."""
        test_cams = list(self.dataset.getTestDataset())
        if (self._dp_n > 1 and len(test_cams) > 1
                and len({(c.image_width, c.image_height) for c in test_cams}) == 1):
            from ..parallel.mesh import dp_eval_scores
            yield from dp_eval_scores(self._dp_group, score, test_cams, self._dp_b, n_img)
            return
        for i, camera in enumerate(test_cams):
            yield (i, camera, *score(camera))

    def _profile_hooks(self, iteration: int) -> None:
        """Open a ``torch.profiler`` window (CPU, and CUDA on the card) at
        ``trainer.profile_start_iter`` and close it at ``profile_end_iter``
        (default 10 iterations later), writing its Chrome trace to
        ``<output_dir>/profile/trace_<start>_<end>.json`` and the program's
        spans and counters of the window (``utils/tracing.py``, on while the
        profiler records) to ``spans_<start>_<end>.json`` beside it; read
        both with ``python -m triangle_splatting_tpu_torch.tools.trace_report``."""
        cfgt = self.config.trainer
        start = cfgt.profile_start_iter
        if not start:
            return
        end = cfgt.profile_end_iter or (start + 10)
        if iteration == start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            tracing.set_step(iteration)          # seen off: the last session ends
            self._profiler.start()
            tracing.set_step(iteration)          # seen on: the window's session starts
            self.logger.info(f"[ITER {iteration}] profiler trace started")
        if iteration == end and self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.stop()
            out = Path(self.output_dir) / "profile"
            out.mkdir(parents=True, exist_ok=True)
            self._profiler.export_chrome_trace(str(out / f"trace_{start}_{end}.json"))
            tracing.write(out / f"spans_{start}_{end}.json")
            self._profiler = None
            self.logger.info(f"[ITER {iteration}] profiler trace written to {out}")

    def _setup_adc_schedulers(self, mu) -> None:
        """The exponential threshold schedule of each ADC block of ``mu``
        (``model.model_update``) that has one, over its window."""
        for block, key, attr in ADC_SCHEDULES:
            b = getattr(mu, block) if mu is not None else None
            if b is not None:
                setattr(self, attr, exponential_scheduler(
                    v_init=getattr(b, f"{key}_init"), v_final=getattr(b, f"{key}_final"),
                    max_steps=b.end_iter - b.start_iter))

    @staticmethod
    def _fires(block, iteration: int, hold: bool = False) -> bool:
        """Whether an ADC block fires at ``iteration``: inside (start_iter,
        end_iter] (through ``hold_iter`` when ``hold`` and it is set) on
        its interval."""
        if block is None:
            return False
        last = (block.hold_iter if hold else None) or block.end_iter
        return block.start_iter < iteration <= last and iteration % block.interval_iter == 0

    def _log_prune(self, iteration: int, kind: str, n: int, extra: str = "") -> None:
        self.prune_history.append((iteration, kind, n))
        tracing.count(f"adc.{PRUNE_BLOCKS[kind]}.rows", n)
        what = {"clipping": "opacity clipping] clipped",
                "scale clipping": "scale clipping] clipped"}.get(kind, f"{kind} pruning] pruned")
        self.logger.info(f"[ITER {iteration}, {what} {n}{extra}")

    def _densify(self, iteration: int, threshold: float, min_view_count, run) -> None:
        """Run one densification (``run()`` returns (params, opt, state,
        grown, overflow)), grow the capacity when candidates were left
        over, and log the firing with the grad statistic's quantiles (taken
        before densify resets it), the rows it placed and the split
        originals it removed (the alive count moves by their difference)."""
        from ..models.triangle import densify_stats
        stats = densify_stats(self.state, min_view_count).cpu().numpy()
        alive0 = self.state.alive.clone()
        self.params, self.opt, self.state, grown, overflow = run()
        alive1 = self.state.alive
        rec = dict(iteration=iteration, grown=int(grown),
                   placed=int((alive1 & ~alive0).sum()),
                   split_pruned=int((alive0 & ~alive1).sum()), overflow=bool(overflow),
                   grad_stat=dict(p50=float(stats[0]), p99=float(stats[1]),
                                  max=float(stats[2]), eligible=int(stats[3])))
        if rec["overflow"]:
            self._grow_capacity()
        rec["capacity"] = self.params.capacity
        self.densify_history.append(rec)
        tracing.count("adc.densification.rows", rec["placed"])
        self.logger.info(
            f"[ITER {iteration}, densification] grew {rec['grown']} points, threshold "
            f"{threshold:.3e} (grad-stat p50 {stats[0]:.2e} p99 {stats[1]:.2e} max "
            f"{stats[2]:.2e}, {int(stats[3])} eligible), placed {rec['placed']}, split "
            f"originals pruned {rec['split_pruned']}"
            + (", capacity full" if rec["overflow"] else ""))

    def _note_overflow(self, overflow) -> None:
        """Count a step whose frame overflowed the pair budget (on the
        device: no host sync between log steps)."""
        self._overflow_steps = self._overflow_steps + overflow.to(torch.int32)

    def _resize_pair_budget(self, num_pairs: int, capacity: int, overflow: bool) -> None:
        """Size the pair budget to a log step's measured need: the first
        sizing shrinks all the way to margin * need, later ones keep the
        anti-thrash hysteresis (as the JAX trainers do). A frame of any
        step since the last log step that overflowed is logged and grows
        the budget as the log step's own overflow does."""
        missed = int(self._overflow_steps)
        self._overflow_steps = 0
        if missed:
            self.logger.warning(f"{missed} step(s) since the last log step overflowed the "
                                f"pair budget (pairs_per_triangle {self._ppt})")
            overflow = True
        first_sizing = not self._ppt_sized
        if not overflow:
            self._ppt_sized = True
        new_ppt = adapt_pair_budget(self._ppt, num_pairs, capacity, overflow,
                                    shrink_if_below=1.0 if first_sizing else 0.5)
        if new_ppt != self._ppt:
            self._ppt = new_ppt
            self.logger.warning(f"pair budget re-sized: pairs_per_triangle -> {self._ppt}")
