"""Trainer base: output dir, logging, seeding, device, dataset construction
(port of ``triangle_splatting_tpu/trainers/base.py``)."""

from __future__ import annotations

import random
import shutil
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
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
        raise NotImplementedError("dataset type 'Qijing' is not ported yet")
    raise ValueError(f"Unknown dataset type: {dtype}")


class BaseTrainer:
    def __init__(self, config: str | Config, exp_name: str | None = None,
                 log_file: bool = True, device="cuda"):
        if isinstance(config, (str, Path)):
            config = loadConfig(config)
        self.config = config
        self.device = resolve_device(device)
        if config.trainer.distributed is not None:
            raise NotImplementedError("trainer.distributed is not ported yet")
        if config.trainer.profile_start_iter:
            raise NotImplementedError("trainer.profile_start_iter is not ported yet")

        out_root = config.trainer.output_dir or "outputs/exp"
        self.output_dir = str(Path(out_root) / exp_name) if exp_name else out_root
        if config.trainer.clean_output_dir and Path(self.output_dir).exists():
            shutil.rmtree(self.output_dir)
        Path(self.output_dir).mkdir(parents=True, exist_ok=True)
        self.logger = Logger("trainer", output_dir=self.output_dir, log_file=log_file)

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
