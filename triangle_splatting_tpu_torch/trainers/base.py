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
from .adc_utils import adapt_pair_budget


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
        # (iteration, "opacity" | "clipping" | "scale" | "contribution",
        # rows pruned or clipped) per firing
        self.prune_history: list[tuple[int, str, int]] = []

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
        what = "opacity clipping] clipped" if kind == "clipping" else f"{kind} pruning] pruned"
        self.logger.info(f"[ITER {iteration}, {what} {n}{extra}")

    def _resize_pair_budget(self, num_pairs: int, capacity: int, overflow: bool) -> None:
        """Size the pair budget to a log step's measured need: the first
        sizing shrinks all the way to margin * need, later ones keep the
        anti-thrash hysteresis (as the JAX trainers do)."""
        first_sizing = not self._ppt_sized
        if not overflow:
            self._ppt_sized = True
        new_ppt = adapt_pair_budget(self._ppt, num_pairs, capacity, overflow,
                                    shrink_if_below=1.0 if first_sizing else 0.5)
        if new_ppt != self._ppt:
            self._ppt = new_ppt
            self.logger.warning(f"pair budget re-sized: pairs_per_triangle -> {self._ppt}")
