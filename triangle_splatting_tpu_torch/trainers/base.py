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


def build_dataset(config: Config, logger: Logger, device):
    dtype = config.type
    if dtype == "NerfSynthetic":
        from ..datasets.nerf_synthetic import NerfSyntheticDatasetFactory
        return NerfSyntheticDatasetFactory(config, logger, device)
    raise NotImplementedError(f"dataset type {dtype!r} is not ported yet "
                              "(the port serves NerfSynthetic)")


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
