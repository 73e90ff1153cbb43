"""Minimal logger: console + optional file + JSONL metric events.

A reduced copy of ``triangle_splatting_tpu/utils/logger.py``: the trainer
needs text logging and scalar/histogram/image sinks; TensorBoard and the
multiprocessing logger are not carried over.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

import numpy as np


class Logger:
    """Console/file logger plus scalar and image sinks (``<out>/log``)."""

    def __init__(self, name: str = "ts", output_dir: str | Path | None = None,
                 log_file: bool = True, level: int = logging.INFO):
        self.logger = logging.getLogger(f"{name}-{id(self)}")
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        fmt = "%(asctime)s %(levelname)s %(message)s"
        sh = logging.StreamHandler(sys.stderr)
        sh.setLevel(level)
        sh.setFormatter(logging.Formatter(fmt, datefmt="%H:%M:%S"))
        self.logger.addHandler(sh)

        self.output_dir = Path(output_dir) if output_dir is not None else None
        self._events_file = None
        if self.output_dir is not None:
            log_dir = self.output_dir / "log"
            log_dir.mkdir(parents=True, exist_ok=True)
            if log_file:
                timestr = time.strftime("%Y%m%d_%H%M%S")
                fh = logging.FileHandler(log_dir / f"{timestr}_outputs.log")
                fh.setLevel(logging.DEBUG)
                fh.setFormatter(logging.Formatter(fmt))
                self.logger.addHandler(fh)
            self._events_file = open(log_dir / "events.jsonl", "a", buffering=1)

    def info(self, msg: str) -> None: self.logger.info(msg)
    def warning(self, msg: str) -> None: self.logger.warning(msg)
    def error(self, msg: str) -> None: self.logger.error(msg)

    def _emit(self, kind: str, tag: str, step: int, payload: dict) -> None:
        if self._events_file is not None:
            rec = {"kind": kind, "tag": tag, "step": int(step),
                   "time": time.time(), **payload}
            self._events_file.write(json.dumps(rec) + "\n")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._emit("scalar", tag, step, {"value": float(value)})

    def add_histogram(self, tag: str, values, step: int) -> None:
        values = np.asarray(values, np.float64).ravel()
        if values.size == 0:
            return
        counts, edges = np.histogram(values, bins=64)
        self._emit("histogram", tag, step, {
            "min": float(values.min()), "max": float(values.max()),
            "mean": float(values.mean()), "counts": counts.tolist(),
            "edges": [float(edges[0]), float(edges[-1])]})

    def add_image(self, tag: str, image, step: int) -> None:
        """image: (3, H, W) or (H, W) float in [0, 1], saved as PNG."""
        img = np.asarray(image)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = np.transpose(img, (1, 2, 0))
        img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if self.output_dir is not None:
            from PIL import Image
            img_dir = self.output_dir / "images"
            img_dir.mkdir(parents=True, exist_ok=True)
            safe_tag = tag.replace("/", "_").replace(" ", "_")
            Image.fromarray(img8.squeeze()).save(img_dir / f"{safe_tag}_{step}.png")
        self._emit("image", tag, step, {"shape": list(img8.shape)})

    def close(self) -> None:
        if self._events_file is not None:
            self._events_file.close()
            self._events_file = None
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
