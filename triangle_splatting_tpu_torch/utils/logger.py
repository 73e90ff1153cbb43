"""Logging: colored console + file + scalar/histogram/image metric sink
(port of ``triangle_splatting_tpu/utils/logger.py``).

Metrics are always written to a JSONL event file (``<out>/log/events.jsonl``)
that tools can tail; with ``use_tensorboard`` and ``torch.utils.tensorboard``
importable, a ``SummaryWriter`` under ``<out>/tb`` mirrors every scalar,
histogram and image, as the JAX logger does. Images are saved as PNG under
``<out>/images``. ``Logger_MP`` forwards records to a listener process, and
``stdout_logger`` is the module-level console logger.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        base = super().format(record)
        return f"{color}{base}{_RESET}" if sys.stderr.isatty() else base


def _summary_writer(log_dir: Path):
    """A TensorBoard ``SummaryWriter`` on ``log_dir``, or None where
    ``torch.utils.tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(str(log_dir))
    except Exception:
        return None


class Logger:
    """Console/file logger plus scalar, histogram and image sinks."""

    def __init__(self, name: str = "ts", output_dir: str | Path | None = None,
                 log_file: bool = True, use_tensorboard: bool = True,
                 level: int = logging.INFO):
        self.logger = logging.getLogger(f"{name}-{id(self)}")
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        fmt = "%(asctime)s %(levelname)s %(message)s"
        sh = logging.StreamHandler(sys.stderr)
        sh.setLevel(level)
        sh.setFormatter(_ColorFormatter(fmt, datefmt="%H:%M:%S"))
        self.logger.addHandler(sh)

        self.output_dir = Path(output_dir) if output_dir is not None else None
        self._events_file = None
        self._tb = None
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
            if use_tensorboard:
                self._tb = _summary_writer(self.output_dir / "tb")

    def debug(self, msg: str) -> None: self.logger.debug(msg)
    def info(self, msg: str) -> None: self.logger.info(msg)
    def warning(self, msg: str) -> None: self.logger.warning(msg)
    def error(self, msg: str) -> None: self.logger.error(msg)

    def warnOnce(self, msg: str) -> None:
        """A warning logged the first time its text comes, then dropped."""
        warned = self.__dict__.setdefault("_warned", set())
        if msg not in warned:
            self.warning(msg)
            warned.add(msg)

    def _emit(self, kind: str, tag: str, step: int, payload: dict) -> None:
        if self._events_file is not None:
            rec = {"kind": kind, "tag": tag, "step": int(step),
                   "time": time.time(), **payload}
            self._events_file.write(json.dumps(rec) + "\n")

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        self._emit("scalar", tag, step, {"value": value})
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        values = np.asarray(values, np.float64).ravel()
        if values.size == 0:
            return
        counts, edges = np.histogram(values, bins=64)
        self._emit("histogram", tag, step, {
            "min": float(values.min()), "max": float(values.max()),
            "mean": float(values.mean()), "counts": counts.tolist(),
            "edges": [float(edges[0]), float(edges[-1])]})
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

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
        if self._tb is not None:
            self._tb.add_image(tag, np.transpose(img8, (2, 0, 1)) if img8.ndim == 3
                               else img8[None], step)

    def close(self) -> None:
        if self._events_file is not None:
            self._events_file.close()
            self._events_file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)


def _mp_listener(queue, name, output_dir, use_tensorboard):
    logger = Logger(name, output_dir, use_tensorboard=use_tensorboard)
    while True:
        try:
            record = queue.get()
            if record is None:            # sentinel: shut down
                break
            kind, args = record
            getattr(logger, kind)(*args)
        except Exception:
            import traceback
            traceback.print_exc(file=sys.stderr)
    logger.close()


class Logger_MP:
    """Logger variant that forwards records through a multiprocessing queue
    to a listener process, so file and TensorBoard IO never stall the train
    loop. The listener is spawned (a forked child would inherit the CUDA
    context)."""

    def __init__(self, name: str = "ts", output_dir: str | Path | None = None,
                 use_tensorboard: bool = True):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue(-1)
        self._listener = ctx.Process(
            target=_mp_listener,
            args=(self._queue, name,
                  str(output_dir) if output_dir is not None else None,
                  use_tensorboard),
            daemon=True)
        self._listener.start()
        self._warned: set[str] = set()

    def _put(self, kind: str, *args) -> None:
        self._queue.put((kind, args))

    def debug(self, msg: str) -> None: self._put("debug", msg)
    def info(self, msg: str) -> None: self._put("info", msg)
    def warning(self, msg: str) -> None: self._put("warning", msg)
    def error(self, msg: str) -> None: self._put("error", msg)

    def warnOnce(self, msg: str) -> None:
        if msg not in self._warned:
            self.warning(msg)
            self._warned.add(msg)

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._put("add_scalar", tag, float(value), int(step))

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._put("add_histogram", tag, np.asarray(values), int(step))

    def add_image(self, tag: str, image, step: int) -> None:
        self._put("add_image", tag, np.asarray(image), int(step))

    def close(self) -> None:
        """Drain the queue and stop the listener (it may still be starting:
        a spawned interpreter importing numpy on a loaded host)."""
        if self._listener.is_alive():
            self._queue.put(None)
            self._listener.join(timeout=120)
            if self._listener.is_alive():
                print("Logger_MP: listener did not drain within 120 s; "
                      "log records may be lost", file=sys.stderr)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# Module-level console-only logger (the reference's utils/logger.py:218).
stdout_logger = Logger("stdout_logger", output_dir=None)
