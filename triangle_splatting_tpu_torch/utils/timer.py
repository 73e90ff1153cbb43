"""Named-channel wall-clock accumulator (port of
``triangle_splatting_tpu/utils/timer.py``, the same code).

``log(channel)`` closes the previous channel and opens a new one; ``stop()``
closes the active channel; ``message()`` formats per-channel totals. Used by
the trainer to attribute time to data loading / forward / loss / backward /
optimizer / model update / logging / saving phases.
"""

from __future__ import annotations

import time
from collections import OrderedDict


class Timer:
    def __init__(self, name: str = "Timer"):
        self.name = name
        self.durations: "OrderedDict[str, float]" = OrderedDict()
        self._active: str | None = None
        self._t0: float = 0.0
        self._start_time = time.time()

    def log(self, channel: str) -> None:
        now = time.time()
        if self._active is not None:
            self.durations[self._active] = self.durations.get(self._active, 0.0) + (now - self._t0)
        self._active = channel
        self._t0 = now

    def stop(self) -> None:
        if self._active is not None:
            now = time.time()
            self.durations[self._active] = self.durations.get(self._active, 0.0) + (now - self._t0)
            self._active = None

    def total_duration(self) -> float:
        return sum(self.durations.values())

    def reset(self) -> None:
        self.durations.clear()
        self._active = None
        self._start_time = time.time()

    def message(self) -> str:
        total = self.total_duration()
        lines = [f"[{self.name}] total {total:.2f}s"]
        for channel, duration in self.durations.items():
            pct = 100.0 * duration / total if total > 0 else 0.0
            lines.append(f"  {channel:<20s} {duration:9.2f}s  ({pct:5.1f}%)")
        return "\n".join(lines)
