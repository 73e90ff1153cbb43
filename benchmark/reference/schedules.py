"""The recipes' learning-rate and threshold schedules, and float32
rounding of host scalars, shared by the references."""

from __future__ import annotations

import numpy as np


def f32(x) -> float:
    return float(np.float32(x))


def exp_schedule(v_init, v_final, max_steps, delay_steps=0, delay_mult=1.0):
    """Log-linear decay from v_init to v_final over max_steps, with the
    optional sine warm-up delay."""
    def at(step):
        if step <= 0:
            return v_init
        if step >= max_steps:
            return v_final
        rate = 1.0
        if delay_steps > 0:
            rate = delay_mult + (1 - delay_mult) * np.sin(0.5 * np.pi * np.clip(step / delay_steps, 0, 1))
        t = np.clip(step / max_steps, 0, 1)
        with np.errstate(divide="ignore"):
            return float(rate * np.exp(np.log(v_init) * (1 - t) + np.log(v_final) * t))
    return at
