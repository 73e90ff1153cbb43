"""Timing shared by the probe tools: CUDA events around the launch on the
card, the host clock on the CPU (where the plain versions run)."""

from __future__ import annotations

import statistics
import time

import torch


def time_ms(fn, device: torch.device, reps: int = 3) -> tuple[float, torch.Tensor]:
    """(median ms of ``reps`` calls of ``fn`` after one warm-up call, the
    last call's output)."""
    out = fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (plain PyTorch versions)"
