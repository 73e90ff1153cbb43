"""Multi-process experiment fan-out (port of
``triangle_splatting_tpu/utils/pipeline_utils.py``).

``run_exp`` keeps the reference's batching: launch ``num_workers``
processes (spawned, so no CUDA context is inherited), wait for the batch
to finish before starting the next, and raise when a worker exits with a
code other than 0. Worker ``j`` of a batch sees only GPU ``j`` (its
``CUDA_VISIBLE_DEVICES``, set before it touches CUDA), so its
``device="cuda"`` is a card of its own. When the workers outnumber the
visible GPUs the scenes run one after another in this process.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from typing import Callable, Sequence


def visible_gpu_count() -> int:
    """The GPUs a worker could claim, read without creating a CUDA context
    in this process (``torch.cuda.device_count`` asks NVML first and does
    not initialise CUDA)."""
    import torch
    return torch.cuda.device_count()


def worker_gpus(n: int) -> list[str]:
    """The ``CUDA_VISIBLE_DEVICES`` entry of each of ``n`` workers: the
    first ``n`` of this process's visible GPUs (its own
    ``CUDA_VISIBLE_DEVICES`` where set, else the indices)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [s.strip() for s in visible.split(",")] if visible else [str(j) for j in range(n)]
    return ids[:n]


def _on_gpu(gpu: str, fn: Callable, args: tuple) -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = gpu
    fn(*args)


def run_exp(fn: Callable, args_list: Sequence[tuple], num_workers: int = 1):
    if num_workers > 1:
        n_dev = visible_gpu_count()
        if n_dev < num_workers:
            print(f"pipeline: {n_dev} device(s) < {num_workers} "
                  f"workers — running scenes sequentially")
            num_workers = 1
    if num_workers <= 1:
        for args in args_list:
            fn(*args)
        return
    gpus = worker_gpus(num_workers)
    ctx = mp.get_context("spawn")
    for i in range(0, len(args_list), num_workers):
        batch = args_list[i:i + num_workers]
        procs = [ctx.Process(target=_on_gpu, args=(gpu, fn, args))
                 for gpu, args in zip(gpus, batch)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
            if p.exitcode != 0:
                raise RuntimeError(f"experiment process failed (exit {p.exitcode})")


run_exp_with_args = run_exp
