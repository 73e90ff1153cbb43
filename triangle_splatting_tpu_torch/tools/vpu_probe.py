"""P1: the card's elementwise rate, float32 against bfloat16, for mul, fma,
min3 and exp chains (port of ``tools/vpu_probe.py``).

Times kernel P1 (``ops/cuda/csrc/probes.cu``): K dependent passes of one
operation over an R x C block held in registers, the K-loop inside one
launch, so the time over R * C * K is the rate of the operation. bfloat16
runs as packed ``__nv_bfloat162`` pairs: the question is whether it doubles
the elementwise rate.

    python -m triangle_splatting_tpu_torch.tools.vpu_probe [--k K] [--r R] [--c C]

On the card by default; ``--device cpu`` runs the plain PyTorch version.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.cuda.probes import VPU_OPS, vpu_probe
from ._timing import device_label, time_ms

R, C = 512, 1024
K = 65536         # dependent passes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def run(op: str, dtype, k: int = K, r: int = R, c: int = C, device="cuda") -> dict:
    """Time ``op`` in ``dtype``; prints the JAX tool's line (ms and tera
    element-ops per second) and returns it as a dict."""
    dev = resolve_device(device)
    x = torch.ones((r, c), dtype=torch.float32, device=dev)
    ms, out = time_ms(lambda: vpu_probe(x, op, dtype, k), dev)
    rate = r * c * k / (ms * 1e-3)
    name = str(dtype).removeprefix("torch.")
    s = float(out.sum())
    print(f"{op:5s} {name:9s}: {ms:7.2f} ms  {rate / 1e12:6.2f} T elem-ops/s   (sum={s:.3e})")
    return dict(op=op, dtype=name, ms=ms, elem_ops_per_s=rate, k=k, r=r, c=c, sum=s)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--r", type=int, default=R)
    ap.add_argument("--c", type=int, default=C)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(f"vpu_probe on {device_label(resolve_device(a.device))}: R x C = {a.r} x {a.c}, "
          f"K = {a.k}")
    return [run(op, dt, a.k, a.r, a.c, a.device) for op in VPU_OPS for dt in DTYPES.values()]


if __name__ == "__main__":
    main()
