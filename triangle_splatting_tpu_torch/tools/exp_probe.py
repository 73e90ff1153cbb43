"""P2: the card's cost of ``expf`` against a polynomial fast exp (port of
``tools/exp_probe.py``).

Times kernel P2 (``ops/cuda/csrc/probes.cu``): K dependent passes over an
R x C float32 block held in registers, the K-loop inside one launch. The
variants are the JAX tool's ``mul8`` (eight products: the yardstick),
``exp`` (``expf``, as the blend kernels call it) and ``fastexp`` (2^k *
poly4(f) with the exponent spliced in by a bitcast), and ``exp_intrinsic``
(CUDA's ``__expf``).

    python -m triangle_splatting_tpu_torch.tools.exp_probe [--k K] [--r R] [--c C]

On the card by default; ``--device cpu`` runs the plain PyTorch version.
First it checks ``fast_exp`` against ``exp`` on [-44, 0].
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.cuda.probes import EXP_OPS, exp_probe, fast_exp
from ._timing import device_label, time_ms

R, C = 512, 1024
K = 16384

__all__ = ["R", "C", "K", "fast_exp", "run", "check", "main"]


def check(device="cuda") -> float:
    """Max relative error of ``fast_exp`` against ``torch.exp`` on
    linspace(-44, 0, 8192); printed and returned."""
    dev = resolve_device(device)
    t = torch.linspace(0.0, 44.0, 8192, device=dev)
    ref = torch.exp(-t)
    err = float(((fast_exp(-t) - ref).abs() / ref.clamp_min(1e-30)).max())
    print("fast_exp max rel err on [-44,0]:", err)
    return err


def run(op: str, k: int = K, r: int = R, c: int = C, device="cuda") -> dict:
    """Time ``op``; prints the JAX tool's line (ms and ps per element-pass)."""
    dev = resolve_device(device)
    x = torch.ones((r, c), dtype=torch.float32, device=dev)
    ms, out = time_ms(lambda: exp_probe(x, op, k), dev)
    per = ms * 1e-3 / (r * c * k) * 1e12
    s = float(out.sum())
    print(f"{op:8s}: {ms:7.2f} ms  {per:6.2f} ps/elem  (sum={s:.6e})")
    return dict(op=op, ms=ms, ps_per_elem=per, k=k, r=r, c=c, sum=s)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--r", type=int, default=R)
    ap.add_argument("--c", type=int, default=C)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(f"exp_probe on {device_label(resolve_device(a.device))}: R x C = {a.r} x {a.c}, "
          f"K = {a.k}")
    check(a.device)
    return [run(op, a.k, a.r, a.c, a.device) for op in EXP_OPS]


if __name__ == "__main__":
    main()
