"""P3: prefix-product scans along 256 rows, the building block of a blend
kernel's transmittance (port of ``tools/scan_probe.py``).

Times kernel P3 (``ops/cuda/csrc/probes.cu``): K dependent prefix products
of an S x C float32 block along its rows, each clipped to [0.9, 1], the
K-loop inside one launch. One variant per name of the JAX tool: ``hs``
(Hillis-Steele passes through shared memory), ``hs_roll`` (the GPU's
register rotate: warp shuffles, then a carry across warps),
``two_level4/8/16/32`` (a sequential product over the chunk in registers,
a scan of the chunk totals, one broadcast multiply) and ``mxu_log``
(exp(L @ log x), the product written out in float32 in the kernel).

    python -m triangle_splatting_tpu_torch.tools.scan_probe [--k K] [--c C]

On the card by default; ``--device cpu`` runs the plain PyTorch versions.
First ``check`` holds every variant against float64 ``torch.cumprod``.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ops.cuda.probes import SCAN_ROWS, SCAN_VARIANTS, scan_probe
from ._timing import device_label, time_ms

S, C = SCAN_ROWS, 1024
K = 2048          # dependent reps
VARIANTS = SCAN_VARIANTS


def check(s: int = S, c: int = C, device="cuda") -> dict:
    """Max relative error of one unclipped scan of linspace(0.9, 1) per
    variant against float64 ``torch.cumprod``; printed and returned."""
    dev = resolve_device(device)
    x = torch.linspace(0.9, 1.0, s * c, device=dev).reshape(s, c)
    ref = torch.cumprod(x.double(), dim=0)
    errs = {}
    for name in VARIANTS:
        out = scan_probe(x, name, k=1, clip=False)
        errs[name] = float(((out.double() - ref).abs() / ref).max())
        print(f"{name:12s} max rel err {errs[name]:.2e}")
    return errs


def run(name: str, k: int = K, s: int = S, c: int = C, device="cuda") -> dict:
    """Time ``name``; prints the JAX tool's line (ns per scan of the block
    and ps per element)."""
    dev = resolve_device(device)
    x = torch.full((s, c), 0.9999, dtype=torch.float32, device=dev)
    ms, _ = time_ms(lambda: scan_probe(x, name, k), dev)
    per = ms * 1e-3 / k * 1e9
    print(f"{name:12s} {per:8.1f} ns/scan  ({per / (s * c) * 1000:6.2f} ps/elem)")
    return dict(variant=name, ms=ms, ns_per_scan=per, ps_per_elem=per / (s * c) * 1000,
                k=k, s=s, c=c)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--c", type=int, default=C)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(f"scan_probe on {device_label(resolve_device(a.device))}: S x C = {S} x {a.c}, "
          f"K = {a.k}")
    errs = check(S, a.c, a.device)
    return dict(check=errs, runs=[run(name, a.k, S, a.c, a.device) for name in VARIANTS])


if __name__ == "__main__":
    main()
