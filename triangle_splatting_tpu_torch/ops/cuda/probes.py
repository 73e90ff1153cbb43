"""Probe kernels P1 (``vpu_probe``), P2 (``exp_probe``) and P3
(``scan_probe``): micro-benchmarks of the card's rates for the blend
kernels' building blocks.

Ports of the Pallas kernels of ``tools/vpu_probe.py``, ``tools/exp_probe.py``
and ``tools/scan_probe.py``: K dependent passes over a block of elements,
the whole K-loop inside one launch, so the launch's time over R * C * K is
the rate of the operation. The CUDA kernels are in ``csrc/probes.cu``.
Each wrapper takes the kernel for CUDA tensors and the plain PyTorch
version beside it (a Python loop over K) for CPU tensors; there is no
fallback from one to the other. ``<wrapper>.launches`` counts the kernel
launches. The command-line tools around them are
``triangle_splatting_tpu_torch/tools/{vpu,exp,scan}_probe.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import check_launch, library
from .streams import _check, _stream

PROBE_C = float(np.float32(1.0000001))   # the chains' multiplier (bf16: exactly 1)
PROBE_S = float(np.float32(1e-6))        # the exp chains' argument scale
VPU_OPS = ("mul", "fma", "min3", "exp")
# "exp_intrinsic" (CUDA's __expf; the plain version takes torch.exp) has no
# JAX twin: it is the fast exp the card has in hardware
EXP_OPS = ("mul8", "exp", "fastexp", "exp_intrinsic")
SCAN_VARIANTS = ("hs", "hs_roll", "two_level4", "two_level8", "two_level16",
                 "two_level32", "mxu_log")
SCAN_ROWS = 256


def _check_block(x: torch.Tensor) -> torch.device:
    _check(x, "x", torch.float32, 2, x.device)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device


# ---------------------------------------------------------------------------
# P1 vpu_probe
# ---------------------------------------------------------------------------

def _vpu_step(v, op: str, c, s):
    if op == "mul":
        return v * c
    if op == "fma":
        return v * c + c
    if op == "min3":
        return torch.minimum(torch.minimum(v, v * c), v + c)
    return torch.exp(-v.abs() * s)


def vpu_probe_plain(x: torch.Tensor, op: str, dtype=torch.float32, k: int = 1) -> torch.Tensor:
    """vpu_probe.py ``_kernel`` in PyTorch: ``x`` cast to ``dtype``, K
    passes of ``op``, back to float32 ("fma" is a mul and an add here, one
    FFMA in the kernel)."""
    v = x.to(dtype)
    c = torch.tensor(PROBE_C, dtype=dtype, device=x.device)
    s = torch.tensor(PROBE_S, dtype=dtype, device=x.device)
    for _ in range(k):
        v = _vpu_step(v, op, c, s)
    return v.float()


def vpu_probe(x: torch.Tensor, op: str, dtype=torch.float32, k: int = 1) -> torch.Tensor:
    """K dependent passes of ``op`` ("mul", "fma", "min3", "exp") over the
    float32 block ``x``, in ``dtype`` (float32, or bfloat16 as packed pairs
    in the kernel), returned as float32."""
    if op not in VPU_OPS:
        raise ValueError(f"vpu_probe: unknown op {op!r}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vpu_probe: dtype must be float32 or bfloat16, got {dtype}")
    dev = _check_block(x)
    if dev.type == "cpu":
        return vpu_probe_plain(x, op, dtype, k)
    bf16 = dtype == torch.bfloat16
    if bf16 and (x.numel() % 2 or x.data_ptr() % 8):
        raise ValueError("vpu_probe: bfloat16 reads float pairs: it needs an even element "
                         "count and an 8-byte aligned block")
    out = torch.empty_like(x)
    vpu_probe.launches += 1
    check_launch(library("probes").ts_probe_vpu(
        x.data_ptr(), out.data_ptr(), x.numel(), k, VPU_OPS.index(op), int(bf16),
        PROBE_C, PROBE_S, _stream()), "vpu_probe")
    return out


vpu_probe.launches = 0


# ---------------------------------------------------------------------------
# P2 exp_probe
# ---------------------------------------------------------------------------

def fast_exp(x: torch.Tensor) -> torch.Tensor:
    """exp_probe.py ``fast_exp``: exp(x) for x <= 0 as 2^k * poly4(f), k the
    nearest integer to x log2 e, the exponent spliced in by an int32 bitcast."""
    y = x * np.float32(1.4426950408889634)
    k = torch.floor(y + 0.5)
    f = y - k
    p = torch.full_like(f, 9.5541051638e-03)
    for coef in (5.5870408514e-02, 2.4024696602e-01, 6.9312802817e-01, 9.9999943979e-01):
        p = p * f + coef
    ki = k.to(torch.int32)
    scale = torch.bitwise_left_shift(ki + 127, 23).view(torch.float32)
    return p * scale


def exp_probe_plain(x: torch.Tensor, op: str, k: int = 1) -> torch.Tensor:
    """exp_probe.py ``_kernel`` in PyTorch: K passes of eight products
    ("mul8"), or of exp / fast_exp of -|v| * 1e-6."""
    v = x.clone()
    c = torch.tensor(PROBE_C, dtype=torch.float32, device=x.device)
    s = torch.tensor(PROBE_S, dtype=torch.float32, device=x.device)
    for _ in range(k):
        if op == "mul8":
            for _ in range(8):
                v = v * c
        else:
            t = v.abs() * s
            v = fast_exp(-t) if op == "fastexp" else torch.exp(-t)
    return v


def exp_probe(x: torch.Tensor, op: str, k: int = 1) -> torch.Tensor:
    """K dependent passes of ``op`` ("mul8", "exp" (expf), "fastexp",
    "exp_intrinsic" (__expf)) over the float32 block ``x``."""
    if op not in EXP_OPS:
        raise ValueError(f"exp_probe: unknown op {op!r}")
    dev = _check_block(x)
    if dev.type == "cpu":
        return exp_probe_plain(x, op, k)
    out = torch.empty_like(x)
    exp_probe.launches += 1
    check_launch(library("probes").ts_probe_exp(
        x.data_ptr(), out.data_ptr(), x.numel(), k, EXP_OPS.index(op), PROBE_C, PROBE_S,
        _stream()), "exp_probe")
    return out


exp_probe.launches = 0


# ---------------------------------------------------------------------------
# P3 scan_probe
# ---------------------------------------------------------------------------

def _prefix_hs(x):
    k = 1
    while k < x.shape[0]:
        pad = torch.ones((k,) + x.shape[1:], dtype=x.dtype, device=x.device)
        x = x * torch.cat([pad, x[:-k]], dim=0)
        k *= 2
    return x


def prefix_hs_lanes(x: torch.Tensor) -> torch.Tensor:
    """One "hs" prefix product along axis 0 as the kernel lays it out: the
    256 rows split into 32 lanes of 8 consecutive rows, a pass with a shift
    below 8 multiplied within each lane and, for a lane's first rows, by
    the previous lane's last rows (the kernel's ``__shfl_up_sync`` by one
    lane), a pass with a larger shift by the same row ``shift / 8`` lanes
    back. The float32 twin of the kernel's layout: each product is
    ``_prefix_hs``'s, so the two agree bit for bit."""
    s, c = x.shape
    lane_rows = s // 32
    v = x.reshape(s // lane_rows, lane_rows, c)
    sh = 1
    while sh < lane_rows:
        new = v.clone()
        new[:, sh:] = v[:, sh:] * v[:, :-sh]
        new[1:, :sh] = v[1:, :sh] * v[:-1, lane_rows - sh:]
        v, sh = new, sh * 2
    d = 1
    while d < v.shape[0]:
        new = v.clone()
        new[d:] = v[d:] * v[:-d]
        v, d = new, d * 2
    return v.reshape(s, c)


def _prefix_roll(x):
    row = torch.arange(x.shape[0], device=x.device)[:, None]
    k = 1
    while k < x.shape[0]:
        x = x * torch.where(row < k, torch.ones((), dtype=x.dtype, device=x.device),
                            torch.roll(x, k, dims=0))
        k *= 2
    return x


def _prefix_two_level(x, chunk):
    s, c = x.shape
    n = s // chunk
    y = _prefix_hs(x.reshape(n, chunk, c).transpose(0, 1)).transpose(0, 1)
    t = _prefix_hs(y[:, chunk - 1, :])
    excl = torch.cat([torch.ones((1, c), dtype=x.dtype, device=x.device), t[:-1]], dim=0)
    return (y * excl[:, None, :]).reshape(s, c)


def _prefix_mxu_log(x):
    l = torch.log(torch.clamp_min(x, 1e-30))  # noqa: E741
    L = torch.tril(torch.ones((x.shape[0], x.shape[0]), dtype=x.dtype, device=x.device))
    return torch.exp(L @ l)


def prefix_plain(x: torch.Tensor, variant: str) -> torch.Tensor:
    """One prefix product along axis 0 the way scan_probe.py's variant
    computes it (``VARIANTS``)."""
    if variant == "hs":
        return _prefix_hs(x)
    if variant == "hs_roll":
        return _prefix_roll(x)
    if variant == "mxu_log":
        return _prefix_mxu_log(x)
    return _prefix_two_level(x, int(variant[len("two_level"):]))


def scan_probe_plain(x: torch.Tensor, variant: str, k: int = 1,
                     clip: bool = True) -> torch.Tensor:
    """scan_probe.py ``_kernel`` in PyTorch: K dependent prefix products
    along axis 0, each clipped to [0.9, 1] (``clip``)."""
    v = x
    for _ in range(k):
        v = prefix_plain(v, variant)
        if clip:
            v = torch.clamp(v, 0.9, 1.0)
    return v


def scan_code(variant: str) -> tuple[int, int]:
    """``ts_probe_scan``'s (variant, chunk) arguments for ``variant``."""
    if variant.startswith("two_level"):
        return 2, int(variant[len("two_level"):])
    return {"hs": 0, "hs_roll": 1, "mxu_log": 3}[variant], 0


def scan_probe(x: torch.Tensor, variant: str, k: int = 1, clip: bool = True) -> torch.Tensor:
    """K dependent prefix products of the (256, C) float32 block ``x``
    along its rows, each clipped to [0.9, 1] when ``clip``, computed as
    ``variant`` (``SCAN_VARIANTS``). The kernel takes C a multiple of 8."""
    if variant not in SCAN_VARIANTS:
        raise ValueError(f"scan_probe: unknown variant {variant!r}")
    dev = _check_block(x)
    if dev.type == "cpu":
        return scan_probe_plain(x, variant, k, clip)
    rows, cols = x.shape
    if rows != SCAN_ROWS or cols % 8:
        raise ValueError(f"scan_probe: the kernel takes ({SCAN_ROWS}, C) with C a multiple "
                         f"of 8, got {tuple(x.shape)}")
    code, chunk = scan_code(variant)
    out = torch.empty_like(x)
    scan_probe.launches += 1
    check_launch(library("probes").ts_probe_scan(
        x.data_ptr(), out.data_ptr(), rows, cols, k, code, chunk, int(clip), _stream()),
        "scan_probe")
    return out


scan_probe.launches = 0
