"""LPIPS (VGG16 variant) in PyTorch (port of ``triangle_splatting_tpu/trainers/lpips.py``).

The LPIPS architecture written out: the input scaling layer, VGG16's 13
3x3 convolutions with ReLU and 2x2 max pooling, the ReLU outputs of convs
2, 4, 7, 10 and 13 unit-normalized over channels, their squared
differences weighted by non-negative per-channel linear heads, the
spatial mean, summed over the five taps. The weights come from an
``.npz`` in the JAX module's schema (``conv{i}_w`` / ``conv{i}_b`` /
``lin{j}_w``), found through ``TS_LPIPS_WEIGHTS`` or at
``weights/lpips_vgg.npz`` beside the package; ``convert_torchvision_weights``
writes one on a machine that has torchvision and the ``lpips`` package.
The convolutions run in full float32 (cuDNN's TF32 off for the call).

Without a weights file ``lpips`` raises ``FileNotFoundError`` and the
trainers report PSNR / SSIM only.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: channels per conv, True = max pooling after it
_VGG_PLAN = [(64, False), (64, True), (128, False), (128, True),
             (256, False), (256, False), (256, True),
             (512, False), (512, False), (512, True),
             (512, False), (512, False), (512, False)]
# LPIPS taps the ReLU outputs of convs 2, 4, 7, 10, 13 (1-indexed)
_TAPS = (1, 3, 6, 9, 12)
# the input scaling layer (lpips.ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_CACHED: Optional[dict] = None
_TRIED = False


def _find_weights() -> Optional[str]:
    path = os.environ.get("TS_LPIPS_WEIGHTS")
    if path and os.path.exists(path):
        return path
    default = os.path.join(os.path.dirname(__file__), "..", "..", "weights", "lpips_vgg.npz")
    return default if os.path.exists(default) else None


def load_weights(path: Optional[str] = None) -> Optional[dict]:
    """Load (and cache) the LPIPS weights as CPU float32 tensors; None when
    no file is found."""
    global _CACHED, _TRIED
    if _CACHED is not None:
        return _CACHED
    if path is None:
        if _TRIED:
            return None
        _TRIED = True
        path = _find_weights()
        if path is None:
            return None
    data = np.load(path)
    weights = {k: torch.as_tensor(np.asarray(data[k], np.float32)) for k in data.files}
    for i in range(len(_VGG_PLAN)):
        if f"conv{i}_w" not in weights:
            raise ValueError(f"LPIPS weights at {path} missing conv{i}_w")
    _CACHED = weights
    return weights


def _vgg_features(weights: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x: (N, 3, H, W) in [-1, 1] -> the tapped ReLU feature maps."""
    shift = torch.as_tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
    x = (x - shift) / scale
    feats = []
    for i, (_, pool) in enumerate(_VGG_PLAN):
        x = torch.relu(F.conv2d(x, weights[f"conv{i}_w"], weights[f"conv{i}_b"], padding=1))
        if i in _TAPS:
            feats.append(x)
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return feats


def _distance(weights: dict, img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    total = torch.zeros(img.shape[0], dtype=torch.float32, device=img.device)
    for j, (a, b) in enumerate(zip(_vgg_features(weights, img), _vgg_features(weights, gt))):
        na = a / torch.sqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
        nb = b / torch.sqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
        lin = weights[f"lin{j}_w"].reshape(1, -1, 1, 1)          # non-negative
        total = total + ((na - nb) ** 2 * lin).sum(dim=1).mean(dim=(1, 2))
    return total


@torch.no_grad()
def lpips(img, gt, weights: Optional[dict] = None) -> torch.Tensor:
    """LPIPS distance between (3, H, W) or (N, 3, H, W) images in [0, 1] on
    the images' device. Raises FileNotFoundError when no weights are
    available."""
    if weights is None:
        weights = load_weights()
    if weights is None:
        raise FileNotFoundError(
            "LPIPS weights not found: set TS_LPIPS_WEIGHTS or place weights/lpips_vgg.npz "
            "(see convert_torchvision_weights)")
    img = torch.as_tensor(img, dtype=torch.float32)
    gt = torch.as_tensor(gt, dtype=torch.float32).to(img.device)
    squeeze = img.dim() == 3
    if squeeze:
        img, gt = img[None], gt[None]
    w = {k: v.to(device=img.device, dtype=torch.float32) for k, v in weights.items()}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = _distance(w, img * 2.0 - 1.0, gt * 2.0 - 1.0)
    return out[0] if squeeze else out


def convert_torchvision_weights(out_path: str) -> None:
    """Write the weights npz on a machine WITH torchvision and the ``lpips``
    package (VGG16's convolutions from torchvision, the linear heads from
    ``lpips``)::

        python -c "from triangle_splatting_tpu_torch.trainers.lpips import \\
            convert_torchvision_weights as c; c('weights/lpips_vgg.npz')"
    """
    import lpips as lpips_pkg
    import torchvision

    vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1").features.eval()
    net = lpips_pkg.LPIPS(net="vgg").eval()
    out = {}
    ci = 0
    for layer in vgg:
        if isinstance(layer, torch.nn.Conv2d):
            out[f"conv{ci}_w"] = layer.weight.detach().numpy()
            out[f"conv{ci}_b"] = layer.bias.detach().numpy()
            ci += 1
    for j, lin in enumerate(net.lins):
        out[f"lin{j}_w"] = lin.model[-1].weight.detach().numpy().reshape(-1)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **out)


def random_weights(seed: int = 0) -> dict:
    """Weights of the right shapes from the JAX function's numpy draws (for
    tests: the metric means nothing without the pretrained weights)."""
    rng = np.random.default_rng(seed)
    out = {}
    in_c = 3
    for i, (c, _) in enumerate(_VGG_PLAN):
        out[f"conv{i}_w"] = torch.as_tensor(
            rng.normal(0, 0.05, (c, in_c, 3, 3)).astype(np.float32))
        out[f"conv{i}_b"] = torch.zeros((c,), dtype=torch.float32)
        in_c = c
    for j, tap in enumerate(_TAPS):
        c = _VGG_PLAN[tap][0]
        out[f"lin{j}_w"] = torch.as_tensor(rng.uniform(0, 0.1, (c,)).astype(np.float32))
    return out
