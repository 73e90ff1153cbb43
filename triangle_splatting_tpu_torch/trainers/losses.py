"""Losses and metrics for photo training (port of the parts of
``triangle_splatting_tpu/trainers/losses.py`` this slice uses).

SSIM uses ``conv2d`` with the 11x11 Gaussian window (the JAX package's
separable shift-multiply form was a TPU workaround). All images are
(C, H, W) float32. Convolutions run in full float32: the trainer disables
TF32 for cuDNN and matmuls, since SSIM's variance terms
(E[x^2] - mu^2) cancel and TF32's ~3 decimal digits are not enough.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(kernel_size: int, sigma: float) -> np.ndarray:
    """Normalized 2D Gaussian kernel."""
    ax = np.arange(kernel_size, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax, indexing="xy")
    mean = (kernel_size - 1) / 2.0
    k = np.exp(-((xx - mean) ** 2 + (yy - mean) ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def depthwise_conv2d(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Same-padding (zero) depthwise conv; img (C, H, W), kernel (kh, kw)."""
    C = img.shape[0]
    kh, kw = kernel.shape
    k = torch.as_tensor(kernel, dtype=img.dtype).to(img.device)
    k = k[None, None].expand(C, 1, kh, kw)
    x = F.pad(img[None], (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    return F.conv2d(x, k, groups=C)[0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """SSIM with a Gaussian window (mean over the map)."""
    kernel = _gaussian_kernel(window_size, sigma)
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mu1 = depthwise_conv2d(img1, kernel)
    mu2 = depthwise_conv2d(img2, kernel)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = depthwise_conv2d(img1 * img1, kernel) - mu1_sq
    sigma2_sq = depthwise_conv2d(img2 * img2, kernel) - mu2_sq
    sigma12 = depthwise_conv2d(img1 * img2, kernel) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def ssim_loss(img1, img2):
    return 1.0 - ssim(img1, img2)


def l1(a, b):
    return (a - b).abs().mean()


def psnr(img1, img2, mask=None):
    """PSNR, optionally alpha-masked."""
    if mask is None:
        mse = ((img1 - img2) ** 2).mean() + 1e-10
    else:
        mse = (((img1 - img2) ** 2) * mask).sum() / (mask.sum() + 1e-10) + 1e-10
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
