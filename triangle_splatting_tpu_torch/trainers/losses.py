"""Losses and metrics of the photo and mesh recipes (port of
``triangle_splatting_tpu/trainers/losses.py``: L1, SSIM, PSNR, the
depth-normal consistency loss of the geometry term, the DoG
frequency-masked L1 and the Scharr smoothness term).

SSIM and the Scharr gradients use ``conv2d`` (the JAX package's separable
shift-multiply form was a TPU workaround). All images are (C, H, W)
float32. Convolutions run in full float32: the trainer disables TF32 for
cuDNN and matmuls, since SSIM's variance terms (E[x^2] - mu^2) cancel and
TF32's ~3 decimal digits are not enough.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.model_utils import resize_linear


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


SCHARR_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32) / 32
SCHARR_Y = np.array([[-3, -10, -3], [0, 0, 0], [3, 10, 3]], np.float32) / 32


def scharr(img: torch.Tensor, ret_norm: bool = False) -> torch.Tensor:
    """Scharr gradients; img (C, H, W) -> (2C, H, W) or their norm (1, H, W)."""
    grad = torch.cat([depthwise_conv2d(img, SCHARR_X), depthwise_conv2d(img, SCHARR_Y)], 0)
    if ret_norm:
        return torch.linalg.vector_norm(grad, dim=0, keepdim=True)
    return grad


def dog_loss(img: torch.Tensor, img_gt: torch.Tensor, freq: int = 90,
             scale_factor: float = 0.5) -> torch.Tensor:
    """L1 over the pixels a difference of Gaussians of the GT's gray image
    (at ``scale_factor`` of the size, resized back) marks: its top half
    after min-max normalization, inverted for ``freq`` >= 50. The mask
    carries no gradient."""
    sigma = 0.1 + (100 - freq) * 0.1 if freq >= 50 else 0.1 + freq * 0.1
    k1 = _gaussian_kernel(int(2 * round(3 * sigma) + 1), sigma)
    k2 = _gaussian_kernel(int(2 * round(6 * sigma) + 1), 2 * sigma)
    with torch.no_grad():
        gray = img_gt.mean(dim=0, keepdim=True)
        H, W = gray.shape[-2:]
        down = resize_linear(gray, int(H * scale_factor), int(W * scale_factor))
        up = resize_linear(depthwise_conv2d(down, k1) - depthwise_conv2d(down, k2), H, W)
        normed = (up - up.min()) / (up.max() - up.min() + 1e-12)
        if freq >= 50:
            normed = 1.0 - normed
        mask = (normed >= 0.5).to(img.dtype)
    return (img * mask - img_gt * mask).abs().mean()


def smoothness_loss(img: torch.Tensor, img_gt: torch.Tensor, quantile: float = 0.3,
                    scale_factor: float = 0.5) -> torch.Tensor:
    """The render's Scharr gradient norm where the GT is flat: below the
    ``quantile`` of the GT's gradient norm (taken at ``scale_factor`` of
    the size and resized back; ``torch.quantile`` interpolates linearly, as
    ``jnp.quantile``). The mask carries no gradient."""
    with torch.no_grad():
        H, W = img_gt.shape[-2:]
        down = resize_linear(img_gt, int(H * scale_factor), int(W * scale_factor))
        up = resize_linear(scharr(down, ret_norm=True), H, W)
        mask = (up < torch.quantile(up, quantile)).to(img.dtype)
    return (scharr(img, ret_norm=True) * mask).mean()


def depth_to_normal(depth: torch.Tensor, tan_fovx, tan_fovy,
                    scale_factor: float | None = None, grad_quantile: float = 0.9):
    """A depth map (H, W) -> view-space normals (3, H, W) from its Scharr
    gradients (at ``scale_factor`` of the size, resized back) and a mask
    (H, W), without gradient, of the pixels whose depth gradient lies
    below its ``grad_quantile`` (the depth discontinuities are left out)."""
    H0, W0 = depth.shape
    d = depth[None]
    if scale_factor is not None and scale_factor != 1:
        d = resize_linear(d, int(H0 * scale_factor), int(W0 * scale_factor))
    dgrad = scharr(d)                      # (2, h, w)
    Dx = dgrad[0] / d[0]
    Dy = dgrad[1] / d[0]
    H, W = d.shape[-2:]
    x = torch.arange(W, dtype=d.dtype, device=d.device)[None, :]
    y = torch.arange(H, dtype=d.dtype, device=d.device)[:, None]
    nx = W * Dx / (2 * tan_fovx)
    ny = H * Dy / (2 * tan_fovy)
    nz = -(1 + (x - W / 2 + 0.5) * Dx + (y - H / 2 + 0.5) * Dy)
    normal = torch.stack([nx, ny, nz], 0)
    if (H, W) != (H0, W0):
        normal = resize_linear(normal, H0, W0)
    normal = normal / torch.linalg.vector_norm(normal, dim=0, keepdim=True)

    with torch.no_grad():
        grad_norm = torch.linalg.vector_norm(dgrad, dim=0, keepdim=True)
        if (H, W) != (H0, W0):
            grad_norm = resize_linear(grad_norm, H0, W0)
        thresh = torch.quantile(grad_norm, grad_quantile)
        mask = (grad_norm < thresh).to(depth.dtype)[0]
    return normal, mask


def depth_normal_loss(depth: torch.Tensor, normal: torch.Tensor, tan_fovx,
                      tan_fovy, scale_factor: float | None = None) -> torch.Tensor:
    """1 - cos(rendered normal, normal from depth), masked at the depth
    discontinuities. Where the rendered normal is exactly 0 (no
    contributor) its gradient stays finite (PyTorch's norm subgradient at
    0); the JAX function's is NaN there (the derivative of
    ``jnp.linalg.norm`` at 0)."""
    d_normal, mask = depth_to_normal(depth, tan_fovx, tan_fovy, scale_factor)
    n = normal / torch.linalg.vector_norm(normal, dim=0, keepdim=True).clamp_min(1e-8)
    return ((1.0 - (n * d_normal).sum(dim=0)) * mask).mean()
