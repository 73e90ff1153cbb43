"""Plain losses of the recipes: L1, SSIM (11x11 Gaussian window, sigma
1.5, zero padding), the Scharr gradients and the depth-normal consistency
term, as ``triangle_splatting_tpu_torch/trainers/losses.py`` defines them
(a frozen copy of the definitions; the convolutions run in float32 unless
the caller enables TF32)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax, indexing="xy")
    mean = (size - 1) / 2.0
    k = np.exp(-((xx - mean) ** 2 + (yy - mean) ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def depthwise(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Same-size zero-padded depthwise convolution of (C, H, W)."""
    C = img.shape[0]
    kh, kw = kernel.shape
    k = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)[None, None].expand(C, 1, kh, kw)
    x = F.pad(img[None], (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    return F.conv2d(x, k, groups=C)[0]


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    k = gaussian_kernel()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = depthwise(a, k), depthwise(b, k)
    s1 = depthwise(a * a, k) - mu1 * mu1
    s2 = depthwise(b * b, k) - mu2 * mu2
    s12 = depthwise(a * b, k) - mu1 * mu2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean()


def l1(a, b):
    return (a - b).abs().mean()


SCHARR_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32) / 32
SCHARR_Y = np.array([[-3, -10, -3], [0, 0, 0], [3, 10, 3]], np.float32) / 32


def resize_linear(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Half-pixel bilinear resize, antialiased when shrinking."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((1, -1) + x.shape[-2:]), size=(H, W), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.reshape(lead + (H, W))


def scharr(img: torch.Tensor) -> torch.Tensor:
    return torch.cat([depthwise(img, SCHARR_X), depthwise(img, SCHARR_Y)], 0)


def depth_to_normal(depth, tan_fovx, tan_fovy, scale_factor):
    """View-space normals (3, H, W) from a depth map's Scharr gradients at
    ``scale_factor`` of its size, and the mask of pixels whose depth
    gradient lies below its 0.9 quantile (no gradient)."""
    H0, W0 = depth.shape
    d = depth[None]
    if scale_factor is not None and scale_factor != 1:
        d = resize_linear(d, int(H0 * scale_factor), int(W0 * scale_factor))
    dgrad = scharr(d)
    Dx, Dy = dgrad[0] / d[0], dgrad[1] / d[0]
    H, W = d.shape[-2:]
    x = torch.arange(W, dtype=d.dtype, device=d.device)[None, :]
    y = torch.arange(H, dtype=d.dtype, device=d.device)[:, None]
    normal = torch.stack([W * Dx / (2 * tan_fovx), H * Dy / (2 * tan_fovy),
                          -(1 + (x - W / 2 + 0.5) * Dx + (y - H / 2 + 0.5) * Dy)], 0)
    if (H, W) != (H0, W0):
        normal = resize_linear(normal, H0, W0)
    normal = normal / torch.linalg.vector_norm(normal, dim=0, keepdim=True)
    with torch.no_grad():
        gn = torch.linalg.vector_norm(dgrad, dim=0, keepdim=True)
        if (H, W) != (H0, W0):
            gn = resize_linear(gn, H0, W0)
        mask = (gn < torch.quantile(gn, 0.9)).to(depth.dtype)[0]
    return normal, mask


def depth_normal_loss(depth, normal, tan_fovx, tan_fovy, scale_factor):
    """1 - cos(rendered normal, normal from depth), masked."""
    d_normal, mask = depth_to_normal(depth, tan_fovx, tan_fovy, scale_factor)
    n = normal / torch.linalg.vector_norm(normal, dim=0, keepdim=True).clamp_min(1e-8)
    return ((1.0 - (n * d_normal).sum(dim=0)) * mask).mean()
