"""Quality metrics: PSNR and SSIM.

Counterpart of ``neural_enhanced_super_resolution_tpu/utils/metrics.py``
(the same formulas in float32): they back the int8 trunk's quality gate.
Inputs are numpy arrays or tensors, (H, W) or (H, W, C); the result is a
Python float.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim"]


def _f32(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(torch.float32)
    return torch.from_numpy(np.array(a, np.float32))


def psnr(a, b, max_val: float = 255.0) -> float:
    a, b = _f32(a), _f32(b)
    mse = torch.mean((a - b.to(a.device)) ** 2)
    return float(10.0 * torch.log10(max_val * max_val
                                    / torch.clamp(mse, min=1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def ssim(a, b, max_val: float = 255.0) -> float:
    """Mean SSIM with the standard 11x11 sigma=1.5 Gaussian window
    (separable, VALID); channels are averaged."""
    a, b = _f32(a), _f32(b)
    b = b.to(a.device)
    if a.dim() == 2:
        a, b = a[:, :, None], b[:, :, None]
    c = a.shape[-1]
    win = _gaussian_window().to(a.device)
    kh = win.view(1, 1, 11, 1).expand(c, 1, 11, 1)
    kw = win.view(1, 1, 1, 11).expand(c, 1, 1, 11)
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2

    def blur2(x):
        y = F.conv2d(x.permute(2, 0, 1)[None], kh, groups=c)
        return F.conv2d(y, kw, groups=c)[0].permute(1, 2, 0)

    mu_a, mu_b = blur2(a), blur2(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_a2 = blur2(a * a) - mu_a2
    sigma_b2 = blur2(b * b) - mu_b2
    sigma_ab = blur2(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2))
    return float(torch.mean(s))
