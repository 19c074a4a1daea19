"""Gaussian and box blur, 2-D filtering and dilation with OpenCV's
kernels, borders and uint8 rounding.

Counterpart of ``neural_enhanced_super_resolution_tpu/ops/blur.py``. The
filters run as weighted sums of shifted slices in float32 — exact fp32
multiply-adds on any device, with no TF32 convolution path — on a
reflect-101 padded image. Integer inputs are rounded (half to even) and
clipped back, as cv2 does for uint8. Dilation is a max over shifted slices
of a -inf padded image. Every op takes (H, W), (H, W, C) or a batch
(..., H, W, C).
"""

from __future__ import annotations

import numpy as np
import torch

from neural_enhanced_super_resolution_torch.ops.pad import reflect_pad

__all__ = ["gaussian_kernel1d", "gaussian_blur", "box_blur", "filter2d",
           "dilate", "saturate_like"]

# OpenCV's fixed small-gaussian tables for ksize<=7 with sigma<=0.
_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125]),
}


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics (incl. fixed small-kernel tables)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].astype(np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _ksize_from_sigma(sigma: float, uint8: bool = True) -> int:
    """OpenCV: ksize = round(sigma * (8U ? 3 : 4) * 2 + 1) | 1."""
    return int(round(sigma * (3 if uint8 else 4) * 2 + 1)) | 1


def saturate_like(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round-and-clip to an integer dtype, plain cast to a float one."""
    if dtype.is_floating_point:
        return y.to(dtype)
    info = torch.iinfo(dtype)
    return torch.clamp(torch.round(y), info.min, info.max).to(dtype)


def _filter_axis(x: torch.Tensor, kern: np.ndarray, dim: int) -> torch.Tensor:
    k = len(kern)
    if k == 1:
        return x * float(kern[0])
    n = x.shape[dim]
    xp = reflect_pad(x, dim, k // 2, k // 2)
    acc = xp.narrow(dim, 0, n) * float(kern[0])
    for i in range(1, k):
        acc = acc + xp.narrow(dim, i, n) * float(kern[i])
    return acc


def _hw_dims(img: torch.Tensor) -> tuple[int, int]:
    return (-2, -1) if img.dim() == 2 else (-3, -2)


def _sep_filter(img: torch.Tensor, kern_h: np.ndarray,
                kern_w: np.ndarray) -> torch.Tensor:
    hdim, wdim = _hw_dims(img)
    x = _filter_axis(img.float(), kern_h, hdim)
    x = _filter_axis(x, kern_w, wdim)
    return saturate_like(x, img.dtype)


def gaussian_blur(img: torch.Tensor, ksize=(0, 0), sigma: float = 0.0,
                  sigma_y: float | None = None) -> torch.Tensor:
    """cv2.GaussianBlur(img, ksize, sigmaX[, sigmaY]), BORDER_REFLECT_101.

    img: (H, W), (H, W, C) or (..., H, W, C); same shape and dtype out.
    """
    kw_, kh_ = (int(ksize[0]), int(ksize[1])) if ksize else (0, 0)
    sy = sigma if sigma_y is None else sigma_y
    uint8 = not img.dtype.is_floating_point
    if kw_ <= 0:
        kw_ = _ksize_from_sigma(sigma, uint8)
    if kh_ <= 0:
        kh_ = _ksize_from_sigma(sy, uint8)
    return _sep_filter(img, gaussian_kernel1d(kh_, sy),
                       gaussian_kernel1d(kw_, sigma))


def box_blur(img: torch.Tensor, ksize: tuple[int, int]) -> torch.Tensor:
    """cv2.boxFilter(img, -1, ksize): normalized box, reflect-101 border."""
    kw_, kh_ = int(ksize[0]), int(ksize[1])
    return _sep_filter(img, np.full((kh_,), 1.0 / kh_, np.float32),
                       np.full((kw_,), 1.0 / kw_, np.float32))


def filter2d(img: torch.Tensor, kernel) -> torch.Tensor:
    """cv2.filter2D(img, -1, kernel): correlation (the kernel is not
    flipped) with a reflect-101 border of kernel-size // 2."""
    kern = np.asarray(kernel, np.float32)
    kh_, kw_ = kern.shape
    hdim, wdim = _hw_dims(img)
    xp = reflect_pad(reflect_pad(img.float(), hdim, kh_ // 2, kh_ // 2),
                     wdim, kw_ // 2, kw_ // 2)
    oh, ow = xp.shape[hdim] - kh_ + 1, xp.shape[wdim] - kw_ + 1
    acc = None
    for i in range(kh_):
        rows = xp.narrow(hdim, i, oh)
        for j in range(kw_):
            term = rows.narrow(wdim, j, ow) * float(kern[i, j])
            acc = term if acc is None else acc + term
    return saturate_like(acc, img.dtype)


def _max_axis(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Max over a window of k along dim, -inf beyond the edges."""
    n, pad = x.shape[dim], k // 2
    edge = list(x.shape)
    edge[dim] = pad
    fill = torch.full(edge, -torch.inf, dtype=x.dtype, device=x.device)
    xp = torch.cat([fill, x, fill], dim=dim)
    out = xp.narrow(dim, 0, n)
    for i in range(1, k):
        out = torch.maximum(out, xp.narrow(dim, i, n))
    return out


def dilate(img: torch.Tensor, ksize: int = 3,
           iterations: int = 1) -> torch.Tensor:
    """cv2.dilate with a ksize x ksize all-ones structuring element; the
    border never wins the max (-inf padding)."""
    hdim, wdim = _hw_dims(img)
    x = img.float()
    for _ in range(iterations):
        x = _max_axis(_max_axis(x, ksize, hdim), ksize, wdim)
    return saturate_like(x, img.dtype)
