"""OpenCV-parity image resize as two separable weight-matrix products.

Counterpart of ``neural_enhanced_super_resolution_tpu/ops/resize.py``. The
per-axis interpolation weight matrices are that module's own numpy builders
(OpenCV centre-aligned coordinates, cubic A = -0.75, Lanczos-4, area,
nearest), reused as they are; the two contractions run in fp32 with TF32
off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from neural_enhanced_super_resolution_torch.ops.blur import saturate_like

__all__ = ["resize", "INTER_NEAREST", "INTER_LINEAR", "INTER_CUBIC",
           "INTER_AREA", "INTER_LANCZOS4"]

INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_CUBIC = 2
INTER_AREA = 3
INTER_LANCZOS4 = 4

_MODE_NAMES = {
    "nearest": INTER_NEAREST, "bilinear": INTER_LINEAR,
    "linear": INTER_LINEAR, "bicubic": INTER_CUBIC, "cubic": INTER_CUBIC,
    "area": INTER_AREA, "lanczos": INTER_LANCZOS4, "lanczos4": INTER_LANCZOS4,
}


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0, (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a,
                 0.0))


def _lanczos4_kernel(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return np.where(np.abs(x) < 4.0, np.sinc(x) * np.sinc(x / 4.0), 0.0)


def _axis_weights_interp(src: int, dst: int, mode: int) -> np.ndarray:
    scale = src / dst
    W = np.zeros((dst, src), dtype=np.float64)
    if mode == INTER_NEAREST:
        for d in range(dst):
            W[d, min(int(np.floor(d * scale)), src - 1)] = 1.0
        return W
    if mode == INTER_LINEAR:
        taps, offs = 2, 0
        kernel = lambda t: np.maximum(0.0, 1.0 - np.abs(t))  # noqa: E731
    elif mode == INTER_CUBIC:
        taps, offs, kernel = 4, 1, _cubic_kernel
    elif mode == INTER_LANCZOS4:
        taps, offs, kernel = 8, 3, _lanczos4_kernel
    else:
        raise ValueError(f"unsupported interp mode {mode}")
    for d in range(dst):
        fx = (d + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        w = kernel(fx - sx - (np.arange(taps) - offs))
        if w.sum() != 0:
            w = w / w.sum()
        for k in range(taps):
            W[d, min(max(sx + k - offs, 0), src - 1)] += w[k]
    return W


def _axis_weights_area_up(src: int, dst: int) -> np.ndarray:
    scale, inv_scale = src / dst, dst / src
    W = np.zeros((dst, src), dtype=np.float64)
    for d in range(dst):
        s = int(np.floor(d * scale))
        fx = (d + 1) - (s + 1) * inv_scale
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        W[d, min(s, src - 1)] += 1.0 - fx
        W[d, min(s + 1, src - 1)] += fx
    return W


def _axis_weights_area(src: int, dst: int) -> np.ndarray:
    scale = src / dst
    W = np.zeros((dst, src), dtype=np.float64)
    for d in range(dst):
        lo, hi = d * scale, (d + 1) * scale
        for s in range(int(np.floor(lo)), min(int(np.ceil(hi)), src)):
            overlap = min(hi, s + 1) - max(lo, s)
            if overlap > 0:
                W[d, s] = overlap / scale
    return W


@functools.lru_cache(maxsize=512)
def _weight_matrices(src_h: int, src_w: int, dst_h: int, dst_w: int,
                     mode: int) -> tuple[np.ndarray, np.ndarray]:
    if mode == INTER_AREA:
        if dst_h <= src_h and dst_w <= src_w:
            wh, ww = (_axis_weights_area(src_h, dst_h),
                      _axis_weights_area(src_w, dst_w))
        else:
            wh, ww = (_axis_weights_area_up(src_h, dst_h),
                      _axis_weights_area_up(src_w, dst_w))
    else:
        wh = _axis_weights_interp(src_h, dst_h, mode)
        ww = _axis_weights_interp(src_w, dst_w, mode)
    return wh.astype(np.float32), ww.astype(np.float32)


def resize(img: torch.Tensor, dsize=None, fx: float = 0.0, fy: float = 0.0,
           interpolation="bilinear") -> torch.Tensor:
    """cv2.resize for an (H, W) or (H, W, C) tensor; dsize is (w, h)."""
    mode = (_MODE_NAMES[interpolation.lower()]
            if isinstance(interpolation, str) else int(interpolation))
    src_h, src_w = int(img.shape[0]), int(img.shape[1])
    if dsize is not None:
        dst_w, dst_h = int(dsize[0]), int(dsize[1])
    else:
        dst_w, dst_h = int(round(src_w * fx)), int(round(src_h * fy))
    if dst_h <= 0 or dst_w <= 0:
        raise ValueError(f"invalid destination size ({dst_w}, {dst_h})")
    if (dst_h, dst_w) == (src_h, src_w) and mode != INTER_AREA:
        return img
    wh, ww = (torch.from_numpy(m).to(img.device)
              for m in _weight_matrices(src_h, src_w, dst_h, dst_w, mode))
    x = img.float()
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, :, None]
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    y = torch.einsum("oh,hwc->owc", wh, x)
    y = torch.einsum("pw,owc->opc", ww, y)
    if squeeze:
        y = y[:, :, 0]
    return saturate_like(y, img.dtype)
