"""Non-local means denoising (cv2.fastNlMeansDenoising[Colored]).

Counterpart of ``neural_enhanced_super_resolution_tpu/ops/nlmeans.py``,
with the same arithmetic: per search offset, the squared difference of the
template neighbourhoods, its 7x7 box sum, the mean per pixel and channel,
the weight w = exp(-max(d - 2 sigma^2, 0) / h^2) and the weighted sums
num / den per field. ``nl_means_colored`` flips RGB to BGR (cv2 reads
channel 0 as B), converts with the linear Lab of cv2 (uint8), denoises L
with ``h`` and (a, b) jointly with ``h_color`` in one pass, rounds, and
converts back. Borders are numpy ``reflect`` (cv2 BORDER_REFLECT_101).

The NL-means itself is ``kernels.nlmeans.nl_means_fields``: on the GPU one
launch of the hand-written kernel ``csrc/nlmeans.cu``, on the CPU its plain
version.
"""

from __future__ import annotations

import torch

from neural_enhanced_super_resolution_torch.kernels.nlmeans import (
    nl_means_fields)
from neural_enhanced_super_resolution_torch.ops.blur import saturate_like
from neural_enhanced_super_resolution_torch.ops.color import (lab_to_rgb,
                                                              rgb_to_lab)

__all__ = ["nl_means", "nl_means_colored"]


def _nl_means_f32(img: torch.Tensor, h: float, sigma: float = 0.0,
                  template: int = 7, search: int = 21) -> torch.Tensor:
    """NL-means on float32 (B, H, W, C) in [0, 255], one field over all
    channels."""
    return nl_means_fields(img.float().contiguous(),
                           ((tuple(range(img.shape[-1])), h),), sigma,
                           template, search)


def _nl_means_lab_joint(lab: torch.Tensor, h: float, h_color: float,
                        template: int = 7, search: int = 21
                        ) -> torch.Tensor:
    """One joint pass over float32 (B, H, W, 3) Lab: L with ``h``, (a, b)
    jointly with ``h_color`` (sigma 0, as cv2's colored variant)."""
    return nl_means_fields(lab.float().contiguous(),
                           (((0,), h), ((1, 2), h_color)), 0.0, template,
                           search)


def _batched(img: torch.Tensor) -> torch.Tensor:
    return img.reshape(-1, *img.shape[-3:])


def nl_means(img: torch.Tensor, h: float = 3.0, template: int = 7,
             search: int = 21, sigma: float = 0.0) -> torch.Tensor:
    """cv2.fastNlMeansDenoising for (H, W) gray or (..., H, W, C) images,
    on the input's device; integer inputs are rounded and clipped back."""
    x = img[..., None] if img.dim() == 2 else img
    out = _nl_means_f32(_batched(x).float(), h, sigma, template, search)
    return saturate_like(out.reshape(x.shape), img.dtype).reshape(img.shape)


def _denoised_lab(img: torch.Tensor, h: float, h_color: float,
                  template: int = 7, search: int = 21) -> torch.Tensor:
    """The uint8 linear Lab (B, H, W, 3) that nl_means_colored converts
    back: BGR -> Lab, the joint pass, round and clip."""
    lab = rgb_to_lab(_batched(img).flip(-1), srgb=False).float()
    return saturate_like(_nl_means_lab_joint(lab, h, h_color, template,
                                             search), torch.uint8)


def _lab_to_output(lab: torch.Tensor, shape) -> torch.Tensor:
    """Linear Lab back to RGB in the input's shape. One uint8 Lab level
    spans up to ~5 RGB levels here (linear light is coarse at the bright
    end), so a float32 rounding flip of one Lab level shows as that."""
    return lab_to_rgb(lab, srgb=False).flip(-1).reshape(shape)


def nl_means_colored(img: torch.Tensor, h: float = 3.0, h_color: float = 3.0,
                     template: int = 7, search: int = 21) -> torch.Tensor:
    """cv2.fastNlMeansDenoisingColored for uint8 RGB (..., H, W, 3), on the
    input's device."""
    return _lab_to_output(_denoised_lab(img, h, h_color, template, search),
                          img.shape)
