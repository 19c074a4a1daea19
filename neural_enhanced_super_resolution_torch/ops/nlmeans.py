"""Non-local means denoising (cv2.fastNlMeansDenoising[Colored]).

Counterpart of ``neural_enhanced_super_resolution_tpu/ops/nlmeans.py``,
with the same arithmetic: per search offset, the squared difference of the
template neighbourhoods, its 7x7 box sum, the mean per pixel and channel,
the weight w = exp(-max(d - 2 sigma^2, 0) / h^2) and the weighted sums
num / den per field. ``nl_means_colored`` flips RGB to BGR (cv2 reads
channel 0 as B), converts with the linear Lab of cv2 (uint8), denoises L
with ``h`` and (a, b) jointly with ``h_color`` in one pass, rounds, and
converts back. Borders are numpy ``reflect`` (cv2 BORDER_REFLECT_101).

Formulated for a GPU as a few large ops instead of one XLA program: the
loop runs over the 21 search rows, and each step takes all 21 column
offsets of its row at once, as an ``unfold`` view of the padded planes
(B, 21, C, H, W) — a tile batch and a row of offsets per op, about 14
launches a row. The box sum is two 1-D ``avg_pool2d`` passes with divisor
1: for uint8 data every partial sum is an integer below 2^24, so it is
exact in float32 and equal to the JAX package's shift-adds. Weights and
sums are float32, summed over the offsets of a row before they join the
running sums (the JAX package adds them one offset at a time), so results
agree up to float32 summation order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.ops.blur import saturate_like
from neural_enhanced_super_resolution_torch.ops.color import (lab_to_rgb,
                                                              rgb_to_lab)
from neural_enhanced_super_resolution_torch.ops.pad import reflect_pad

__all__ = ["nl_means", "nl_means_colored"]


def _inv_h2(h: float) -> float:
    """1 / h^2 computed in float32, as the JAX package computes it."""
    h32 = torch.tensor(h, dtype=torch.float32)
    return float(1.0 / (h32 * h32))


def _nl_planes(x: torch.Tensor, fields, sigma: float, template: int,
               search: int) -> torch.Tensor:
    """NL-means on planar float32 (B, C, H, W) in [0, 255].

    fields: ((channels, h), ...): the channels whose squared differences
    form one weight field, and its filter strength. Returns (B, C, H, W).
    """
    b, c, h, w = x.shape
    tr, sr = template // 2, search // 2
    pad = sr + tr
    ext = reflect_pad(reflect_pad(x, 2, pad, pad), 3, pad, pad)
    hh, ww = h + 2 * tr, w + 2 * tr
    center = ext[:, None, :, sr:sr + hh, sr:sr + ww]
    # Per channel: the patch area of its field and -1/h^2; a field's sum
    # is gathered in its first channel and copied to the others.
    area = torch.empty(c, dtype=torch.float32)
    neg_inv = torch.empty(c, dtype=torch.float32)
    for chans, strength in fields:
        area[list(chans)] = float(template * template * len(chans))
        neg_inv[list(chans)] = -_inv_h2(strength)
    area = area.view(1, 1, c, 1, 1).to(x.device)
    neg_inv = neg_inv.view(1, 1, c, 1, 1).to(x.device)
    two_sigma2 = float(torch.tensor(2.0, dtype=torch.float32)
                       * torch.tensor(sigma, dtype=torch.float32) ** 2)

    num = torch.zeros((b, c, h, w), dtype=torch.float32, device=x.device)
    den = torch.zeros_like(num)
    diff = torch.empty((b, search, c, hh, ww), dtype=torch.float32,
                       device=x.device)
    for dy in range(search):
        # The row's 21 column offsets as one view: (B, 21, C, hh, ww).
        shifted = ext[:, :, dy:dy + hh].unfold(3, ww, 1).permute(0, 3, 1, 2,
                                                                  4)
        torch.sub(center, shifted, out=diff)
        diff.square_()
        wgt = F.avg_pool2d(
            F.avg_pool2d(diff.view(b * search, c, hh, ww), (template, 1),
                         stride=1, divisor_override=1),
            (1, template), stride=1, divisor_override=1).view(
                b, search, c, h, w)
        for chans, _ in fields:
            for ch in chans[1:]:
                wgt[:, :, chans[0]].add_(wgt[:, :, ch])
            for ch in chans[1:]:
                wgt[:, :, ch].copy_(wgt[:, :, chans[0]])
        wgt.div_(area)
        if sigma > 0:
            wgt.sub_(two_sigma2).clamp_(min=0.0)
        wgt.mul_(neg_inv).exp_()
        den.add_(wgt.sum(1))
        vals = ext[:, :, dy + tr:dy + tr + h, tr:tr + w + 2 * sr].unfold(
            3, w, 1).permute(0, 3, 1, 2, 4)
        num.add_(wgt.mul_(vals).sum(1))
    return num / den


def _nl_nhwc(x: torch.Tensor, fields, sigma: float, template: int,
             search: int) -> torch.Tensor:
    """_nl_planes on float32 (B, H, W, C); returns (B, H, W, C)."""
    planes = x.permute(0, 3, 1, 2).float().contiguous()
    return _nl_planes(planes, fields, sigma, template, search).permute(
        0, 2, 3, 1)


def _nl_means_f32(img: torch.Tensor, h: float, sigma: float = 0.0,
                  template: int = 7, search: int = 21) -> torch.Tensor:
    """NL-means on float32 (B, H, W, C) in [0, 255], one field over all
    channels."""
    return _nl_nhwc(img, ((tuple(range(img.shape[-1])), h),), sigma,
                    template, search)


def _nl_means_lab_joint(lab: torch.Tensor, h: float, h_color: float,
                        template: int = 7, search: int = 21
                        ) -> torch.Tensor:
    """One joint pass over float32 (B, H, W, 3) Lab: L with ``h``, (a, b)
    jointly with ``h_color`` (sigma 0, as cv2's colored variant)."""
    return _nl_nhwc(lab, (((0,), h), ((1, 2), h_color)), 0.0, template,
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
