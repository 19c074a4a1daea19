"""NL-means on the card: ``csrc/nlmeans.cu`` and its plain version.

``nl_means_fields(x, fields, sigma, template, search)`` denoises a float32
(B, H, W, C) batch in [0, 255] with NL-means: per pixel and search offset
the 7x7 box sum of the squared differences over each field's channels,
its mean per pixel and channel, the weight w = exp(-max(d - 2 sigma^2, 0)
/ h^2) of the field and the weighted sums num / den; out = num / den.
``fields`` is ((channels, h), ...): the channels whose squared
differences form one weight field, and its filter strength. Borders are
numpy ``reflect`` (cv2 BORDER_REFLECT_101).

On a CUDA tensor it is one launch of ``csrc/nlmeans.cu`` (``launches``
counts them), which takes the two field layouts of the JAX package's
NL-means: one field over all C <= 4 channels with any sigma
(``_nl_means_f32``), or the Lab joint pass, C = 3, L with h and (a, b)
jointly with h_color, sigma 0 (``_nl_means_lab_joint``); a 7x7 template
and a 21x21 search. Anything else raises ``KernelInputError``; a failed
build or launch ``KernelError``. On a CPU tensor it takes
``nl_means_fields_plain`` (``calls`` counts them).

The plain version is formulated for a GPU as a few large ops: the loop
runs over the 21 search rows, and each step takes all 21 column offsets
of its row at once, as an ``unfold`` view of the padded planes (B, 21, C,
H, W), about 14 launches a row. The box sum is two 1-D ``avg_pool2d``
passes with divisor 1: for uint8 data every partial sum is an integer
below 2^24, so it is exact in float32 and equal to the JAX package's
shift-adds. Weights and sums are float32, summed over the offsets of a
row before they join the running sums (the JAX package and the kernel add
them one offset at a time), so results agree up to float32 summation
order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)

__all__ = ["nl_means_fields", "nl_means_fields_plain", "inv_h2"]

# The kernel's field layouts (csrc/nlmeans.cu): one field over all
# channels, and the Lab joint pass.
_ONE, _LAB = 0, 1


# The scalars in float32 by numpy on the host, so that a call dispatches
# no PyTorch op but its output's allocation.
def inv_h2(h: float) -> float:
    """1 / h^2 computed in float32, as the JAX package computes it."""
    h32 = np.float32(h)
    return float(np.float32(1.0) / (h32 * h32))


def _two_sigma2(sigma: float) -> float:
    s32 = np.float32(sigma)
    return float(np.float32(2.0) * (s32 * s32))


def nl_means_fields_plain(x: torch.Tensor, fields, sigma: float,
                          template: int, search: int) -> torch.Tensor:
    """The plain version of ``nl_means_fields``: float32 (B, H, W, C) in,
    (B, H, W, C) out, on x's device."""
    from neural_enhanced_super_resolution_torch.ops.pad import reflect_pad
    nl_means_fields_plain.calls += 1
    x = x.permute(0, 3, 1, 2).float().contiguous()
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
        neg_inv[list(chans)] = -inv_h2(strength)
    area = area.view(1, 1, c, 1, 1).to(x.device)
    neg_inv = neg_inv.view(1, 1, c, 1, 1).to(x.device)
    two_sigma2 = _two_sigma2(sigma)

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
    return (num / den).permute(0, 2, 3, 1)


nl_means_fields_plain.calls = 0


def _layout(x: torch.Tensor, fields, sigma: float, template: int,
            search: int) -> tuple:
    """The kernel's field layout and -1/h^2 of its fields for this call;
    raises KernelInputError for one it does not take."""
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise KernelInputError(
            f"nl_means_fields: needs a contiguous float32 (B, H, W, C) "
            f"tensor, got {x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    if not (1 <= b <= 65535 and h >= 1 and w >= 1 and 1 <= c <= 4):
        raise KernelInputError(f"nl_means_fields: no kernel for shape "
                               f"{tuple(x.shape)} (B 1..65535, C 1..4)")
    if (template, search) != (7, 21):
        raise KernelInputError(f"nl_means_fields: the kernel takes a 7x7 "
                               f"template and a 21x21 search, got "
                               f"{template} and {search}")
    if not sigma >= 0:
        raise KernelInputError(f"nl_means_fields: sigma {sigma} < 0")
    fields = tuple((tuple(chans), strength) for chans, strength in fields)
    if len(fields) == 1 and fields[0][0] == tuple(range(c)):
        return _ONE, -inv_h2(fields[0][1]), 0.0
    if (c == 3 and len(fields) == 2 and fields[0][0] == (0,)
            and fields[1][0] == (1, 2) and sigma == 0):
        return _LAB, -inv_h2(fields[0][1]), -inv_h2(fields[1][1])
    raise KernelInputError(
        f"nl_means_fields: no kernel for the fields {fields} (sigma "
        f"{sigma}) over {c} channels: one field over all channels, or "
        "((0,), h), ((1, 2), h_color) over 3 with sigma 0")


def nl_means_fields(x: torch.Tensor, fields, sigma: float = 0.0,
                    template: int = 7, search: int = 21) -> torch.Tensor:
    """NL-means of float32 (B, H, W, C) in [0, 255] with the given weight
    fields; returns float32 (B, H, W, C) on x's device. On the GPU one
    launch of ``csrc/nlmeans.cu``."""
    if x.device.type == "cpu":
        return nl_means_fields_plain(x, fields, sigma, template, search)
    mode, neg_inv0, neg_inv1 = _layout(x, fields, sigma, template, search)
    if not x.is_cuda:
        raise KernelInputError(f"nl_means_fields: no kernel for device "
                               f"{x.device}")
    lib = _build.load_library()
    out = torch.empty_like(x)
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        err = lib.nesr_nl_means(x.data_ptr(), out.data_ptr(), b, h, w, c,
                                mode, neg_inv0, neg_inv1, _two_sigma2(sigma),
                                _build.stream_ptr())
    _build.check("nl_means_fields", err)
    nl_means_fields.launches += 1
    return out


nl_means_fields.launches = 0
