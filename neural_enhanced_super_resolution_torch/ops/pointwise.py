"""Saturating pointwise ops with OpenCV uint8 semantics.

Counterpart of ``neural_enhanced_super_resolution_tpu/ops/pointwise.py``.
"""

from __future__ import annotations

import torch

from neural_enhanced_super_resolution_torch.ops.blur import saturate_like

__all__ = ["add_weighted", "subtract", "convert_scale_abs",
           "threshold_binary"]


def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor, beta: float,
                 gamma: float = 0.0) -> torch.Tensor:
    """cv2.addWeighted: saturate(a*alpha + b*beta + gamma)."""
    y = a.float() * alpha + b.float() * beta + gamma
    return saturate_like(y, a.dtype)


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cv2.subtract: saturating subtraction (uint8 clamps at 0)."""
    return saturate_like(a.float() - b.float(), a.dtype)


def convert_scale_abs(x: torch.Tensor, alpha: float = 1.0,
                      beta: float = 0.0) -> torch.Tensor:
    """cv2.convertScaleAbs: saturate_cast<uint8>(|x*alpha + beta|)."""
    return saturate_like(torch.abs(x.float() * alpha + beta), torch.uint8)


def threshold_binary(x: torch.Tensor, thresh: float,
                     maxval: float = 255.0) -> torch.Tensor:
    """cv2.threshold(..., THRESH_BINARY): maxval where x > thresh else 0."""
    y = torch.where(x.float() > thresh, maxval, 0.0)
    return saturate_like(y, x.dtype)
