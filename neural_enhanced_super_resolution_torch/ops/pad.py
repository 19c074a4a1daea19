"""Reflect padding by index gather.

numpy's / jnp's ``mode="reflect"`` (= OpenCV BORDER_REFLECT_101) for any
dtype — uint8 included — and any pad width, including pads wider than the
axis (repeated reflection). ``F.pad(mode="reflect")`` covers neither.
"""

from __future__ import annotations

import torch

__all__ = ["reflect_index", "reflect_pad"]


def reflect_index(n: int, before: int, after: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Source indices of an axis of length n reflect-padded by (before,
    after). Computed on ``device`` (reflection is periodic with period
    2 (n - 1)), so no host-to-device copy waits on the host."""
    idx = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = idx.abs() % period
    return torch.where(idx >= n, period - idx, idx)


def reflect_pad(x: torch.Tensor, dim: int, before: int,
                after: int) -> torch.Tensor:
    """Reflect-101 pad ``x`` along ``dim``."""
    if before == 0 and after == 0:
        return x
    idx = reflect_index(x.shape[dim], before, after, x.device)
    return x.index_select(dim, idx)
