"""Reflect padding by index gather.

numpy's / jnp's ``mode="reflect"`` (= OpenCV BORDER_REFLECT_101) for any
dtype — uint8 included — and any pad width, including pads wider than the
axis (repeated reflection). ``F.pad(mode="reflect")`` covers neither.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["reflect_index", "reflect_pad"]


@functools.lru_cache(maxsize=256)
def _reflect_index_np(n: int, before: int, after: int) -> np.ndarray:
    return np.pad(np.arange(n), (before, after), mode="reflect")


def reflect_index(n: int, before: int, after: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Source indices of an axis of length n reflect-padded by (before,
    after)."""
    return torch.from_numpy(_reflect_index_np(n, before, after)).to(device)


def reflect_pad(x: torch.Tensor, dim: int, before: int,
                after: int) -> torch.Tensor:
    """Reflect-101 pad ``x`` along ``dim``."""
    if before == 0 and after == 0:
        return x
    idx = reflect_index(x.shape[dim], before, after, x.device)
    return x.index_select(dim, idx)
