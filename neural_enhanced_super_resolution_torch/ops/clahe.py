"""CLAHE with OpenCV's exact algorithm (clip, redistribute, bilinear LUT).

Counterpart of ``neural_enhanced_super_resolution_tpu/ops/clahe.py``:
reflect-101 extension to the tile grid, per-tile 256-bin histograms
(integer ``bincount``), clipping at max(clipLimit*tileArea/256, 1) with the
uniform batch plus OpenCV's strided residual, LUT = round(cumsum *
255/tileArea), and bilinear interpolation between the four neighbouring
tile LUTs with per-pixel grids built in numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from neural_enhanced_super_resolution_torch.ops.pad import reflect_pad

__all__ = ["clahe"]


@functools.lru_cache(maxsize=64)
def _interp_grids(h: int, w: int, tiles_y: int, tiles_x: int,
                  tile_h: int, tile_w: int):
    """Per-pixel tile indices and bilinear weights (OpenCV mapping)."""
    def axis(n, tiles, tile):
        f = np.arange(n, dtype=np.float64) / tile - 0.5
        i1 = np.floor(f).astype(np.int64)
        a = (f - i1).astype(np.float32)
        i2 = np.minimum(i1 + 1, tiles - 1)
        i1 = np.maximum(i1, 0)
        return i1, i2, a

    return axis(h, tiles_y, tile_h) + axis(w, tiles_x, tile_w)


def clahe(src: torch.Tensor, clip_limit: float = 2.0,
          tile_grid_size=(8, 8)) -> torch.Tensor:
    """cv2.createCLAHE(clipLimit, tileGridSize).apply(src), uint8 (H, W)."""
    if src.dtype != torch.uint8:
        raise TypeError("clahe expects a uint8 single-channel image")
    if src.dim() != 2:
        raise ValueError("clahe expects a 2-D (H, W) image")
    tiles_x, tiles_y = int(tile_grid_size[0]), int(tile_grid_size[1])
    dev = src.device
    h, w = src.shape
    he = -(-h // tiles_y) * tiles_y
    we = -(-w // tiles_x) * tiles_x
    ext = reflect_pad(reflect_pad(src, 0, 0, he - h), 1, 0, we - w)
    th, tw = he // tiles_y, we // tiles_x
    tile_area = th * tw
    n_tiles = tiles_y * tiles_x

    vals = ext.reshape(tiles_y, th, tiles_x, tw).permute(0, 2, 1, 3)
    vals = vals.reshape(n_tiles, tile_area).long()
    offs = torch.arange(n_tiles, device=dev)[:, None] * 256
    hist = torch.bincount((vals + offs).reshape(-1),
                          minlength=n_tiles * 256).reshape(n_tiles, 256)

    if clip_limit > 0:
        limit = max(int(clip_limit * tile_area / 256.0), 1)
        clipped = torch.clamp(hist - limit, min=0).sum(dim=1, keepdim=True)
        hist = torch.clamp(hist, max=limit)
        batch = clipped // 256
        residual = clipped - batch * 256
        hist = hist + batch
        step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
        bins = torch.arange(256, device=dev)[None, :]
        gets_one = (((bins % step) == 0) & ((bins // step) < residual)
                    & (residual > 0))
        hist = hist + gets_one.long()

    scale = np.float32(255.0 / float(tile_area))
    lut = torch.clamp(torch.round(torch.cumsum(hist, dim=1).float()
                                  * float(scale)), 0, 255)
    flat_lut = lut.reshape(-1)

    ty1, ty2, ya, tx1, tx2, xa = (torch.from_numpy(a).to(dev) for a in
                                  _interp_grids(h, w, tiles_y, tiles_x,
                                                th, tw))
    ya = ya[:, None]
    xa = xa[None, :]
    v = src.long()

    def sample(tyi, txi):
        return flat_lut[(tyi[:, None] * tiles_x + txi[None, :]) * 256 + v]

    # a*b + c*d with the first product fused (one rounding), as XLA
    # contracts it: values landing on .5 round the same way as the JAX op.
    def lerp(a, wa, c, wc):
        return (a.double() * wa.double() + (c * wc).double()).float()

    top = lerp(sample(ty1, tx1), 1.0 - xa, sample(ty1, tx2), xa)
    bot = lerp(sample(ty2, tx1), 1.0 - xa, sample(ty2, tx2), xa)
    out = lerp(top, 1.0 - ya, bot, ya)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
