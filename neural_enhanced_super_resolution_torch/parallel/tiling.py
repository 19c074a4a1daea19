"""Overlap-halo tiling: pad to a tile grid, cut tiles with reflect halos, run
a batch model over chunks of tiles, crop and stitch.

Counterpart of ``neural_enhanced_super_resolution_tpu/parallel/tiling.py``
(batched mode). Tiles are staged with torch indexing on the image's own
device; reflect padding is an index gather, so it works for uint8 and for
pads wider than the image. ``process_tiled_to_host`` lands each chunk's
cropped tiles in a host canvas and returns exactly what ``process_tiled``
returns. A partial last chunk runs at its own size: the JAX package pads it
to a power of two (``tile_tail``) to reuse a compiled shape, which eager
PyTorch does not need.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from neural_enhanced_super_resolution_torch.ops.pad import (reflect_index,
                                                            reflect_pad)

logger = logging.getLogger("nesr.tiling")

__all__ = ["pad_to_grid", "extract_tiles", "stitch_tiles", "process_tiled",
           "process_tiled_to_host", "TilingCancelled"]


class TilingCancelled(Exception):
    """Raised between tile chunks when the caller's cancel_check fires."""


def pad_to_grid(image: torch.Tensor, tile: int
                ) -> tuple[torch.Tensor, int, int]:
    """Reflect-pad (H, W, C) on the bottom/right to a multiple of ``tile``."""
    h, w = int(image.shape[0]), int(image.shape[1])
    image = reflect_pad(image, 0, 0, (-h) % tile)
    image = reflect_pad(image, 1, 0, (-w) % tile)
    return image, h, w


def extract_tiles(image: torch.Tensor, tile: int, halo: int) -> torch.Tensor:
    """(H, W, C) -> (ny*nx, tile+2*halo, tile+2*halo, C) with reflect halos.

    H and W must be multiples of ``tile`` (use pad_to_grid first)."""
    h, w, c = image.shape
    ny, nx = h // tile, w // tile
    k = tile + 2 * halo
    dev = image.device
    ridx = reflect_index(h, halo, halo, dev)
    cidx = reflect_index(w, halo, halo, dev)
    win = torch.arange(k, device=dev)
    rows = ridx[(torch.arange(ny, device=dev) * tile)[:, None] + win]  # ny,k
    cols = cidx[(torch.arange(nx, device=dev) * tile)[:, None] + win]  # nx,k
    tiles = image[rows[:, None, :, None], cols[None, :, None, :]]
    return tiles.reshape(ny * nx, k, k, c)


def stitch_tiles(tiles: torch.Tensor, ny: int, nx: int, tile_out: int,
                 halo_out: int) -> torch.Tensor:
    """(ny*nx, tile_out+2*halo_out, ..., C) -> (ny*tile_out, nx*tile_out, C)."""
    c = tiles.shape[-1]
    core = tiles[:, halo_out:halo_out + tile_out,
                 halo_out:halo_out + tile_out, :]
    core = core.reshape(ny, nx, tile_out, tile_out, c).permute(0, 2, 1, 3, 4)
    return core.reshape(ny * tile_out, nx * tile_out, c)


def _chunks(tiles: torch.Tensor, batch_tiles: int | None,
            cancel_check: Callable[[], bool] | None):
    """Yield (start, chunk) over chunks of ``batch_tiles`` tiles; a partial
    last chunk runs at its own size (the kernels take any batch)."""
    n = tiles.shape[0]
    step = batch_tiles or n
    for start in range(0, n, step):
        if cancel_check is not None and cancel_check():
            raise TilingCancelled(f"cancelled at tile {start}/{n}")
        yield start, tiles[start:start + step].contiguous()


def _tile_grid(image: torch.Tensor, tile_size: int, halo: int):
    padded, orig_h, orig_w = pad_to_grid(image, tile_size)
    ny = int(padded.shape[0]) // tile_size
    nx = int(padded.shape[1]) // tile_size
    return extract_tiles(padded, tile_size, halo), ny, nx, orig_h, orig_w


def process_tiled(model_fn: Callable[[torch.Tensor], torch.Tensor],
                  image: torch.Tensor, tile_size: int = 512, halo: int = 16,
                  scale: int = 2, batch_tiles: int | None = None,
                  cancel_check: Callable[[], bool] | None = None
                  ) -> torch.Tensor:
    """Batched uniform tiled processing.

    model_fn: (N, T+2h, T+2h, C) -> (N, s(T+2h), s(T+2h), C') on the
    image's device. Returns (H*scale, W*scale, C') on that device.
    """
    tiles, ny, nx, orig_h, orig_w = _tile_grid(image, tile_size, halo)
    outs = [model_fn(chunk)
            for _, chunk in _chunks(tiles, batch_tiles, cancel_check)]
    out_tiles = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    out = stitch_tiles(out_tiles, ny, nx, tile_size * scale, halo * scale)
    return out[:orig_h * scale, :orig_w * scale, :]


def process_tiled_to_host(model_fn: Callable[[torch.Tensor], torch.Tensor],
                          image: torch.Tensor, tile_size: int = 512,
                          halo: int = 16, scale: int = 2,
                          batch_tiles: int = 16,
                          cancel_check: Callable[[], bool] | None = None
                          ) -> np.ndarray:
    """process_tiled whose output lands chunk by chunk in a host canvas.

    Equal to ``process_tiled(...).cpu().numpy()`` with the same arguments.
    """
    tiles, ny, nx, orig_h, orig_w = _tile_grid(image, tile_size, halo)
    to, ho = tile_size * scale, halo * scale
    canvas = None
    for start, chunk in _chunks(tiles, batch_tiles, cancel_check):
        cores = model_fn(chunk)[:, ho:ho + to, ho:ho + to, :]
        cores = cores.cpu().numpy()
        if canvas is None:
            canvas = np.empty((ny * to, nx * to, cores.shape[-1]),
                              dtype=cores.dtype)
        for j in range(cores.shape[0]):
            iy, ix = divmod(start + j, nx)
            canvas[iy * to:(iy + 1) * to, ix * to:(ix + 1) * to] = cores[j]
    return canvas[:orig_h * scale, :orig_w * scale, :]
