"""Multi-device execution: tile-batch data parallelism and strip sharding
with halo exchange.

Counterpart of ``neural_enhanced_super_resolution_tpu/parallel/sharded.py``
over a mesh (``parallel/mesh.py``): one process, one thread, every slot's
work enqueued on its device's current stream before any result is read.

* ``process_tiled_sharded``: each chunk of the tile batch is split into
  one equal shard a slot (the JAX package's chunk policy: ``batch_tiles``
  tiles a slot a chunk, a power-of-two bucket a slot, the tail padded by
  repeating the last tile); the model callable runs each slot's shard on
  the slot's device (a PyTorch module lives on one device, so the callable
  picks its model replica by the tiles' device), and the tiles are
  gathered and stitched on the home slot (slot 0).
* ``halo_exchange_strips`` / ``process_strips_sharded``: the image is cut
  into one horizontal strip a slot; each strip takes ``halo`` rows from
  each neighbour (a peer copy), the first and last strips reflect their own
  edge, the model runs on strip + halos, and the upscaled halos are
  cropped before the strips are gathered on the home slot.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from neural_enhanced_super_resolution_torch.ops.pad import reflect_pad
from neural_enhanced_super_resolution_torch.parallel.tiling import (
    TilingCancelled, _tile_grid, stitch_tiles)
from neural_enhanced_super_resolution_torch.runtime.profiler import (
    NULL_TIMER)

__all__ = ["process_tiled_sharded", "halo_exchange_strips",
           "process_strips_sharded"]

ModelFn = Callable[[torch.Tensor], torch.Tensor]


def _gather(parts: list[torch.Tensor], home: torch.device) -> torch.Tensor:
    return torch.cat([p.to(home, non_blocking=True) for p in parts], dim=0)


def process_tiled_sharded(model_fn: ModelFn, image: torch.Tensor,
                          mesh: Sequence[torch.device], tile_size: int = 512,
                          halo: int = 16, scale: int = 2,
                          batch_tiles: int | None = None,
                          cancel_check: Callable[[], bool] | None = None,
                          timer=NULL_TIMER) -> torch.Tensor:
    """Tile-batch data parallelism over ``mesh``.

    model_fn: (n, T+2h, T+2h, C) on a slot's device to
    (n, s(T+2h), s(T+2h), C') on the same device.
    A chunk holds ``batch_tiles`` tiles a slot (all tiles when None); its
    tail is padded by repeating the last tile up to a power-of-two count a
    slot (at most the chunk), the padded outputs are dropped. Returns
    (H*scale, W*scale, C') on slot 0's device. ``cancel_check`` is polled
    between chunks (``TilingCancelled``); ``timer`` takes the tile grid's
    counters (``parallel/tiling``), the padded tail's tiles among those run.
    """
    mesh = tuple(mesh)
    n_dev = len(mesh)
    home = mesh[0]
    tiles, ny, nx, orig_h, orig_w = _tile_grid(image.to(home), tile_size,
                                               halo, timer)
    n = tiles.shape[0]
    step = n if batch_tiles is None else max(n_dev, batch_tiles * n_dev)
    chunks = []
    for start in range(0, n, step):
        if cancel_check is not None and cancel_check():
            raise TilingCancelled(f"cancelled at tile {start}/{n}")
        chunk = tiles[start:start + step]
        valid = chunk.shape[0]
        per_dev = -(-valid // n_dev)
        bucket = 1
        while bucket < per_dev:
            bucket *= 2
        target = (bucket * n_dev if batch_tiles is None
                  else min(step, bucket * n_dev))
        if valid < target:
            chunk = torch.cat([chunk, chunk[-1:].expand(
                target - valid, *chunk.shape[1:])], dim=0)
            # the padded tail runs too
            timer.count("tiles", target - valid)
            timer.count("tile_px", (target - valid) * int(tiles.shape[1]) ** 2)
        per = target // n_dev
        # every slot's shard is dispatched before any output is gathered
        outs = [model_fn(chunk[i * per:(i + 1) * per]
                         .to(dev, non_blocking=True).contiguous())
                for i, dev in enumerate(mesh)]
        chunks.append(_gather(outs, home)[:valid])
    out_tiles = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
    out = stitch_tiles(out_tiles, ny, nx, tile_size * scale, halo * scale)
    return out[:orig_h * scale, :orig_w * scale, :]


def halo_exchange_strips(strips: Sequence[torch.Tensor], halo: int
                         ) -> list[torch.Tensor]:
    """Give each strip ``halo`` rows from both ring neighbours.

    strips: one (rows, W, C) a slot, on its slot's device. Returns one
    (rows + 2 halo, W, C) a slot on the same device: the top halo is the
    previous strip's last rows, the bottom halo the next strip's first
    rows; the first and last strips reflect their own edge instead
    (``strip[1:halo+1]`` and ``strip[-halo-1:-1]`` reversed), so rows must
    be at least halo + 1."""
    n = len(strips)
    out = []
    for i, s in enumerate(strips):
        top = (strips[i - 1][-halo:].to(s.device, non_blocking=True) if i > 0
               else s[1:halo + 1].flip(0))
        bot = (strips[i + 1][:halo].to(s.device, non_blocking=True)
               if i < n - 1 else s[-halo - 1:-1].flip(0))
        out.append(torch.cat([top, s, bot], dim=0))
    return out


def process_strips_sharded(model_fn: ModelFn, image: torch.Tensor,
                           mesh: Sequence[torch.device], halo: int = 16,
                           scale: int = 2) -> torch.Tensor:
    """Strip-shard an (H, W, C) image over ``mesh`` with halo exchange.

    H is reflect-padded to a multiple of the mesh size; slot i holds rows
    [i r, (i+1) r) and ``model_fn`` maps it as (1, r + 2 halo, W, C) to
    (1, scale (r + 2 halo), scale W, C') on its device; the upscaled halos
    are cropped and the strips gathered on slot 0, cut back to H * scale
    rows."""
    mesh = tuple(mesh)
    n_dev = len(mesh)
    h = int(image.shape[0])
    image = reflect_pad(image.to(mesh[0]), 0, 0, (-h) % n_dev)
    rows = int(image.shape[0]) // n_dev
    strips = [image[i * rows:(i + 1) * rows].to(dev, non_blocking=True)
              for i, dev in enumerate(mesh)]
    cut = halo * scale
    outs = []
    for ext in halo_exchange_strips(strips, halo):
        y = model_fn(ext[None].contiguous())[0]
        outs.append(y[cut:y.shape[0] - cut])
    return _gather(outs, mesh[0])[:h * scale]
