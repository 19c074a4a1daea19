"""Overlap-halo tiling: pad to a tile grid, cut tiles with reflect halos, run
a batch model over chunks of tiles, crop and stitch; and the reference's
per-tile loop (``process_with_tiling_parity``, config ``parity_tiling``).

Counterpart of ``neural_enhanced_super_resolution_tpu/parallel/tiling.py``
(batched mode). Tiles are staged with torch indexing on the image's own
device; reflect padding is an index gather, so it works for uint8 and for
pads wider than the image. ``process_tiled_to_host`` lands each chunk's
cropped tiles in a host canvas, the copies overlapping the next chunk's
compute, and returns exactly what ``process_tiled(...).cpu()`` returns. A
partial last chunk runs at its own size: the JAX package pads it to a
power of two (``tile_tail``) to reuse a compiled shape, which eager
PyTorch does not need.

With a ``StageTimer`` in ``timer`` (``runtime/profiler``), a tiled path
counts at ``_tile_grid`` the tiles run (``tiles``), the pixels they run
(``tile_px``: tiles x (tile + 2 halo)^2) and the image's (``tile_image_px``);
``process_tiled_sharded`` adds its padded tail, and ``ops/enhance``'s op
tiling passes no timer, so it is not counted. ``process_tiled_to_host``
adds the spans ``tiling/grid`` (pad and cut),
``tiling/chunk`` (a chunk's forward and crop), ``tiling/copy`` (a chunk's
copy, on the copy stream), ``tiling/land`` (a chunk's landing in the
canvas; on the GPU on a fetch thread, host clock only and no range) and
``tiling/drain`` (the calling thread's waits on a landing slot and on the
last landings).
"""

from __future__ import annotations

import logging
import math
from typing import Callable

import numpy as np
import torch

from neural_enhanced_super_resolution_torch.kernels._build import (
    is_device_fault)
from neural_enhanced_super_resolution_torch.ops.pad import (reflect_index,
                                                            reflect_pad)
from neural_enhanced_super_resolution_torch.ops.resize import resize
from neural_enhanced_super_resolution_torch.runtime.profiler import (
    NULL_TIMER)

logger = logging.getLogger("nesr.tiling")

__all__ = ["pad_to_grid", "extract_tiles", "stitch_tiles", "process_tiled",
           "process_tiled_to_host", "process_with_tiling_parity",
           "TilingCancelled"]


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


def _tile_grid(image: torch.Tensor, tile_size: int, halo: int,
               timer=NULL_TIMER):
    padded, orig_h, orig_w = pad_to_grid(image, tile_size)
    ny = int(padded.shape[0]) // tile_size
    nx = int(padded.shape[1]) // tile_size
    timer.count("tiles", ny * nx)
    timer.count("tile_px", ny * nx * (tile_size + 2 * halo) ** 2)
    timer.count("tile_image_px", orig_h * orig_w)
    return extract_tiles(padded, tile_size, halo), ny, nx, orig_h, orig_w


def process_tiled(model_fn: Callable[[torch.Tensor], torch.Tensor],
                  image: torch.Tensor, tile_size: int = 512, halo: int = 16,
                  scale: int = 2, batch_tiles: int | None = None,
                  cancel_check: Callable[[], bool] | None = None,
                  timer=NULL_TIMER) -> torch.Tensor:
    """Batched uniform tiled processing.

    model_fn: (N, T+2h, T+2h, C) -> (N, s(T+2h), s(T+2h), C') on the
    image's device. Returns (H*scale, W*scale, C') on that device.
    """
    tiles, ny, nx, orig_h, orig_w = _tile_grid(image, tile_size, halo, timer)
    outs = [model_fn(chunk)
            for _, chunk in _chunks(tiles, batch_tiles, cancel_check)]
    out_tiles = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    out = stitch_tiles(out_tiles, ny, nx, tile_size * scale, halo * scale)
    return out[:orig_h * scale, :orig_w * scale, :]


def _land(canvas: np.ndarray, cores: np.ndarray, start: int, nx: int,
          to: int) -> None:
    for j in range(cores.shape[0]):
        iy, ix = divmod(start + j, nx)
        canvas[iy * to:(iy + 1) * to, ix * to:(ix + 1) * to] = cores[j]


def process_tiled_to_host(model_fn: Callable[[torch.Tensor], torch.Tensor],
                          image: torch.Tensor, tile_size: int = 512,
                          halo: int = 16, scale: int = 2,
                          batch_tiles: int = 16,
                          cancel_check: Callable[[], bool] | None = None,
                          timer=NULL_TIMER) -> np.ndarray:
    """process_tiled whose output lands chunk by chunk in a host canvas,
    each chunk's copy to the host overlapping the next chunk's compute.

    The image is tiled on its own device. On the GPU the cropped cores of
    chunk i go to a pinned host buffer on a copy stream, ordered after the
    compute by an event, while chunk i+1 computes, and a fetch thread lands
    them in the canvas, waiting on that chunk's event; two chunks (each
    with its buffer and thread) may be in flight to the host. On the CPU
    the same steps run without streams. Equal, bit for bit, to
    ``process_tiled(...).cpu().numpy()`` with the same arguments.
    Cancellation raises ``TilingCancelled`` between chunks; errors of the
    model or the copies propagate.
    """
    dev = image.device
    with timer.span("tiling/grid", dev):
        tiles, ny, nx, orig_h, orig_w = _tile_grid(image, tile_size, halo,
                                                   timer)
    to, ho = tile_size * scale, halo * scale
    if image.is_cuda:
        canvas = _streamed_to_host(model_fn, tiles, nx, ny, to, ho,
                                   batch_tiles, cancel_check, timer)
    else:
        canvas = None
        for start, chunk in _chunks(tiles, batch_tiles, cancel_check):
            with timer.span("tiling/chunk", dev):
                cores = model_fn(chunk)[:, ho:ho + to, ho:ho + to, :].numpy()
            if canvas is None:
                canvas = np.empty((ny * to, nx * to, cores.shape[-1]),
                                  dtype=cores.dtype)
            with timer.span("tiling/land"):
                _land(canvas, cores, start, nx, to)
    return canvas[:orig_h * scale, :orig_w * scale, :]


def _streamed_to_host(model_fn, tiles: torch.Tensor, nx: int, ny: int,
                      to: int, ho: int, batch_tiles: int,
                      cancel_check, timer=NULL_TIMER) -> np.ndarray:
    """The GPU body of process_tiled_to_host. Two pinned output buffers
    take turns; a buffer is refilled only after its last chunk landed."""
    import concurrent.futures

    depth = 2
    dev = tiles.device
    compute = torch.cuda.current_stream(dev)
    d2h = torch.cuda.Stream(dev)
    bufs: list[torch.Tensor] = []
    landing: list = [None] * depth
    canvas = None

    parent = timer.current()   # the landings' parent, on another thread

    def land(done, cores, start):
        done.synchronize()   # this chunk's copy, not the whole device
        with timer.span("tiling/land", parent=parent):
            _land(canvas, cores, start, nx, to)

    with concurrent.futures.ThreadPoolExecutor(depth) as pool:
        for i, (start, chunk) in enumerate(
                _chunks(tiles, batch_tiles, cancel_check)):
            with timer.span("tiling/chunk", dev):
                core = model_fn(chunk)[:, ho:ho + to, ho:ho + to, :]
                core = core.contiguous()
            slot = i % depth
            if landing[slot] is not None:
                with timer.span("tiling/drain", dev):
                    landing[slot].result()
            if len(bufs) <= slot:
                bufs.append(torch.empty(
                    (batch_tiles or tiles.shape[0],) + tuple(core.shape[1:]),
                    dtype=core.dtype, pin_memory=True))
            host = bufs[slot][:core.shape[0]]
            if canvas is None:
                canvas = np.empty((ny * to, nx * to, core.shape[-1]),
                                  dtype=host.numpy().dtype)
            d2h.wait_stream(compute)
            with torch.cuda.stream(d2h):
                with timer.span("tiling/copy", dev):
                    host.copy_(core, non_blocking=True)
                done = torch.cuda.Event(enable_timing=True, blocking=True)
                done.record(d2h)
            core.record_stream(d2h)
            landing[slot] = pool.submit(land, done, host.numpy(), start)
        with timer.span("tiling/drain", dev):
            for fut in landing:
                if fut is not None:
                    fut.result()
    return canvas


# --------------------------------------------------------------------------
# Parity mode: the reference's exact per-tile arithmetic.
# --------------------------------------------------------------------------

def _propagates(exc: BaseException) -> bool:
    """Cancellation and device faults pass through the parity loop's
    bicubic rungs: a broken kernel must not come out as a bicubic tile."""
    return isinstance(exc, TilingCancelled) or is_device_fault(exc)


def process_with_tiling_parity(processor_func: Callable[[torch.Tensor],
                                                        torch.Tensor],
                               image: torch.Tensor, upscale_factor: float,
                               tile_size: int = 512, padding: int = 10,
                               cancel_check: Callable[[], bool] | None = None
                               ) -> torch.Tensor:
    """Reference-parity tiled processing, one tile at a time.

    The JAX package's ``process_with_tiling_parity`` line for line, on
    tensors of the image's device: the <=256 px probe on the corner tile,
    int-truncated halo crop windows, a Lanczos resize on a size mismatch,
    the per-tile bicubic rung, and the uint8 canvas sized by the
    *configured* (not the actual) scale. An ordinary exception in the
    probe or a tile takes the bicubic rung, as there; cancellation
    (``cancel_check``, polled before each tile) and kernel or CUDA faults
    propagate.
    """
    h, w, c = (int(v) for v in image.shape)
    if h <= tile_size and w <= tile_size:
        return processor_func(image)

    num_tiles_h = math.ceil(h / tile_size)
    num_tiles_w = math.ceil(w / tile_size)
    out_h = int(h * upscale_factor)
    out_w = int(w * upscale_factor)
    output = torch.zeros((out_h, out_w, c), dtype=torch.uint8,
                         device=image.device)

    logger.info("Processing image in %dx%d tiles", num_tiles_h, num_tiles_w)

    # Probe on a corner tile; on failure, bicubic for all tiles.
    try:
        test_size = min(256, tile_size)
        processor_func(image[:test_size, :test_size])
        processor_works = True
        logger.info("Tile processor test successful")
    except Exception as exc:  # noqa: BLE001 - ladder rung
        if _propagates(exc):
            raise
        logger.warning("Tile processor test failed: %s", exc)
        processor_works = False
        logger.warning("Falling back to bicubic scaling for all tiles")

    def _bicubic(tile_img, dw, dh):
        return resize(tile_img, dsize=(dw, dh), interpolation="bicubic")

    for i in range(num_tiles_h):
        for j in range(num_tiles_w):
            if cancel_check is not None and cancel_check():
                raise TilingCancelled(f"cancelled at tile ({i},{j})")
            y_start = max(0, i * tile_size - padding)
            y_end = min(h, (i + 1) * tile_size + padding)
            x_start = max(0, j * tile_size - padding)
            x_end = min(w, (j + 1) * tile_size + padding)
            tile = image[y_start:y_end, x_start:x_end]

            try:
                if processor_works:
                    processed = processor_func(tile)
                else:
                    processed = _bicubic(
                        tile, int(tile.shape[1] * upscale_factor),
                        int(tile.shape[0] * upscale_factor))

                out_y_start = int(y_start * upscale_factor)
                out_y_end = int(y_end * upscale_factor)
                out_x_start = int(x_start * upscale_factor)
                out_x_end = int(x_end * upscale_factor)
                if padding > 0:
                    pad_up = int(padding * upscale_factor)
                    if y_start > 0:
                        out_y_start += pad_up
                    if y_end < h:
                        out_y_end -= pad_up
                    if x_start > 0:
                        out_x_start += pad_up
                    if x_end < w:
                        out_x_end -= pad_up

                t_h, t_w = int(processed.shape[0]), int(processed.shape[1])
                scale_y = t_h / tile.shape[0]
                scale_x = t_w / tile.shape[1]
                ty0 = 0 if y_start == 0 else int(padding * scale_y)
                ty1 = t_h if y_end == h else int(t_h - padding * scale_y)
                tx0 = 0 if x_start == 0 else int(padding * scale_x)
                tx1 = t_w if x_end == w else int(t_w - padding * scale_x)
                ty0 = max(0, min(ty0, t_h - 1))
                ty1 = max(ty0 + 1, min(ty1, t_h))
                tx0 = max(0, min(tx0, t_w - 1))
                tx1 = max(tx0 + 1, min(tx1, t_w))

                oh = out_y_end - out_y_start
                ow = out_x_end - out_x_start
                if oh <= 0 or ow <= 0:
                    logger.warning("Invalid output region for tile (%d,%d)",
                                   i, j)
                    continue
                region = processed[ty0:ty1, tx0:tx1]
                if region.shape[0] != oh or region.shape[1] != ow:
                    region = resize(region, dsize=(ow, oh),
                                    interpolation="lanczos4")
                output[out_y_start:out_y_end, out_x_start:out_x_end] = region

            except Exception as exc:  # noqa: BLE001 - per-tile ladder rung
                if _propagates(exc):
                    raise
                logger.warning("Error processing tile (%d,%d): %s", i, j, exc)
                bt = _bicubic(tile, int(tile.shape[1] * upscale_factor),
                              int(tile.shape[0] * upscale_factor))
                oy0 = int(i * tile_size * upscale_factor)
                oy1 = min(int(h * upscale_factor),
                          int((i + 1) * tile_size * upscale_factor))
                ox0 = int(j * tile_size * upscale_factor)
                ox1 = min(int(w * upscale_factor),
                          int((j + 1) * tile_size * upscale_factor))
                if oy1 > oy0 and ox1 > ox0:
                    if bt.shape[0] != oy1 - oy0 or bt.shape[1] != ox1 - ox0:
                        bt = _bicubic(bt, ox1 - ox0, oy1 - oy0)
                    output[oy0:oy1, ox0:ox1] = bt

    return output
