"""Composite enhancement stages: CLAHE contrast, unsharp mask, adaptive
sharpen, ensemble.

Counterpart of ``neural_enhanced_super_resolution_tpu/ops/enhance.py``
(``denoise_stage`` / NL-means is not ported yet). The local ops take batched
(..., H, W, 3) uint8 tensors, so the streamed final iteration sharpens a
whole tile batch in one call. As in the JAX package, large images run the
local ops through the fixed-tile machinery (512-px tiles, 16-px halo, above
a 768-px edge), which gives the same pixels as the whole-image op.
"""

from __future__ import annotations

import torch

from neural_enhanced_super_resolution_torch.ops.blur import gaussian_blur
from neural_enhanced_super_resolution_torch.ops.clahe import clahe
from neural_enhanced_super_resolution_torch.ops.color import (
    lab_to_rgb, rgb_to_gray, rgb_to_lab)
from neural_enhanced_super_resolution_torch.ops.pointwise import (
    add_weighted, convert_scale_abs, subtract, threshold_binary)
from neural_enhanced_super_resolution_torch.ops.resize import resize

__all__ = ["contrast_stage", "unsharp_mask", "adaptive_sharpen",
           "adaptive_sharpen_batch", "ensemble"]

_TILED_THRESHOLD = 768  # route local ops through fixed tiles above this edge
_OP_TILE = 512
_OP_HALO = 16


def _tiled_unit_op(fn, img: torch.Tensor, batch_tiles: int = 32
                   ) -> torch.Tensor:
    """Run a local batched (B, H, W, C) -> (B, H, W, C) op on an (H, W, C)
    image, through the fixed-tile path when the image is large."""
    if max(int(img.shape[0]), int(img.shape[1])) <= _TILED_THRESHOLD:
        return fn(img[None])[0]
    from neural_enhanced_super_resolution_torch.parallel.tiling import (
        process_tiled)
    return process_tiled(fn, img, tile_size=_OP_TILE, halo=_OP_HALO, scale=1,
                         batch_tiles=batch_tiles)


def contrast_stage(img: torch.Tensor) -> torch.Tensor:
    """RGB -> Lab -> CLAHE(2.0, 8x8) on L -> RGB (uint8 (H, W, 3))."""
    lab = rgb_to_lab(img)
    l_eq = clahe(lab[:, :, 0].contiguous(), clip_limit=2.0,
                 tile_grid_size=(8, 8))
    return lab_to_rgb(torch.cat([l_eq[:, :, None], lab[:, :, 1:]], dim=-1))


def unsharp_mask(img: torch.Tensor) -> torch.Tensor:
    """addWeighted(img, 1.5, GaussianBlur(img, 0, 3), -0.5, 0)."""
    return add_weighted(img, 1.5, gaussian_blur(img, (0, 0), 3.0), -0.5, 0.0)


def adaptive_sharpen_batch(img: torch.Tensor) -> torch.Tensor:
    """Detail-masked unsharp mask on (..., H, W, 3) uint8.

    detail = |gray - blur(gray, sigma=2)| thresholded at 10; the output is
    the unsharp-masked pixel where detail is set, the input elsewhere."""
    gray = rgb_to_gray(img)
    low = gaussian_blur(gray[..., None], (0, 0), 2.0)[..., 0]
    variance = convert_scale_abs(subtract(gray, low))
    alpha = threshold_binary(variance, 10.0, 255.0)
    return torch.where(alpha[..., None] > 0, unsharp_mask(img), img)


def adaptive_sharpen(img: torch.Tensor) -> torch.Tensor:
    """adaptive_sharpen_batch on one (H, W, 3) image (tiled when large)."""
    return _tiled_unit_op(adaptive_sharpen_batch, img)


def ensemble(images: list[torch.Tensor]) -> torch.Tensor:
    """Uniform-weight ensemble: align to the lexicographic max (h, w) with
    Lanczos-4, average in fp32, truncate to uint8."""
    if len(images) == 1:
        return images[0]
    target_h, target_w = max((int(im.shape[0]), int(im.shape[1]))
                             for im in images)
    acc = None
    for im in images:
        if im.shape[0] != target_h or im.shape[1] != target_w:
            im = resize(im, dsize=(target_w, target_h),
                        interpolation="lanczos4")
        term = im.float() * (1.0 / len(images))
        acc = term if acc is None else acc + term
    return acc.to(torch.uint8)
