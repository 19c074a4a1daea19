"""Composite enhancement stages: NL-means denoise, CLAHE contrast, unsharp
mask, segmentation-masked and adaptive sharpening, ensemble.

Counterpart of ``neural_enhanced_super_resolution_tpu/ops/enhance.py``. The
local ops take batched (..., H, W, 3) uint8 tensors, so the streamed final
iteration sharpens a whole tile batch in one call. As in the JAX package,
large images run the local ops through the fixed-tile machinery (512-px
tiles, 16-px halo >= NL-means' 13-px reach, above a 768-px edge), which
gives the same pixels as the whole-image op; extra (H, W) planes such as a
segmentation mask ride along as channels.
"""

from __future__ import annotations

import functools

import torch

from neural_enhanced_super_resolution_torch.ops.blur import (dilate,
                                                             gaussian_blur,
                                                             saturate_like)
from neural_enhanced_super_resolution_torch.ops.clahe import clahe
from neural_enhanced_super_resolution_torch.ops.color import (
    lab_to_rgb, rgb_to_gray, rgb_to_lab)
from neural_enhanced_super_resolution_torch.ops.nlmeans import (
    nl_means_colored)
from neural_enhanced_super_resolution_torch.ops.pointwise import (
    add_weighted, convert_scale_abs, subtract, threshold_binary)
from neural_enhanced_super_resolution_torch.ops.resize import resize

__all__ = ["denoise_stage", "contrast_stage", "preprocess", "unsharp_mask",
           "masked_sharpen", "adaptive_sharpen", "adaptive_sharpen_batch",
           "ensemble"]

_TILED_THRESHOLD = 768  # route local ops through fixed tiles above this edge
_OP_TILE = 512
_OP_HALO = 16


def _tiled_unit_op(fn, img: torch.Tensor, *planes: torch.Tensor,
                   batch_tiles: int = 32) -> torch.Tensor:
    """Run a local batched op fn(img (B, H, W, C), *planes (B, H, W)) ->
    (B, H, W, C) on an (H, W, C) image and its (H, W) planes, through the
    fixed-tile path when the image is large (the planes are packed as
    channels of the image's dtype, so each tile carries its own crop)."""
    if max(int(img.shape[0]), int(img.shape[1])) <= _TILED_THRESHOLD:
        return fn(img[None], *(p[None] for p in planes))[0]
    from neural_enhanced_super_resolution_torch.parallel.tiling import (
        process_tiled)
    c = int(img.shape[-1])
    packed = torch.cat([img] + [p[:, :, None].to(img.dtype) for p in planes],
                       dim=-1)

    def tile_fn(tiles):
        return fn(tiles[..., :c], *(tiles[..., c + i]
                                    for i in range(len(planes))))

    return process_tiled(tile_fn, packed, tile_size=_OP_TILE, halo=_OP_HALO,
                         scale=1, batch_tiles=batch_tiles)


def denoise_stage(img: torch.Tensor, denoise_level: float = 0.5,
                  max_megapixels: float | None = None) -> torch.Tensor:
    """NL-means (h = h_color = 10 * level, 7x7 template, 21x21 search) on
    an (H, W, 3) uint8 image.

    Above ``max_megapixels`` (None = off) NL-means runs on an area-average
    shrink by a power of two (at most 8) and the noise residual is carried
    back: out = img - up_bilinear(small - nl_means(small))."""
    strength = float(denoise_level) * 10.0
    fn = functools.partial(nl_means_colored, h=strength, h_color=strength,
                           template=7, search=21)
    h, w = int(img.shape[0]), int(img.shape[1])
    mp = h * w / 1e6
    if max_megapixels is None or mp <= float(max_megapixels):
        return _tiled_unit_op(fn, img)
    factor = 2
    while mp / (factor * factor) > float(max_megapixels) and factor < 8:
        factor *= 2
    small = resize(img, dsize=(w // factor, h // factor),
                   interpolation="area")
    return _denoise_residual_apply(img, small, _tiled_unit_op(fn, small))


def _denoise_residual_apply(img: torch.Tensor, small: torch.Tensor,
                            den_small: torch.Tensor) -> torch.Tensor:
    resid = small.float() - den_small.float()
    h, w = int(img.shape[0]), int(img.shape[1])
    resid_up = resize(resid, dsize=(w, h), interpolation="bilinear")
    return saturate_like(img.float() - resid_up, img.dtype)


def contrast_stage(img: torch.Tensor) -> torch.Tensor:
    """RGB -> Lab -> CLAHE(2.0, 8x8) on L -> RGB (uint8 (H, W, 3))."""
    lab = rgb_to_lab(img)
    l_eq = clahe(lab[:, :, 0].contiguous(), clip_limit=2.0,
                 tile_grid_size=(8, 8))
    return lab_to_rgb(torch.cat([l_eq[:, :, None], lab[:, :, 1:]], dim=-1))


def preprocess(img: torch.Tensor, denoise_level: float = 0.5
               ) -> torch.Tensor:
    """NL-means denoise (h = 10 * level) when the level is above 0, then
    CLAHE(2.0, 8x8) on Lab L: the pipeline's preprocessing as one call, on
    an (H, W, 3) uint8 image."""
    if denoise_level > 0:
        img = denoise_stage(img, denoise_level)
    return contrast_stage(img)


def unsharp_mask(img: torch.Tensor) -> torch.Tensor:
    """addWeighted(img, 1.5, GaussianBlur(img, 0, 3), -0.5, 0)."""
    return add_weighted(img, 1.5, gaussian_blur(img, (0, 0), 3.0), -0.5, 0.0)


def _masked_sharpen_batch(img: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    mask = dilate(mask[..., None], 3, 1)
    return torch.where(mask == 1, unsharp_mask(img), img)


def masked_sharpen(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Segmentation-guided sharpening of an (H, W, 3) uint8 image: the
    (H, W) uint8 object mask is dilated 3x3 once, and the unsharp-masked
    pixel replaces the input where it is 1 (tiled when large)."""
    return _tiled_unit_op(_masked_sharpen_batch, img, mask)


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
