"""Degradations and comparison images: the JAX package's
``utils/image_utils.py`` on the port's own ops.

The same names, arguments and semantics: ``add_noise``, ``blur_image``,
``downsample_image``, ``apply_jpeg_compression``,
``create_comparison_image`` and ``add_text_to_image``. Blur and resize run
``ops/blur.py`` and ``ops/resize.py`` (OpenCV's rounding) on the image's
device (a numpy image on the CPU); JPEG and text go through PIL. Images
are (H, W, 3) uint8, numpy arrays or tensors, and come back as numpy
arrays. Noise draws from an explicit ``torch.Generator`` or seed.
"""

from __future__ import annotations

import io

import numpy as np
import torch
from PIL import Image, ImageDraw

from neural_enhanced_super_resolution_torch.ops.blur import (box_blur,
                                                             filter2d,
                                                             gaussian_blur)
from neural_enhanced_super_resolution_torch.ops.resize import resize
from neural_enhanced_super_resolution_torch.runtime.device import (
    device_fetch)

__all__ = ["add_noise", "blur_image", "downsample_image",
           "apply_jpeg_compression", "create_comparison_image",
           "add_text_to_image"]


def _generator(generator: torch.Generator | int | None,
               device: torch.device) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    gen = torch.Generator(device)
    if generator is None:
        gen.seed()
    else:
        gen.manual_seed(int(generator))
    return gen


def add_noise(image, noise_type: str = "gaussian", amount: float = 0.1,
              generator: torch.Generator | int | None = None) -> np.ndarray:
    """Gaussian (sigma amount*255), salt & pepper (a share ``amount`` of
    the values, half each), speckle (x + x*N(0, amount)) or Poisson
    (scaling amount*10) noise, clipped to uint8. ``generator``: a
    ``torch.Generator`` on the image's device, a seed, or None for a fresh
    seed."""
    img = torch.as_tensor(image)
    if amount <= 0:
        return device_fetch(img).copy()
    gen = _generator(generator, img.device)
    h, w = int(img.shape[0]), int(img.shape[1])
    result = img.float().clone()

    def normal(std):
        return torch.randn(img.shape, generator=gen, device=img.device) * std

    if noise_type == "gaussian":
        result += normal(amount * 255.0)
    elif noise_type in ("salt & pepper", "salt_pepper"):
        s_vs_p = 0.5
        for count, value in ((int(np.ceil(amount * img.numel() * s_vs_p)),
                              255.0),
                             (int(np.ceil(amount * img.numel()
                                          * (1.0 - s_vs_p))), 0.0)):
            ys = torch.randint(0, h - 1, (count,), generator=gen,
                               device=img.device)
            xs = torch.randint(0, w - 1, (count,), generator=gen,
                               device=img.device)
            result[ys, xs, :] = value
    elif noise_type == "speckle":
        result += result * normal(amount)
    elif noise_type == "poisson":
        scaling = amount * 10.0
        result = torch.poisson(img.float() / 255.0 * scaling,
                               generator=gen) / scaling * 255.0
    return device_fetch(torch.clamp(result, 0, 255).to(torch.uint8))


def blur_image(image, blur_type: str = "gaussian",
               radius: int = 3) -> np.ndarray:
    """Gaussian, box or horizontal motion blur of size 2*radius+1."""
    img = torch.as_tensor(image)
    if radius <= 0:
        return device_fetch(img).copy()
    k = radius * 2 + 1
    if blur_type == "box":
        return device_fetch(box_blur(img, (k, k)))
    if blur_type == "motion":
        kernel = np.zeros((k, k), np.float32)
        kernel[(k - 1) // 2, :] = 1.0
        kernel /= k
        return device_fetch(filter2d(img, kernel))
    return device_fetch(gaussian_blur(img, (k, k), 0.0))


def downsample_image(image, scale_factor: float = 0.5,
                     interpolation: str = "bicubic") -> np.ndarray:
    """Downsample by ``scale_factor`` (< 1) with nearest, bilinear,
    bicubic or lanczos interpolation."""
    img = torch.as_tensor(image)
    if scale_factor >= 1.0:
        return device_fetch(img).copy()
    h, w = int(img.shape[0]), int(img.shape[1])
    new_w, new_h = int(w * scale_factor), int(h * scale_factor)
    mode = {"nearest": "nearest", "bilinear": "bilinear",
            "bicubic": "bicubic", "lanczos": "lanczos4"}.get(
                interpolation.lower(), "bicubic")
    return device_fetch(resize(img, dsize=(new_w, new_h), interpolation=mode))


def apply_jpeg_compression(image, quality: int = 75) -> np.ndarray:
    """Round trip through an in-memory JPEG encode at ``quality``."""
    buf = io.BytesIO()
    Image.fromarray(device_fetch(torch.as_tensor(image))).save(
        buf, format="JPEG", quality=quality)
    buf.seek(0)
    return np.array(Image.open(buf))


def create_comparison_image(original, enhanced,
                            orientation: str = "horizontal") -> np.ndarray:
    """``original`` and ``enhanced`` side by side (or stacked), the
    enhanced one Lanczos-resized to the original's height (width), a red
    one-pixel divider between them."""
    original = device_fetch(torch.as_tensor(original))
    enhanced_t = torch.as_tensor(enhanced)
    oh, ow = original.shape[:2]
    eh, ew = int(enhanced_t.shape[0]), int(enhanced_t.shape[1])
    horizontal = orientation.lower() == "horizontal"
    if horizontal and oh != eh:
        scale = oh / eh
        enhanced_t = resize(enhanced_t, dsize=(int(ew * scale), oh),
                            interpolation="lanczos4")
    elif not horizontal and ow != ew:
        scale = ow / ew
        enhanced_t = resize(enhanced_t, dsize=(ow, int(eh * scale)),
                            interpolation="lanczos4")
    enhanced = device_fetch(enhanced_t)
    if horizontal:
        comparison = np.hstack((original, enhanced))
        comparison[:, ow:ow + 1, :] = [255, 0, 0]
    else:
        comparison = np.vstack((original, enhanced))
        comparison[oh:oh + 1, :, :] = [255, 0, 0]
    return comparison


def add_text_to_image(image, text: str, position="top",
                      font_scale: float = 1.0,
                      color=(255, 255, 255)) -> np.ndarray:
    """``text`` on a black box, centred at the top or bottom, or at an
    (x, y) position (PIL's default font; ``font_scale`` is accepted for
    the API and unused, as in the JAX package)."""
    image = device_fetch(torch.as_tensor(image))
    result = Image.fromarray(image.copy())
    draw = ImageDraw.Draw(result)
    bbox = draw.textbbox((0, 0), text)
    tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
    if position == "top":
        x, y = int((image.shape[1] - tw) / 2), th + 10
    elif position == "bottom":
        x, y = int((image.shape[1] - tw) / 2), image.shape[0] - 10 - th
    else:
        x, y = position
    draw.rectangle((x - 5, y - 5, x + tw + 5, y + th + 5), fill=(0, 0, 0))
    draw.text((x, y), text, fill=tuple(color))
    return np.asarray(result)
