"""Host-side image IO (PIL-backed), a copy of the JAX package's
``utils/io.py``. Images are RGB uint8 (H, W, 3) numpy arrays."""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

__all__ = ["imread_rgb", "imwrite_rgb"]


def imread_rgb(path: str) -> np.ndarray:
    """Load an image as RGB uint8 (H, W, 3). Raises ValueError like the
    reference (_load_image, nesr.py:663-665) if unreadable."""
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except Exception as exc:
        raise ValueError(f"Could not load image: {path}") from exc


def imwrite_rgb(path: str, image: np.ndarray) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(np.asarray(image, dtype=np.uint8)).save(path)
    return path
