"""The GUI's toolkit-free controller (view-model layer).

Counterpart of the JAX package's ``gui/controller.py``, with the same
names and behaviour, on the port's ``utils/image_utils``, downloader and
pipeline. Everything behind the PyQt5 view lives here, so it is tested
without a display:

  * the degradation preview / apply / reset state
  * the enhancement presets
  * the settings of the Enhancement and Advanced tabs, as a pipeline config
  * background workers with progress, image, finish and error events
    (``EnhancementWorker``, ``ModelDownloadWorker``), the progress events
    throttled to one per 0.5 s, with cooperative cancellation
  * the model availability check
  * the image viewer's zoom, view composition and split-divider math

``gui/app.py`` binds these to widgets when PyQt5 is installed.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

logger = logging.getLogger("nesr.gui")

__all__ = ["DegradationState", "EnhancementSettingsState", "PRESETS",
           "EnhancementWorker", "ModelDownloadWorker", "check_model_status"]


# ---------------------------------------------------------------- presets ---

PRESETS = {
    # The JAX package's four presets, the same values (denoise_level is
    # the 0-10 slider / 10, as the pipeline takes it).
    "Default": {"iterations": 3, "upscale_factor": 2.0, "use_esrgan": True,
                "use_diffusion": True, "segment_enhancement": True,
                "prompt": "a high resolution detailed photograph",
                "denoise_level": 0.5, "adaptive_sharpening": True},
    "High Quality": {"iterations": 3, "upscale_factor": 2.0,
                     "use_esrgan": True, "use_diffusion": True,
                     "segment_enhancement": True,
                     "prompt": "a highly detailed professional photograph",
                     "denoise_level": 0.3, "adaptive_sharpening": True},
    "Fast": {"iterations": 2, "upscale_factor": 2.0, "use_esrgan": True,
             "use_diffusion": False, "segment_enhancement": False,
             "prompt": "", "denoise_level": 0.5,
             "adaptive_sharpening": True},
    # the accelerator preset, under the name the JAX package keeps
    "Apple Silicon Optimized": {"iterations": 2, "upscale_factor": 2.0,
                                "use_esrgan": True, "use_diffusion": True,
                                "segment_enhancement": False,
                                "prompt": "a detailed photograph",
                                "denoise_level": 0.5,
                                "adaptive_sharpening": True},
}


@dataclass
class EnhancementSettingsState:
    """The settings the Enhancement and Advanced tabs hold."""
    iterations: int = 3
    upscale_factor: float = 2.0
    use_esrgan: bool = True
    use_diffusion: bool = True
    # the SwinIR branch (models/swinir.py), off by default as in the config
    use_swinir: bool = False
    segment_enhancement: bool = True
    denoise_level: float = 0.5
    adaptive_sharpening: bool = True
    prompt: str = ""
    # advanced
    force_3channel: bool = False
    max_tile_size: int = 512
    enable_tiling: bool = True
    device: str = "auto"
    output_dir: str = "outputs"
    intermediate_saves: bool = False

    def apply_preset(self, name: str) -> None:
        for key, value in PRESETS[name].items():
            setattr(self, key, value)

    def to_config(self) -> dict:
        return {
            "iterations": self.iterations,
            "upscale_factor": self.upscale_factor,
            "use_esrgan": self.use_esrgan,
            "use_diffusion": self.use_diffusion,
            "use_swinir": self.use_swinir,
            "segment_enhancement": self.segment_enhancement,
            "denoise_level": self.denoise_level,
            "adaptive_sharpening": self.adaptive_sharpening,
            "force_3channel": self.force_3channel,
            "max_tile_size": self.max_tile_size,
            "enable_tiling": self.enable_tiling,
            "output_dir": self.output_dir,
            "intermediate_saves": self.intermediate_saves,
        }


# ------------------------------------------------------------ degradation ---

@dataclass
class DegradationState:
    """The Degradation tab's state: load an original, preview a degraded
    version, apply it as the working image, reset."""
    original: np.ndarray | None = None
    degraded: np.ndarray | None = None

    def load(self, image: np.ndarray) -> None:
        self.original = np.asarray(image)
        self.degraded = None

    def preview(self, downscale: float = 1.0, noise_type: str = "gaussian",
                noise_amount: float = 0.0, blur_type: str = "gaussian",
                blur_radius: int = 0, jpeg_quality: int = 100,
                generator=None) -> np.ndarray:
        """Apply the degradation chain in the JAX package's order:
        downsample -> noise -> blur -> jpeg. ``generator`` (a
        ``torch.Generator`` or a seed) draws the noise."""
        if self.original is None:
            raise ValueError("no image loaded")
        from neural_enhanced_super_resolution_torch.utils.image_utils import (
            add_noise, apply_jpeg_compression, blur_image, downsample_image)
        img = self.original
        if downscale < 1.0:
            img = downsample_image(img, downscale)
        if noise_amount > 0:
            img = add_noise(img, noise_type, noise_amount,
                            generator=generator)
        if blur_radius > 0:
            img = blur_image(img, blur_type, blur_radius)
        if jpeg_quality < 100:
            img = apply_jpeg_compression(img, jpeg_quality)
        self.degraded = np.asarray(img)
        return self.degraded

    def apply(self) -> np.ndarray:
        if self.degraded is None:
            raise ValueError("no degraded preview to apply")
        return self.degraded

    def reset(self) -> np.ndarray:
        if self.original is None:
            raise ValueError("no image loaded")
        self.degraded = None
        return self.original


# ---------------------------------------------------------------- workers ---

class EnhancementWorker:
    """Background enhancement thread.

    Events are plain callables (the Qt view connects them to signals):
    on_progress(stage, iter, total, msg), throttled to one per 0.5 s;
    on_image(np_image); on_finished(path); on_error(msg). Cancellation is
    cooperative through .stop(): the progress callback raises, and the
    pipeline's ``cancel_check`` stops a tile sweep at its next chunk.
    """

    PROGRESS_THROTTLE_S = 0.5

    def __init__(self, pipeline, image_path: str, prompt: str | None = None,
                 on_progress: Callable = None, on_image: Callable = None,
                 on_finished: Callable = None, on_error: Callable = None):
        self.pipeline = pipeline
        self.image_path = image_path
        self.prompt = prompt
        self.on_progress = on_progress
        self.on_image = on_image
        self.on_finished = on_finished
        self.on_error = on_error
        self.running = False
        self._last_emit = 0.0
        self._thread: threading.Thread | None = None

    def _progress(self, stage, iteration, total, message):
        if not self.running:
            raise _Cancelled()
        now = time.monotonic()
        if (now - self._last_emit >= self.PROGRESS_THROTTLE_S
                or stage in ("Complete", "Enhancement")):
            self._last_emit = now
            if self.on_progress:
                self.on_progress(stage, iteration, total, message)

    def _run(self):
        from neural_enhanced_super_resolution_torch.pipeline import (
            EnhancementCancelled)
        try:
            self.pipeline.config["progress_callback"] = self._progress
            # Mid-stage cancellation: the pipeline polls this between tile
            # chunks (parallel/tiling) and iterations, so stop() interrupts
            # a long tile sweep at the next chunk boundary.
            self.pipeline.config["cancel_check"] = lambda: not self.running
            if self.on_image:
                self.pipeline.config["image_callback"] = self.on_image
            path = self.pipeline.enhance_image(self.image_path, self.prompt)
            if self.running and self.on_finished:
                self.on_finished(path)
        except (_Cancelled, EnhancementCancelled):
            logger.info("Enhancement cancelled")
        except Exception as exc:  # noqa: BLE001 - surfaced to the UI
            logger.error("Enhancement failed: %s", exc)
            if self.on_error:
                self.on_error(str(exc))
        finally:
            self.running = False

    def start(self):
        self.running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self.running = False

    def join(self, timeout=None):
        if self._thread:
            self._thread.join(timeout)


class _Cancelled(Exception):
    pass


class ModelDownloadWorker:
    """Background model download (``utils/downloader.download_models``)."""

    def __init__(self, model_keys=None, on_progress: Callable = None,
                 on_finished: Callable = None, on_error: Callable = None):
        self.model_keys = model_keys
        self.on_progress = on_progress
        self.on_finished = on_finished
        self.on_error = on_error
        self._thread: threading.Thread | None = None

    def _run(self):
        try:
            from neural_enhanced_super_resolution_torch.utils.downloader import (
                download_models)
            results = download_models(self.model_keys, self.on_progress)
            if self.on_finished:
                self.on_finished(results)
        except Exception as exc:  # noqa: BLE001
            if self.on_error:
                self.on_error(str(exc))

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def join(self, timeout=None):
        if self._thread:
            self._thread.join(timeout)


def check_model_status() -> dict:
    """Model availability for the check-on-start dialog."""
    from neural_enhanced_super_resolution_torch.utils.downloader import (
        check_models_exist, get_model_info)
    info = get_model_info()
    existing = check_models_exist()
    missing_required = [k for k, v in info.items()
                        if v["required"] and not existing.get(k)]
    return {"info": info, "missing_required": missing_required}


# ----------------------------------------------------------- view logic ----
# The image viewer's zoom/fit math and view composition, testable without
# Qt; gui/app.py's ImageViewer is a thin shell over these.

VIEW_MODES = ("side-by-side", "split", "before", "after")
ZOOM_MIN, ZOOM_MAX = 0.1, 4.0  # 10-400%


def fit_zoom(image_hw: tuple, viewport_hw: tuple) -> float:
    """Zoom factor that fits the image inside the viewport, clamped to
    10-400%."""
    ih, iw = image_hw
    vh, vw = viewport_hw
    if ih <= 0 or iw <= 0:
        return 1.0
    z = min(vh / ih, vw / iw)
    return float(min(ZOOM_MAX, max(ZOOM_MIN, z)))


def compose_view(before, after, mode: str = "side-by-side",
                 split_pos: float = 0.5):
    """Compose the displayed array for a view mode.

    split: before pixels left of the (draggable) divider, after pixels right
    of it, a 3-px red divider at ``split_pos`` (0..1). after is resized to
    before's geometry first so columns align.
    """
    from neural_enhanced_super_resolution_torch.utils.image_utils import (
        create_comparison_image)

    if before is None and after is None:
        return None
    if after is None or mode == "before":
        return np.asarray(before)
    if before is None or mode == "after":
        return np.asarray(after)
    if mode == "split":
        before = np.asarray(before)
        after = np.asarray(after)
        h, w = before.shape[:2]
        if after.shape[:2] != (h, w):
            after = _resize_like(after, (w, h))
        split_pos = min(1.0, max(0.0, float(split_pos)))
        x = int(round(split_pos * (w - 1)))
        out = after.copy()
        out[:, :x] = before[:, :x]
        lo, hi = max(0, x - 1), min(w, x + 2)
        out[:, lo:hi] = (255, 0, 0)
        return out
    return create_comparison_image(np.asarray(before), np.asarray(after),
                                   "horizontal")


def _resize_like(img, dsize):
    import torch

    from neural_enhanced_super_resolution_torch.ops.resize import resize
    return resize(torch.from_numpy(np.ascontiguousarray(img)), dsize=dsize,
                  interpolation="lanczos4").numpy()


def drag_split_position(x_px: int, width_px: int) -> float:
    """Mouse x within the view -> divider position (0..1)."""
    if width_px <= 1:
        return 0.5
    return min(1.0, max(0.0, x_px / (width_px - 1)))
