"""Device and precision policy.

Counterpart of ``neural_enhanced_super_resolution_tpu/runtime/device.py``,
with one deliberate difference: nothing falls back to the CPU. ``auto`` and
``cuda`` both mean the GPU and raise when none is present; the CPU runs
only when ``cpu`` is asked for.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["determine_device", "default_compute_dtype", "device_fetch",
           "torch_dtype", "visible_devices"]


def determine_device(requested: str = "auto") -> str:
    """Resolve a requested device to 'cuda' or 'cpu'.

    auto, cuda or gpu -> cuda, and RuntimeError when no GPU is visible;
    cpu -> cpu; anything else raises ValueError.
    """
    requested = (requested or "auto").lower()
    if requested == "cpu":
        return "cpu"
    if requested in ("auto", "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {requested!r} requested but no CUDA "
                               "GPU is available")
        return "cuda"
    raise ValueError(f"unknown device {requested!r} (auto, cuda or cpu)")


def visible_devices(device: str) -> list[torch.device]:
    """Every device a request on ``device`` may spread over: each visible
    GPU (``cuda:0`` ... ``cuda:n-1``) for ``cuda``, the one CPU for
    ``cpu``. What ``jax.devices()`` is to the JAX pipeline, and the only
    place the multi-device layout learns the device count."""
    if device == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device)]


def default_compute_dtype(device: str) -> str:
    """bf16 on the GPU (tensor-core native), f32 on the CPU (parity)."""
    return "bfloat16" if device == "cuda" else "float32"


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def device_fetch(x) -> np.ndarray:
    """Device -> host copy as a numpy array (numpy input passes through)."""
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()
