"""Where the model registry's weights live on disk.

The ``sd_upscaler`` and ``segmentation`` entries and ``get_model_path`` of
the JAX package's ``utils/downloader.py``, so that ``diffusion_model_path:
null`` and ``segmentation_model_path: null`` resolve to the same
directories. Nothing here downloads or creates a directory; a missing
snapshot disables its branch (``pipeline._load_models``).
Downloading is not ported yet (ROADMAP).
"""

from __future__ import annotations

import os
import sys

__all__ = ["MODELS", "get_models_dir", "get_model_path"]

MODELS = {
    "sd_upscaler": {
        "huggingface_id": "stabilityai/stable-diffusion-x4-upscaler"},
    "segmentation": {
        "huggingface_id": "nvidia/segformer-b0-finetuned-ade-512-512"},
}


def get_models_dir() -> str:
    """``NESR_MODELS_DIR`` if set, else the platform's default."""
    if "NESR_MODELS_DIR" in os.environ:
        return os.environ["NESR_MODELS_DIR"]
    if sys.platform == "win32":
        base_dir = os.path.join(os.environ.get("APPDATA", ""), "NESR")
    elif sys.platform == "darwin":
        base_dir = os.path.join(os.path.expanduser("~"), "Library",
                                "Application Support", "NESR")
    else:
        base_dir = os.path.join(os.path.expanduser("~"), ".nesr")
    return os.path.join(base_dir, "models")


def get_model_path(model_key: str) -> str:
    """A Hugging Face snapshot lives under its repo id's last part."""
    return os.path.join(get_models_dir(), "huggingface",
                        MODELS[model_key]["huggingface_id"].split("/")[-1])
