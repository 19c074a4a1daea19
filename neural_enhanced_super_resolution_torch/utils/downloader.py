"""Where the model registry's weights live on disk.

The ``swinir``, ``sd_upscaler`` and ``segmentation`` entries and
``get_model_path`` of the JAX package's ``utils/downloader.py``, so that
``swinir_model_path: null``, ``diffusion_model_path: null`` and
``segmentation_model_path: null`` resolve to the same files. Nothing here
downloads or creates a directory; missing weights disable their branch
(``pipeline._load_models``).
Downloading is not ported yet (ROADMAP).
"""

from __future__ import annotations

import os
import sys

__all__ = ["MODELS", "get_models_dir", "get_model_path"]

MODELS = {
    "swinir": {
        # the published real-world SwinIR-M x4 GAN checkpoint
        # (JingyunLiang/SwinIR release v0.0,
        # 003_realSR_BSRGAN_DFO_s64w8_SwinIR-M_x4_GAN.pth)
        "path": "weights/SwinIR_realSR_M_x4_GAN.pth"},
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
    """A file entry lives at its ``path`` under the models directory, a
    Hugging Face snapshot under its repo id's last part."""
    info = MODELS[model_key]
    if info.get("path"):
        return os.path.join(get_models_dir(), info["path"])
    return os.path.join(get_models_dir(), "huggingface",
                        info["huggingface_id"].split("/")[-1])
