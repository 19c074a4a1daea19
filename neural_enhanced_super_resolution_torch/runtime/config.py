"""Pipeline configuration: the JAX package's keys and defaults, a ``cuda``
overlay, and a guard for the features this port does not carry yet.

``default_config`` has the same keys and defaults as
``neural_enhanced_super_resolution_tpu/runtime/config.py`` so JSON configs
written for it work unchanged. The ``cuda`` overlay takes the tile geometry
of that package's ``tpu`` overlay (tile above 8 MP, 256-px tiles, 6-px halo,
16 tiles per batch), so both packages tile an image identically, and its
diffusion cap (``diffusion_max_megapixels`` 0.27, just above a 512x512
input: attention grows with the square of the latent area, and the canvas
grows 4x per iteration); it does not take that overlay's remote-host
workarounds (``tile_tail: "full"``, ``prewarm``, ``fallback_to_cpu``).

``merge_config`` raises ``ValueError`` for a feature that is not ported yet
(parity tiling, the int8 trunk), naming the ROADMAP item that will bring
it, instead of turning it off. Segmentation and NL-means denoise, which the
defaults turn on, and the SwinIR branch (``use_swinir``) are ported: the
JAX package's default config runs here unchanged.
"""

from __future__ import annotations

from typing import Any

__all__ = ["default_config", "merge_config"]


def default_config() -> dict[str, Any]:
    return {
        "iterations": 3,
        "use_diffusion": True,
        "use_esrgan": True,
        "use_swinir": False,
        "preserve_details": True,
        "adaptive_sharpening": True,
        "segment_enhancement": True,
        "denoise_level": 0.5,
        "upscale_factor": 2,
        "intermediate_saves": False,
        "output_dir": "outputs",
        "progress_callback": None,
        "image_callback": None,
        "force_3channel": False,
        "max_tile_size": 512,
        "enable_tiling": True,
        "memory_efficient": False,
        "device_specific": {
            "cuda": {
                "max_megapixels": 8,
                "max_tile_size": 256,
                "tile_halo": 6,
                "tile_batch": 16,
                "half_precision": True,
                "diffusion_max_megapixels": 0.27,
            },
            "cpu": {
                "max_megapixels": 2,
            },
        },
        "precision": None,            # None -> per-device default
        "parity_tiling": False,
        "stage_overlap": True,
        "data_parallel": "auto",
        "shard_strategy": "tiles",
        "tile_batch": 16,
        "tile_halo": 16,
        "esrgan_model_path": None,
        "esrgan_arch": None,
        # RRDB trunk: None / "xla" = the source-major fused trunk, its five
        # convs per RDB through K1; "dform" = one K2 launch per RDB (bf16).
        "esrgan_trunk": None,
        "swinir_model_path": None,
        "swinir_tile_batch": 1,
        "diffusion_model_path": None,
        "segmentation_model_path": None,
        # Accepted for config compatibility and ignored: a partial chunk of
        # tiles runs at its own size (no padding to a compiled shape).
        "tile_tail": "bucket",
        "streamed_output": True,
        "denoise_max_megapixels": None,
        "diffusion_max_megapixels": None,
        "sd_stage_detail": False,
        "num_inference_steps": None,
        "sd_cfg_split": None,
        "sd_cfg_shard": False,
    }


# (predicate on the merged config, what is missing, where ROADMAP queues it)
_NOT_PORTED = (
    (lambda c: c.get("parity_tiling"), "parity_tiling",
     "queue 1, parity tiling"),
    (lambda c: c.get("esrgan_trunk") in ("int8", "s2d"),
     "esrgan_trunk int8/s2d", "queue 1, the int8 trunk (s2d is a TPU "
     "layout and folds into K1)"),
)


def merge_config(device: str, user_config: dict | None) -> dict[str, Any]:
    """defaults <- user config <- device-specific overlay (user keys win).

    Raises ValueError for a feature this port does not carry yet."""
    cfg = default_config()
    user_config = user_config or {}
    cfg.update(user_config)
    overlay = cfg["device_specific"].get(device, {})
    for key, value in overlay.items():
        if key not in user_config:
            cfg[key] = value
    for pred, what, where in _NOT_PORTED:
        if pred(cfg):
            raise ValueError(f"{what} is not ported to the PyTorch package "
                             f"yet (ROADMAP: {where}); set it off in the "
                             "config")
    if cfg.get("esrgan_trunk") not in (None, "xla", "dform"):
        raise ValueError(f"unknown esrgan_trunk {cfg['esrgan_trunk']!r}")
    return cfg

