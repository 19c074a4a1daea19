"""Pipeline configuration: the JAX package's keys and defaults and a
``cuda`` overlay.

``default_config`` has the same keys and defaults as
``neural_enhanced_super_resolution_tpu/runtime/config.py`` so JSON configs
written for it work unchanged. The ``cuda`` overlay takes the tile geometry
of that package's ``tpu`` overlay (tile above 8 MP, 256-px tiles, 6-px halo,
16 tiles per batch), so both packages tile an image identically, and its
diffusion cap (``diffusion_max_megapixels`` 0.27, just above a 512x512
input: attention grows with the square of the latent area, and the canvas
grows 4x per iteration); it does not take that overlay's remote-host
workarounds (``tile_tail: "full"``, ``prewarm``, ``fallback_to_cpu``).

Every key of the JAX package is carried: segmentation and NL-means
denoise, which the defaults turn on, the SwinIR branch (``use_swinir``),
the int8 trunk (``esrgan_trunk: "int8"``), the reference-exact per-tile
stitch (``parity_tiling``) and the multi-device keys (``data_parallel``,
``shard_strategy``, ``stage_overlap``, ``sd_cfg_shard``); the JAX
package's default config runs here unchanged. ``merge_config`` raises ``ValueError``
only for an ``esrgan_trunk`` that neither package knows.
"""

from __future__ import annotations

import copy
from typing import Any

__all__ = ["default_config", "merge_config", "snapshot", "ESRGAN_TRUNKS"]

# esrgan_trunk values: None / "xla" / "s2d" = the fused trunk ("s2d" is the
# JAX package's rows-s2d TPU layout, which its pipeline never selects: it
# runs the fused trunk for it, and so does this one); "dform" = K2;
# "int8" = the int8 trunk on K4.
ESRGAN_TRUNKS = (None, "xla", "s2d", "dform", "int8")


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
        # Stage overlap: leave ESRGAN's work in flight while the diffusion
        # branch is dispatched (on its own device when the layout splits
        # the devices; parallel/overlap.py).
        "stage_overlap": True,
        # Multi-device execution from the product entry points: "auto"
        # shards the ESRGAN (and SwinIR) tile batch over every visible
        # device (and, with use_diffusion + stage_overlap, keeps the last
        # quarter of them for the denoise loop; pipeline._parallel_layout).
        # "off" (or 0/1) forces one device; an int caps the device count.
        # One-GPU hosts are unaffected.
        "data_parallel": "auto",
        # Multi-device sharding strategy for the upscale branches: "tiles"
        # (default) = tile-batch data parallelism; "strips" = strip-shard
        # the image with halo exchange (parallel/sharded.py); "auto" =
        # strips above the reference's 16 MP force-tiling threshold, tiles
        # otherwise. One-GPU hosts ignore this.
        "shard_strategy": "tiles",
        "tile_batch": 16,
        "tile_halo": 16,
        "esrgan_model_path": None,
        "esrgan_arch": None,
        # RRDB trunk: None / "xla" / "s2d" = the source-major fused trunk,
        # its five convs per RDB through K1; "dform" = one K2 launch per RDB
        # (bf16); "int8" = int8 weights and activations, the convs on K4.
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
        "num_inference_steps": None,
        "sd_cfg_split": None,
        # Split the two CFG UNet passes over the last two devices
        # (models/diffusion/cfg_shard.py): uncond on one, cond on the
        # other, one eps swap per step; equal to cfg_split on one device.
        # Engages only when >= 2 devices are visible.
        "sd_cfg_shard": False,
    }


def merge_config(device: str, user_config: dict | None) -> dict[str, Any]:
    """defaults <- user config <- device-specific overlay (user keys win).

    Raises ValueError for an unknown ``esrgan_trunk``."""
    cfg = default_config()
    user_config = user_config or {}
    cfg.update(user_config)
    overlay = cfg["device_specific"].get(device, {})
    for key, value in overlay.items():
        if key not in user_config:
            cfg[key] = value
    if cfg.get("esrgan_trunk") not in ESRGAN_TRUNKS:
        raise ValueError(f"unknown esrgan_trunk {cfg['esrgan_trunk']!r}")
    return cfg



def snapshot(cfg: dict[str, Any]) -> dict[str, Any]:
    """A deep copy without the callbacks (for logging and debugging)."""
    out = {k: v for k, v in cfg.items()
           if k not in ("progress_callback", "image_callback")}
    return copy.deepcopy(out)
