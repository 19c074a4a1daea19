"""Synthetic weights and snapshots for the diffusion components.

The parameter names and shapes come from the modules themselves (built on
the meta device), so there is no separate spec to keep in step. The init
follows the JAX package's ``specs.random_params``: norm weights 1, biases 0,
every other tensor normal, with a fixed std (``init="fixed"``, the JAX
package's 0.05 for tiny test models) or std 1/sqrt(fan_in)
(``init="fan_in"``, for full-width models, where 0.05 makes every branch
several times larger than its input).
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from neural_enhanced_super_resolution_torch.models.diffusion.clip_text import (
    CLIPTextConfig, CLIPTextModel)
from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
    UNet2DConditionModel, UNetConfig)
from neural_enhanced_super_resolution_torch.models.diffusion.vae import (
    AutoencoderKL, VAEConfig)

__all__ = ["random_state_dict", "write_synthetic_snapshot",
           "SCHEDULER_CONFIG"]

# The main (DDIM) and low-res (DDPM) schedulers of a synthetic snapshot.
SCHEDULER_CONFIG = {"num_train_timesteps": 1000, "beta_start": 0.0001,
                    "beta_end": 0.02, "beta_schedule": "scaled_linear",
                    "prediction_type": "epsilon"}


def random_state_dict(module: nn.Module, generator: torch.Generator,
                      init: str = "fan_in", scale: float = 0.05,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Seeded weights for every parameter of ``module`` (CPU tensors)."""
    if init not in ("fan_in", "fixed"):
        raise ValueError(f"unknown init {init!r} (fan_in or fixed)")
    sd = {}
    for name, p in sorted(module.state_dict().items()):
        parent = name.split(".")[-2] if "." in name else ""
        if name.endswith(".bias"):
            t = torch.zeros(p.shape)
        elif "norm" in parent:
            t = torch.ones(p.shape)
        else:
            fan_in = p[0].numel() if p.dim() > 1 else p.numel()
            std = fan_in ** -0.5 if init == "fan_in" else scale
            t = torch.randn(p.shape, generator=generator,
                            device=generator.device) * std
        sd[name] = t.to(dtype).cpu()
    return sd


def _save_component(path: str, config: dict, sd: dict, fname: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    torch.save(sd, os.path.join(path, fname))


def _config_dict(cfg) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in vars(cfg).items()}


def write_synthetic_snapshot(path: str, cfgs: tuple[UNetConfig, VAEConfig,
                                                    CLIPTextConfig],
                             generator: torch.Generator,
                             dtype: torch.dtype = torch.bfloat16,
                             init: str = "fan_in") -> str:
    """A diffusers-layout snapshot of the x4 upscaler with seeded weights:
    ``unet/``, ``vae/`` (encoder and decoder), ``text_encoder/``,
    ``scheduler/`` (DDIM), ``low_res_scheduler/`` (DDPM) and
    ``model_index.json``; no tokenizer (the pipeline then hashes words into
    ids)."""
    ucfg, vcfg, tcfg = cfgs
    for sub, cfg, cls, fname in (
            ("unet", ucfg, UNet2DConditionModel,
             "diffusion_pytorch_model.bin"),
            ("vae", vcfg, AutoencoderKL,
             "diffusion_pytorch_model.bin"),
            ("text_encoder", tcfg, CLIPTextModel, "pytorch_model.bin")):
        with torch.device("meta"):
            module = cls(cfg)
        _save_component(os.path.join(path, sub), _config_dict(cfg),
                        random_state_dict(module, generator, init,
                                          dtype=dtype), fname)
    for sub, cls_name in (("scheduler", "DDIMScheduler"),
                          ("low_res_scheduler", "DDPMScheduler")):
        os.makedirs(os.path.join(path, sub), exist_ok=True)
        with open(os.path.join(path, sub, "scheduler_config.json"), "w") as f:
            json.dump(dict(SCHEDULER_CONFIG, _class_name=cls_name), f)
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump({"_class_name": "StableDiffusionUpscalePipeline",
                   "max_noise_level": 350}, f)
    return path
