"""The Stable Diffusion x4 upscaler on PyTorch: CLIP text, UNet, the VAE,
schedulers, and the pipeline that runs them (the JAX package's
``models/diffusion`` without ``cfg_shard``)."""

from neural_enhanced_super_resolution_torch.models.diffusion.clip_text import (
    CLIPTextConfig, CLIPTextModel, clip_text_forward)
from neural_enhanced_super_resolution_torch.models.diffusion.pipeline import (
    UpscalePipeline, build_module, load_upscale_pipeline)
from neural_enhanced_super_resolution_torch.models.diffusion.scheduler import (
    DDIMScheduler, DDPMScheduler)
from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
    UNet2DConditionModel, UNetConfig, unet_forward)
from neural_enhanced_super_resolution_torch.models.diffusion.vae import (
    AutoencoderKL, AutoencoderKLDecoder, VAEConfig, vae_decode, vae_encode)

__all__ = [
    "UpscalePipeline", "load_upscale_pipeline", "build_module",
    "DDPMScheduler", "DDIMScheduler",
    "UNetConfig", "UNet2DConditionModel", "unet_forward",
    "VAEConfig", "AutoencoderKL", "AutoencoderKLDecoder", "vae_decode",
    "vae_encode",
    "CLIPTextConfig", "CLIPTextModel", "clip_text_forward",
]
