"""The Stable Diffusion x4 upscaler: CLIP text + UNet + DDIM/DDPM + VAE.

Counterpart of the JAX package's ``models/diffusion/pipeline.py``, with the
same call contract: ``pipe(prompt=..., image=..., noise_level=20,
num_inference_steps=20, guidance_scale=7.5, seed=0)`` on an RGB uint8 image
returns the RGB uint8 image at 4x (here as a tensor on the pipeline's
device). PyTorch runs the denoise loop eagerly, step by step.

* Classifier-free guidance runs as two batch-n UNet passes (uncond, cond)
  by default (``cfg_split``; ``NESR_SD_CFG_SPLIT=0`` or ``cfg_split=False``
  batches them into one batch-2n pass). The text context's cross-attention
  K/V are computed once per call, outside the step loop.
* Every noise draw comes from ``torch.Generator(device).manual_seed(seed)``
  (image noise, initial latents, then the DDPM step noises); ``_denoise``
  takes them as tensors, so ``__call__`` and ``trace_latents`` (noise
  injected from outside) run the same ops.
* With a ``StageTimer`` in ``timer`` (``runtime/profiler``), the call is
  traced as the spans ``diffusion/clip``, ``diffusion/denoise`` (with
  ``diffusion/step``, one CFG step: both UNet passes, the guidance and the
  scheduler update) and ``diffusion/vae``; spans never synchronise.
* ``to_device`` moves the pipeline (and its seeded draws) to another
  device (the stage-overlap slot); with a two-device ``cfg_shard_mesh``
  (``cfg_shard.cfg_mesh``) the uncond and cond passes run on one device
  each (``cfg_shard.denoise_cfg_sharded``), the result equal to
  ``cfg_split`` on one device.
"""

from __future__ import annotations

import logging
import os
import zlib

import numpy as np
import torch

from neural_enhanced_super_resolution_torch.models.diffusion.clip_text import (
    CLIPTextConfig, CLIPTextModel)
from neural_enhanced_super_resolution_torch.models.diffusion.convert import (
    load_component, read_json)
from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
    materialize)
from neural_enhanced_super_resolution_torch.models.diffusion.scheduler import (
    DDIMScheduler, DDPMScheduler)
from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
    UNet2DConditionModel, UNetConfig, precompute_context_kv, unet_forward)
from neural_enhanced_super_resolution_torch.models.diffusion.vae import (
    AutoencoderKL, VAEConfig, vae_decode)
from neural_enhanced_super_resolution_torch.parallel.mesh import module_on
from neural_enhanced_super_resolution_torch.runtime.device import torch_dtype
from neural_enhanced_super_resolution_torch.runtime.profiler import (
    NULL_TIMER)

logger = logging.getLogger("nesr.diffusion")

__all__ = ["UpscalePipeline", "load_upscale_pipeline", "build_module",
           "guided_step"]


def guided_step(scheduler, eps_uncond: torch.Tensor, eps_cond: torch.Tensor,
                guidance_scale: float, t: int, prev_t: int,
                latents: torch.Tensor,
                step_noise: torch.Tensor | None) -> torch.Tensor:
    """Classifier-free guidance, then one scheduler step; a DDPM step adds
    ``step_noise`` where t > 0."""
    eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
    if isinstance(scheduler, DDPMScheduler):
        noise = step_noise if t > 0 else torch.zeros_like(latents)
        return scheduler.step(eps, t, prev_t, latents, noise)
    return scheduler.step(eps, t, prev_t, latents)


class UpscalePipeline:
    """x4 latent upscaler on one device."""

    def __init__(self, unet: UNet2DConditionModel, vae: AutoencoderKL,
                 text_encoder: CLIPTextModel, scheduler, low_res_scheduler,
                 tokenizer=None, max_noise_level: int = 350,
                 cfg_split: bool | None = None):
        if cfg_split is None:
            cfg_split = os.environ.get("NESR_SD_CFG_SPLIT", "1") == "1"
        self.cfg_split = bool(cfg_split)
        self.unet = unet
        self.vae = vae
        self.text_encoder = text_encoder
        self.scheduler = scheduler
        self.low_res_scheduler = low_res_scheduler
        self.tokenizer = tokenizer
        self.max_noise_level = max_noise_level
        self.device = unet.conv_in.weight.device
        self.timer = None  # a StageTimer traces the call
        self.cfg_shard_mesh = None  # two devices: split CFG across them
        self._unet_replicas: dict = {}

    def to_device(self, device) -> "UpscalePipeline":
        """Move the UNet, the VAE, the text encoder and the seeded draws
        to ``device`` (the stage-overlap placement)."""
        for module in (self.unet, self.vae, self.text_encoder):
            module.to(device)
        self.device = torch.device(device)
        self._unet_replicas = {}
        return self

    def _unet_on(self, device) -> UNet2DConditionModel:
        """The UNet on ``device``: itself, or a replica made once."""
        device = torch.device(device)
        if device not in self._unet_replicas:
            self._unet_replicas[device] = module_on(self.unet, device)
        return self._unet_replicas[device]

    # ------------------------------------------------------------- text ----

    def _tokenize(self, text: str) -> np.ndarray:
        length = self.text_encoder.cfg.max_position_embeddings
        if self.tokenizer is not None:
            ids = self.tokenizer(text, padding="max_length", max_length=length,
                                 truncation=True, return_tensors="np").input_ids
            return ids.astype(np.int32)
        # Test-fixture fallback for a snapshot without tokenizer files:
        # crc32 word hashes (stable across processes), framed like CLIP.
        bos, eos = 49406, 49407
        ids = [bos] + [zlib.crc32(w.encode()) % 49000
                       for w in text.lower().split()][:75] + [eos]
        ids += [eos] * (length - len(ids))
        return np.asarray([ids], dtype=np.int32)

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """[uncond, cond] embeddings, (2, 77, hidden) f32."""
        ids = np.concatenate([self._tokenize(""), self._tokenize(prompt)])
        return self.text_encoder(torch.as_tensor(ids, dtype=torch.long,
                                                 device=self.device))

    # ---------------------------------------------------------- denoise ----

    @torch.no_grad()
    def _denoise(self, embeds, image, image_noise, init_latents, step_noises,
                 timesteps, noise_level: int, guidance_scale: float,
                 trace: list | None = None) -> torch.Tensor:
        """Noise the conditioning image, run the step loop, return the final
        latents (N, H, W, 4) f32. image: (N, H, W, 3) in [-1, 1]; the noises
        are explicit; step_noises is None for DDIM. With ``trace``, each
        step's latents are appended to it. With a ``cfg_shard_mesh`` (and no
        trace) the two passes run on its two devices."""
        if self.cfg_shard_mesh is not None and trace is None:
            from neural_enhanced_super_resolution_torch.models.diffusion \
                .cfg_shard import denoise_cfg_sharded
            mesh = self.cfg_shard_mesh
            return denoise_cfg_sharded(
                [self._unet_on(d) for d in mesh], embeds, image, image_noise,
                init_latents, step_noises, timesteps, noise_level,
                guidance_scale, self.scheduler, self.low_res_scheduler,
                mesh).to(self.device)
        n = image.shape[0]
        noisy = self.low_res_scheduler.add_noise(image, image_noise,
                                                 noise_level)
        labels = torch.full((n,), noise_level, dtype=torch.long,
                            device=self.device)
        kv = precompute_context_kv(self.unet, embeds)
        kv_uncond = {k: (a[:n], b[:n]) for k, (a, b) in kv.items()}
        kv_cond = {k: (a[n:], b[n:]) for k, (a, b) in kv.items()}
        timer = self.timer or NULL_TIMER
        latents = init_latents
        for i, t in enumerate(int(s) for s in timesteps):
            prev_t = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
            with timer.span("diffusion/step", self.device):
                if self.cfg_split:
                    unet_in = torch.cat([latents, noisy], dim=-1)
                    eps_u = unet_forward(self.unet, unet_in, t, embeds[:n],
                                         labels, kv_uncond)
                    eps_c = unet_forward(self.unet, unet_in, t, embeds[n:],
                                         labels, kv_cond)
                else:
                    unet_in = torch.cat([torch.cat([latents, latents]),
                                         torch.cat([noisy, noisy])], dim=-1)
                    eps_u, eps_c = unet_forward(
                        self.unet, unet_in, t, embeds, labels.repeat(2),
                        kv).chunk(2)
                latents = guided_step(
                    self.scheduler, eps_u, eps_c, guidance_scale, t, prev_t,
                    latents, None if step_noises is None else step_noises[i])
            if trace is not None:
                trace.append(latents)
        return latents

    @torch.no_grad()
    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Final latents -> RGB uint8 (N, 4H, 4W, 3)."""
        decoded = vae_decode(self.vae,
                             latents / self.vae.cfg.scaling_factor)
        out = torch.clamp((decoded + 1.0) * 127.5, 0.0, 255.0)
        return torch.round(out).to(torch.uint8)

    def _image(self, image) -> torch.Tensor:
        img = torch.as_tensor(image, device=self.device)
        return (img.float() / 127.5 - 1.0)[None]

    # ------------------------------------------------------------ calls ----

    def trace_latents(self, prompt: str, image, image_noise: np.ndarray,
                      init_latents: np.ndarray, noise_level: int = 20,
                      num_inference_steps: int = 20,
                      guidance_scale: float = 7.5
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Replay with injected noise (DDIM): image RGB uint8 (H, W, 3),
        image_noise (H, W, 3) and init_latents (H, W, 4) standard normal.
        Returns (latents per step (T, H, W, 4) f32, final RGB uint8)."""
        if isinstance(self.scheduler, DDPMScheduler):
            raise ValueError("trace_latents replays DDIM only (a DDPM step "
                             "draws noise)")
        dev = self.device
        trace: list = []
        latents = self._denoise(
            self.encode_prompt(prompt), self._image(image),
            torch.as_tensor(image_noise, dtype=torch.float32, device=dev)[None],
            torch.as_tensor(init_latents, dtype=torch.float32,
                            device=dev)[None],
            None, self.scheduler.timesteps(num_inference_steps),
            noise_level, guidance_scale, trace)
        lats = torch.cat(trace).cpu().numpy()
        return lats, self._decode(latents)[0].cpu().numpy()

    def __call__(self, prompt: str, image, noise_level: int = 20,
                 num_inference_steps: int = 20, guidance_scale: float = 7.5,
                 seed: int = 0) -> torch.Tensor:
        """image: RGB uint8 (H, W, 3), array or tensor; returns RGB uint8
        (4H, 4W, 3) on the pipeline's device."""
        if noise_level > self.max_noise_level:
            raise ValueError(f"noise_level {noise_level} > max "
                             f"{self.max_noise_level}")
        timer = self.timer or NULL_TIMER
        img = self._image(image)
        n, h, w, _ = img.shape
        lat_ch = self.unet.cfg.out_channels
        timesteps = self.scheduler.timesteps(num_inference_steps)
        gen = torch.Generator(self.device).manual_seed(seed)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=self.device)

        image_noise = normal(n, h, w, 3)
        init_latents = normal(n, h, w, lat_ch)
        step_noises = (normal(len(timesteps), n, h, w, lat_ch)
                       if isinstance(self.scheduler, DDPMScheduler) else None)
        with timer.span("diffusion/clip", self.device):
            embeds = self.encode_prompt(prompt)
        with timer.span("diffusion/denoise", self.device):
            latents = self._denoise(embeds, img, image_noise, init_latents,
                                    step_noises, timesteps, noise_level,
                                    guidance_scale)
        with timer.span("diffusion/vae", self.device):
            return self._decode(latents)[0]


def build_module(cls, cfg, state_dict: dict, dtype: torch.dtype, device):
    """``cls(cfg)`` built on the meta device, loaded strictly from
    ``state_dict`` and placed on ``device`` (``layers.materialize``)."""
    with torch.device("meta"):
        module = cls(cfg)
    return materialize(module, state_dict, dtype, device)


def load_upscale_pipeline(path: str | None = None, device="cuda",
                          compute_dtype: str = "bfloat16",
                          cfg_split: bool | None = None) -> UpscalePipeline:
    """Load a diffusers-layout snapshot of the x4 upscaler onto ``device``.

    ``path`` defaults to the model directory of ``sd_upscaler``
    (``utils/downloader.get_model_path``). Every component loads
    strictly, the VAE with its encoder.
    """
    if path is None:
        from neural_enhanced_super_resolution_torch.utils.downloader import (
            get_model_path)
        path = get_model_path("sd_upscaler")
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"diffusion model snapshot not found at {path}")
    dtype = torch_dtype(compute_dtype)

    def component(sub, cfg_cls, module_cls):
        config, sd = load_component(os.path.join(path, sub))
        return build_module(module_cls, cfg_cls(**config), sd, dtype, device)

    unet = component("unet", UNetConfig, UNet2DConditionModel)
    vae = component("vae", VAEConfig, AutoencoderKL)
    text = component("text_encoder", CLIPTextConfig, CLIPTextModel)

    sched_cfg = read_json(os.path.join(path, "scheduler",
                                       "scheduler_config.json"))
    low_cfg = read_json(os.path.join(path, "low_res_scheduler",
                                     "scheduler_config.json"))
    sched_cls = (DDIMScheduler if "DDIM" in sched_cfg.get("_class_name", "")
                 else DDPMScheduler)

    tokenizer = None
    tok_dir = os.path.join(path, "tokenizer")
    if os.path.isdir(tok_dir):
        from neural_enhanced_super_resolution_torch.models.diffusion.tokenizer \
            import ClipBpeTokenizer
        # As the JAX package does: a tokenizer/ that fails to load is
        # logged, and _tokenize takes its word-hash fallback.
        try:
            tokenizer = ClipBpeTokenizer.from_pretrained(tok_dir)
        except Exception as exc:
            logger.warning("tokenizer load failed: %s", exc)

    mi_path = os.path.join(path, "model_index.json")
    model_index = read_json(mi_path) if os.path.exists(mi_path) else {}
    return UpscalePipeline(
        unet, vae, text, sched_cls(**sched_cfg), DDPMScheduler(**low_cfg),
        tokenizer, max_noise_level=model_index.get("max_noise_level", 350),
        cfg_split=cfg_split)
