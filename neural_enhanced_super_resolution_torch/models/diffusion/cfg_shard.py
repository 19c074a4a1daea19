"""Split classifier-free guidance across two devices.

Counterpart of ``neural_enhanced_super_resolution_tpu/models/diffusion/
cfg_shard.py``. The uncond and cond UNet passes of a step are independent,
so on a two-device mesh each runs on its own device: slot 0 the uncond
pass, slot 1 the cond pass, each a batch-n ``unet_forward`` with its half
of the hoisted context K/V, exactly as single-device ``cfg_split``. Each
step the two eps swap slots (a peer copy), and both slots apply the
guidance and the scheduler step, so the latents stay identical on both
without a broadcast. The noises are explicit tensors, as in
``UpscalePipeline._denoise``; the result equals ``cfg_split`` on one
device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from neural_enhanced_super_resolution_torch.models.diffusion.pipeline import (
    guided_step)
from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
    precompute_context_kv, unet_forward)
from neural_enhanced_super_resolution_torch.parallel.mesh import replicate

__all__ = ["cfg_mesh", "denoise_cfg_sharded"]


def cfg_mesh(devices: Sequence[torch.device] | None = None
             ) -> tuple[torch.device, torch.device]:
    """A mesh of exactly two devices (default: the first two GPUs)."""
    if devices is None:
        from neural_enhanced_super_resolution_torch.runtime.device import (
            visible_devices)
        devices = visible_devices("cuda")
    devices = tuple(torch.device(d) for d in devices)[:2]
    if len(devices) != 2:
        raise ValueError(f"split-CFG sharding needs 2 devices, got "
                         f"{len(devices)}")
    return devices


@torch.no_grad()
def denoise_cfg_sharded(unets: Sequence, embeds: torch.Tensor,
                        image: torch.Tensor, image_noise: torch.Tensor,
                        init_latents: torch.Tensor,
                        step_noises: torch.Tensor | None, timesteps,
                        noise_level: int, guidance_scale: float, scheduler,
                        low_res_scheduler, mesh: Sequence[torch.device]
                        ) -> torch.Tensor:
    """Noise the conditioning image and run the step loop with the CFG pair
    split over ``mesh``; returns the final latents (N, H, W, 4) f32 on
    slot 0's device.

    unets: the UNet on each slot's device. embeds (2N, 77, D) [uncond,
    cond]; image (N, H, W, 3) in [-1, 1]; image_noise, init_latents and
    step_noises (DDPM, else None) as in ``UpscalePipeline._denoise``."""
    home, peer = mesh = cfg_mesh(mesh)
    n = image.shape[0]
    noisy = low_res_scheduler.add_noise(image.to(home),
                                        image_noise.to(home), noise_level)
    labels = torch.full((n,), noise_level, dtype=torch.long, device=home)
    embeds = embeds.to(home)
    kv = precompute_context_kv(unets[0], embeds)
    context = [embeds[:n], embeds[n:].to(peer, non_blocking=True)]
    kvs = [{k: (a[:n], b[:n]) for k, (a, b) in kv.items()},
           {k: (a[n:].to(peer, non_blocking=True),
                b[n:].to(peer, non_blocking=True))
            for k, (a, b) in kv.items()}]
    noisy, labels = replicate(noisy, mesh), replicate(labels, mesh)
    latents = replicate(init_latents, mesh)
    noises = (replicate(step_noises, mesh) if step_noises is not None
              else [None, None])
    for i, t in enumerate(int(s) for s in timesteps):
        prev_t = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
        eps = [unet_forward(unets[s], torch.cat([latents[s], noisy[s]],
                                                dim=-1),
                            t, context[s], labels[s], kvs[s])
               for s in (0, 1)]
        # the swap: each slot gets the other slot's eps
        pairs = [(eps[0], eps[1].to(home, non_blocking=True)),
                 (eps[0].to(peer, non_blocking=True), eps[1])]
        latents = [guided_step(scheduler, u, c, guidance_scale, t, prev_t,
                               latents[s],
                               None if noises[s] is None else noises[s][i])
                   for s, (u, c) in enumerate(pairs)]
    return latents[0]
