"""AutoencoderKL (the diffusers VAE of the SD x4 upscaler).

Counterpart of the JAX package's ``models/diffusion/vae.py``. Decode:
latents (N, h, w, 4) -> RGB in [-1, 1], (N, h*f, w*f, 3) with
f = 2^(blocks-1); encode: RGB in [-1, 1], (N, H, W, 3) -> moments
(N, H/f, W/f, 2 x latent channels). The upscale pipeline only decodes, but
a snapshot's VAE loads whole (``AutoencoderKL``, strictly, encoder and
``quant_conv`` included); ``AutoencoderKLDecoder`` is its decoder half.
Each mid-block attention (one head, d = the widest channel count, over the
whole latent grid) goes through ``kernels.attention.attention_auto``, so
K3's wide form runs it on the card. Convs take bf16 operands (the weights'
dtype on the card) and give f32, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_enhanced_super_resolution_torch.kernels import attention as _attn
from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
    conv2d, group_norm, linear, nearest_upsample_x2, silu)
from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
    ResnetBlock2D)

__all__ = ["VAEConfig", "AutoencoderKLDecoder", "AutoencoderKL",
           "vae_decode", "vae_encode"]


class VAEConfig:
    def __init__(self, in_channels=3, out_channels=3, latent_channels=4,
                 block_out_channels=(128, 256, 512),
                 layers_per_block=2, norm_num_groups=32,
                 scaling_factor=0.08333, **_ignored):
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.latent_channels = latent_channels
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.norm_num_groups = norm_num_groups
        self.scaling_factor = scaling_factor


class _MidAttention(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        flat = group_norm(x, self.group_norm).reshape(n, h * w, c)
        out = _attn.attention_auto(
            linear(flat, self.to_q), linear(flat, self.to_k),
            linear(flat, self.to_v), 1, dtype=self.to_q.weight.dtype)
        return linear(out, self.to_out[0]).reshape(n, h, w, c) + x


class AutoencoderKLDecoder(nn.Module):
    """``post_quant_conv`` and ``decoder.*`` of diffusers' AutoencoderKL."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        b, groups = cfg.block_out_channels, cfg.norm_num_groups
        rev = list(reversed(b))

        def res(cin, cout):
            return ResnetBlock2D(cin, cout, None, groups, 1e-6)

        lat = cfg.latent_channels
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        dec = self.decoder = nn.Module()
        dec.conv_in = nn.Conv2d(lat, b[-1], 3, padding=1)
        dec.mid_block = nn.Module()
        dec.mid_block.resnets = nn.ModuleList([res(b[-1], b[-1]),
                                               res(b[-1], b[-1])])
        dec.mid_block.attentions = nn.ModuleList(
            [_MidAttention(b[-1], groups)])
        dec.up_blocks = nn.ModuleList()
        c = b[-1]
        for ui in range(len(b)):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(res(c, rev[ui]))
                c = rev[ui]
            if ui < len(b) - 1:
                up = nn.Module()
                up.conv = nn.Conv2d(c, c, 3, padding=1)
                blk.upsamplers = nn.ModuleList([up])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(groups, b[0], eps=1e-6)
        dec.conv_out = nn.Conv2d(b[0], cfg.out_channels, 3, padding=1)

    @torch.no_grad()
    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        dec = self.decoder
        x = conv2d(latents, self.post_quant_conv, padding=0)
        x = conv2d(x, dec.conv_in)
        x = dec.mid_block.resnets[0](x)
        x = dec.mid_block.attentions[0](x)
        x = dec.mid_block.resnets[1](x)
        for blk in dec.up_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            if hasattr(blk, "upsamplers"):
                x = conv2d(nearest_upsample_x2(x), blk.upsamplers[0].conv)
        x = group_norm(x, dec.conv_norm_out)
        return conv2d(silu(x), dec.conv_out)


class AutoencoderKL(AutoencoderKLDecoder):
    """The whole diffusers AutoencoderKL: the decoder and ``quant_conv``
    and ``encoder.*``. ``forward`` decodes; ``encode`` encodes."""

    def __init__(self, cfg: VAEConfig):
        super().__init__(cfg)
        b, groups = cfg.block_out_channels, cfg.norm_num_groups
        lat = cfg.latent_channels

        def res(cin, cout):
            return ResnetBlock2D(cin, cout, None, groups, 1e-6)

        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        enc = self.encoder = nn.Module()
        enc.conv_in = nn.Conv2d(cfg.in_channels, b[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        c = b[0]
        for bi in range(len(b)):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(res(c, b[bi]))
                c = b[bi]
            if bi < len(b) - 1:
                down = nn.Module()
                down.conv = nn.Conv2d(c, c, 3, stride=2)
                blk.downsamplers = nn.ModuleList([down])
            enc.down_blocks.append(blk)
        enc.mid_block = nn.Module()
        enc.mid_block.resnets = nn.ModuleList([res(b[-1], b[-1]),
                                               res(b[-1], b[-1])])
        enc.mid_block.attentions = nn.ModuleList(
            [_MidAttention(b[-1], groups)])
        enc.conv_norm_out = nn.GroupNorm(groups, b[-1], eps=1e-6)
        enc.conv_out = nn.Conv2d(b[-1], 2 * lat, 3, padding=1)

    @torch.no_grad()
    def encode(self, image: torch.Tensor) -> torch.Tensor:
        enc = self.encoder
        x = conv2d(image, enc.conv_in)
        for blk in enc.down_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            if hasattr(blk, "downsamplers"):
                # diffusers' Downsample2D(padding=0): a (0, 1, 0, 1) zero
                # pad, then a VALID stride-2 conv
                x = F.pad(x, (0, 0, 0, 1, 0, 1))
                x = conv2d(x, blk.downsamplers[0].conv, stride=2, padding=0)
        x = enc.mid_block.resnets[0](x)
        x = enc.mid_block.attentions[0](x)
        x = enc.mid_block.resnets[1](x)
        x = group_norm(x, enc.conv_norm_out)
        x = conv2d(silu(x), enc.conv_out)
        return conv2d(x, self.quant_conv, padding=0)


def vae_decode(vae: AutoencoderKLDecoder,
               latents: torch.Tensor) -> torch.Tensor:
    """latents (N, h, w, latent_ch), already divided by scaling_factor ->
    RGB in [-1, 1], (N, h*f, w*f, 3) f32."""
    return vae(latents)


def vae_encode(vae: AutoencoderKL, image: torch.Tensor) -> torch.Tensor:
    """image (N, H, W, 3) in [-1, 1] -> moments (N, H/f, W/f,
    2 x latent_ch) f32: the mean and the log-variance of the latent."""
    return vae.encode(image)
