"""UNet2DConditionModel (the diffusers subset the SD x4 upscaler uses).

Counterpart of the JAX package's ``models/diffusion/unet.py``: DownBlock2D /
CrossAttnDownBlock2D / UNetMidBlock2DCrossAttn / CrossAttnUpBlock2D /
UpBlock2D, timestep + class (noise-level) embeddings, GEGLU transformer
blocks with self- and cross-attention. Parameter names are the diffusers
state-dict names. ``unet_forward`` takes and returns NHWC, f32 out.

The self-attention (``attn1``) of every transformer goes through
``kernels.attention.attention_auto``, i.e. K3 on the GPU; the
cross-attention over the 77-token text context is the plain
``attention_qmajor``, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_enhanced_super_resolution_torch.kernels import attention as _attn
from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
    Table, attention_qmajor, conv2d, group_norm, layer_norm, linear,
    nearest_upsample_x2, silu, timestep_embedding)

__all__ = ["UNetConfig", "UNet2DConditionModel", "unet_forward",
           "crossattn_layer_names", "precompute_context_kv",
           "ResnetBlock2D"]


class UNetConfig:
    """Static config (subset of diffusers UNet2DConditionModel); defaults are
    the published stable-diffusion-x4-upscaler's."""

    def __init__(self, sample_size=128, in_channels=7, out_channels=4,
                 down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                                   "CrossAttnDownBlock2D",
                                   "CrossAttnDownBlock2D"),
                 up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                                 "CrossAttnUpBlock2D", "UpBlock2D"),
                 block_out_channels=(256, 512, 512, 1024),
                 layers_per_block=2, cross_attention_dim=1024,
                 attention_head_dim=8, num_class_embeds=1000,
                 norm_num_groups=32, mid_block_type="UNetMidBlock2DCrossAttn",
                 **_ignored):
        self.sample_size = sample_size
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.down_block_types = tuple(down_block_types)
        self.up_block_types = tuple(up_block_types)
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.cross_attention_dim = cross_attention_dim
        # diffusers' "attention_head_dim" is the NUMBER of heads in SD-x4-era
        # configs; per-block values allowed.
        if isinstance(attention_head_dim, (list, tuple)):
            self.attention_head_dim = tuple(attention_head_dim)
        else:
            self.attention_head_dim = (attention_head_dim,) * len(
                self.block_out_channels)
        self.num_class_embeds = num_class_embeds
        self.norm_num_groups = norm_num_groups
        self.mid_block_type = mid_block_type


# ---------------------------------------------------------------- blocks ----

class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D (the VAE's has no time embedding)."""

    def __init__(self, cin: int, cout: int, temb_dim: int | None, groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_dim, cout) if temb_dim
                              else None)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(cin, cout, 1) if cin != cout
                              else None)

    def forward(self, x: torch.Tensor,
                temb: torch.Tensor | None = None) -> torch.Tensor:
        h = conv2d(silu(group_norm(x, self.norm1)), self.conv1)
        if self.time_emb_proj is not None:
            h = h + linear(silu(temb), self.time_emb_proj)[:, None, None, :]
        h = conv2d(silu(group_norm(h, self.norm2)), self.conv2)
        if self.conv_shortcut is not None:
            x = conv2d(x, self.conv_shortcut, padding=0)
        return x + h


class _Attention(nn.Module):
    def __init__(self, dim: int, kv_dim: int, bias: bool = False):
        super().__init__()
        self.to_q = nn.Linear(dim, dim, bias=bias)
        self.to_k = nn.Linear(kv_dim, dim, bias=bias)
        self.to_v = nn.Linear(kv_dim, dim, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class _FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # net.1 is diffusers' dropout: no parameters
        self.net = nn.ModuleList([_GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = linear(x, self.net[0].proj).chunk(2, dim=-1)
        # jax.nn.gelu's default, which the JAX package uses: the tanh form
        return linear(a * F.gelu(gate, approximate="tanh"), self.net[2])


class _BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, cross_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = _Attention(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = _Attention(dim, cross_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = _FeedForward(dim)

    def forward(self, x, context, kv=None):
        x = x + self.self_attention(layer_norm(x, self.norm1))
        x = x + self.cross_attention(layer_norm(x, self.norm2), context, kv)
        return x + self.ff(layer_norm(x, self.norm3))

    def self_attention(self, h):
        a1 = self.attn1
        h = _attn.attention_auto(linear(h, a1.to_q), linear(h, a1.to_k),
                                 linear(h, a1.to_v), self.heads,
                                 dtype=a1.to_q.weight.dtype)
        return linear(h, a1.to_out[0])

    def cross_attention(self, h, context, kv=None):
        a2 = self.attn2
        if kv is None:
            kv = self.context_kv(context)
        h = attention_qmajor(linear(h, a2.to_q), kv[0], kv[1], self.heads,
                             dtype=a2.to_q.weight.dtype)
        return linear(h, a2.to_out[0])

    def context_kv(self, context):
        """The cross-attention's K and V of the text context."""
        return linear(context, self.attn2.to_k), linear(context,
                                                        self.attn2.to_v)


class Transformer2DModel(nn.Module):
    def __init__(self, dim: int, cross_dim: int, heads: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [_BasicTransformerBlock(dim, cross_dim, heads)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, context, kv=None, block=None):
        """``block`` replaces the transformer block's forward (the
        tensor-parallel one of ``parallel/tensor.py``)."""
        n, h, w, c = x.shape
        y = linear(group_norm(x, self.norm).reshape(n, h * w, c),
                   self.proj_in)
        y = (block or self.transformer_blocks[0])(y, context, kv)
        return linear(y, self.proj_out).reshape(n, h, w, c) + x


class _Sampler(nn.Module):
    """Downsample2D / Upsample2D: one 3x3 conv named ``conv``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)


class _TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)


def _block(resnets, attentions=None, sampler_name=None, sampler=None):
    blk = nn.Module()
    blk.resnets = nn.ModuleList(resnets)
    if attentions:
        blk.attentions = nn.ModuleList(attentions)
    if sampler is not None:
        setattr(blk, sampler_name, nn.ModuleList([sampler]))
    return blk


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        b = cfg.block_out_channels
        temb = 4 * b[0]
        groups, layers = cfg.norm_num_groups, cfg.layers_per_block

        def res(cin, cout):
            return ResnetBlock2D(cin, cout, temb, groups, 1e-5)

        def attn(c, bi):
            return Transformer2DModel(c, cfg.cross_attention_dim,
                                      cfg.attention_head_dim[bi], groups)

        self.time_embedding = _TimestepEmbedding(b[0], temb)
        if cfg.num_class_embeds:
            self.class_embedding = Table(cfg.num_class_embeds, temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, b[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        skips, cin = [b[0]], b[0]
        for bi, btype in enumerate(cfg.down_block_types):
            resnets, attns = [], []
            for _ in range(layers):
                resnets.append(res(cin, b[bi]))
                cin = b[bi]
                if btype == "CrossAttnDownBlock2D":
                    attns.append(attn(b[bi], bi))
                skips.append(b[bi])
            last = bi == len(b) - 1
            if not last:
                skips.append(b[bi])
            self.down_blocks.append(_block(
                resnets, attns, "downsamplers",
                None if last else _Sampler(b[bi])))
        self.mid_block = _block(
            [res(b[-1], b[-1]), res(b[-1], b[-1])],
            [attn(b[-1], len(b) - 1)]
            if cfg.mid_block_type == "UNetMidBlock2DCrossAttn" else None)
        self.up_blocks = nn.ModuleList()
        c = b[-1]
        for ui, btype in enumerate(cfg.up_block_types):
            bi = len(b) - 1 - ui
            resnets, attns = [], []
            for _ in range(layers + 1):
                resnets.append(res(c + skips.pop(), b[bi]))
                c = b[bi]
                if btype == "CrossAttnUpBlock2D":
                    attns.append(attn(b[bi], bi))
            self.up_blocks.append(_block(
                resnets, attns, "upsamplers",
                _Sampler(b[bi]) if ui < len(b) - 1 else None))
        self.conv_norm_out = nn.GroupNorm(groups, b[0])
        self.conv_out = nn.Conv2d(b[0], cfg.out_channels, 3, padding=1)

    @torch.no_grad()
    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states,
                class_labels=None, context_kv: dict | None = None,
                blocks: dict | None = None):
        cfg = self.cfg
        ckv = context_kv or {}
        blk_for = (blocks or {}).get
        ctx = encoder_hidden_states
        n = sample.shape[0]
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        temb = timestep_embedding(t.expand(n), cfg.block_out_channels[0])
        temb = linear(temb, self.time_embedding.linear_1)
        temb = linear(silu(temb), self.time_embedding.linear_2)
        if cfg.num_class_embeds and class_labels is not None:
            temb = temb + self.class_embedding.weight[class_labels]

        x = conv2d(sample, self.conv_in)
        skips = [x]
        for bi, blk in enumerate(self.down_blocks):
            for li, resnet in enumerate(blk.resnets):
                x = resnet(x, temb)
                if hasattr(blk, "attentions"):
                    name = f"down_blocks.{bi}.attentions.{li}"
                    x = blk.attentions[li](x, ctx, ckv.get(name),
                                           blk_for(name))
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                # diffusers Downsample2D: stride 2, one zero row/column on
                # each side (the JAX package's (0,1) pad + (1,0) conv pad)
                x = conv2d(x, blk.downsamplers[0].conv, stride=2)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        if hasattr(mid, "attentions"):
            name = "mid_block.attentions.0"
            x = mid.attentions[0](x, ctx, ckv.get(name), blk_for(name))
        x = mid.resnets[1](x, temb)

        for ui, blk in enumerate(self.up_blocks):
            for li, resnet in enumerate(blk.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=-1), temb)
                if hasattr(blk, "attentions"):
                    name = f"up_blocks.{ui}.attentions.{li}"
                    x = blk.attentions[li](x, ctx, ckv.get(name),
                                           blk_for(name))
            if hasattr(blk, "upsamplers"):
                x = conv2d(nearest_upsample_x2(x), blk.upsamplers[0].conv)

        x = group_norm(x, self.conv_norm_out)
        return conv2d(silu(x), self.conv_out)


def unet_forward(unet: UNet2DConditionModel, sample: torch.Tensor, timestep,
                 encoder_hidden_states: torch.Tensor,
                 class_labels: torch.Tensor | None = None,
                 context_kv: dict | None = None,
                 blocks: dict | None = None) -> torch.Tensor:
    """sample (N, H, W, in_channels) -> eps (N, H, W, out_channels) f32.

    context_kv: per-layer cross-attention K/V from
    ``precompute_context_kv``, hoisted out of a step loop. blocks:
    {transformer name: callable} run in place of that layer's transformer
    block (``parallel/tensor.TensorParallelUNet``)."""
    return unet(sample, timestep, encoder_hidden_states, class_labels,
                context_kv, blocks)


def crossattn_layer_names(cfg: UNetConfig) -> tuple:
    """The Transformer2DModel names of a forward pass, in call order."""
    names = []
    for bi, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            names += [f"down_blocks.{bi}.attentions.{li}"
                      for li in range(cfg.layers_per_block)]
    if cfg.mid_block_type == "UNetMidBlock2DCrossAttn":
        names.append("mid_block.attentions.0")
    for ui, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            names += [f"up_blocks.{ui}.attentions.{li}"
                      for li in range(cfg.layers_per_block + 1)]
    return tuple(names)


@torch.no_grad()
def precompute_context_kv(unet: UNet2DConditionModel,
                          context: torch.Tensor) -> dict:
    """{transformer name: (k, v)} of every cross-attention: the text
    context's K/V projections, constant across denoise steps. Slice the
    leading batch axis to match each pass's context batch."""
    return {name: unet.get_submodule(name).transformer_blocks[0].context_kv(
        context) for name in crossattn_layer_names(unet.cfg)}
