"""Building blocks of the diffusion stack (NHWC activations, PyTorch).

Counterpart of the JAX package's ``models/diffusion/layers.py``. Parameters
live in ``nn.Module``s whose names are the diffusers / transformers
state-dict names, so a snapshot loads with ``load_state_dict(strict=True)``
(``materialize``). Conv and linear weights are kept in the compute dtype
(bf16 on the GPU, f32 for parity on the CPU); biases, norm parameters and
embedding tables in f32.

Precision follows the JAX package, which keeps every conv and matmul output
in f32 (``preferred_element_type``) and adds the bias in f32: each conv and
linear here runs in the weight's dtype and is cast back to f32 at once, so
the residual stream stays f32 (a bf16 op's output is rounded to bf16 first,
which the JAX package does not do). The plain attentions compute their
einsums on f32 copies of the rounded operands, which is what an f32-
accumulating bf16 product gives. Convolutions take the NHWC tensor as an
NCHW view, which is channels_last memory.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["conv2d", "linear", "group_norm", "layer_norm", "silu",
           "attention", "attention_qmajor", "timestep_embedding",
           "nearest_upsample_x2", "materialize", "Table"]


class Table(nn.Module):
    """An embedding table, ``weight`` (num, dim), indexed directly: the
    parameter of ``nn.Embedding`` without its init, which on the meta device
    imports torch's compiler stack (seconds in every process)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))


def conv2d(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """NHWC conv in the weight's dtype, f32 out, f32 bias."""
    dt = conv.weight.dtype
    y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight, None, stride,
                 padding)
    y = y.permute(0, 2, 3, 1).float()
    if conv.bias is not None:
        y = y + conv.bias
    return y


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """x @ W^T in the weight's dtype, f32 out, f32 bias."""
    y = F.linear(x.to(lin.weight.dtype), lin.weight).float()
    if lin.bias is not None:
        y = y + lin.bias
    return y


def group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of NHWC, f32 statistics."""
    n, h, w, c = x.shape
    g = norm.num_groups
    x32 = x.float().reshape(n, h * w, g, c // g)
    var, mean = torch.var_mean(x32, dim=(1, 3), keepdim=True, correction=0)
    x32 = ((x32 - mean) * torch.rsqrt(var + norm.eps)).reshape(n, h, w, c)
    return x32 * norm.weight + norm.bias


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _heads(t: torch.Tensor, num_heads: int, dtype) -> torch.Tensor:
    b, s, d = t.shape
    return t.reshape(b, s, num_heads, d // num_heads).to(dtype).float()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, mask: torch.Tensor | None = None,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Multi-head attention over (B, Sq, D) x (B, Skv, D), scores
    (B, H, Sq, Skv); mask is added to the scores. f32 out."""
    b, sq, d = q.shape
    qh, kh, vh = (_heads(t, num_heads, dtype) for t in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d // num_heads)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), vh)
    return out.reshape(b, sq, d)


def attention_qmajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, mask: torch.Tensor | None = None,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The same attention with head-last scores (B, Sq, H, Skv): the UNet's
    cross-attention over the 77-token text context. ``mask`` comes in the
    (..., heads, q, k) convention of ``attention``."""
    b, sq, d = q.shape
    qh, kh, vh = (_heads(t, num_heads, dtype) for t in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bqhk", qh, kh) / math.sqrt(d // num_heads)
    if mask is not None:
        scores = scores + mask.transpose(-3, -2)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", probs.to(dtype).float(), vh)
    return out.reshape(b, sq, d)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - freq_shift)
    args = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def nearest_upsample_x2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)


def materialize(module: nn.Module, state_dict: Mapping[str, torch.Tensor],
                dtype: torch.dtype, device) -> nn.Module:
    """Load ``state_dict`` strictly into ``module`` (built on the meta
    device), then place it on ``device``: conv and linear weights in
    ``dtype`` (conv weights channels_last), every other tensor in f32."""
    module.load_state_dict(state_dict, strict=True, assign=True)
    for mod in module.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            matmul = name == "weight" and isinstance(mod, (nn.Linear,
                                                          nn.Conv2d))
            t = p.detach().to(device=device,
                              dtype=dtype if matmul else torch.float32)
            if matmul and t.dim() == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            setattr(mod, name, nn.Parameter(t, requires_grad=False))
    return module.eval().requires_grad_(False)
