"""CLIP text encoder (transformers ``CLIPTextModel`` subset) for the prompt.

Counterpart of the JAX package's ``models/diffusion/clip_text.py``: the
causal text tower, parameters under the transformers state-dict names
(``text_model.encoder.layers.{i}.self_attn.q_proj.weight`` ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
    Table, attention, layer_norm, linear)

__all__ = ["CLIPTextConfig", "CLIPTextModel", "clip_text_forward"]


class CLIPTextConfig:
    def __init__(self, vocab_size=49408, hidden_size=1024,
                 intermediate_size=4096, num_hidden_layers=23,
                 num_attention_heads=16, max_position_embeddings=77,
                 hidden_act="gelu", layer_norm_eps=1e-5, **_ignored):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.hidden_act = hidden_act
        self.layer_norm_eps = layer_norm_eps


class _SelfAttention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)


class _MLP(nn.Module):
    def __init__(self, h: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(h, inner)
        self.fc2 = nn.Linear(inner, h)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(h, eps=eps)
        self.self_attn = _SelfAttention(h)
        self.layer_norm2 = nn.LayerNorm(h, eps=eps)
        self.mlp = _MLP(h, cfg.intermediate_size)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)  # exact (erf) GELU, as the JAX package


class CLIPTextModel(nn.Module):
    """forward: input_ids (N, S) -> last hidden state (N, S, hidden) f32."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.text_model = nn.Module()
        self.text_model.embeddings = nn.Module()
        self.text_model.embeddings.token_embedding = Table(cfg.vocab_size, h)
        self.text_model.embeddings.position_embedding = Table(
            cfg.max_position_embeddings, h)
        self.text_model.encoder = nn.Module()
        self.text_model.encoder.layers = nn.ModuleList(
            _EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.text_model.final_layer_norm = nn.LayerNorm(
            h, eps=cfg.layer_norm_eps)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        cfg, tm = self.cfg, self.text_model
        dt = tm.encoder.layers[0].self_attn.q_proj.weight.dtype
        s = input_ids.shape[1]
        # Out-of-range ids are clamped, as the JAX package's gather does (the
        # test fixtures' tiny vocabularies see CLIP's bos/eos ids).
        ids = input_ids.clamp(0, cfg.vocab_size - 1)
        x = (tm.embeddings.token_embedding.weight[ids]
             + tm.embeddings.position_embedding.weight[:s])
        ar = torch.arange(s, device=x.device)
        causal = torch.zeros((s, s), device=x.device).masked_fill(
            ar[None, :] > ar[:, None], float("-inf"))[None, None]
        for layer in tm.encoder.layers:
            att = layer.self_attn
            h = layer_norm(x, layer.layer_norm1)
            h = attention(linear(h, att.q_proj), linear(h, att.k_proj),
                          linear(h, att.v_proj), cfg.num_attention_heads,
                          mask=causal, dtype=dt)
            x = x + linear(h, att.out_proj)
            h = layer_norm(x, layer.layer_norm2)
            h = _act(linear(h, layer.mlp.fc1), cfg.hidden_act)
            x = x + linear(h, layer.mlp.fc2)
        return layer_norm(x, tm.final_layer_norm)


def clip_text_forward(model: CLIPTextModel,
                      input_ids: torch.Tensor) -> torch.Tensor:
    return model(input_ids)
