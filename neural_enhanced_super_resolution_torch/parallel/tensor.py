"""Tensor parallelism for the diffusion UNet's transformer blocks.

Counterpart of ``neural_enhanced_super_resolution_tpu/parallel/tensor.py``.
The JAX package annotates Megatron-style shardings on the diffusers-named
weights and lets GSPMD partition the forward; here the same shardings
(the same three name patterns, ``tp_spec_for``) drive a forward written
out per slot (``TensorParallelUNet``):

* q/k/v and the GEGLU up projection are column-parallel: slot i holds a
  contiguous block of output features. Attention reshapes heads in
  feature order, so that block is a block of whole heads, and each slot
  runs the attention (K3 on the card, for the self-attention) on its own
  heads. GEGLU's value and gate halves are split alike, so slot i holds
  value block i and gate block i.
* The attention out-projection and the FF down projection are
  row-parallel: each slot multiplies its block of input features (rounded
  to the compute dtype) by a float32 copy of its weight rows into an
  unrounded float32 partial sum; the partials are added on the home slot
  in slot order and the sum is rounded to the compute dtype once, as the
  replicated linear rounds its product; the bias is added after the sum.
* Convs, norms, embeddings and the residual stream stay on the home slot.

A block whose head count (or GEGLU half) does not divide over the slots
keeps that layer replicated on the home slot, as ``tp_spec_for`` degrades
to replication where a dim does not divide. On a TPU the JAX package turns
flash attention off under TP (GSPMD cannot partition a Pallas call); the
per-slot attention here computes the same function on K3.

Weights are the port's UNet state dict, in torch layout: a linear weight
is (out, in), so column-parallel shards dim 0 and row-parallel dim 1.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import attention as _attn
from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
    attention_qmajor, layer_norm)
from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
    UNet2DConditionModel, crossattn_layer_names, unet_forward)
from neural_enhanced_super_resolution_torch.parallel.mesh import (
    make_mesh, replicate, sum_on)

__all__ = ["tp_mesh", "tp_spec_for", "shard_transformer_params",
           "TensorParallelUNet"]

# The JAX package's patterns on the diffusers names.
_COL_PARALLEL = re.compile(
    r"\.(attn[12]\.to_[qkv]|ff\.net\.0\.proj)\.weight$")
_ROW_PARALLEL = re.compile(
    r"\.(attn[12]\.to_out\.0|ff\.net\.2)\.weight$")
_COL_BIAS = re.compile(r"\.(attn[12]\.to_[qkv]|ff\.net\.0\.proj)\.bias$")
_GEGLU = "ff.net.0.proj"
_ROW_WEIGHTS = ("attn1.to_out.0.weight", "attn2.to_out.0.weight",
                "ff.net.2.weight")


def tp_mesh(n_devices: int | None = None,
            devices: Sequence[torch.device] | None = None
            ) -> tuple[torch.device, ...]:
    """A tensor-parallel mesh (``parallel/mesh.make_mesh``)."""
    return make_mesh(n_devices, devices)


def tp_spec_for(name: str, shape: tuple, mesh: Sequence) -> int | None:
    """The dim a diffusers-named tensor (torch layout) is sharded on under
    head/FF sharding: 0 for a column-parallel weight or its bias, 1 for a
    row-parallel weight, None to replicate (also where the dim, or a GEGLU
    half, does not divide over the mesh)."""
    tp = len(mesh)
    if _COL_PARALLEL.search(name) and len(shape) == 2 and shape[0] % tp == 0:
        if _GEGLU in name and (shape[0] // 2) % tp:
            return None
        return 0
    if _ROW_PARALLEL.search(name) and len(shape) == 2 and shape[1] % tp == 0:
        return 1
    if _COL_BIAS.search(name) and len(shape) == 1 and shape[0] % tp == 0:
        if _GEGLU in name and (shape[0] // 2) % tp:
            return None
        return 0
    return None


def _shard(name: str, t: torch.Tensor, dim: int, tp: int
           ) -> list[torch.Tensor]:
    if _GEGLU in name:   # [value | gate]: slot i takes block i of each half
        value, gate = t.chunk(2, dim=0)
        return [torch.cat(pair, dim=0) for pair in zip(value.chunk(tp),
                                                       gate.chunk(tp))]
    return list(t.chunk(tp, dim=dim))


def shard_transformer_params(params: dict[str, torch.Tensor],
                             mesh: Sequence[torch.device]
                             ) -> list[dict[str, torch.Tensor]]:
    """Per slot, every tensor of ``params`` (a flat diffusers-named state
    dict, torch layout) on the slot's device: its shard where
    ``tp_spec_for`` shards it, else the whole tensor (one copy per distinct
    device)."""
    mesh = tuple(mesh)
    out: list[dict[str, torch.Tensor]] = [{} for _ in mesh]
    for name, t in params.items():
        dim = tp_spec_for(name, tuple(t.shape), mesh)
        parts = (replicate(t, mesh) if dim is None else
                 [p.to(dev, non_blocking=True).contiguous() for p, dev in
                  zip(_shard(name, t, dim, len(mesh)), mesh)])
        for i, part in enumerate(parts):
            out[i][name] = part
    return out


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w^T in the weight's dtype, float32 out (``layers.linear``
    without its bias)."""
    return F.linear(x.to(w.dtype), w).float()


def _partial(x: torch.Tensor, w32: torch.Tensor, dt) -> torch.Tensor:
    """A row-parallel partial sum: x rounded to the compute dtype, times
    the float32 copy of the weight shard, in float32 (no rounding of the
    partial before the sum)."""
    return F.linear(x.to(dt).float(), w32)


class _TPBlock:
    """One ``_BasicTransformerBlock`` under TP: called in its place with
    (x, context, kv)."""

    def __init__(self, owner: "TensorParallelUNet", block, prefix: str,
                 shards: list[dict]):
        self.owner, self.block = owner, block
        self.dt = block.attn1.to_q.weight.dtype
        tp = len(owner.mesh)
        self.w = [{k[len(prefix):]: v for k, v in s.items()
                   if k.startswith(prefix)} for s in shards]
        for w in self.w:   # row-parallel shards in float32, made once
            for k in _ROW_WEIGHTS:
                w[k] = w[k].float()
        specs = {k: tp_spec_for(prefix + k, tuple(v.shape), owner.mesh)
                 for k, v in block.state_dict().items()}

        def split(*names):
            return all(specs.get(n) is not None for n in names)

        heads = block.heads % tp == 0
        self.split_attn1 = heads and split(
            "attn1.to_q.weight", "attn1.to_k.weight", "attn1.to_v.weight",
            "attn1.to_out.0.weight")
        self.split_attn2 = heads and split(
            "attn2.to_q.weight", "attn2.to_k.weight", "attn2.to_v.weight",
            "attn2.to_out.0.weight")
        self.split_ff = split("ff.net.0.proj.weight", "ff.net.0.proj.bias",
                              "ff.net.2.weight")
        self.heads = block.heads // tp

    def _psum(self, parts: list[torch.Tensor], bias) -> torch.Tensor:
        """The row-parallel sum on the home slot, rounded to the compute
        dtype once, as ``layers.linear`` rounds its product, then the
        bias."""
        acc = sum_on(parts, self.owner.mesh[0]).to(self.dt).float()
        return acc + bias if bias is not None else acc

    def _attention(self, i: int, q, k, v, cross: bool) -> torch.Tensor:
        """Slot ``i``'s attention over its heads: K3 (``attention_auto``)
        for the self-attention, the plain path for the cross-attention."""
        if cross:
            return attention_qmajor(q, k, v, self.heads, dtype=self.dt)
        return _attn.attention_auto(q, k, v, self.heads, dtype=self.dt)

    def _attn(self, a: str, h, context, kv) -> torch.Tensor:
        hs = replicate(h, self.owner.mesh)
        parts = []
        for i, (w, hi) in enumerate(zip(self.w, hs)):
            q = _mm(hi, w[f"{a}.to_q.weight"])
            if a == "attn1":
                k, v = _mm(hi, w[f"{a}.to_k.weight"]), _mm(
                    hi, w[f"{a}.to_v.weight"])
            elif kv is not None:   # hoisted K/V: this slot's feature block
                cols = slice(i * q.shape[-1], (i + 1) * q.shape[-1])
                k, v = (t[..., cols].to(hi.device, non_blocking=True)
                        for t in kv)
            else:
                ci = context.to(hi.device, non_blocking=True)
                k, v = _mm(ci, w[f"{a}.to_k.weight"]), _mm(
                    ci, w[f"{a}.to_v.weight"])
            out = self._attention(i, q, k, v, cross=a == "attn2")
            parts.append(_partial(out, w[f"{a}.to_out.0.weight"], self.dt))
        return self._psum(parts, getattr(self.block, a).to_out[0].bias)

    def _ff(self, h) -> torch.Tensor:
        parts = []
        for w, hi in zip(self.w, replicate(h, self.owner.mesh)):
            value, gate = (_mm(hi, w["ff.net.0.proj.weight"])
                           + w["ff.net.0.proj.bias"]).chunk(2, dim=-1)
            parts.append(_partial(value * F.gelu(gate, approximate="tanh"),
                                  w["ff.net.2.weight"], self.dt))
        return self._psum(parts, self.block.ff.net[2].bias)

    def __call__(self, x, context, kv=None):
        b = self.block
        h = layer_norm(x, b.norm1)
        x = x + (self._attn("attn1", h, context, None) if self.split_attn1
                 else b.self_attention(h))
        h = layer_norm(x, b.norm2)
        x = x + (self._attn("attn2", h, context, kv) if self.split_attn2
                 else b.cross_attention(h, context, kv))
        h = layer_norm(x, b.norm3)
        return x + (self._ff(h) if self.split_ff else b.ff(h))


class TensorParallelUNet:
    """A UNet whose transformer blocks run tensor-parallel over ``mesh``.

    The UNet module stays on the home slot (slot 0) and runs everything
    else; ``shard_transformer_params`` places the blocks' shards on every
    slot. Called like ``unet_forward`` without its first argument."""

    def __init__(self, unet: UNet2DConditionModel,
                 mesh: Sequence[torch.device]):
        self.unet = unet
        self.mesh = tuple(mesh)
        names = crossattn_layer_names(unet.cfg)
        prefixes = [f"{n}.transformer_blocks.0." for n in names]
        sd = {k: v for k, v in unet.state_dict().items()
              if k.startswith(tuple(prefixes))}
        shards = shard_transformer_params(sd, self.mesh)
        self.blocks = {n: _TPBlock(self, unet.get_submodule(p[:-1]), p,
                                   shards)
                       for n, p in zip(names, prefixes)}

    @torch.no_grad()
    def __call__(self, sample, timestep, encoder_hidden_states,
                 class_labels=None, context_kv=None) -> torch.Tensor:
        return unet_forward(self.unet, sample, timestep,
                            encoder_hidden_states, class_labels, context_kv,
                            blocks=self.blocks)
