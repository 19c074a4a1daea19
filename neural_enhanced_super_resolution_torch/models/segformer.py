"""SegFormer (MiT encoder + all-MLP decode head) on PyTorch.

Counterpart of ``neural_enhanced_super_resolution_tpu/models/segformer.py``
for segmentation-guided sharpening: SegFormer-b0 by default (150 ADE20k
labels). Four stages of overlap patch embedding, spatial-reduction
self-attention and Mix-FFN (dense, depthwise 3x3, exact GELU, dense), then
the all-MLP head at 1/4 scale (per-stage projection, bilinear upsampling,
concatenation in reversed order, 1x1 fuse, inference BatchNorm, ReLU, 1x1
classifier).

Parameter names are the Hugging Face ``SegformerForSemanticSegmentation``
state-dict keys, so an HF snapshot (``config.json`` + ``model.safetensors``
or ``pytorch_model.bin``) loads with ``strict=True``. Precision follows the
JAX package: convs and linears in the compute dtype (bf16 on the GPU, f32
on the CPU) with f32 outputs and biases, LayerNorm (eps ``layer_norm_eps``
throughout) and the residual stream in f32, f32 logits. The attention is
the plain product of ``models/diffusion/layers.attention``, as in the JAX
package, which runs it outside any Pallas kernel.
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn.functional as F
from torch import nn

from neural_enhanced_super_resolution_torch.models.diffusion.convert import (
    load_component)
from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
    attention, conv2d, layer_norm, linear, materialize)
from neural_enhanced_super_resolution_torch.ops.resize import resize
from neural_enhanced_super_resolution_torch.runtime.device import torch_dtype

__all__ = ["SegFormerConfig", "SegFormer", "SegFormerModel",
           "segformer_param_shapes", "load_segformer",
           "write_synthetic_segformer"]


class SegFormerConfig:
    """Static config (defaults = SegFormer-b0, ADE20k). Takes an HF
    ``config.json``: unknown keys are ignored, and ``num_labels`` comes
    from ``id2label`` where the file has no ``num_labels``."""

    def __init__(self, num_channels=3, num_encoder_blocks=4,
                 depths=(2, 2, 2, 2), sr_ratios=(8, 4, 2, 1),
                 hidden_sizes=(32, 64, 160, 256),
                 patch_sizes=(7, 3, 3, 3), strides=(4, 2, 2, 2),
                 num_attention_heads=(1, 2, 5, 8), mlp_ratios=(4, 4, 4, 4),
                 decoder_hidden_size=256, num_labels=None,
                 layer_norm_eps=1e-6, id2label=None, **_ignored):
        self.num_channels = num_channels
        self.num_encoder_blocks = num_encoder_blocks
        self.depths = tuple(depths)
        self.sr_ratios = tuple(sr_ratios)
        self.hidden_sizes = tuple(hidden_sizes)
        self.patch_sizes = tuple(patch_sizes)
        self.strides = tuple(strides)
        self.num_attention_heads = tuple(num_attention_heads)
        self.mlp_ratios = tuple(mlp_ratios)
        self.decoder_hidden_size = decoder_hidden_size
        self.num_labels = num_labels or (len(id2label) if id2label else 150)
        self.layer_norm_eps = layer_norm_eps

    def to_dict(self) -> dict:
        return {"num_channels": self.num_channels,
                "num_encoder_blocks": self.num_encoder_blocks,
                "depths": list(self.depths),
                "sr_ratios": list(self.sr_ratios),
                "hidden_sizes": list(self.hidden_sizes),
                "patch_sizes": list(self.patch_sizes),
                "strides": list(self.strides),
                "num_attention_heads": list(self.num_attention_heads),
                "mlp_ratios": list(self.mlp_ratios),
                "decoder_hidden_size": self.decoder_hidden_size,
                "num_labels": self.num_labels,
                "layer_norm_eps": self.layer_norm_eps}


def segformer_param_shapes(cfg: SegFormerConfig) -> dict[str, tuple]:
    """HF state-dict keys and shapes: conv (O, I, kh, kw), depthwise
    (C, 1, 3, 3), linear (out, in); no ``num_batches_tracked``."""
    spec: dict[str, tuple] = {}

    def norm(name, c):
        spec[f"{name}.weight"] = (c,)
        spec[f"{name}.bias"] = (c,)

    def lin(name, cin, cout):
        spec[f"{name}.weight"] = (cout, cin)
        spec[f"{name}.bias"] = (cout,)

    cin = cfg.num_channels
    for si in range(cfg.num_encoder_blocks):
        c, k = cfg.hidden_sizes[si], cfg.patch_sizes[si]
        pe = f"segformer.encoder.patch_embeddings.{si}"
        spec[f"{pe}.proj.weight"] = (c, cin, k, k)
        spec[f"{pe}.proj.bias"] = (c,)
        norm(f"{pe}.layer_norm", c)
        for li in range(cfg.depths[si]):
            base = f"segformer.encoder.block.{si}.{li}"
            norm(f"{base}.layer_norm_1", c)
            lin(f"{base}.attention.self.query", c, c)
            sr = cfg.sr_ratios[si]
            if sr > 1:
                spec[f"{base}.attention.self.sr.weight"] = (c, c, sr, sr)
                spec[f"{base}.attention.self.sr.bias"] = (c,)
                norm(f"{base}.attention.self.layer_norm", c)
            lin(f"{base}.attention.self.key", c, c)
            lin(f"{base}.attention.self.value", c, c)
            lin(f"{base}.attention.output.dense", c, c)
            norm(f"{base}.layer_norm_2", c)
            mlp = c * cfg.mlp_ratios[si]
            lin(f"{base}.mlp.dense1", c, mlp)
            spec[f"{base}.mlp.dwconv.dwconv.weight"] = (mlp, 1, 3, 3)
            spec[f"{base}.mlp.dwconv.dwconv.bias"] = (mlp,)
            lin(f"{base}.mlp.dense2", mlp, c)
        norm(f"segformer.encoder.layer_norm.{si}", c)
        cin = c
    d = cfg.decoder_hidden_size
    for si in range(cfg.num_encoder_blocks):
        lin(f"decode_head.linear_c.{si}.proj", cfg.hidden_sizes[si], d)
    spec["decode_head.linear_fuse.weight"] = (d, d * cfg.num_encoder_blocks,
                                              1, 1)
    for stat in ("weight", "bias", "running_mean", "running_var"):
        spec[f"decode_head.batch_norm.{stat}"] = (d,)
    spec["decode_head.classifier.weight"] = (cfg.num_labels, d, 1, 1)
    spec["decode_head.classifier.bias"] = (cfg.num_labels,)
    return spec


def _container(**children: nn.Module) -> nn.Module:
    mod = nn.Module()
    for name, child in children.items():
        mod.add_module(name, child)
    return mod


class _BatchNorm(nn.Module):
    """Inference BatchNorm; the running statistics are parameters so that
    ``materialize`` places them with the rest."""

    def __init__(self, c: int):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            setattr(self, name, nn.Parameter(torch.empty(c)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ((x - self.running_mean) * torch.rsqrt(self.running_var + 1e-5)
                * self.weight + self.bias)


class _Layer(nn.Module):
    def __init__(self, cfg: SegFormerConfig, si: int):
        super().__init__()
        c, sr = cfg.hidden_sizes[si], cfg.sr_ratios[si]
        eps, mlp = cfg.layer_norm_eps, c * cfg.mlp_ratios[si]
        self.heads, self.sr_ratio = cfg.num_attention_heads[si], sr
        self.layer_norm_1 = nn.LayerNorm(c, eps=eps)
        attn = _container(query=nn.Linear(c, c), key=nn.Linear(c, c),
                          value=nn.Linear(c, c))
        if sr > 1:
            attn.add_module("sr", nn.Conv2d(c, c, sr, sr))
            attn.add_module("layer_norm", nn.LayerNorm(c, eps=eps))
        self.attention = _container(
            self=attn, output=_container(dense=nn.Linear(c, c)))
        self.layer_norm_2 = nn.LayerNorm(c, eps=eps)
        self.mlp = _container(
            dense1=nn.Linear(c, mlp),
            dwconv=_container(dwconv=nn.Conv2d(mlp, mlp, 3, 1, 1,
                                               groups=mlp)),
            dense2=nn.Linear(mlp, c))

    def forward(self, seq: torch.Tensor, h: int, w: int) -> torch.Tensor:
        n, _, c = seq.shape
        attn = self.attention.self
        dtype = attn.query.weight.dtype
        hn = layer_norm(seq, self.layer_norm_1)
        q = linear(hn, attn.query)
        red = hn
        if self.sr_ratio > 1:
            red = conv2d(hn.reshape(n, h, w, c), attn.sr,
                         stride=self.sr_ratio, padding=0)
            red = layer_norm(red.reshape(n, -1, c), attn.layer_norm)
        att = attention(q, linear(red, attn.key), linear(red, attn.value),
                        self.heads, dtype=dtype)
        seq = seq + linear(att, self.attention.output.dense)
        hn = linear(layer_norm(seq, self.layer_norm_2), self.mlp.dense1)
        dw = self.mlp.dwconv.dwconv
        hn = F.conv2d(hn.reshape(n, h, w, -1).to(dtype).permute(0, 3, 1, 2),
                      dw.weight, None, 1, 1, 1, dw.weight.shape[0])
        hn = hn.permute(0, 2, 3, 1).float() + dw.bias
        hn = F.gelu(hn.reshape(n, h * w, -1))
        return seq + linear(hn, self.mlp.dense2)


class SegFormer(nn.Module):
    """``SegformerForSemanticSegmentation`` with HF parameter names.
    forward: ImageNet-normalised (N, H, W, 3) -> f32 logits (N, H/4, W/4,
    num_labels)."""

    def __init__(self, cfg: SegFormerConfig):
        super().__init__()
        self.cfg = cfg
        eps, d = cfg.layer_norm_eps, cfg.decoder_hidden_size
        embeds, blocks, norms = [], [], []
        cin = cfg.num_channels
        for si in range(cfg.num_encoder_blocks):
            c, k = cfg.hidden_sizes[si], cfg.patch_sizes[si]
            embeds.append(_container(
                proj=nn.Conv2d(cin, c, k, cfg.strides[si], k // 2),
                layer_norm=nn.LayerNorm(c, eps=eps)))
            blocks.append(nn.ModuleList(_Layer(cfg, si)
                                        for _ in range(cfg.depths[si])))
            norms.append(nn.LayerNorm(c, eps=eps))
            cin = c
        self.segformer = _container(encoder=_container(
            patch_embeddings=nn.ModuleList(embeds),
            block=nn.ModuleList(blocks), layer_norm=nn.ModuleList(norms)))
        self.decode_head = _container(
            linear_c=nn.ModuleList(_container(proj=nn.Linear(c, d))
                                   for c in cfg.hidden_sizes),
            linear_fuse=nn.Conv2d(d * cfg.num_encoder_blocks, d, 1,
                                  bias=False),
            batch_norm=_BatchNorm(d),
            classifier=nn.Conv2d(d, cfg.num_labels, 1))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg, enc = self.cfg, self.segformer.encoder
        n = pixel_values.shape[0]
        x = pixel_values
        features = []
        for si in range(cfg.num_encoder_blocks):
            pe = enc.patch_embeddings[si]
            x = conv2d(x, pe.proj, stride=cfg.strides[si],
                       padding=cfg.patch_sizes[si] // 2)
            _, h, w, c = x.shape
            seq = layer_norm(x.reshape(n, h * w, c), pe.layer_norm)
            for layer in enc.block[si]:
                seq = layer(seq, h, w)
            x = layer_norm(seq, enc.layer_norm[si]).reshape(n, h, w, c)
            features.append(x)
        head = self.decode_head
        th, tw = features[0].shape[1], features[0].shape[2]
        projected = []
        for si, feat in enumerate(features):
            p = linear(feat, head.linear_c[si].proj)
            if p.shape[1] != th or p.shape[2] != tw:
                # Half-pixel bilinear: jax.image.resize's upsampling, whose
                # border renormalisation is the clamp of align_corners=False.
                p = F.interpolate(p.permute(0, 3, 1, 2), size=(th, tw),
                                  mode="bilinear", align_corners=False
                                  ).permute(0, 2, 3, 1)
            projected.append(p)
        fused = conv2d(torch.cat(projected[::-1], dim=-1), head.linear_fuse,
                       padding=0)
        fused = torch.relu(head.batch_norm(fused))
        return conv2d(fused, head.classifier, padding=0).float()


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class SegFormerModel:
    """The inference protocol of the JAX package's ``SegFormerModel``: cap
    the long side at 1024 px (Lanczos-4), resize to ``input_size`` square
    (bilinear), ImageNet-normalise, argmax, nearest-resize back."""

    def __init__(self, model: SegFormer, input_size: int = 512):
        self.model = model
        self.cfg = model.cfg
        self.input_size = input_size

    @torch.no_grad()
    def segment(self, image: torch.Tensor) -> torch.Tensor:
        """RGB uint8 (H, W, 3) on the model's device -> int32 class map at
        the input size capped to 1024 px, on the same device."""
        h, w = int(image.shape[0]), int(image.shape[1])
        max_size = 1024
        if max(h, w) > max_size:
            scale = max_size / max(h, w)
            image = resize(image, dsize=(int(w * scale), int(h * scale)),
                           interpolation="lanczos4")
        net_in = resize(image, dsize=(self.input_size, self.input_size),
                        interpolation="bilinear")
        mean = torch.tensor(_IMAGENET_MEAN, device=image.device)
        std = torch.tensor(_IMAGENET_STD, device=image.device)
        x = (net_in.float() / 255.0 - mean) / std
        seg = self.model(x[None])[0].argmax(-1).to(torch.uint8)
        seg = resize(seg, dsize=(int(image.shape[1]), int(image.shape[0])),
                     interpolation="nearest")
        return seg.to(torch.int32)


def load_segformer(path: str | None = None, compute_dtype: str = "bfloat16",
                   device="cuda") -> SegFormerModel:
    """Load an HF-layout SegFormer snapshot onto ``device``; ``path``
    defaults to the ``segmentation`` entry of the model registry."""
    if path is None:
        from neural_enhanced_super_resolution_torch.utils.downloader import (
            get_model_path)
        path = get_model_path("segmentation")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"segformer snapshot not found at {path}")
    config, sd = load_component(path)
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    cfg = SegFormerConfig(**config)
    with torch.device("meta"):
        model = SegFormer(cfg)
    return SegFormerModel(materialize(model, sd, torch_dtype(compute_dtype),
                                      device))


def write_synthetic_segformer(path: str, cfg: SegFormerConfig,
                             generator: torch.Generator,
                             dtype: torch.dtype = torch.float32) -> str:
    """An HF-layout snapshot of ``cfg`` with seeded weights: convs and
    linears uniform in +-1/sqrt(fan_in) (PyTorch's default init), biases
    small, norms at identity, the BatchNorm's statistics at (0, 1)."""
    from safetensors.torch import save_file
    tensors = {}
    for name, shape in segformer_param_shapes(cfg).items():
        if name.endswith("running_var") or (
                "norm" in name and name.endswith(".weight")):
            t = torch.ones(shape)
        elif "norm" in name or name.endswith("running_mean"):
            t = torch.zeros(shape)
        elif name.endswith(".weight"):
            fan_in = 1
            for s in shape[1:]:
                fan_in *= s
            t = (torch.rand(shape, generator=generator) * 2 - 1) \
                * fan_in ** -0.5
        else:
            t = (torch.rand(shape, generator=generator) * 2 - 1) * 0.02
        tensors[name] = t.to(dtype).contiguous()
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(cfg.to_dict(), model_type="segformer",
                       architectures=["SegformerForSemanticSegmentation"],
                       id2label={str(i): f"class_{i}"
                                 for i in range(cfg.num_labels)}), f)
    save_file(tensors, os.path.join(path, "model.safetensors"))
    return path
