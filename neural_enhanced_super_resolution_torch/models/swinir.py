"""SwinIR (Swin-transformer SR) in PyTorch, NHWC, on the port's kernels.

Counterpart of ``neural_enhanced_super_resolution_tpu/models/swinir.py``
(Liang et al. 2021, the official JingyunLiang/SwinIR layout, so published
checkpoints load directly):

  conv_first -> RSTB x L [STL x depth -> conv3x3, residual] -> norm
  -> conv_after_body (+ residual) -> upsampler -> conv_last

An STL is window multi-head self-attention (relative position bias, every
other layer shifted by half a window with cross-region pairs masked at
-100) and a two-layer GELU MLP, both pre-LayerNorm with residual adds.

Activations are NHWC in the compute dtype (bf16 on the GPU, f32 for parity
on the CPU). Every 3x3 conv goes through K1 (``kernels.conv3x3``, weights
packed once at build); the CPU takes its plain version. Window attention,
the linears and LayerNorm are plain PyTorch, as they are einsums in the
JAX package: 64-token windows are far below where a flash kernel pays.

Rounding points are the JAX package's: LayerNorm statistics in f32 (eps
1e-5) then a cast; linears and the two attention products as f32 results
of compute-dtype operands (cuBLAS's f32-output GEMM on the GPU), f32 bias,
then a cast; ``q * hd**-0.5`` in the compute dtype; bias and mask added
and softmax taken in f32; residual adds and exact GELU in f32 with one
rounding. The relative-position bias is gathered once per layer at build
((heads, n, n) f32 on the device); per padded size the shift mask and the
window gathers (``torch.roll`` and the window partition as one row
gather, and its inverse) are made once on the device, so a call does no
host work beyond dispatch.
"""

from __future__ import annotations

import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neural_enhanced_super_resolution_torch.models.rrdbnet import (
    Conv3x3, nearest_x2)
from neural_enhanced_super_resolution_torch.models.weights import (
    load_state_dict)
from neural_enhanced_super_resolution_torch.runtime.device import torch_dtype

__all__ = ["SwinIRConfig", "SwinIRModel", "swinir_param_shapes",
           "init_swinir", "swinir_params_from_state_dict",
           "infer_swinir_config", "load_swinir"]


class SwinIRConfig:
    """Static hyperparameters (hashable); the JAX package's defaults are
    the published real-world SwinIR-M x4."""

    def __init__(self, img_range: float = 1.0, scale: int = 4,
                 embed_dim: int = 180, depths: tuple = (6, 6, 6, 6, 6, 6),
                 num_heads: tuple = (6, 6, 6, 6, 6, 6),
                 window_size: int = 8, mlp_ratio: float = 2.0,
                 num_feat: int = 64, upsampler: str = "nearest+conv",
                 in_ch: int = 3, out_ch: int = 3):
        self.img_range = float(img_range)
        self.scale = scale
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.window_size = window_size
        self.mlp_ratio = mlp_ratio
        self.num_feat = num_feat
        self.upsampler = upsampler
        self.in_ch = in_ch
        self.out_ch = out_ch

    def _key(self):
        return (self.img_range, self.scale, self.embed_dim, self.depths,
                self.num_heads, self.window_size, self.mlp_ratio,
                self.num_feat, self.upsampler, self.in_ch, self.out_ch)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, SwinIRConfig) and self._key() == other._key()

    def __repr__(self):
        return f"SwinIRConfig{self._key()}"


# The official SwinIR RGB mean, subtracted for every 3-channel checkpoint.
_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def _conv_names(cfg: SwinIRConfig) -> dict[str, tuple[int, int]]:
    """Every 3x3 conv of the network: name -> (Cin, Cout)."""
    c, f = cfg.embed_dim, cfg.num_feat
    convs = {"conv_first": (cfg.in_ch, c)}
    convs.update({f"layers.{li}.conv": (c, c)
                  for li in range(len(cfg.depths))})
    convs["conv_after_body"] = (c, c)
    convs["conv_before_upsample.0"] = (c, f)
    if cfg.upsampler == "pixelshuffle":
        for k in range(int(math.log2(cfg.scale))):
            convs[f"upsample.{2 * k}"] = (f, 4 * f)
    else:
        for name in ("conv_up1", "conv_up2", "conv_hr"):
            convs[name] = (f, f)
    convs["conv_last"] = (f, cfg.out_ch)
    return convs


def swinir_param_shapes(cfg: SwinIRConfig) -> dict[str, tuple]:
    """{name: shape} of the official state dict: convs OIHW, linears
    (out, in), the bias tables ((2w - 1)^2, heads)."""
    c, w = cfg.embed_dim, cfg.window_size
    hidden = int(c * cfg.mlp_ratio)
    spec: dict[str, tuple] = {}
    for name, (cin, cout) in _conv_names(cfg).items():
        spec[f"{name}.weight"] = (cout, cin, 3, 3)
        spec[f"{name}.bias"] = (cout,)
    for li, depth in enumerate(cfg.depths):
        for bi in range(depth):
            b = f"layers.{li}.residual_group.blocks.{bi}"
            spec[f"{b}.attn.relative_position_bias_table"] = (
                (2 * w - 1) ** 2, cfg.num_heads[li])
            for name, cin, cout in (("attn.qkv", c, 3 * c),
                                    ("attn.proj", c, c),
                                    ("mlp.fc1", c, hidden),
                                    ("mlp.fc2", hidden, c)):
                spec[f"{b}.{name}.weight"] = (cout, cin)
                spec[f"{b}.{name}.bias"] = (cout,)
            for norm in ("norm1", "norm2"):
                spec[f"{b}.{norm}.weight"] = (c,)
                spec[f"{b}.{norm}.bias"] = (c,)
    spec["norm.weight"] = (c,)
    spec["norm.bias"] = (c,)
    return spec


def init_swinir(cfg: SwinIRConfig, generator: torch.Generator
                ) -> dict[str, torch.Tensor]:
    """Synthetic weights in the official layout, made from ``generator``.

    Convs take PyTorch's Conv2d default (weights and biases uniform within
    1/sqrt(fan_in)); linears std 0.02 as the official init, their biases
    std 0.02; LayerNorms 1 + 0.05 n and 0.05 n; the bias tables std 1, so
    the position bias moves the scores as a trained table does."""
    convs = _conv_names(cfg)
    out = {}
    for name, shape in sorted(swinir_param_shapes(cfg).items()):
        owner = name.rsplit(".", 1)[0]
        if owner in convs:
            u = torch.rand(shape, generator=generator) * 2 - 1
            out[name] = u * (9 * convs[owner][0]) ** -0.5
            continue
        n = torch.randn(shape, generator=generator)
        if name.endswith("relative_position_bias_table"):
            out[name] = n
        elif owner.rsplit(".", 1)[-1].startswith("norm"):
            out[name] = float(name.endswith(".weight")) + 0.05 * n
        else:
            out[name] = 0.02 * n
    return out


def swinir_params_from_state_dict(sd: Mapping[str, torch.Tensor]
                                  ) -> dict[str, torch.Tensor]:
    """Official state dict -> the port's flat params: convs HWIO, linears
    (in, out), float32. The ``attn_mask`` and ``relative_position_index``
    buffers are dropped: they are rebuilt at build."""
    out = {}
    for name, val in sd.items():
        if name.endswith(("attn_mask", "relative_position_index")):
            continue
        a = torch.as_tensor(val).float()
        if name.endswith(".weight") and a.dim() == 4:
            a = a.permute(2, 3, 1, 0)
        elif name.endswith(".weight") and a.dim() == 2:
            a = a.t()
        out[name] = a.contiguous()
    return out


def infer_swinir_config(params: Mapping[str, torch.Tensor]) -> SwinIRConfig:
    """The architecture of a converted checkpoint, from its shapes alone
    (JAX ``load_swinir``'s inference: depth, heads and window from layer 0,
    the upsampler from which convs exist; the real-world head is x4)."""
    c = params["conv_first.weight"].shape[-1]
    nl = 1 + max(int(k.split(".")[1]) for k in params
                 if k.startswith("layers."))
    depth = 1 + max(int(k.split(".")[4]) for k in params
                    if k.startswith("layers.0.residual_group.blocks."))
    b0 = "layers.0.residual_group.blocks.0"
    table = params[f"{b0}.attn.relative_position_bias_table"].shape
    ws = (math.isqrt(table[0]) + 1) // 2
    hidden = params[f"{b0}.mlp.fc1.weight"].shape[-1]
    if "upsample.0.weight" in params:
        upsampler = "pixelshuffle"
        # one conv per 2x stage, at indices 0, 2, 4, ...
        scale = 2 ** (1 + max(int(k.split(".")[1]) for k in params
                              if k.startswith("upsample.")) // 2)
    else:
        upsampler, scale = "nearest+conv", 4
    return SwinIRConfig(scale=scale, embed_dim=c, depths=(depth,) * nl,
                        num_heads=(table[1],) * nl, window_size=ws,
                        mlp_ratio=hidden / c, upsampler=upsampler,
                        num_feat=params["conv_last.weight"].shape[2])


def relative_position_index(w: int) -> torch.Tensor:
    """(w*w, w*w) indices into the ((2w - 1)^2, heads) bias table."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w),
                                        indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + w - 1
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


def shift_attn_mask(hp: int, wp: int, w: int, shift: int) -> torch.Tensor:
    """(nW, n, n) f32 additive mask, -100 on pairs of a shifted window that
    come from different regions of the (hp, wp) grid (the official
    construction)."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(hp // w, w, wp // w, w).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, w * w)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0)
                            .astype(np.float32))


def _mm_f32(a: torch.Tensor, b: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """a @ b (2-D, or 3-D batched) of compute-dtype operands, accumulated
    and returned in f32, + an f32 bias: the JAX package's einsum with
    ``preferred_element_type=f32``. On the GPU cuBLAS writes the f32
    result of the bf16 product itself (``out_dtype``); elsewhere the same
    product runs on f32 copies of the operands."""
    if a.is_cuda and a.dtype != torch.float32:
        f32 = torch.float32
        if a.dim() == 3:
            return torch.bmm(a, b, out_dtype=f32)
        if bias is None:
            return torch.mm(a, b, out_dtype=f32)
        return torch.addmm(bias, a, b, out_dtype=f32)
    y = torch.matmul(a.float(), b.float())
    return y if bias is None else y + bias


class _Linear(nn.Module):
    """x @ W + b, f32 out, cast to x's dtype; W (in, out) in the compute
    dtype, b f32."""

    def __init__(self, p, name, dtype, device):
        super().__init__()
        self.register_buffer("w", p[f"{name}.weight"].to(device, dtype)
                             .contiguous())
        self.register_buffer("b", p[f"{name}.bias"].to(device, torch.float32)
                             .contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _mm_f32(x.reshape(-1, x.shape[-1]), self.w, self.b)
        return y.to(x.dtype).view(*x.shape[:-1], -1)


class _LayerNorm(nn.Module):
    """LayerNorm over the channels, statistics in f32, eps 1e-5, cast to
    the input's dtype."""

    def __init__(self, p, name, device):
        super().__init__()
        self.register_buffer("w", p[f"{name}.weight"].to(device,
                                                         torch.float32))
        self.register_buffer("b", p[f"{name}.bias"].to(device,
                                                       torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.w, self.b,
                            1e-5).to(x.dtype)


def window_index(hp: int, wp: int, w: int, shift: int) -> torch.Tensor:
    """(hp * wp,) token order of the windows of the grid rolled by
    (-shift, -shift): entry j is the row-major token that lands at place j
    of window j // (w * w). A gather by it is ``torch.roll`` followed by
    the window partition."""
    idx = torch.roll(torch.arange(hp * wp).view(hp, wp), (-shift, -shift),
                     dims=(0, 1))
    return idx.view(hp // w, w, wp // w, w).permute(0, 2, 1, 3).reshape(-1)


class _STL(nn.Module):
    """One Swin transformer layer on (B, H*W, C) tokens in row-major
    order; H and W are multiples of the window.

    Every add of two compute-dtype tensors here (``x + o``) and GELU run
    as PyTorch's reduced-precision elementwise ops do, in f32 with one
    rounding to the compute dtype: the JAX package's f32 residual adds and
    f32 GELU followed by a cast."""

    def __init__(self, p, base, heads, window, shift, dtype, device):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.norm1 = _LayerNorm(p, f"{base}.norm1", device)
        self.qkv = _Linear(p, f"{base}.attn.qkv", dtype, device)
        self.proj = _Linear(p, f"{base}.attn.proj", dtype, device)
        self.norm2 = _LayerNorm(p, f"{base}.norm2", device)
        self.fc1 = _Linear(p, f"{base}.mlp.fc1", dtype, device)
        self.fc2 = _Linear(p, f"{base}.mlp.fc2", dtype, device)
        # The table ((2w - 1)^2, heads) indexed by the flattened pair index,
        # then heads first: (heads, n, n) f32, once.
        n = window * window
        table = p[f"{base}.attn.relative_position_bias_table"]
        bias = table[relative_position_index(window).reshape(-1)]
        self.register_buffer("bias", bias.reshape(n, n, heads)
                             .permute(2, 0, 1).to(device, torch.float32)
                             .contiguous())

    def _attention(self, xw: torch.Tensor, mask: torch.Tensor | None
                   ) -> torch.Tensor:
        """xw (B*nW, n, C); mask (nW, n, n) f32 or None."""
        bn, n, c = xw.shape
        heads, dt = self.heads, xw.dtype
        hd = c // heads
        qkv = self.qkv(xw).view(bn, n, 3, heads, hd).permute(
            2, 0, 3, 1, 4).reshape(3, bn * heads, n, hd)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        s = _mm_f32(q, k.transpose(1, 2)).view(bn, heads, n, n)
        s += self.bias
        if mask is not None:
            nw = mask.shape[0]
            s.view(bn // nw, nw, heads, n, n).add_(mask[None, :, None])
        a = torch.softmax(s, dim=-1).to(dt).view(bn * heads, n, n)
        o = _mm_f32(a, v).view(bn, heads, n, hd).transpose(1, 2)
        return self.proj(o.to(dt).reshape(bn, n, c))

    def forward(self, x: torch.Tensor, idx: torch.Tensor, inv: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:
        """x (B, T, C); idx / inv the window gather of this layer's shift
        and its inverse; mask for a shifted layer."""
        b, t, c = x.shape
        n = self.window * self.window
        yw = self.norm1(x).index_select(1, idx).view(-1, n, c)
        o = self._attention(yw, mask).view(b, t, c).index_select(1, inv)
        x = x + o
        y = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="none"))
        return x + y


def _pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch PixelShuffle on NHWC (channel c*r*r + ry*r + rx)."""
    n, h, w, c4 = x.shape
    c = c4 // (r * r)
    x = x.reshape(n, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c)


class SwinIRModel(nn.Module):
    """SwinIR built from the port's flat params
    (``swinir_params_from_state_dict``) on an explicit device.

    forward: x (B, H, W, 3) float in [0, 1] -> (B, sH, sW, 3) float32; H
    and W are reflect-padded to window multiples and the output is cropped
    back after upsampling (the official ``check_image_size``)."""

    def __init__(self, cfg: SwinIRConfig, params: Mapping[str, torch.Tensor],
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.convs = nn.ModuleDict({
            name.replace(".", "_"): Conv3x3(params[f"{name}.weight"],
                                            params[f"{name}.bias"], dtype,
                                            device)
            for name in _conv_names(cfg)})
        ws = cfg.window_size
        self.layers = nn.ModuleList(
            nn.ModuleList(_STL(params, f"layers.{li}.residual_group.blocks."
                               f"{bi}", cfg.num_heads[li], ws,
                               0 if bi % 2 == 0 else ws // 2, dtype, device)
                          for bi in range(depth))
            for li, depth in enumerate(cfg.depths))
        self.norm = _LayerNorm(params, "norm", device)
        mean = _RGB_MEAN if cfg.in_ch == 3 else (0.0,) * cfg.in_ch
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32,
                                                  device=device))
        self.device = torch.device(device)
        self._grids: dict[tuple[int, int], tuple] = {}

    def _apply(self, fn, recurse=True):
        # .to() / .cuda(): the device and the grid tables follow the buffers
        super()._apply(fn, recurse)
        self.device = self.mean.device
        self._grids = {}
        return self

    def _grid(self, hp: int, wp: int) -> tuple:
        """Per padded size, on the device, made once: the window gathers
        and their inverses without and with the shift, and the shift
        mask."""
        if (hp, wp) not in self._grids:
            ws = self.cfg.window_size
            tables = []
            for shift in (0, ws // 2):
                idx = window_index(hp, wp, ws, shift)
                tables += [idx, torch.argsort(idx)]
            tables.append(shift_attn_mask(hp, wp, ws, ws // 2))
            self._grids[(hp, wp)] = tuple(t.to(self.device) for t in tables)
        return self._grids[(hp, wp)]

    def _conv(self, name, x, lrelu=False, plain=False):
        return self.convs[name.replace(".", "_")](x.to(self.dtype),
                                                  lrelu=lrelu, plain=plain)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """plain=True runs K1's plain version instead (the reference a
        kernel run is held against on the card)."""
        cfg, p = self.cfg, plain
        b, h, w, _ = x.shape
        ws = cfg.window_size
        ph, pw = (-h) % ws, (-w) % ws
        if ph or pw:
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                      mode="reflect").permute(0, 2, 3, 1)
        hp, wp = h + ph, w + pw
        idx0, inv0, idx1, inv1, mask = self._grid(hp, wp)
        x = (x.float() - self.mean) * cfg.img_range

        # adds of two compute-dtype tensors round once from f32 (_STL)
        feat = self._conv("conv_first", x, plain=p)
        body = feat
        for li, blocks in enumerate(self.layers):
            tokens = body.view(b, hp * wp, -1)
            for stl in blocks:
                tokens = (stl(tokens, idx1, inv1, mask) if stl.shift
                          else stl(tokens, idx0, inv0, None))
            body = self._conv(f"layers.{li}.conv", tokens.view(body.shape),
                              plain=p) + body
        body = self.norm(body)
        feat = feat + self._conv("conv_after_body", body, plain=p)

        y = self._conv("conv_before_upsample.0", feat, lrelu=True, plain=p)
        if cfg.upsampler == "pixelshuffle":
            for k in range(int(math.log2(cfg.scale))):
                y = _pixel_shuffle(self._conv(f"upsample.{2 * k}", y,
                                              plain=p), 2)
        else:
            y = self._conv("conv_up1", nearest_x2(y), lrelu=True, plain=p)
            y = self._conv("conv_up2", nearest_x2(y), lrelu=True, plain=p)
            y = self._conv("conv_hr", y, lrelu=True, plain=p)
        out = self._conv("conv_last", y, plain=p)
        out = out.float() / cfg.img_range + self.mean
        return out[:, :h * cfg.scale, :w * cfg.scale, :]

    @torch.no_grad()
    def upscale_batch(self, tiles_u8: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 RGB -> (N, sH, sW, 3) uint8 RGB: /255, the
        forward, then clip(y * 255) truncated to uint8."""
        y = self(tiles_u8.to(self.device).float() / 255.0)
        return torch.clamp(y * 255.0, 0.0, 255.0).to(torch.uint8)


def load_swinir(path: str | None = None, compute_dtype: str = "bfloat16",
                device: str | torch.device = "cuda",
                cfg: SwinIRConfig | None = None) -> SwinIRModel:
    """Load an official SwinIR checkpoint (``.pth``, wrapped in
    ``params_ema`` / ``params`` or flat, or ``.safetensors``); without
    ``cfg`` the architecture is inferred from the state dict."""
    if path is None:
        from neural_enhanced_super_resolution_torch.utils.downloader import (
            get_model_path)
        path = get_model_path("swinir")
    if not os.path.exists(path):
        raise FileNotFoundError(f"SwinIR checkpoint not found at {path}")
    params = swinir_params_from_state_dict(load_state_dict(path))
    if cfg is None:
        cfg = infer_swinir_config(params)
    return SwinIRModel(cfg, params, torch_dtype(compute_dtype),
                       device).eval()
