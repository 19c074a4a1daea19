"""The request's networks in plain PyTorch, float32, on a state dict.

Written from the published architectures, independently of the program:

* RRDBNet (Real-ESRGAN / basicsr): dense blocks of five 3x3 convs with
  LeakyReLU(0.2), x + 0.2 x5; RRDB = three of them, x + 0.2 rdb3; conv
  body residual; two nearest x2 upsamplings with convs; conv_hr, conv_last.
* SegFormer (Hugging Face ``SegformerForSemanticSegmentation``): overlap
  patch embeddings, spatial-reduction attention, Mix-FFN with exact GELU,
  the all-MLP decode head with inference BatchNorm.
* The SD x4 upscaler (diffusers ``UNet2DConditionModel`` with linear
  projections, ``AutoencoderKL``'s decoder, transformers' ``CLIPTextModel``)
  and the DDIM / DDPM step rules, after ``tests/torch_twin.py``.

The UNet follows two keys of its configuration: ``only_cross_attention``
(diffusers': a block's ``attn1`` attends to the text instead of itself)
and ``geglu_approximate`` (GELU's form in the GEGLU: "none", diffusers'
exact form, or "tanh"). Attention is computed in blocks
of queries (exact softmax per block), so the VAE's 150k-token attention
fits.

``PRECISION`` switches every conv, linear and attention product to
operands rounded to float8 e4m3 with a per-tensor scale: the control that
has to fail the comparison (the nearest precision below the bf16 the
configurations state).
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch
import torch.nn.functional as F

PRECISION = {"mode": "float32"}
_E4M3_MAX = 448.0
_Q_BLOCK = 2048          # queries per attention block


def set_precision(mode: str) -> None:
    if mode not in ("float32", "fp8"):
        raise ValueError(f"unknown reference precision {mode!r}")
    PRECISION["mode"] = mode


def _q(t: torch.Tensor) -> torch.Tensor:
    """An operand as the reference computes with it: float32, or rounded
    to float8 e4m3 under one per-tensor scale (the control)."""
    t = t.float()
    if PRECISION["mode"] == "float32":
        return t
    scale = t.abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def conv(x, w, b=None, stride=1, padding=1, groups=1):
    return F.conv2d(_q(x), _q(w), None if b is None else b.float(), stride,
                    padding, 1, groups)


def lin(x, w, b=None):
    return F.linear(_q(x), _q(w), None if b is None else b.float())


def attention(q, k, v, heads: int, mask=None):
    """(B, Sq, D) x (B, Skv, D) -> (B, Sq, D): softmax(q k^T / sqrt(d) +
    mask) v, exact, in blocks of queries."""
    b, sq, dm = q.shape
    d = dm // heads

    def split(t):
        return _q(t).reshape(b, t.shape[1], heads, d).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    out = torch.empty_like(qh)
    for s in range(0, sq, _Q_BLOCK):
        sc = qh[:, :, s:s + _Q_BLOCK] @ kh.transpose(-1, -2) / math.sqrt(d)
        if mask is not None:
            sc = sc + mask[..., s:s + _Q_BLOCK, :]
        out[:, :, s:s + _Q_BLOCK] = _q(torch.softmax(sc, dim=-1)) @ vh
        del sc
    return out.transpose(1, 2).reshape(b, sq, dm)


# ---------------------------------------------------------------- RRDBNet --

def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _c(sd, name, x, padding=1):
    return conv(x, sd[f"{name}.weight"], sd[f"{name}.bias"],
                padding=padding)


def _rdb(sd, name, x):
    feats = [x]
    for i in range(1, 5):
        feats.append(_lrelu(_c(sd, f"{name}.conv{i}", torch.cat(feats, 1))))
    return x + 0.2 * _c(sd, f"{name}.conv5", torch.cat(feats, 1))


def rrdbnet(sd, x: torch.Tensor, num_block: int) -> torch.Tensor:
    """x (N, H, W, C) float in [0, 1] -> (N, 4H, 4W, 3) float32 (x4)."""
    feat = _c(sd, "conv_first", x.permute(0, 3, 1, 2).float())
    body = feat
    for i in range(num_block):
        y = body
        for r in ("rdb1", "rdb2", "rdb3"):
            y = _rdb(sd, f"body.{i}.{r}", y)
        body = body + 0.2 * y
    feat = feat + _c(sd, "conv_body", body)
    for up in ("conv_up1", "conv_up2"):
        feat = _lrelu(_c(sd, up, F.interpolate(feat, scale_factor=2,
                                               mode="nearest")))
    out = _c(sd, "conv_last", _lrelu(_c(sd, "conv_hr", feat)))
    return out.permute(0, 2, 3, 1)


# -------------------------------------------------------------- SegFormer --

def _ln(x, sd, name, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"],
                        sd[f"{name}.bias"], eps)


def segformer_logits(sd, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalised (N, H, W, 3) -> logits (N, H/4, W/4, labels)."""
    eps = cfg["layer_norm_eps"]
    n = x.shape[0]
    h_ = x.permute(0, 3, 1, 2).float()
    features = []
    for si in range(len(cfg["hidden_sizes"])):
        pe = f"segformer.encoder.patch_embeddings.{si}"
        k = cfg["patch_sizes"][si]
        h_ = conv(h_, sd[f"{pe}.proj.weight"], sd[f"{pe}.proj.bias"],
                  cfg["strides"][si], k // 2)
        _, c, hh, ww = h_.shape
        seq = _ln(h_.flatten(2).transpose(1, 2), sd, f"{pe}.layer_norm", eps)
        sr = cfg["sr_ratios"][si]
        heads = cfg["num_attention_heads"][si]
        for li in range(cfg["depths"][si]):
            p = f"segformer.encoder.block.{si}.{li}"
            a = f"{p}.attention.self"
            hn = _ln(seq, sd, f"{p}.layer_norm_1", eps)
            red = hn
            if sr > 1:
                red = conv(hn.transpose(1, 2).reshape(n, c, hh, ww),
                           sd[f"{a}.sr.weight"], sd[f"{a}.sr.bias"], sr, 0)
                red = _ln(red.flatten(2).transpose(1, 2), sd,
                          f"{a}.layer_norm", eps)
            att = attention(lin(hn, sd[f"{a}.query.weight"],
                                sd[f"{a}.query.bias"]),
                            lin(red, sd[f"{a}.key.weight"],
                                sd[f"{a}.key.bias"]),
                            lin(red, sd[f"{a}.value.weight"],
                                sd[f"{a}.value.bias"]), heads)
            seq = seq + lin(att, sd[f"{p}.attention.output.dense.weight"],
                            sd[f"{p}.attention.output.dense.bias"])
            hn = lin(_ln(seq, sd, f"{p}.layer_norm_2", eps),
                     sd[f"{p}.mlp.dense1.weight"], sd[f"{p}.mlp.dense1.bias"])
            m = hn.shape[-1]
            hn = conv(hn.transpose(1, 2).reshape(n, m, hh, ww),
                      sd[f"{p}.mlp.dwconv.dwconv.weight"],
                      sd[f"{p}.mlp.dwconv.dwconv.bias"], 1, 1, groups=m)
            hn = F.gelu(hn.flatten(2).transpose(1, 2))
            seq = seq + lin(hn, sd[f"{p}.mlp.dense2.weight"],
                            sd[f"{p}.mlp.dense2.bias"])
        seq = _ln(seq, sd, f"segformer.encoder.layer_norm.{si}", eps)
        h_ = seq.transpose(1, 2).reshape(n, c, hh, ww)
        features.append(h_)
    th, tw = features[0].shape[2:]
    proj = []
    for si, f in enumerate(features):
        p = lin(f.flatten(2).transpose(1, 2),
                sd[f"decode_head.linear_c.{si}.proj.weight"],
                sd[f"decode_head.linear_c.{si}.proj.bias"])
        p = p.transpose(1, 2).reshape(n, -1, *f.shape[2:])
        if p.shape[2:] != (th, tw):
            p = F.interpolate(p, size=(th, tw), mode="bilinear",
                              align_corners=False)
        proj.append(p)
    fused = conv(torch.cat(proj[::-1], 1), sd["decode_head.linear_fuse.weight"],
                 None, 1, 0)
    bn = "decode_head.batch_norm"
    fused = ((fused - sd[f"{bn}.running_mean"][:, None, None])
             * torch.rsqrt(sd[f"{bn}.running_var"][:, None, None] + 1e-5)
             * sd[f"{bn}.weight"][:, None, None] + sd[f"{bn}.bias"][:, None,
                                                                   None])
    out = conv(torch.relu(fused), sd["decode_head.classifier.weight"],
               sd["decode_head.classifier.bias"], 1, 0)
    return out.permute(0, 2, 3, 1)


# -------------------------------------------------------- CLIP text tower --

def tokenize(text: str, length: int = 77) -> list[int]:
    """CLIP's framing with the system's tokenizer-less fallback: word
    hashes (crc32 % 49000) between bos and eos, padded with eos."""
    bos, eos = 49406, 49407
    ids = [bos] + [zlib.crc32(w.encode()) % 49000
                   for w in text.lower().split()][:75] + [eos]
    return ids + [eos] * (length - len(ids))


def clip_text(sd, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """(N, S) token ids -> last hidden state (N, S, hidden), causal."""
    tm = "text_model"
    s = ids.shape[1]
    ids = ids.clamp(0, cfg["vocab_size"] - 1)
    x = (sd[f"{tm}.embeddings.token_embedding.weight"][ids].float()
         + sd[f"{tm}.embeddings.position_embedding.weight"][:s].float())
    ar = torch.arange(s, device=x.device)
    causal = torch.zeros((s, s), device=x.device).masked_fill(
        ar[None, :] > ar[:, None], float("-inf"))
    eps = cfg["layer_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"{tm}.encoder.layers.{i}"
        h = _ln(x, sd, f"{p}.layer_norm1", eps)
        a = f"{p}.self_attn"
        h = attention(lin(h, sd[f"{a}.q_proj.weight"], sd[f"{a}.q_proj.bias"]),
                      lin(h, sd[f"{a}.k_proj.weight"], sd[f"{a}.k_proj.bias"]),
                      lin(h, sd[f"{a}.v_proj.weight"], sd[f"{a}.v_proj.bias"]),
                      cfg["num_attention_heads"], causal)
        x = x + lin(h, sd[f"{a}.out_proj.weight"], sd[f"{a}.out_proj.bias"])
        h = _ln(x, sd, f"{p}.layer_norm2", eps)
        h = F.gelu(lin(h, sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"]))
        x = x + lin(h, sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"])
    return _ln(x, sd, f"{tm}.final_layer_norm", eps)


# --------------------------------------------------------- UNet, VAE (NCHW) --

def _gn(sd, name, x, groups, eps=1e-5):
    return F.group_norm(x.float(), groups, sd[f"{name}.weight"].float(),
                        sd[f"{name}.bias"].float(), eps=eps)


def _resnet(sd, name, x, temb, groups, eps=1e-5):
    h = _c(sd, f"{name}.conv1", F.silu(_gn(sd, f"{name}.norm1", x, groups,
                                           eps)))
    if temb is not None:
        h = h + lin(F.silu(temb), sd[f"{name}.time_emb_proj.weight"],
                    sd[f"{name}.time_emb_proj.bias"])[:, :, None, None]
    h = _c(sd, f"{name}.conv2", F.silu(_gn(sd, f"{name}.norm2", h, groups,
                                           eps)))
    if f"{name}.conv_shortcut.weight" in sd:
        x = _c(sd, f"{name}.conv_shortcut", x, padding=0)
    return x + h


def _mha(sd, name, x, ctx, heads):
    def proj(p, t):   # the UNet's q, k, v have no bias; the VAE's have
        return lin(t, sd[f"{name}.{p}.weight"], sd.get(f"{name}.{p}.bias"))

    return lin(attention(proj("to_q", x), proj("to_k", ctx),
                         proj("to_v", ctx), heads),
               sd[f"{name}.to_out.0.weight"], sd[f"{name}.to_out.0.bias"])


def _transformer(sd, name, x, ctx, heads, groups, only_cross=False,
                 approximate="none"):
    b, c, h, w = x.shape
    y = _gn(sd, f"{name}.norm", x, groups, eps=1e-6)
    y = lin(y.permute(0, 2, 3, 1).reshape(b, h * w, c),
            sd[f"{name}.proj_in.weight"], sd[f"{name}.proj_in.bias"])
    t = f"{name}.transformer_blocks.0"
    q = _ln(y, sd, f"{t}.norm1", 1e-5)
    y = y + _mha(sd, f"{t}.attn1", q, ctx if only_cross else q, heads)
    y = y + _mha(sd, f"{t}.attn2", _ln(y, sd, f"{t}.norm2", 1e-5), ctx, heads)
    hidden, gate = lin(_ln(y, sd, f"{t}.norm3", 1e-5),
                       sd[f"{t}.ff.net.0.proj.weight"],
                       sd[f"{t}.ff.net.0.proj.bias"]).chunk(2, dim=-1)
    y = y + lin(hidden * F.gelu(gate, approximate=approximate),
                sd[f"{t}.ff.net.2.weight"], sd[f"{t}.ff.net.2.bias"])
    y = lin(y, sd[f"{name}.proj_out.weight"], sd[f"{name}.proj_out.bias"])
    return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def unet(sd, cfg: dict, sample, timestep: int, ctx, class_labels):
    """sample (N, Cin, H, W) -> eps (N, Cout, H, W); ctx (N, 77, D)."""
    groups = cfg["norm_num_groups"]
    chans = cfg["block_out_channels"]
    heads = cfg["attention_head_dim"]
    heads = [heads] * len(chans) if isinstance(heads, int) else list(heads)
    L = cfg["layers_per_block"]
    only = cfg.get("only_cross_attention", False)
    only = [only] * len(chans) if isinstance(only, bool) else list(only)
    gelu = cfg.get("geglu_approximate", "none")
    t = torch.full((sample.shape[0],), timestep, device=sample.device)
    temb = lin(_timestep_embedding(t, chans[0]),
               sd["time_embedding.linear_1.weight"],
               sd["time_embedding.linear_1.bias"])
    temb = lin(F.silu(temb), sd["time_embedding.linear_2.weight"],
               sd["time_embedding.linear_2.bias"])
    temb = temb + sd["class_embedding.weight"][class_labels].float()
    x = _c(sd, "conv_in", sample.float())
    skips = [x]
    for bi, btype in enumerate(cfg["down_block_types"]):
        bname = f"down_blocks.{bi}"
        for li in range(L):
            x = _resnet(sd, f"{bname}.resnets.{li}", x, temb, groups)
            if btype == "CrossAttnDownBlock2D":
                x = _transformer(sd, f"{bname}.attentions.{li}", x, ctx,
                                 heads[bi], groups, only[bi], gelu)
            skips.append(x)
        if bi < len(chans) - 1:
            w_ = sd[f"{bname}.downsamplers.0.conv.weight"]
            x = conv(x, w_, sd[f"{bname}.downsamplers.0.conv.bias"], 2, 1)
            skips.append(x)
    x = _resnet(sd, "mid_block.resnets.0", x, temb, groups)
    x = _transformer(sd, "mid_block.attentions.0", x, ctx, heads[-1], groups,
                     only[-1], gelu)
    x = _resnet(sd, "mid_block.resnets.1", x, temb, groups)
    for ui, btype in enumerate(cfg["up_block_types"]):
        bname = f"up_blocks.{ui}"
        bi = len(chans) - 1 - ui
        for li in range(L + 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = _resnet(sd, f"{bname}.resnets.{li}", x, temb, groups)
            if btype == "CrossAttnUpBlock2D":
                x = _transformer(sd, f"{bname}.attentions.{li}", x, ctx,
                                 heads[bi], groups, only[bi], gelu)
        if ui < len(chans) - 1:
            x = _c(sd, f"{bname}.upsamplers.0.conv",
                   F.interpolate(x, scale_factor=2, mode="nearest"))
    x = _gn(sd, "conv_norm_out", x, groups)
    return _c(sd, "conv_out", F.silu(x))


def vae_decode(sd, cfg: dict, latents: torch.Tensor) -> torch.Tensor:
    """latents (N, 4, H, W), already divided by the scaling factor ->
    (N, 3, 8H/2^(3-levels)..., ) in [-1, 1] (x4 for three levels)."""
    groups = cfg["norm_num_groups"]

    def resnet(name, x):
        return _resnet(sd, name, x, None, groups, 1e-6)

    x = conv(latents, sd["post_quant_conv.weight"], sd["post_quant_conv.bias"],
             1, 0)
    x = _c(sd, "decoder.conv_in", x)
    x = resnet("decoder.mid_block.resnets.0", x)
    name = "decoder.mid_block.attentions.0"
    b, c, h, w = x.shape
    y = _gn(sd, f"{name}.group_norm", x, groups, 1e-6)
    y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
    y = _mha(sd, name, y, y, 1)
    x = y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
    x = resnet("decoder.mid_block.resnets.1", x)
    levels = len(cfg["block_out_channels"])
    for ui in range(levels):
        bname = f"decoder.up_blocks.{ui}"
        for li in range(cfg["layers_per_block"] + 1):
            x = resnet(f"{bname}.resnets.{li}", x)
        if ui < levels - 1:
            x = _c(sd, f"{bname}.upsamplers.0.conv",
                   F.interpolate(x, scale_factor=2, mode="nearest"))
    x = _gn(sd, "decoder.conv_norm_out", x, groups, 1e-6)
    return _c(sd, "decoder.conv_out", F.silu(x))


class Scheduler:
    """DDIM (eta 0) and DDPM step rules as published, in float64 numpy
    constants: scaled-linear betas, leading timesteps, epsilon or v
    prediction (diffusers' ``prediction_type``), ``set_alpha_to_one``."""

    def __init__(self, num_train_timesteps=1000, beta_start=1e-4,
                 beta_end=0.02, steps_offset=0, set_alpha_to_one=True,
                 prediction_type="epsilon", **_):
        if prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(f"prediction_type {prediction_type!r}")
        self.v = prediction_type == "v_prediction"
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps) ** 2
        self.acp = np.cumprod(1.0 - betas)
        self.final = 1.0 if set_alpha_to_one else float(self.acp[0])
        self.T = num_train_timesteps
        self.offset = steps_offset

    def timesteps(self, n: int) -> list[int]:
        step = self.T // n
        return [int(t) + self.offset
                for t in (np.arange(n) * step).round()[::-1]]

    def ddim_step(self, out, t: int, prev_t: int, x):
        """x at prev_t from the model's output ``out`` (eps, or v) at t."""
        ab = float(self.acp[t])
        abp = float(self.acp[prev_t]) if prev_t >= 0 else self.final
        if self.v:
            x0 = math.sqrt(ab) * x - math.sqrt(1 - ab) * out
            eps = math.sqrt(ab) * out + math.sqrt(1 - ab) * x
        else:
            x0, eps = (x - math.sqrt(1 - ab) * out) / math.sqrt(ab), out
        return math.sqrt(abp) * x0 + math.sqrt(1 - abp) * eps

    def add_noise(self, x, noise, t: int):
        ab = float(self.acp[t])
        return math.sqrt(ab) * x + math.sqrt(1 - ab) * noise
