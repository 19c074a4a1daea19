"""K3: flash attention (non-causal, unmasked) and the attention dispatcher.

``flash_attention`` launches the hand-written Hopper kernel
(``csrc/flash_attn.cu``) on a bf16 CUDA tensor, its float32 form
``flash_attention_f32`` (``csrc/flash_attn_f32.cu``, the parity mode's) on a
float32 one, and takes the plain PyTorch version ``flash_attention_plain``
only for a tensor on the CPU. It replaces
the JAX package's Pallas ``kernels/attention.py:flash_attention`` (both of
its lowerings, ``_flash_kernel`` and ``_flash_kernel_kvgrid``).

``attention_auto`` is the diffusion stack's self-attention entry: packed
heads (B, S, H*d) in, float32 out. Unlike the JAX package, which gates the
kernel on a TPU-measured minimum length of 1024 tokens, every unmasked call
goes to ``flash_attention``; a masked call (only CLIP's causal tower) takes
the plain ``layers.attention``, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)

__all__ = ["flash_attention", "flash_attention_f32", "flash_attention_plain",
           "attention_auto", "flash_f32_splits", "F32_TILES"]

MAX_HEAD_DIM = 512  # the kernel's widest head dim (csrc/flash_attn.cu)

# K3f's instantiations (csrc/flash_attn_f32.cu, Pick<DP>): head dim padded
# to DP -> (query rows a block BQ, keys a tile BK). The kernel refuses a
# launch whose BQ and BK are not its own.
F32_TILES = {32: (64, 32), 64: (64, 32), 128: (64, 32), 256: (64, 128),
             512: (32, 256)}


def _f32_tiles(d: int) -> tuple[int, int]:
    return F32_TILES[next(p for p in sorted(F32_TILES) if p >= d)]


def flash_f32_splits(sq: int, skv: int, bh: int, d: int,
                     sms: int = 132) -> tuple[int, int]:
    """K3f's key-range split: (splits, keys a split), from the (BQ, BK) of
    ``F32_TILES``.

    The query blocks (``bh`` x ceil(Sq / BQ)) run alone when there is one
    for each of the ``sms`` SMs; with fewer, the keys are split into
    2 sms / blocks ranges of whole BK-key tiles (at most one a tile), so the
    card gets about two waves. Every split starts below Skv, so each holds
    a real key."""
    bq, bk = _f32_tiles(d)
    qblocks = bh * -(-sq // bq)
    ntiles = -(-skv // bk)
    want = 1 if qblocks >= sms else min(ntiles, (2 * sms) // qblocks)
    per = -(-ntiles // want)
    return -(-ntiles // per), per * bk


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The plain version: the kernel's math over one KV block.

    Operands rounded to ``q.dtype``, scores in fp32 scaled by 1/sqrt(d),
    unnormalised P = exp(S - max) rounded to ``q.dtype`` for P v with fp32
    accumulation, l summed from the fp32 P, output (P v) / l in
    ``q.dtype``."""
    flash_attention_plain.calls += 1
    if q.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    dt = q.dtype
    s = torch.matmul(q.float(), k.to(dt).float().transpose(-1, -2))
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(dt).float(), v.to(dt).float()) / l
    return out.to(dt)


flash_attention_plain.calls = 0


def _check(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.dtype != torch.bfloat16:
        raise KernelInputError(f"flash_attention: {name} must be bf16, got "
                               f"{t.dtype}")
    if t.device != dev:
        raise KernelInputError(f"flash_attention: {name} on {t.device}, "
                               f"q on {dev}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise KernelInputError(
            f"flash_attention: {name} needs a contiguous head dim and batch,"
            f" head and sequence strides that are multiples of 8, got "
            f"{t.stride()}")
    if t.data_ptr() % 16:
        raise KernelInputError(f"flash_attention: {name} is not 16-byte "
                               "aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v, (B, H, Sq, d) x (B, H, Skv, d) ->
    (B, H, Sq, d); Sq may differ from Skv.

    On the GPU: bf16 operands on one device, d a multiple of 8 up to 512,
    the last dim contiguous and the other strides multiples of 8 (so
    transposed views of packed projections go in without a copy). The
    output takes q's layout. A float32 q goes to ``flash_attention_f32``.
    Anything else raises ``KernelInputError``.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if not q.is_cuda:
        raise KernelInputError(f"flash_attention: no kernel for device "
                               f"{q.device}")
    if q.dtype == torch.float32:
        return flash_attention_f32(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise KernelInputError(f"flash_attention: bad shapes q "
                               f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                               f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise KernelInputError(f"flash_attention: q {tuple(q.shape)} and k "
                               f"{tuple(k.shape)} do not match")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM or min(b, h, sq, skv) < 1:
        raise KernelInputError(f"flash_attention: unsupported shape q "
                               f"{tuple(q.shape)}, Skv {skv}")
    if b * h > 65535:
        raise KernelInputError(f"flash_attention: {b * h} (batch, head) "
                               "pairs, at most 65535")
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check(name, t, q.device)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.nesr_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, skv, d, strides, 1.0 / math.sqrt(d),
            _build.stream_ptr())
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """K3's float32 form: the same attention, all in float32.

    On the GPU: float32 operands on one device, d a multiple of 4 up to
    512, the last dim contiguous and the other strides multiples of 4. The
    output takes q's layout. Where ``flash_f32_splits`` splits the keys,
    the kernel writes each split's share to scratch made here and its
    merge kernel combines them (one launch counted). On the CPU:
    ``flash_attention_plain``. Anything else raises ``KernelInputError``.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if not q.is_cuda:
        raise KernelInputError(f"flash_attention_f32: no kernel for device "
                               f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise KernelInputError(f"flash_attention_f32: bad shapes q "
                               f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                               f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise KernelInputError(f"flash_attention_f32: q {tuple(q.shape)} "
                               f"and k {tuple(k.shape)} do not match")
    if d % 4 or not 4 <= d <= MAX_HEAD_DIM or min(b, h, sq, skv) < 1:
        raise KernelInputError(f"flash_attention_f32: unsupported shape q "
                               f"{tuple(q.shape)}, Skv {skv}")
    if b * h > 65535:
        raise KernelInputError(f"flash_attention_f32: {b * h} (batch, head)"
                               " pairs, at most 65535")
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise KernelInputError(f"flash_attention_f32: {name} must be "
                                   f"float32 on {q.device}")
        if (t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise KernelInputError(
                f"flash_attention_f32: {name} needs a contiguous head dim, "
                "batch, head and sequence strides that are multiples of 4 "
                f"and 16-byte alignment, got {t.stride()}")
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    nsplit, kps = flash_f32_splits(
        sq, skv, b * h, d,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    bq, bk = _f32_tiles(d)
    part = ml = None
    if nsplit > 1:
        # each split's unnormalised output (nsplit, B*H, Sq, d), then its
        # (m, l) a row (nsplit, B*H, Sq, 2), in one buffer
        rows = nsplit * b * h * sq
        scratch = torch.empty(rows * (d + 2), dtype=torch.float32,
                              device=q.device)
        part, ml = scratch.data_ptr(), scratch.data_ptr() + rows * d * 4
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.nesr_flash_attn_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part,
            ml, b, h, sq, skv, d, strides, 1.0 / math.sqrt(d), nsplit, kps,
            bq, bk, _build.stream_ptr())
    _build.check("flash_attention_f32", err)
    flash_attention_f32.launches += 1
    return out


flash_attention_f32.launches = 0


def attention_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int, mask: torch.Tensor | None = None,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Multi-head attention over packed heads (B, Sq, D) x (B, Skv, D).

    Unmasked: casts to ``dtype`` and runs ``flash_attention`` on
    (B, H, S, d) views of the packed tensors (no transpose copies); the
    output is float32 (B, Sq, D). Masked: the plain ``layers.attention``.
    """
    from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
        attention)

    if mask is not None:
        return attention(q, k, v, num_heads, mask=mask, dtype=dtype)
    b, sq, dm = q.shape
    hd = dm // num_heads

    def heads(t):
        return t.to(dtype).reshape(b, t.shape[1], num_heads, hd).transpose(1, 2)

    out = flash_attention(heads(q), heads(k), heads(v))
    return out.transpose(1, 2).reshape(b, sq, dm).float()
