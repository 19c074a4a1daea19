"""K4: SAME 3x3 conv of int8 NHWC activations with int8 weights, int32
accumulation and a per-output-channel dequantisation to bf16.

``conv3x3_int8`` launches the hand-written Hopper kernel
(``csrc/conv3x3_int8.cu``) on a CUDA tensor and takes the plain PyTorch
version ``conv3x3_int8_plain`` only for a tensor on the CPU. It replaces
``conv_q`` of the JAX package's int8 trunk
(``models/rrdbnet.py:_rdb_fused_int8``), which is XLA's int8
``lax.conv_general_dilated`` with int32 accumulation, not a Pallas kernel:

    y = bf16(float32(conv_int32(q, wq)) * ((s_x / 127) * w_s[co]))

in that order (the scale vector first, then one multiply, then one
round-to-nearest-even cast). The accumulation is exact, so the kernel and
the plain version agree bit for bit. Layout: NHWC activations, HWIO
weights (3, 3, Cin, Cout), as in the JAX package.

The int8 trunk runs K4's redesign instead, ``conv3x3_int8_rdb``
(``csrc/rdb_int8.cu``): one launch a conv of an RDB that quantises its
float input in the patch load and does that conv's share of
``_rdb_fused_int8``'s float32 assembly in its epilogue, with the scale of
each source produced on the device (``int8_amax`` starts the chain).
``conv3x3_int8_rdb_plain`` is ``quantize_int8`` -> ``conv3x3_int8_plain``
-> that step's slice of the assembly, in PyTorch; the two agree bit for
bit. ``conv3x3_int8`` stays a standalone entry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    tile_width)

__all__ = ["conv3x3_int8", "conv3x3_int8_plain", "conv3x3_int8_rdb",
           "conv3x3_int8_rdb_plain", "int8_amax", "int8_amax_plain",
           "block_amax", "rdb_growth", "pack_conv3x3_int8_weights",
           "pass_width_int8", "packed_int8_numel", "quantize_int8",
           "STEP_TILE"]

# The step kernel's output tile (rows, columns): a block takes the max of
# what its two workers write over their tiles, then one atomicMax joins
# the blocks.
STEP_TILE = (4, 16)


def pass_width_int8(cin: int) -> int:
    """Input channels the kernel takes a pass: 32 (one k-step of the 8-bit
    ``wgmma``) as Cin is at most 32, else 64. Cin is zero-padded to a whole
    number of passes."""
    return 32 if cin <= 32 else 64


def _padded_cin(cin: int) -> int:
    kc = pass_width_int8(cin)
    return -(-cin // kc) * kc


def packed_int8_numel(cin: int, cout: int) -> int:
    """Bytes in ``pack_conv3x3_int8_weights`` of a (3, 3, cin, cout)
    weight."""
    nw, tiles = tile_width(cout)
    return tiles * 9 * _padded_cin(cin) * nw


def pack_conv3x3_int8_weights(wq: torch.Tensor) -> torch.Tensor:
    """HWIO int8 weights (3, 3, Cin, Cout) -> the kernel's flat int8 image.

    With N, tiles = ``tile_width(Cout)`` (K1's N tiles), kc =
    ``pass_width_int8(Cin)`` and Kp = Cin rounded up to kc, the buffer holds
    tiles x 9 x Kp x N bytes, zero past Cin and Cout. Per N tile, slab i =
    (pass i // 9, tap i % 9, tap = 3 ky + kx) is kc x N contiguous bytes at
    i * kc * N: one bulk copy. In a slab the 32-channel k-steps s follow
    each other (32 N bytes each), and a k-step is N/8 x 2 core matrices of
    8 rows x 16 bytes, core (j, h) at (2j + h) * 128 holding output
    channels 8j + r (row r) by input channels 32s + 16h + k (byte k). That
    is B of the 8-bit ``wgmma`` K-major with no swizzle: leading (K) byte
    offset 128, stride (N) byte offset 256, the byte layout of K1's bf16
    slabs.
    """
    _, _, cin, cout = wq.shape
    nw, tiles = tile_width(cout)
    kc, kp = pass_width_int8(cin), _padded_cin(cin)
    wz = torch.zeros((3, 3, kp, tiles * nw), dtype=torch.int8,
                     device=wq.device)
    wz[:, :, :cin, :cout] = wq
    s = wz.reshape(9, kp // kc, kc // 32, 2, 16, tiles, nw // 8, 8)
    # (tap, pass, step, h, k, tile, j, r) -> (tile, pass, tap, step, j, h, r, k)
    return s.permute(5, 1, 0, 2, 6, 3, 7, 4).reshape(-1).contiguous()


# One IEEE division each, a 0-d tensor by a 0-d tensor: PyTorch turns
# ``tensor / python_scalar`` on CUDA into a multiply by the reciprocal, and
# ``python_scalar / tensor`` into reciprocal-then-multiply everywhere: two
# roundings where the JAX package has one.
def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    return torch.div(den.new_full((), num), den)


def _div_by(num: torch.Tensor, den: float) -> torch.Tensor:
    return torch.div(num, num.new_full((), den))


def quantize_int8(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric quantisation, as ``conv_q`` does it:
    s_x = max(max|h| over the whole tensor, 1e-8) and q = clip(round(h *
    (127 / s_x)), -127, 127) in float32 (round half to even). Returns (q
    int8, s_x as a 0-d float32 tensor on h's device: no host sync)."""
    hf = h.float()
    s_x = hf.abs().amax().clamp_min(1e-8)
    return _quantize(hf, s_x), s_x


def _quantize(hf: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """q = clip(round(hf * (127 / s_x)), -127, 127) as int8."""
    return torch.round(hf * _div(127.0, s_x)).clamp_(-127, 127).to(
        torch.int8)


def _dequant_scale(s_x: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """The (Cout,) float32 scale ``(s_x / 127) * w_s``, in the JAX order."""
    return _div_by(s_x, 127.0) * w_s


def conv3x3_int8_plain(q: torch.Tensor, wq: torch.Tensor, s_x: torch.Tensor,
                       w_s: torch.Tensor) -> torch.Tensor:
    """The plain version: the int32 sum computed exactly as float64
    products of the integer values (every partial sum is an integer below
    2^53), one matrix product per tap, then the JAX package's epilogue in
    float32 and one cast to bf16."""
    conv3x3_int8_plain.calls += 1
    n, h, w, cin = q.shape
    xp = F.pad(q.to(torch.float64), (0, 0, 1, 1, 1, 1))
    w64 = wq.to(torch.float64)
    acc = torch.zeros((n * h * w, wq.shape[3]), dtype=torch.float64,
                      device=q.device)
    for ky in range(3):
        for kx in range(3):
            acc += xp[:, ky:ky + h, kx:kx + w, :].reshape(-1, cin) @ w64[ky, kx]
    y = acc.to(torch.float32) * _dequant_scale(s_x.float(), w_s.float())
    return y.to(torch.bfloat16).reshape(n, h, w, -1)


conv3x3_int8_plain.calls = 0


def conv3x3_int8(q: torch.Tensor, wq: torch.Tensor, s_x: torch.Tensor,
                 w_s: torch.Tensor,
                 packed: torch.Tensor | None = None) -> torch.Tensor:
    """SAME 3x3 conv of int8 q (N, H, W, Cin) with int8 wq (3, 3, Cin,
    Cout), dequantised by the 0-d float32 ``s_x`` and the (Cout,) float32
    ``w_s``. Returns (N, H, W, Cout) bf16.

    On the GPU: every tensor contiguous on q's device, q 16-byte aligned;
    ``packed`` is ``pack_conv3x3_int8_weights(wq)`` (made here when None).
    Anything else raises ``KernelInputError``.
    """
    if q.device.type == "cpu":
        return conv3x3_int8_plain(q, wq, s_x, w_s)
    if not q.is_cuda:
        raise KernelInputError(f"conv3x3_int8: no kernel for device "
                               f"{q.device}")
    if q.dim() != 4 or wq.shape[:2] != (3, 3) or wq.shape[2] != q.shape[3]:
        raise KernelInputError(f"conv3x3_int8: bad shapes q "
                               f"{tuple(q.shape)}, wq {tuple(wq.shape)}")
    if q.dtype != torch.int8 or wq.dtype != torch.int8:
        raise KernelInputError(f"conv3x3_int8: needs int8 q and wq, got "
                               f"{q.dtype}, {wq.dtype}")
    n, h, wd, cin = q.shape
    cout = wq.shape[3]
    if (s_x.dtype != torch.float32 or s_x.dim() != 0
            or w_s.dtype != torch.float32 or w_s.shape != (cout,)):
        raise KernelInputError(f"conv3x3_int8: s_x must be a 0-d and w_s a "
                               f"({cout},) float32 tensor")
    if any(t.device != q.device for t in (wq, s_x, w_s)):
        raise KernelInputError("conv3x3_int8: operands on different "
                               "devices")
    if not all(t.is_contiguous() for t in (q, wq, w_s)):
        raise KernelInputError("conv3x3_int8: q, wq and w_s must be "
                               "contiguous")
    if q.data_ptr() % 16:
        raise KernelInputError("conv3x3_int8: q must be 16-byte aligned")
    if n > 65535 or min(n, h, wd, cin, cout) < 1:
        raise KernelInputError(f"conv3x3_int8: unsupported shape "
                               f"{tuple(q.shape)}")
    if packed is None:
        packed = pack_conv3x3_int8_weights(wq)
    if (packed.dtype != torch.int8 or packed.device != q.device
            or not packed.is_contiguous() or packed.data_ptr() % 16
            or packed.numel() != packed_int8_numel(cin, cout)):
        raise KernelInputError("conv3x3_int8: packed is not "
                               "pack_conv3x3_int8_weights(wq) on the device")
    lib = _build.load_library()
    y = torch.empty((n, h, wd, cout), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.nesr_conv3x3_int8(
            q.data_ptr(), packed.data_ptr(), s_x.data_ptr(), w_s.data_ptr(),
            y.data_ptr(), n, h, wd, cin, cout, tile_width(cout)[0],
            _build.stream_ptr())
    _build.check("conv3x3_int8", err)
    conv3x3_int8.launches += 1
    return y


conv3x3_int8.launches = 0


# ---- K4's redesign: one conv of the int8 RDB a launch --------------------

def block_amax(t: torch.Tensor) -> torch.Tensor:
    """max|t| of an (N, H, W, C) tensor as the step kernel takes it: the max
    over each ``STEP_TILE`` output tile (all channels), then the max of
    those. A 0-d float32 tensor on t's device."""
    n, h, w, c = t.shape
    th, tw = STEP_TILE
    a = F.pad(t.float().abs(), (0, 0, 0, -w % tw, 0, -h % th))
    per = a.reshape(n, -(-h // th), th, -(-w // tw), tw, c).amax(
        dim=(2, 4, 5))
    return per.amax()


def int8_amax_plain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """The plain version of ``int8_amax``."""
    int8_amax_plain.calls += 1
    scales = torch.zeros(steps + 1, dtype=torch.float32, device=x.device)
    scales[0] = block_amax(x)
    return scales


int8_amax_plain.calls = 0


def int8_amax(x: torch.Tensor, steps: int) -> torch.Tensor:
    """The scale chain of ``steps`` steps of ``conv3x3_int8_rdb`` starting
    from x: a (steps + 1,) float32 tensor on x's device, 0 but for [0] =
    max|x|. Step i reads [i] (raw: it takes max(raw, 1e-8), the JAX
    package's floor) and raises [i + 1] to the max of what it writes. On
    the GPU one launch (after a memset of the chain); no host sync."""
    if x.device.type == "cpu":
        return int8_amax_plain(x, steps)
    if not x.is_cuda:
        raise KernelInputError(f"int8_amax: no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise KernelInputError(f"int8_amax: needs a contiguous bf16 or "
                               f"float32 tensor, got {x.dtype}")
    if steps < 1 or x.numel() < 1:
        raise KernelInputError("int8_amax: needs steps >= 1 and a "
                               "non-empty tensor")
    lib = _build.load_library()
    scales = torch.empty(steps + 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_int8_amax(
            x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(),
            int(x.data_ptr() % 16 == 0), scales.data_ptr(), steps + 1,
            _build.stream_ptr())
    _build.check("int8_amax", err)
    int8_amax.launches += 1
    return scales


int8_amax.launches = 0


def rdb_growth(k: int, cin: int, cs: int) -> tuple[int, int]:
    """(g, nf) of an RDB from step k's input width and the slot width
    cs = 4 g + nf: step 0 reads the nf-channel RDB input, steps 1..4 a
    g-channel x_k."""
    if k == 0:
        return (cs - cin) // 4, cin
    return cin, cs - 4 * cin


def conv3x3_int8_rdb_plain(k: int, src: torch.Tensor, s_src: torch.Tensor,
                           s_out: torch.Tensor, wq: torch.Tensor,
                           w_s: torch.Tensor, b: torch.Tensor,
                           slots: torch.Tensor,
                           x: torch.Tensor | None = None,
                           skip: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The plain version of ``conv3x3_int8_rdb``: the source quantised
    with s = max(s_src, 1e-8) (``quantize_int8``'s arithmetic), then
    ``conv3x3_int8_plain``, then step k's slice of ``_rdb_fused_int8``'s
    assembly with PyTorch's rounding points."""
    conv3x3_int8_rdb_plain.calls += 1
    s = s_src.float().clamp_min(1e-8)
    c = conv3x3_int8_plain(_quantize(src.float(), s), wq, s, w_s)
    g, _ = rdb_growth(k, src.shape[-1], slots.shape[-1])
    lo = k * g
    if k < 4:
        t = c[..., :g] if k == 0 else slots[..., lo:lo + g] + c[..., :g]
        y = F.leaky_relu(t + b[lo:lo + g], 0.2)
        if k == 0:
            slots[..., g:] = c[..., g:]
        else:
            slots[..., lo + g:] += c[..., g:]
    else:
        y = x + 0.2 * (slots[..., lo:] + c + b[lo:]).to(x.dtype)
        if skip is not None:
            y = skip + 0.2 * y
    s_out.copy_(torch.maximum(s_out, block_amax(y)))
    return y


conv3x3_int8_rdb_plain.calls = 0


def _check_step(k, src, s_src, s_out, wq, w_s, b, slots, x, skip, packed):
    name = "conv3x3_int8_rdb"
    if not 0 <= k <= 4:
        raise KernelInputError(f"{name}: step {k} is not 0..4")
    if src.dim() != 4 or slots.dim() != 4 or slots.shape[:3] != src.shape[:3]:
        raise KernelInputError(f"{name}: bad shapes src {tuple(src.shape)}, "
                               f"slots {tuple(slots.shape)}")
    cin, cs = src.shape[3], slots.shape[3]
    g, nf = rdb_growth(k, cin, cs)
    cout = cs - k * g
    if (g < 1 or nf < 1 or 4 * g + nf != cs or wq.shape != (3, 3, cin, cout)
            or wq.dtype != torch.int8):
        raise KernelInputError(f"{name}: step {k} of src {tuple(src.shape)}, "
                               f"slots width {cs} and wq {tuple(wq.shape)} "
                               f"{wq.dtype} is no int8 RDB conv")
    want = (torch.bfloat16, torch.float32) if k == 0 else (torch.float32,)
    if src.dtype not in want or slots.dtype != torch.bfloat16:
        raise KernelInputError(f"{name}: step {k} takes a {want} source and "
                               f"bf16 slots, got {src.dtype}, {slots.dtype}")
    if (w_s.dtype != torch.float32 or w_s.shape != (cout,)
            or b.dtype != torch.float32 or b.shape != (cs,)
            or any(t.dtype != torch.float32 or t.dim() != 0
                   for t in (s_src, s_out))):
        raise KernelInputError(f"{name}: w_s ({cout},), b ({cs},) and the "
                               "0-d scales must be float32")
    if (k == 4) != (x is not None) or (skip is not None and k != 4):
        raise KernelInputError(f"{name}: x (and skip) belong to step 4")
    extra = [t for t in (x, skip) if t is not None]
    if any(t.shape != (*src.shape[:3], nf) or t.dtype not in (
            torch.bfloat16, torch.float32) or t.dtype != extra[0].dtype
            for t in extra):
        raise KernelInputError(f"{name}: x and skip must be ({nf},)-channel "
                               "bf16 or float32 tensors of one dtype")
    ops = [src, wq, w_s, b, s_src, s_out, slots, packed, *extra]
    if any(t.device != src.device for t in ops):
        raise KernelInputError(f"{name}: operands on different devices")
    if not all(t.is_contiguous() for t in ops):
        raise KernelInputError(f"{name}: operands must be contiguous")
    if src.shape[0] > 65535 or min(src.shape[1:3]) < 1:
        raise KernelInputError(f"{name}: unsupported shape "
                               f"{tuple(src.shape)}")
    if (packed.dtype != torch.int8 or packed.data_ptr() % 16
            or packed.numel() != packed_int8_numel(cin, cout)):
        raise KernelInputError(f"{name}: packed is not "
                               "pack_conv3x3_int8_weights(wq) on the device")
    return g, nf, cout


def conv3x3_int8_rdb(k: int, src: torch.Tensor, s_src: torch.Tensor,
                     s_out: torch.Tensor, wq: torch.Tensor,
                     w_s: torch.Tensor, b: torch.Tensor, slots: torch.Tensor,
                     x: torch.Tensor | None = None,
                     skip: torch.Tensor | None = None,
                     packed: torch.Tensor | None = None) -> torch.Tensor:
    """Step k (0..4) of the int8 RDB ``_rdb_fused_int8``: conv k of its
    quantised source with its share of the dense-block assembly.

    src: step 0 the RDB input x (N, H, W, nf), bf16 or float32; step k >= 1
    x_k (N, H, W, g) float32. s_src: its raw max| | (a 0-d view into the
    ``int8_amax`` chain); s_out: the next one, raised to the max of what
    this step returns. wq / w_s: conv k's int8 HWIO weight and (Cout,)
    scales, b: the RDB's (4g + nf,) float32 biases, slots: the (N, H, W,
    4g + nf) bf16 assembly buffer, laid out as conv 0's output and updated
    in place (conv k's channel j is slot channel k g + j). Steps 0..3
    return x_{k+1} (N, H, W, g) float32; step 4 takes x (the RDB input)
    and returns x + 0.2 * (x5 + b) in x's dtype, and with ``skip`` (the
    RRDB input) skip + 0.2 * that.

    On the GPU one launch of ``csrc/rdb_int8.cu``; ``packed`` is
    ``pack_conv3x3_int8_weights(wq)`` (made here when None). Anything the
    kernel does not take raises ``KernelInputError``.
    """
    if src.device.type == "cpu":
        return conv3x3_int8_rdb_plain(k, src, s_src, s_out, wq, w_s, b,
                                      slots, x, skip)
    if not src.is_cuda:
        raise KernelInputError(f"conv3x3_int8_rdb: no kernel for device "
                               f"{src.device}")
    if packed is None:
        packed = pack_conv3x3_int8_weights(wq)
    g, nf, cout = _check_step(k, src, s_src, s_out, wq, w_s, b, slots, x,
                              skip, packed)
    n, h, wd, cin = src.shape
    if k < 4:
        y = torch.empty((n, h, wd, g), dtype=torch.float32, device=src.device)
        xn, out = y, None
    else:
        y = torch.empty_like(x)
        xn, out = None, y
    ptrs = [t for t in (src, slots, y, x, skip) if t is not None]
    vec = int(g % 8 == 0 and nf % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in ptrs))
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        err = lib.nesr_rdb_int8_step(
            src.data_ptr(), packed.data_ptr(), w_s.data_ptr(), b.data_ptr(),
            s_src.data_ptr(), s_out.data_ptr(), slots.data_ptr(),
            None if xn is None else xn.data_ptr(),
            None if x is None else x.data_ptr(),
            None if skip is None else skip.data_ptr(),
            None if out is None else out.data_ptr(),
            n, h, wd, cin, cout, k, g, 4 * g + nf, tile_width(cout)[0],
            int(src.dtype == torch.bfloat16),
            int(x is not None and x.dtype == torch.bfloat16), vec,
            _build.stream_ptr())
    _build.check("conv3x3_int8_rdb", err)
    conv3x3_int8_rdb.launches += 1
    return y


conv3x3_int8_rdb.launches = 0
