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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    tile_width)

__all__ = ["conv3x3_int8", "conv3x3_int8_plain", "pack_conv3x3_int8_weights",
           "pass_width_int8", "packed_int8_numel", "quantize_int8"]


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
    q = torch.round(hf * _div(127.0, s_x)).clamp_(-127, 127).to(torch.int8)
    return q, s_x


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
