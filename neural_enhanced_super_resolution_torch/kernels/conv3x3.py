"""K1: fused SAME 3x3 conv (+ optional bias, + optional LeakyReLU(0.2)).

``conv3x3`` launches the hand-written Hopper kernel (``csrc/conv3x3.cu``) on
a bf16 CUDA tensor, its float32 form ``conv3x3_f32`` (``csrc/conv3x3_f32.cu``,
the parity mode's) on a float32 one, and takes the plain PyTorch version
``conv3x3_plain`` only for a tensor on the CPU. It replaces the JAX package's three conv Pallas kernels
(``kernels/conv3x3.py:conv3x3_lrelu``, ``kernels/conv3x3_v2.py``,
``kernels/rdb_pallas.py:rows_s2d_conv3x3``). Layout is NHWC at the
interface, weights HWIO (3, 3, Cin, Cout) as in the JAX package.

The kernel reads its weights pre-packed by ``pack_conv3x3_weights`` into the
image of its shared-memory slabs; models pack once at build and pass the
buffer as ``packed``, and a call without it packs on the fly.

``Conv3x3Function`` is the float32 conv with a gradient, for training: its
forward and its input gradient are K1f launches on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)

__all__ = ["conv3x3", "conv3x3_f32", "conv3x3_plain", "pack_conv3x3_weights",
           "Conv3x3Function", "pass_width",
           "tile_width", "packed_numel", "TILE_WIDTHS"]

# The kernel's instantiations: the output-channel width N of one tile; a
# block walks Cout's tiles one after the other.
TILE_WIDTHS = (8, 16, 32, 64, 80, 96, 128)


def pass_width(cin: int) -> int:
    """Input channels the kernel takes a pass: 16, 32 or 64 as Cin is at
    most 16, at most 32, or more. Cin is zero-padded to a whole number of
    passes (Kp), so a Cin-32 conv stages no zero channels."""
    return 16 if cin <= 16 else 32 if cin <= 32 else 64


def _padded_cin(cin: int) -> int:
    kc = pass_width(cin)
    return -(-cin // kc) * kc


def tile_width(cout: int) -> tuple[int, int]:
    """(N, tiles): Cout is split into ``tiles`` = ceil(Cout / 128) equal
    tiles, each rounded up to the next instantiation N (extra columns are
    zero weights)."""
    tiles = -(-cout // TILE_WIDTHS[-1])
    return next(n for n in TILE_WIDTHS if n >= -(-cout // tiles)), tiles


def packed_numel(cin: int, cout: int) -> int:
    """Values in ``pack_conv3x3_weights`` of a (3, 3, cin, cout) weight."""
    nw, tiles = tile_width(cout)
    return tiles * 9 * _padded_cin(cin) * nw


def pack_conv3x3_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights (3, 3, Cin, Cout) -> the kernel's flat bf16 image.

    With N, tiles = ``tile_width(Cout)``, kc = ``pass_width(Cin)`` and Kp
    = Cin rounded up to kc, the buffer holds tiles x 9 x Kp x N values, zero
    past Cin and Cout. Per N tile, slab i = (pass i // 9, tap i % 9, tap =
    3 ky + kx) is kc x N contiguous values at i * kc * N: what the kernel
    copies into shared memory with one bulk copy. In a slab the 16-channel
    k-steps s follow each other (16 N values each), and a k-step is N/8 x 2
    core matrices of 8 x 8 values, core (j, h) at (2j + h) * 64 holding
    output channels 8j + r (row r) by input channels 16s + 8h + k (column
    k). That is B of ``wgmma`` K-major with no swizzle: leading (K) byte
    offset 128, stride (N) byte offset 256 (``csrc/common.cuh:wgmma_desc``).
    """
    _, _, cin, cout = w.shape
    nw, tiles = tile_width(cout)
    kc, kp = pass_width(cin), _padded_cin(cin)
    wz = torch.zeros((3, 3, kp, tiles * nw), dtype=torch.bfloat16,
                     device=w.device)
    wz[:, :, :cin, :cout] = w
    s = wz.reshape(9, kp // kc, kc // 16, 2, 8, tiles, nw // 8, 8)
    # (tap, pass, step, h, k, tile, j, r) -> (tile, pass, tap, step, j, h, r, k)
    return s.permute(5, 1, 0, 2, 6, 3, 7, 4).reshape(-1).contiguous()


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  lrelu: bool = False) -> torch.Tensor:
    """The plain version: ``F.conv2d`` on operands rounded to ``x.dtype``,
    computed in fp32, with bias and LeakyReLU in fp32, rounded to
    ``x.dtype`` once at the end."""
    conv3x3_plain.calls += 1
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dt = x.dtype
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.to(dt).float().permute(3, 2, 0, 1), padding=1)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    if lrelu:
        y = F.leaky_relu(y, 0.2)
    return y.permute(0, 2, 3, 1).to(dt).contiguous()


conv3x3_plain.calls = 0


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor | None = None,
            lrelu: bool = False,
            packed: torch.Tensor | None = None) -> torch.Tensor:
    """SAME 3x3 conv. x (N, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout,).

    On the GPU: x and w bf16, bias fp32 (or None), all contiguous on one
    device, x 16-byte aligned; ``packed`` is ``pack_conv3x3_weights(w)``
    (made here when None). Returns (N, H, W, Cout) bf16. A float32 x goes
    to ``conv3x3_f32`` (``packed`` unused). Anything else raises
    ``KernelInputError``.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias, lrelu)
    if not x.is_cuda:
        raise KernelInputError(f"conv3x3: no kernel for device {x.device}")
    if x.dtype == torch.float32:
        return conv3x3_f32(x, w, bias, lrelu)
    if x.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[3]:
        raise KernelInputError(f"conv3x3: bad shapes x {tuple(x.shape)}, "
                               f"w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise KernelInputError(f"conv3x3: needs bf16 x and w, got "
                               f"{x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise KernelInputError("conv3x3: x and w must be contiguous")
    if w.device != x.device:
        raise KernelInputError("conv3x3: x and w on different devices")
    if x.data_ptr() % 16:
        raise KernelInputError("conv3x3: x must be 16-byte aligned")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.device != x.device
                or bias.shape != (cout,) or not bias.is_contiguous()):
            raise KernelInputError("conv3x3: bias must be a contiguous "
                                   f"fp32 ({cout},) tensor on {x.device}")
    if n > 65535 or min(n, h, wd, cin, cout) < 1:
        raise KernelInputError(f"conv3x3: unsupported shape {tuple(x.shape)}")
    if packed is None:
        packed = pack_conv3x3_weights(w)
    if (packed.dtype != torch.bfloat16 or packed.device != x.device
            or not packed.is_contiguous() or packed.data_ptr() % 16
            or packed.numel() != packed_numel(cin, cout)):
        raise KernelInputError("conv3x3: packed is not "
                               "pack_conv3x3_weights(w) on the device")
    lib = _build.load_library()
    y = torch.empty((n, h, wd, cout), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_conv3x3(
            x.data_ptr(), packed.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            n, h, wd, cin, cout, tile_width(cout)[0], int(bool(lrelu)),
            _build.stream_ptr())
    _build.check("conv3x3", err)
    conv3x3.launches += 1
    return y


conv3x3.launches = 0


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None,
                lrelu: bool = False) -> torch.Tensor:
    """K1's float32 form: the same SAME 3x3 conv, all in float32.

    On the GPU: x (N, H, W, Cin), w (3, 3, Cin, Cout) and bias (Cout,) (or
    None) float32 and contiguous on one device. Returns (N, H, W, Cout)
    float32. On the CPU: ``conv3x3_plain``. Anything else raises
    ``KernelInputError``.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias, lrelu)
    if not x.is_cuda:
        raise KernelInputError(f"conv3x3_f32: no kernel for device "
                               f"{x.device}")
    if x.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[3]:
        raise KernelInputError(f"conv3x3_f32: bad shapes x "
                               f"{tuple(x.shape)}, w {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    for name, t in (("x", x), ("w", w)) + ((("bias", bias),)
                                            if bias is not None else ()):
        if (t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise KernelInputError(f"conv3x3_f32: {name} must be a "
                                   f"contiguous float32 tensor on {x.device}")
    if bias is not None and bias.shape != (cout,):
        raise KernelInputError(f"conv3x3_f32: bias {tuple(bias.shape)}, "
                               f"want ({cout},)")
    if n > 65535 or min(n, h, wd, cin, cout) < 1:
        raise KernelInputError(f"conv3x3_f32: unsupported shape "
                               f"{tuple(x.shape)}")
    lib = _build.load_library()
    y = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_conv3x3_f32(
            x.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            n, h, wd, cin, cout, int(bool(lrelu)), _build.stream_ptr())
    _build.check("conv3x3_f32", err)
    conv3x3_f32.launches += 1
    return y


conv3x3_f32.launches = 0


class Conv3x3Function(torch.autograd.Function):
    """The float32 SAME 3x3 conv (+ bias, + optional LeakyReLU(0.2)) with a
    gradient: what the JAX trainer differentiates through
    ``lax.conv_general_dilated`` in float32 (``tools/train_tiny_esrgan.py``).

    x (N, H, W, Cin) and w (3, 3, Cin, Cout) float32, bias (Cout,). On a
    CUDA tensor the forward and the input gradient are K1f launches: the
    input gradient of a SAME stride-1 3x3 conv is the SAME 3x3 conv of the
    output gradient with the weight flipped in both spatial axes and Cin
    and Cout swapped, no bias, no activation. On the CPU both are
    ``conv3x3_plain``. The LeakyReLU's derivative, 1 where y >= 0 and 0.2
    elsewhere (JAX's ``_lrelu``, 1 at 0), is read from the saved output,
    whose sign is the pre-activation's. The weight gradient, a reduction
    over pixels that no kernel of the port computes (XLA's autodiff in the
    JAX package), is ``torch.nn.grad.conv2d_weight`` with TF32 off.
    """

    @staticmethod
    def forward(ctx, x, w, bias, lrelu: bool):
        y = conv3x3_f32(x, w, bias, lrelu)
        ctx.lrelu = bool(lrelu)
        ctx.save_for_backward(x, w, y if lrelu else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, y = ctx.saved_tensors
        g = gy * torch.where(y >= 0, 1.0, 0.2) if ctx.lrelu else gy
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_f32(g, w.flip(0, 1).transpose(2, 3).contiguous())
        if ctx.needs_input_grad[1]:
            if g.is_cuda:
                torch.backends.cudnn.allow_tf32 = False
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (w.shape[3], w.shape[2], 3, 3),
                g.permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2))
        return dx, dw, db, None
