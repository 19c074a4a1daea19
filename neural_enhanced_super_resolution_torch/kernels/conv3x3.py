"""K1: fused SAME 3x3 conv (+ optional bias, + optional LeakyReLU(0.2)).

``conv3x3`` launches the hand-written Hopper kernel (``csrc/conv3x3.cu``) on
a CUDA tensor and takes the plain PyTorch version ``conv3x3_plain`` only for
a tensor on the CPU. It replaces the JAX package's three conv Pallas kernels
(``kernels/conv3x3.py:conv3x3_lrelu``, ``kernels/conv3x3_v2.py``,
``kernels/rdb_pallas.py:rows_s2d_conv3x3``). Layout is NHWC at the
interface, weights HWIO (3, 3, Cin, Cout) as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)

__all__ = ["conv3x3", "conv3x3_plain"]


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
            lrelu: bool = False) -> torch.Tensor:
    """SAME 3x3 conv. x (N, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout,).

    On the GPU: x and w bf16, bias fp32 (or None), all contiguous on one
    device; returns (N, H, W, Cout) bf16. Anything else raises
    ``KernelInputError``.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias, lrelu)
    if not x.is_cuda:
        raise KernelInputError(f"conv3x3: no kernel for device {x.device}")
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
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.device != x.device
                or bias.shape != (cout,) or not bias.is_contiguous()):
            raise KernelInputError("conv3x3: bias must be a contiguous "
                                   f"fp32 ({cout},) tensor on {x.device}")
    if n > 65535 or min(n, h, wd, cin, cout) < 1:
        raise KernelInputError(f"conv3x3: unsupported shape {tuple(x.shape)}")
    lib = _build.load_library()
    y = torch.empty((n, h, wd, cout), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_conv3x3(
            x.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            n, h, wd, cin, cout, int(bool(lrelu)), _build.stream_ptr())
    _build.check("conv3x3", err)
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
