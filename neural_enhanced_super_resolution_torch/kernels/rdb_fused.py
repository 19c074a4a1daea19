"""K2: one whole residual dense block in one launch.

``rdb_fused`` launches the hand-written Hopper kernel (``csrc/rdb_fused.cu``)
on a CUDA tensor and takes the plain PyTorch version ``rdb_fused_plain`` only
for a tensor on the CPU. It is the counterpart of the JAX package's
``kernels/rdb_dform.py:rdb_dform_call`` with the v2 numerics of
``rdb_dform_reference(..., v2=True)``: every conv output is rounded to the
working dtype once, before the dense-block assembly adds, and every assembly
slot is rounded as it is updated. Unlike the D-form kernel it takes plain
NHWC (N, H, W, nf) and any H and W.

Weights are the source-major fused RDB of ``models/rrdbnet.fuse_rdb``:
``w = (w0, .., w4)`` HWIO with Cout 4g+nf, 3g+nf, 2g+nf, g+nf, nf and
``b`` the (4g + nf,) concatenated conv1..conv5 biases. The kernel reads
each weight as K1 does, packed by ``pack_conv3x3_weights`` into the image
of its ``wgmma`` B slabs (63 slabs an RDB, one sequence across the five
convs); models pack once at build and pass the five buffers as
``packed``, and a call without them packs on the fly.
"""

from __future__ import annotations

from typing import Sequence

import torch

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    conv3x3_plain, pack_conv3x3_weights, packed_numel)

__all__ = ["rdb_fused", "rdb_fused_plain", "KERNEL_NF", "KERNEL_GC"]

KERNEL_NF = 64  # the kernel's compiled feature width
KERNEL_GC = 32  # and growth width


def _lrelu(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, 0.2 * v)


def rdb_fused_plain(x: torch.Tensor, w: Sequence[torch.Tensor],
                    b: torch.Tensor) -> torch.Tensor:
    """The plain version, built from ``conv3x3_plain`` (bias-free convs)."""
    rdb_fused_plain.calls += 1
    dt = x.dtype
    g = w[1].shape[2]
    bf = b.float()

    def conv(t, wi):
        return conv3x3_plain(t, wi).float()   # rounded to dt once

    def rnd(v):
        return v.to(dt).float()

    c0 = conv(x, w[0])
    x1 = _lrelu(c0[..., :g] + bf[:g]).to(dt)
    a2, a3, a4, a5 = (c0[..., g:2 * g], c0[..., 2 * g:3 * g],
                      c0[..., 3 * g:4 * g], c0[..., 4 * g:])
    c1 = conv(x1, w[1])
    x2 = _lrelu(a2 + c1[..., :g] + bf[g:2 * g]).to(dt)
    a3 = rnd(a3 + c1[..., g:2 * g])
    a4 = rnd(a4 + c1[..., 2 * g:3 * g])
    a5 = rnd(a5 + c1[..., 3 * g:])
    c2 = conv(x2, w[2])
    x3 = _lrelu(a3 + c2[..., :g] + bf[2 * g:3 * g]).to(dt)
    a4 = rnd(a4 + c2[..., g:2 * g])
    a5 = rnd(a5 + c2[..., 2 * g:])
    c3 = conv(x3, w[3])
    x4 = _lrelu(a4 + c3[..., :g] + bf[3 * g:4 * g]).to(dt)
    a5 = rnd(a5 + c3[..., g:])
    c4 = conv(x4, w[4])
    x5 = a5 + c4 + bf[4 * g:]
    return (x.float() + 0.2 * x5).to(dt)


rdb_fused_plain.calls = 0


def rdb_fused(x: torch.Tensor, w: Sequence[torch.Tensor],
              b: torch.Tensor,
              packed: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """One RDB: x (N, H, W, nf) -> same shape and dtype.

    On the GPU: nf 64, growth 32, x and w bf16, b fp32, all contiguous on
    one device, x 16-byte aligned; ``packed`` is
    ``[pack_conv3x3_weights(wi) for wi in w]`` (made here when None).
    Anything else raises ``KernelInputError``.
    """
    if x.device.type == "cpu":
        return rdb_fused_plain(x, w, b)
    if not x.is_cuda:
        raise KernelInputError(f"rdb_fused: no kernel for device {x.device}")
    nf, g = KERNEL_NF, KERNEL_GC
    if x.dim() != 4 or x.shape[3] != nf:
        raise KernelInputError(f"rdb_fused: x must be (N, H, W, {nf}), "
                               f"got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise KernelInputError("rdb_fused: x must be contiguous bf16")
    want = [(3, 3, nf, 4 * g + nf)] + [(3, 3, g, k * g + nf)
                                      for k in (3, 2, 1, 0)]
    if len(w) != 5:
        raise KernelInputError("rdb_fused: needs five weights w0..w4")
    for i, (wi, shape) in enumerate(zip(w, want)):
        if (tuple(wi.shape) != shape or wi.dtype != torch.bfloat16
                or not wi.is_contiguous() or wi.device != x.device):
            raise KernelInputError(f"rdb_fused: w{i} must be contiguous "
                                   f"bf16 {shape} on {x.device}, got "
                                   f"{tuple(wi.shape)} {wi.dtype}")
    if (tuple(b.shape) != (4 * g + nf,) or b.dtype != torch.float32
            or not b.is_contiguous() or b.device != x.device):
        raise KernelInputError(f"rdb_fused: b must be contiguous fp32 "
                               f"({4 * g + nf},) on {x.device}")
    n, h, wd, _ = x.shape
    if n > 65535:
        raise KernelInputError(f"rdb_fused: batch {n} too large")
    if x.data_ptr() % 16:
        raise KernelInputError("rdb_fused: x must be 16-byte aligned")
    if packed is None:
        packed = [pack_conv3x3_weights(wi) for wi in w]
    if len(packed) != 5 or any(
            p.dtype != torch.bfloat16 or p.device != x.device
            or not p.is_contiguous() or p.data_ptr() % 16
            or p.numel() != packed_numel(*shape[2:])
            for p, shape in zip(packed, want)):
        raise KernelInputError("rdb_fused: packed is not "
                               "[pack_conv3x3_weights(wi) for wi in w] on "
                               "the device")
    lib = _build.load_library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.nesr_rdb_fused(
            x.data_ptr(), *[p.data_ptr() for p in packed], b.data_ptr(),
            y.data_ptr(), n, h, wd, _build.stream_ptr())
    _build.check("rdb_fused", err)
    rdb_fused.launches += 1
    return y


rdb_fused.launches = 0
