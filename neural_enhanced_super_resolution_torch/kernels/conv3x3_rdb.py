"""The K1 step: one conv of the bf16 residual dense block with its share of
the dense-block assembly in the epilogue.

``conv3x3_rdb`` launches the hand-written Hopper kernel
(``csrc/rdb_bf16.cu``) on a CUDA tensor and takes the plain PyTorch version
``conv3x3_rdb_plain`` only for a tensor on the CPU. Five steps (k = 0..4)
make one RDB of the fused trunk: the JAX package's ``_rdb_fused``
(``models/rrdbnet.py:167``), XLA's bias-free bf16 convs with their
assembly, which is no Pallas kernel. Step k is K1's conv k
(``conv3x3`` without bias, rounded to bf16 once) followed by step k's
slice of the assembly that ``models/rrdbnet.FusedRDB._composition`` runs
in PyTorch, with its rounding points; the two agree bit for bit.

Layout: NHWC activations, HWIO weights (3, 3, Cin, Cout) from
``models/rrdbnet.fuse_rdb`` (Cout 4g + nf, 3g + nf, 2g + nf, g + nf, nf),
read as K1 reads them, packed by ``pack_conv3x3_weights``. The slots are
one (N, H, W, 4g + nf) buffer laid out as conv 0's output: conv k's
channel j is slot channel k g + j.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    conv3x3_plain, pack_conv3x3_weights, packed_numel, tile_width)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
    rdb_growth)

__all__ = ["conv3x3_rdb", "conv3x3_rdb_plain"]


def conv3x3_rdb_plain(k: int, src: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor, slots: torch.Tensor,
                      xn: torch.Tensor | None = None,
                      x: torch.Tensor | None = None,
                      skip: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of ``conv3x3_rdb``: ``conv3x3_plain`` without
    bias (rounded to src's dtype once), then step k's slice of the
    assembly with PyTorch's rounding points, in src's dtype (bf16 or
    float32). ``xn``, when given, receives x_{k+1}."""
    conv3x3_rdb_plain.calls += 1
    c = conv3x3_plain(src, w)
    g, _ = rdb_growth(k, src.shape[-1], slots.shape[-1])
    lo = k * g
    if k == 4:
        y = x + 0.2 * (slots[..., lo:] + c + b[lo:]).to(x.dtype)
        return y if skip is None else skip + 0.2 * y
    t = c[..., :g] if k == 0 else slots[..., lo:lo + g] + c[..., :g]
    y = F.leaky_relu(t + b[lo:lo + g], 0.2).to(src.dtype)
    if k == 0:
        slots[..., g:] = c[..., g:]
    else:
        slots[..., lo + g:] += c[..., g:]
    if xn is None:
        return y
    xn.copy_(y)
    return xn


conv3x3_rdb_plain.calls = 0


def _check_step(k, src, w, b, slots, xn, x, skip, packed):
    name = "conv3x3_rdb"
    if not 0 <= k <= 4:
        raise KernelInputError(f"{name}: step {k} is not 0..4")
    if src.dim() != 4 or slots.dim() != 4 or slots.shape[:3] != src.shape[:3]:
        raise KernelInputError(f"{name}: bad shapes src {tuple(src.shape)}, "
                               f"slots {tuple(slots.shape)}")
    cin, cs = src.shape[3], slots.shape[3]
    g, nf = rdb_growth(k, cin, cs)
    cout = cs - k * g
    if g < 1 or nf < 1 or 4 * g + nf != cs or w.shape != (3, 3, cin, cout):
        raise KernelInputError(f"{name}: step {k} of src {tuple(src.shape)}, "
                               f"slots width {cs} and w {tuple(w.shape)} is "
                               "no RDB conv")
    if any(t.dtype != torch.bfloat16 for t in (src, w, slots)) or (
            b.dtype != torch.float32 or b.shape != (cs,)):
        raise KernelInputError(f"{name}: needs bf16 src, w and slots and "
                               f"float32 ({cs},) biases, got {src.dtype}, "
                               f"{w.dtype}, {slots.dtype}, {b.dtype}")
    if (k == 4) != (x is not None) or (skip is not None and k != 4):
        raise KernelInputError(f"{name}: x (and skip) belong to step 4")
    extra = [t for t in (x, skip) if t is not None]
    if any(t.shape != (*src.shape[:3], nf) or t.dtype != torch.bfloat16
           for t in extra):
        raise KernelInputError(f"{name}: x and skip must be ({nf},)-channel "
                               "bf16 tensors")
    if xn is not None and (k == 4 or xn.shape != (*src.shape[:3], g)
                           or xn.dtype != torch.bfloat16):
        raise KernelInputError(f"{name}: xn is step k < 4's "
                               f"({g},)-channel bf16 x_(k+1)")
    ops = [t for t in (src, w, b, slots, packed, xn, *extra) if t is not None]
    if any(t.device != src.device for t in ops):
        raise KernelInputError(f"{name}: operands on different devices")
    if not all(t.is_contiguous() for t in ops):
        raise KernelInputError(f"{name}: operands must be contiguous")
    if src.data_ptr() % 16 or packed.data_ptr() % 16:
        raise KernelInputError(f"{name}: src and packed must be 16-byte "
                               "aligned")
    if xn is not None and xn.data_ptr() == src.data_ptr():
        raise KernelInputError(f"{name}: x_(k+1) must not overwrite x_k, "
                               "whose halo other blocks still read")
    if src.shape[0] > 65535 or min(src.shape[1:3]) < 1:
        raise KernelInputError(f"{name}: unsupported shape "
                               f"{tuple(src.shape)}")
    if (packed.dtype != torch.bfloat16
            or packed.numel() != packed_numel(cin, cout)):
        raise KernelInputError(f"{name}: packed is not "
                               "pack_conv3x3_weights(w) on the device")
    return g, nf, cout


def conv3x3_rdb(k: int, src: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, slots: torch.Tensor,
                xn: torch.Tensor | None = None,
                x: torch.Tensor | None = None,
                skip: torch.Tensor | None = None,
                packed: torch.Tensor | None = None) -> torch.Tensor:
    """Step k (0..4) of the fused RDB ``_rdb_fused``: conv k of its source
    with its share of the dense-block assembly.

    src: step 0 the RDB input x (N, H, W, nf); step k >= 1 x_k (N, H, W,
    g). w: conv k's HWIO weight (3, 3, Cin, Cout) from ``fuse_rdb``, b: the
    RDB's (4g + nf,) float32 biases, slots: the (N, H, W, 4g + nf)
    assembly buffer, laid out as conv 0's output and updated in place
    (conv k's channel j is slot channel k g + j). Steps 0..3 return
    x_{k+1} = lrelu(slot + c + b) (N, H, W, g), written into ``xn`` when
    given (a buffer other than src: neighbouring blocks still read src's
    halo); step 4 takes x (the RDB input) and returns x + 0.2 * (x5 + b),
    and with ``skip`` (the RRDB input) skip + 0.2 * that.

    On the GPU one launch of ``csrc/rdb_bf16.cu``, everything bf16 but b;
    ``packed`` is ``pack_conv3x3_weights(w)`` (made here when None).
    Anything the kernel does not take raises ``KernelInputError``.
    """
    if src.device.type == "cpu":
        return conv3x3_rdb_plain(k, src, w, b, slots, xn, x, skip)
    if not src.is_cuda:
        raise KernelInputError(f"conv3x3_rdb: no kernel for device "
                               f"{src.device}")
    if packed is None:
        packed = pack_conv3x3_weights(w)
    g, nf, cout = _check_step(k, src, w, b, slots, xn, x, skip, packed)
    n, h, wd, cin = src.shape
    if k < 4:
        y = xn if xn is not None else torch.empty(
            (n, h, wd, g), dtype=torch.bfloat16, device=src.device)
        out = None
    else:
        y = out = torch.empty_like(x)
    ptrs = [t for t in (slots, y, x, skip) if t is not None]
    vec = int(g % 8 == 0 and nf % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in ptrs))
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        err = lib.nesr_rdb_bf16_step(
            src.data_ptr(), packed.data_ptr(), b.data_ptr(),
            slots.data_ptr(), None if k == 4 else y.data_ptr(),
            None if x is None else x.data_ptr(),
            None if skip is None else skip.data_ptr(),
            None if out is None else out.data_ptr(),
            n, h, wd, cin, cout, k, g, 4 * g + nf, tile_width(cout)[0], vec,
            _build.stream_ptr())
    _build.check("conv3x3_rdb", err)
    conv3x3_rdb.launches += 1
    return y


conv3x3_rdb.launches = 0
