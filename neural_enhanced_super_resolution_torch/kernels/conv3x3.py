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

The folded RRDBNet head (``models/rrdbnet.py:FoldedHead``) adds two pairs
of kernels, each with three epilogue options: the JAX package's rounding
order (``round_first``: bf16 before the LeakyReLU), its frame mask
(``mask``) and depth-to-space on the store (``d2s``). Its 3x3 forms,
``conv3x3_head`` (``csrc/conv3x3_head.cu``, weights packed by
``pack_conv3x3_weights(w, head=True)``) and ``conv3x3_head_f32``
(``csrc/conv3x3_head_f32.cu``), which ``conv3x3`` takes whenever ``d2s``
or ``round_first`` is asked; and its 2x2 forms, ``conv2x2_s2d``
(``conv2x2_s2d_f32`` in float32; plain version ``conv2x2_s2d_plain``,
weights packed by ``pack_conv2x2_weights``), the space-to-depth convs that
conv_hr and conv_last fold into.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)

__all__ = ["conv3x3", "conv3x3_f32", "conv3x3_plain", "pack_conv3x3_weights",
           "conv3x3_head", "conv3x3_head_f32", "head_plan",
           "head_tile_width", "conv2x2_s2d", "conv2x2_s2d_f32",
           "conv2x2_s2d_plain", "pack_conv2x2_weights", "d2s",
           "frame_border_mask", "Conv3x3Function", "pass_width", "tile_width",
           "tile_width_2x2", "packed_numel", "TILE_WIDTHS", "TILE_WIDTHS_2X2"]

# The kernel's instantiations: the output-channel width N of one tile; a
# block walks Cout's tiles one after the other.
TILE_WIDTHS = (8, 16, 32, 64, 80, 96, 128)
# The 2x2 form's instantiations (its passes are 64 input channels): the
# folded head's Cout 12 (conv_last) and 4 nf (conv_hr: 256 as 2 x 128, an
# N tile a block); the head's 3x3 form packs at the same widths while Cin
# is one pass, narrower beyond (head_tile_width).
TILE_WIDTHS_2X2 = (16, 64, 128)
# The head 3x3 form's instantiations (csrc/conv3x3_head.cu): a block keeps
# its N tile's weights resident, 9 x 64 x N bf16 a pass, so the passes
# times N are at most 128 (147,456 bytes).
HEAD_WIDTHS = (8, 16, 64, 128)
_HEAD_MAX_PASSES = 16
# The head 3x3 form's shared memory (csrc/conv3x3_head.cu: layout): three
# patch slots of 6 x 18 pixels x 72 channels (128-byte aligned), seven
# mbarriers.
_HEAD_SLOT = -(-6 * 18 * 72 * 2 // 128) * 128
_HEAD_MAX_SMEM = 232448
# Epilogue flags of the C entry points (csrc/conv3x3.cu).
_LRELU, _ROUND_FIRST, _MASK, _D2S = 1, 2, 4, 8


def pass_width(cin: int) -> int:
    """Input channels the kernel takes a pass: 16, 32 or 64 as Cin is at
    most 16, at most 32, or more. Cin is zero-padded to a whole number of
    passes (Kp), so a Cin-32 conv stages no zero channels."""
    return 16 if cin <= 16 else 32 if cin <= 32 else 64


def _padded_cin(cin: int) -> int:
    kc = pass_width(cin)
    return -(-cin // kc) * kc


def tile_width(cout: int, widths: tuple = TILE_WIDTHS) -> tuple[int, int]:
    """(N, tiles): Cout is split into ``tiles`` = ceil(Cout / 128) equal
    tiles, each rounded up to the next instantiation N of ``widths``
    (extra columns are zero weights)."""
    tiles = -(-cout // widths[-1])
    return next(n for n in widths if n >= -(-cout // tiles)), tiles


def tile_width_2x2(cout: int) -> tuple[int, int]:
    """``tile_width`` of the 2x2 form (N one of 16, 64, 128)."""
    return tile_width(cout, TILE_WIDTHS_2X2)


def head_tile_width(cin: int, cout: int) -> tuple[int, int]:
    """(N, tiles) of the head 3x3 form: ``tile_width_2x2(cout)`` when Cin
    is one 64-channel pass (the trunk's nf up to 64); with more passes the
    widest ``HEAD_WIDTHS`` whose resident weights fit (passes x N at most
    128: Cin up to 128 takes N 64, up to 512 N 16, up to 1024 N 8).
    Raises ``KernelInputError`` past 1024 input channels."""
    npass = -(-cin // 64)
    if npass == 1:
        return tile_width_2x2(cout)
    if npass > _HEAD_MAX_PASSES:
        raise KernelInputError(f"conv3x3_head: Cin {cin} over "
                               f"{64 * _HEAD_MAX_PASSES}: the weights of an "
                               "N tile would not fit in shared memory")
    return tile_width(cout, tuple(n for n in HEAD_WIDTHS
                                  if n * npass <= 128))


def head_plan(n: int, h: int, w: int, cin: int, cout: int,
              sms: int) -> dict:
    """The head 3x3 form's launch on a card of ``sms`` SMs for x (n, h, w,
    cin): its N width and tiles (``head_tile_width``), its 4 x 16-pixel
    tiles, the blocks a N tile (one an SM, split evenly between the N
    tiles, at most one for every two tiles), the grid and the dynamic
    shared memory, which the C entry point checks against its own layout:
    two staging tiles of 64 pixels x N, the N tile's weights, three patch
    slots, the barriers and N biases."""
    nw, n_tiles = head_tile_width(cin, cout)
    npass = -(-cin // 64)
    tiles = n * -(-h // 4) * -(-w // 16)
    per_nt = max(1, min(sms // n_tiles, -(-tiles // 2)))
    stg = -(-64 * nw * 2 // 1024) * 1024
    p_off = -(-(2 * stg + npass * 9 * 64 * nw * 2) // 128) * 128
    smem = p_off + 3 * _HEAD_SLOT + 8 * 7 + 4 * nw
    assert smem <= _HEAD_MAX_SMEM
    return {"n_width": nw, "n_tiles": n_tiles, "tiles": tiles,
            "per_nt": per_nt, "grid": per_nt * n_tiles, "smem": smem}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def packed_numel(cin: int, cout: int, taps: int = 3,
                 head: bool = False) -> int:
    """Values in ``pack_conv3x3_weights(w, head)`` of a (3, 3, cin, cout)
    weight, or with ``taps`` 2 in ``pack_conv2x2_weights`` of a (2, 2, cin,
    cout) one (the folded head's forms: 64-channel passes)."""
    if taps == 2 or head:
        nw, tiles = (tile_width_2x2(cout) if taps == 2
                     else head_tile_width(cin, cout))
        return tiles * taps * taps * (-(-cin // 64) * 64) * nw
    nw, tiles = tile_width(cout)
    return tiles * 9 * _padded_cin(cin) * nw


def _pack(w: torch.Tensor, kc: int, nw: int, tiles: int) -> torch.Tensor:
    kh, kw, cin, cout = w.shape
    kp = -(-cin // kc) * kc
    wz = torch.zeros((kh, kw, kp, tiles * nw), dtype=torch.bfloat16,
                     device=w.device)
    wz[:, :, :cin, :cout] = w
    s = wz.reshape(kh * kw, kp // kc, kc // 16, 2, 8, tiles, nw // 8, 8)
    # (tap, pass, step, h, k, tile, j, r) -> (tile, pass, tap, step, j, h, r, k)
    return s.permute(5, 1, 0, 2, 6, 3, 7, 4).reshape(-1).contiguous()


def pack_conv3x3_weights(w: torch.Tensor, head: bool = False
                         ) -> torch.Tensor:
    """HWIO weights (3, 3, Cin, Cout) -> the kernel's flat bf16 image.

    With N, tiles = ``tile_width(Cout)``, kc = ``pass_width(Cin)`` (with
    ``head``, for the folded head's 3x3 form: ``head_tile_width(Cin,
    Cout)`` and kc = 64) and Kp = Cin rounded up to kc, the buffer holds
    tiles x 9 x Kp x N values, zero
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
    if head:
        return _pack(w, 64, *head_tile_width(cin, cout))
    return _pack(w, pass_width(cin), *tile_width(cout))


def pack_conv2x2_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights (2, 2, Cin, Cout) -> the 2x2 form's flat bf16 image:
    ``pack_conv3x3_weights``'s layout with 4 taps (tap = 2 ky + kx),
    passes of 64 input channels and N, tiles = ``tile_width_2x2(Cout)``
    (Cout 256: two N tiles of 128, a (pass, tap) slab 64 x 128, 16 KB, one
    bulk copy)."""
    return _pack(w, 64, *tile_width_2x2(w.shape[3]))


def d2s(z: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 4C) subpixel-major -> (N, 2H, 2W, C) depth-to-space:
    channel (2 oi + oj) C + f of pixel (r, s) goes to pixel (2r + oi,
    2s + oj), channel f (the JAX package's ``_d2s``)."""
    n, h, w, c4 = z.shape
    c = c4 // 4
    z = z.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return z.reshape(n, 2 * h, 2 * w, c)


def frame_border_mask(h: torch.Tensor) -> torch.Tensor:
    """Zero the half-pixel frame of a padding-1 2x2 conv's output (N, H+1,
    W+1, 4D): in channel group g = 2 oi + oj, row 0 when oi = 0, the last
    row when oi = 1, column 0 when oj = 0 and the last column when oj = 1
    (the JAX package's ``_frame_border_mask``)."""
    n, rp1, sp1, c4 = h.shape
    ri = torch.arange(rp1, device=h.device)
    rm = torch.stack([ri != 0, ri != rp1 - 1], dim=-1)        # (rp1, 2) per oi
    ci = torch.arange(sp1, device=h.device)
    cm = torch.stack([ci != 0, ci != sp1 - 1], dim=-1)        # (sp1, 2) per oj
    keep = (rm[:, None, :, None] & cm[None, :, None, :]).reshape(
        1, rp1, sp1, 4, 1)
    h5 = h.reshape(n, rp1, sp1, 4, c4 // 4)
    return torch.where(keep, h5, torch.zeros((), dtype=h.dtype,
                                             device=h.device)).reshape(h.shape)


def _plain(x, w, bias, lrelu, pad, round_first, mask=False,
           to_d2s=False) -> torch.Tensor:
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2),
                 w.to(dt).to(acc).permute(3, 2, 0, 1), padding=pad)
    if bias is not None:
        y = y + bias.to(acc).view(1, -1, 1, 1)
    if round_first:
        y = y.to(dt)
    if lrelu:
        y = F.leaky_relu(y, 0.2)
    y = y.permute(0, 2, 3, 1).to(dt)
    if mask:
        y = frame_border_mask(y)
    if to_d2s:
        y = d2s(y)
    return y.contiguous()


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  lrelu: bool = False, d2s: bool = False,
                  round_first: bool = False) -> torch.Tensor:
    """The plain version: ``F.conv2d`` on operands rounded to ``x.dtype``,
    computed in fp32 (in float64 for float64 operands: the card's float64
    reference forward), with bias and LeakyReLU in fp32, rounded to
    ``x.dtype`` once at the end; with ``round_first``, rounded before the
    LeakyReLU, which then runs on the ``x.dtype`` value (``0.2 * y``
    rounded again). ``d2s``: the output in depth-to-space form."""
    conv3x3_plain.calls += 1
    return _plain(x, w, bias, lrelu, 1, round_first, to_d2s=d2s)


conv3x3_plain.calls = 0


def conv2x2_s2d_plain(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None, lrelu: bool, pad: int,
                      mask: bool, d2s: bool) -> torch.Tensor:
    """The 2x2 form's plain version, with the JAX package's rounding
    points (``_conv`` then ``_lrelu``): ``F.conv2d`` at padding ``pad`` on
    operands rounded to ``x.dtype``, in fp32, plus the fp32 bias, rounded
    to ``x.dtype``, then LeakyReLU in ``x.dtype``, ``frame_border_mask``
    and depth-to-space as asked. x (N, H, W, Cin), w (2, 2, Cin, Cout);
    returns (N, H + 2 pad - 1, W + 2 pad - 1, Cout) or its d2s form."""
    conv2x2_s2d_plain.calls += 1
    return _plain(x, w, bias, lrelu, pad, True, mask, d2s)


conv2x2_s2d_plain.calls = 0


def _flags(lrelu, round_first=False, mask=False, to_d2s=False) -> int:
    return ((_LRELU if lrelu else 0) | (_ROUND_FIRST if round_first else 0)
            | (_MASK if mask else 0) | (_D2S if to_d2s else 0))


def _out_shape(n, ho, wo, cout, to_d2s) -> tuple:
    return (n, 2 * ho, 2 * wo, cout // 4) if to_d2s else (n, ho, wo, cout)


def _check_bf16(name: str, x, w, bias, taps: int, to_d2s: bool,
                mask: bool = False) -> None:
    """The bf16 forms' input checks (raise ``KernelInputError``)."""
    if x.dim() != 4 or w.shape[:2] != (taps, taps) or w.shape[2] != x.shape[3]:
        raise KernelInputError(f"{name}: bad shapes x {tuple(x.shape)}, "
                               f"w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise KernelInputError(f"{name}: needs bf16 x and w, got "
                               f"{x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise KernelInputError(f"{name}: x and w must be contiguous")
    if w.device != x.device:
        raise KernelInputError(f"{name}: x and w on different devices")
    if x.data_ptr() % 16:
        raise KernelInputError(f"{name}: x must be 16-byte aligned")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.device != x.device
                or bias.shape != (cout,) or not bias.is_contiguous()):
            raise KernelInputError(f"{name}: bias must be a contiguous "
                                   f"fp32 ({cout},) tensor on {x.device}")
    if n > 65535 or min(n, h, wd, cin, cout) < 1:
        raise KernelInputError(f"{name}: unsupported shape {tuple(x.shape)}")
    if (to_d2s or mask) and cout % 4:
        raise KernelInputError(f"{name}: d2s and mask need Cout % 4 == 0, "
                               f"got {cout}")


def _check_packed(name: str, packed, x, cin, cout, taps, head) -> None:
    if (packed.dtype != torch.bfloat16 or packed.device != x.device
            or not packed.is_contiguous() or packed.data_ptr() % 16
            or packed.numel() != packed_numel(cin, cout, taps, head)):
        raise KernelInputError(
            f"{name}: packed is not pack_conv{taps}x{taps}_weights(w"
            + (", head=True" if head and taps == 3 else "") + ") on the "
            "device")


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor | None = None,
            lrelu: bool = False,
            packed: torch.Tensor | None = None,
            d2s: bool = False, round_first: bool = False) -> torch.Tensor:
    """SAME 3x3 conv. x (N, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout,).

    On the GPU: x and w bf16, bias fp32 (or None), all contiguous on one
    device, x 16-byte aligned; ``packed`` is ``pack_conv3x3_weights(w)``
    (made here when None). Returns (N, H, W, Cout) bf16, or with ``d2s``
    its depth-to-space form (N, 2H, 2W, Cout / 4); ``round_first`` rounds
    to bf16 before the LeakyReLU (``conv3x3_plain``). Either goes to the
    folded head's 3x3 form, ``conv3x3_head`` (whose ``packed`` is
    ``pack_conv3x3_weights(w, head=True)``). A float32 x goes to
    ``conv3x3_f32`` (``packed`` unused). Anything else raises
    ``KernelInputError``.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias, lrelu, d2s, round_first)
    if not x.is_cuda:
        raise KernelInputError(f"conv3x3: no kernel for device {x.device}")
    if d2s or round_first:
        return conv3x3_head(x, w, bias, lrelu, packed, d2s, round_first)
    if x.dtype == torch.float32:
        return conv3x3_f32(x, w, bias, lrelu)
    _check_bf16("conv3x3", x, w, bias, 3, False)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if packed is None:
        packed = pack_conv3x3_weights(w)
    _check_packed("conv3x3", packed, x, cin, cout, 3, False)
    lib = _build.load_library()
    y = torch.empty((n, h, wd, cout), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_conv3x3(
            x.data_ptr(), packed.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            n, h, wd, cin, cout, tile_width(cout)[0], _flags(lrelu),
            _build.stream_ptr())
    _build.check("conv3x3", err)
    conv3x3.launches += 1
    return y


conv3x3.launches = 0


def conv3x3_head(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None, lrelu: bool = False,
                 packed: torch.Tensor | None = None, d2s: bool = False,
                 round_first: bool = False) -> torch.Tensor:
    """The folded head's 3x3 form (up1, up2): the SAME 3x3 conv of
    ``conv3x3`` with ``round_first`` and ``d2s`` as ``conv3x3_plain`` has
    them, on K1's head kernel (``csrc/conv3x3_head.cu``; plain version
    ``conv3x3_plain``).

    x (N, H, W, Cin) and w (3, 3, Cin, Cout) bf16, bias (Cout,) fp32 (or
    None), contiguous on one device, x 16-byte aligned, Cin at most 1024;
    ``packed`` is ``pack_conv3x3_weights(w, head=True)`` (made here when
    None). A Cin that is not a multiple of 8 is zero-padded to one first
    (a copy of x: the kernel's tensor map steps pixels in 16-byte units).
    Returns (N, H, W, Cout) bf16, or with ``d2s`` (Cout % 4 == 0) its
    depth-to-space form (N, 2H, 2W, Cout / 4). A float32 x goes to
    ``conv3x3_head_f32``; a CPU tensor to the plain version. Anything else
    raises ``KernelInputError``.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias, lrelu, d2s, round_first)
    if not x.is_cuda:
        raise KernelInputError(f"conv3x3_head: no kernel for device "
                               f"{x.device}")
    if x.dtype == torch.float32:
        return conv3x3_head_f32(x, w, bias, lrelu, d2s)
    _check_bf16("conv3x3_head", x, w, bias, 3, d2s)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if packed is None:
        packed = pack_conv3x3_weights(w, head=True)
    _check_packed("conv3x3_head", packed, x, cin, cout, 3, True)
    if cin % 8:
        x = F.pad(x, (0, 8 - cin % 8))
        cin = x.shape[3]
    plan = head_plan(n, h, wd, cin, cout, _sm_count(x.device.index
                                                     or 0))
    lib = _build.load_library()
    y = torch.empty(_out_shape(n, h, wd, cout, d2s), dtype=torch.bfloat16,
                    device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_conv3x3_head(
            x.data_ptr(), packed.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            n, h, wd, cin, cout, plan["n_width"],
            _flags(lrelu, round_first, False, d2s), plan["grid"],
            plan["smem"], _build.stream_ptr())
    _build.check("conv3x3_head", err)
    conv3x3_head.launches += 1
    return y


conv3x3_head.launches = 0


def conv2x2_s2d(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None, lrelu: bool, pad: int,
                mask: bool, d2s: bool,
                packed: torch.Tensor | None = None) -> torch.Tensor:
    """2x2 conv over a space-to-depth form at padding ``pad`` (0 or 1),
    with the JAX package's rounding points, the frame mask and
    depth-to-space as asked (``conv2x2_s2d_plain``): K1's 2x2 form.

    x (N, H, W, Cin) and w (2, 2, Cin, Cout) bf16 and bias (Cout,) fp32
    (or None), contiguous on one device, x 16-byte aligned; ``packed`` is
    ``pack_conv2x2_weights(w)`` (made here when None). A Cin that is not a
    multiple of 8 is zero-padded to one first (a copy of x; the folded
    head's 4 nf is one whenever nf is even). Returns (N, H + 2 pad - 1, W +
    2 pad - 1, Cout) bf16, or its d2s form. A float32 x goes
    to ``conv2x2_s2d_f32``; a CPU tensor to the plain version. Anything
    else raises ``KernelInputError``.
    """
    if x.device.type == "cpu":
        return conv2x2_s2d_plain(x, w, bias, lrelu, pad, mask, d2s)
    if not x.is_cuda:
        raise KernelInputError(f"conv2x2_s2d: no kernel for device "
                               f"{x.device}")
    if x.dtype == torch.float32:
        return conv2x2_s2d_f32(x, w, bias, lrelu, pad, mask, d2s)
    _check_bf16("conv2x2_s2d", x, w, bias, 2, d2s, mask)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    ho, wo = h + 2 * pad - 1, wd + 2 * pad - 1
    if pad not in (0, 1) or min(ho, wo) < 1:
        raise KernelInputError(f"conv2x2_s2d: pad {pad} on {tuple(x.shape)}")
    if packed is None:
        packed = pack_conv2x2_weights(w)
    _check_packed("conv2x2_s2d", packed, x, cin, cout, 2, True)
    if cin % 8:
        # The kernel's tensor map steps pixels in 16-byte units: zero
        # channels up to a multiple of 8 (the packing already holds them).
        x = F.pad(x, (0, 8 - cin % 8))
        cin = x.shape[3]
    lib = _build.load_library()
    y = torch.empty(_out_shape(n, ho, wo, cout, d2s), dtype=torch.bfloat16,
                    device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_conv2x2(
            x.data_ptr(), packed.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            n, h, wd, cin, cout, tile_width_2x2(cout)[0], pad,
            _flags(lrelu, True, mask, d2s), _build.stream_ptr())
    _build.check("conv2x2_s2d", err)
    conv2x2_s2d.launches += 1
    return y


conv2x2_s2d.launches = 0


def _check_f32(name: str, x, w, bias, taps: int, to_d2s: bool,
               mask: bool = False) -> None:
    """The float32 forms' input checks (raise ``KernelInputError``)."""
    if x.dim() != 4 or w.shape[:2] != (taps, taps) or w.shape[2] != x.shape[3]:
        raise KernelInputError(f"{name}: bad shapes x "
                               f"{tuple(x.shape)}, w {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    for key, t in (("x", x), ("w", w)) + ((("bias", bias),)
                                           if bias is not None else ()):
        if (t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise KernelInputError(f"{name}: {key} must be a "
                                   f"contiguous float32 tensor on {x.device}")
    if bias is not None and bias.shape != (cout,):
        raise KernelInputError(f"{name}: bias {tuple(bias.shape)}, "
                               f"want ({cout},)")
    if n > 65535 or min(n, h, wd, cin, cout) < 1:
        raise KernelInputError(f"{name}: unsupported shape "
                               f"{tuple(x.shape)}")
    if (to_d2s or mask) and cout % 4:
        raise KernelInputError(f"{name}: d2s and mask need Cout % 4 == 0, "
                               f"got {cout}")


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None,
                lrelu: bool = False, d2s: bool = False) -> torch.Tensor:
    """K1's float32 form: the same SAME 3x3 conv, all in float32.

    On the GPU: x (N, H, W, Cin), w (3, 3, Cin, Cout) and bias (Cout,) (or
    None) float32 and contiguous on one device. Returns (N, H, W, Cout)
    float32; with ``d2s``, its depth-to-space form by the folded head's
    float32 3x3 form (``conv3x3_head_f32``). On the CPU:
    ``conv3x3_plain``. Anything else raises ``KernelInputError``.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias, lrelu, d2s)
    if not x.is_cuda:
        raise KernelInputError(f"conv3x3_f32: no kernel for device "
                               f"{x.device}")
    if d2s:
        return conv3x3_head_f32(x, w, bias, lrelu, d2s)
    _check_f32("conv3x3_f32", x, w, bias, 3, False)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    lib = _build.load_library()
    y = torch.empty((n, h, wd, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_conv3x3_f32(
            x.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            n, h, wd, cin, cout, _flags(lrelu), _build.stream_ptr())
    _build.check("conv3x3_f32", err)
    conv3x3_f32.launches += 1
    return y


conv3x3_f32.launches = 0


def conv3x3_head_f32(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None, lrelu: bool = False,
                     d2s: bool = False) -> torch.Tensor:
    """K1f's head 3x3 form (``csrc/conv3x3_head_f32.cu``): the folded
    head's up1 and up2 in float32, the SAME 3x3 conv with bias, LeakyReLU
    and, with ``d2s``, the depth-to-space store (the JAX package's rounding
    order is moot in float32). x, w, bias float32 and contiguous on one
    device. On the CPU: ``conv3x3_plain``. Anything else raises
    ``KernelInputError``."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias, lrelu, d2s)
    if not x.is_cuda:
        raise KernelInputError(f"conv3x3_head_f32: no kernel for device "
                               f"{x.device}")
    _check_f32("conv3x3_head_f32", x, w, bias, 3, d2s)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    lib = _build.load_library()
    y = torch.empty(_out_shape(n, h, wd, cout, d2s), dtype=torch.float32,
                    device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_conv3x3_head_f32(
            x.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            n, h, wd, cin, cout, _flags(lrelu, False, False, d2s),
            _build.stream_ptr())
    _build.check("conv3x3_head_f32", err)
    conv3x3_head_f32.launches += 1
    return y


conv3x3_head_f32.launches = 0


def conv2x2_s2d_f32(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor | None, lrelu: bool, pad: int,
                    mask: bool, d2s: bool) -> torch.Tensor:
    """K1f's 2x2 form: ``conv2x2_s2d`` all in float32 (x, w, bias float32
    and contiguous on one device). On the CPU: ``conv2x2_s2d_plain``.
    Anything else raises ``KernelInputError``."""
    if x.device.type == "cpu":
        return conv2x2_s2d_plain(x, w, bias, lrelu, pad, mask, d2s)
    if not x.is_cuda:
        raise KernelInputError(f"conv2x2_s2d_f32: no kernel for device "
                               f"{x.device}")
    _check_f32("conv2x2_s2d_f32", x, w, bias, 2, d2s, mask)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    ho, wo = h + 2 * pad - 1, wd + 2 * pad - 1
    if pad not in (0, 1) or min(ho, wo) < 1:
        raise KernelInputError(f"conv2x2_s2d_f32: pad {pad} on "
                               f"{tuple(x.shape)}")
    lib = _build.load_library()
    y = torch.empty(_out_shape(n, ho, wo, cout, d2s), dtype=torch.float32,
                    device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nesr_conv2x2_f32(
            x.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            n, h, wd, cin, cout, pad, _flags(lrelu, False, mask, d2s),
            _build.stream_ptr())
    _build.check("conv2x2_s2d_f32", err)
    conv2x2_s2d_f32.launches += 1
    return y


conv2x2_s2d_f32.launches = 0


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
