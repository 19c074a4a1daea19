"""The RDB step: one conv of the fused trunk's residual dense block with
its share of the dense-block assembly in the epilogue, in bf16 (the K1
step) or float32 (the parity mode).

``conv3x3_rdb`` launches the hand-written Hopper kernel
(``csrc/rdb_bf16.cu``) on a bf16 CUDA tensor, its float32 form
``conv3x3_rdb_f32`` (``csrc/rdb_f32.cu``) on a float32 one, and takes the
plain PyTorch version ``conv3x3_rdb_plain`` only for a tensor on the CPU.
Five steps (k = 0..4) make one RDB of the fused trunk: the JAX package's
``_rdb_fused`` (``models/rrdbnet.py:167``), XLA's bias-free convs with
their assembly, which is no Pallas kernel. Step k is K1's conv k
(``conv3x3`` without bias, rounded to bf16 once; in float32 K1f's)
followed by step k's slice of the assembly that
``models/rrdbnet.FusedRDB._composition`` runs in PyTorch, with its
rounding points; the two agree bit for bit.

Layout: NHWC activations, HWIO weights (3, 3, Cin, Cout) from
``models/rrdbnet.fuse_rdb`` (Cout 4g + nf, 3g + nf, 2g + nf, g + nf, nf),
read as K1 reads them, packed by ``pack_conv3x3_weights``. The slots are
one (N, H, W, 4g + nf) buffer laid out as conv 0's output: conv k's
channel j is slot channel k g + j.

The bf16 launch is ``step_plan``'s: a persistent grid of at most one block
an SM, each block two consumer warpgroups on 4 x 16-pixel tiles of their own
and two producer warps; a sweep's packed weights resident in shared
memory (every N tile where they fit, else one N tile a sweep) and
``step_smem`` the layout the kernel takes. The float32 launch is K1f's
(``csrc/conv3x3_f32_body.cuh``): a block an 8R x 16-pixel tile and every
output channel up to 192, a thread 8 pixels x one 8-channel granule.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import _build
from neural_enhanced_super_resolution_torch.kernels._build import (
    KernelInputError)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    conv3x3_plain, pack_conv3x3_weights, packed_numel, pass_width,
    tile_width)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
    rdb_growth)

__all__ = ["conv3x3_rdb", "conv3x3_rdb_f32", "conv3x3_rdb_plain",
           "StepPlan", "step_plan", "step_smem", "step_tiles", "STEP_SMEM",
           "STEP_TILE"]

# The kernel's geometry (csrc/rdb_bf16.cu): a consumer's tile is
# STEP_TILE = (rows, columns) output pixels, its patch two rows and two
# columns wider; four input stages (two a consumer), or two where four do
# not fit; a TMA box at most 256 channels wide.
STEP_TILE = (4, 16)
STEP_BOX = 256
# The most dynamic shared memory an H100 block may take (227 KB).
STEP_SMEM = 232448


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One launch of the K1 step: the instantiation (``n_width`` x
    ``ks`` k-steps a pass) and its ``n_tiles`` N tiles, the batch's
    ``tiles`` (4 x 16 pixels), ``grid`` persistent blocks, ``nps`` N tiles
    a sweep (the weights a block keeps resident while it walks all its
    tiles), ``stages`` input stages, ``bulk`` (TMA loads and bulk stores;
    else cp.async, and 16-byte or scalar stores) and ``smem`` bytes of
    dynamic shared memory."""
    n_width: int
    ks: int
    n_tiles: int
    tiles: int
    grid: int
    nps: int
    stages: int
    bulk: bool
    smem: int


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def _patch_bytes(cin: int) -> int:
    """A stage's patch, every pass: 6 x 18 pixels at pitch kc + 8, each
    pass 128-byte aligned."""
    kc = pass_width(cin)
    rows, cols = STEP_TILE
    return -(-cin // kc) * _up((rows + 2) * (cols + 2) * (kc + 8) * 2, 128)


def step_smem(k: int, cin: int, cout: int, nf: int, nps: int,
              stages: int = 4) -> int:
    """Bytes of the kernel's shared memory (csrc/rdb_bf16.cu: layout):
    ``nps`` N tiles' packed weights, then ``stages`` stages, each the
    patch of every pass, the staging tile of the sweep (pitch nps N + 8)
    and at step 4 x and skip, then the stages' and the weights' full and
    empty barriers."""
    nw, _ = tile_width(cout)
    kc = pass_width(cin)
    rows, cols = STEP_TILE
    px = rows * cols
    tile = _up(_patch_bytes(cin) + px * (nps * nw + 8) * 2, 128)
    stage = _up(tile + (2 * px * nf * 2 if k == 4 else 0), 128)
    weights = _up(nps * -(-cin // kc) * 9 * kc * nw * 2, 128)
    return weights + stages * stage + 8 * (2 * stages + 2)


def _bulk_fits(k: int, cin: int, cout: int, nf: int, nps: int) -> bool:
    """Whether the bulk path takes this launch: TMA boxes of at most 256
    channels, x_{k+1}'s channels all in the first sweep (out's in one),
    and the dense x_{k+1} or out within a stage's patch."""
    nw, n_tiles = tile_width(cout)
    g = (cout - nf) // 4 if k == 0 else cin
    rows, cols = STEP_TILE
    return (nps * nw + 8 <= STEP_BOX and nf <= STEP_BOX
            and (min(nps * nw, cout) >= g if k < 4 else nps == n_tiles)
            and rows * cols * (g if k < 4 else nf) * 2 <= _patch_bytes(cin))


def step_tiles(n: int, h: int, w: int) -> int:
    """The batch's 4 x 16-pixel tiles: row-major in each image."""
    rows, cols = STEP_TILE
    return n * -(-h // rows) * -(-w // cols)


def step_plan(k: int, cin: int, cout: int, nf: int, n: int, h: int,
              w: int, sms: int, vec: bool = True) -> StepPlan:
    """The launch of step k (cin -> cout, nf the RDB's width) on an (n,
    h, w) batch on a card of ``sms`` SMs: one sweep of every N tile if
    their weights fit beside four stages, else a sweep an N tile (with
    four stages, else two); with ``vec`` (16-byte paths) the bulk path
    where it fits; ``grid`` = min(sms, ceil(tiles / 2)), so that every
    block's first consumer has a tile. Raises ``KernelInputError`` where
    not even one N tile fits."""
    nw, n_tiles = tile_width(cout)
    for nps, stages in ((n_tiles, 4), (1, 4), (1, 2)):
        smem = step_smem(k, cin, cout, nf, nps, stages)
        if smem <= STEP_SMEM:
            tiles = step_tiles(n, h, w)
            return StepPlan(nw, pass_width(cin) // 16, n_tiles, tiles,
                            max(1, min(sms, -(-tiles // 2))), nps, stages,
                            vec and _bulk_fits(k, cin, cout, nf, nps), smem)
    raise KernelInputError(f"conv3x3_rdb: step {k} ({cin} -> {cout}) does "
                           "not fit in shared memory")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _check_step(k, src, w, b, slots, xn, x, skip, packed,
                name="conv3x3_rdb"):
    """The checks before a launch (raise ``KernelInputError``): src, w,
    slots, xn, x and skip all bf16 or all float32, b float32; ``packed``
    (bf16 only) ``pack_conv3x3_weights(w)``. Returns (g, nf, Cout)."""
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
    dt = src.dtype
    acts = [t for t in (src, w, slots, xn, x, skip) if t is not None]
    if (dt not in (torch.bfloat16, torch.float32)
            or any(t.dtype != dt for t in acts)
            or b.dtype != torch.float32 or b.shape != (cs,)):
        raise KernelInputError(
            f"{name}: needs bf16 (or float32) src, w, slots, xn, x and skip "
            f"alike and float32 ({cs},) biases, got "
            f"{[str(t.dtype) for t in acts]}, b {b.dtype}")
    if (k == 4) != (x is not None) or (skip is not None and k != 4):
        raise KernelInputError(f"{name}: x (and skip) belong to step 4")
    extra = [t for t in (x, skip) if t is not None]
    if any(t.shape != (*src.shape[:3], nf) for t in extra):
        raise KernelInputError(f"{name}: x and skip must be ({nf},)-channel "
                               "tensors")
    if xn is not None and (k == 4 or xn.shape != (*src.shape[:3], g)):
        raise KernelInputError(f"{name}: xn is step k < 4's "
                               f"({g},)-channel x_(k+1)")
    ops = [t for t in (src, w, b, slots, packed, xn, *extra) if t is not None]
    if any(t.device != src.device for t in ops):
        raise KernelInputError(f"{name}: operands on different devices")
    if not all(t.is_contiguous() for t in ops):
        raise KernelInputError(f"{name}: operands must be contiguous")
    if xn is not None and xn.data_ptr() == src.data_ptr():
        raise KernelInputError(f"{name}: x_(k+1) must not overwrite x_k, "
                               "whose halo other blocks still read")
    if src.shape[0] > 65535 or min(src.shape[1:3]) < 1:
        raise KernelInputError(f"{name}: unsupported shape "
                               f"{tuple(src.shape)}")
    if dt == torch.float32:
        return g, nf, cout
    if src.data_ptr() % 16 or packed.data_ptr() % 16:
        raise KernelInputError(f"{name}: src and packed must be 16-byte "
                               "aligned")
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

    On the GPU one launch of ``csrc/rdb_bf16.cu`` as ``step_plan`` lays it
    out, everything bf16 but b; ``packed`` is ``pack_conv3x3_weights(w)``
    (made here when None). A float32 src goes to ``conv3x3_rdb_f32``
    (``packed`` unused).
    Anything the kernel does not take raises ``KernelInputError``.
    """
    if src.device.type == "cpu":
        return conv3x3_rdb_plain(k, src, w, b, slots, xn, x, skip)
    if not src.is_cuda:
        raise KernelInputError(f"conv3x3_rdb: no kernel for device "
                               f"{src.device}")
    if src.dtype == torch.float32:
        return conv3x3_rdb_f32(k, src, w, b, slots, xn, x, skip)
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
    plan = step_plan(k, cin, cout, nf, n, h, wd,
                     _sms(src.device.index if src.device.index is not None
                          else torch.cuda.current_device()), bool(vec))
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        err = lib.nesr_rdb_bf16_step(
            src.data_ptr(), packed.data_ptr(), b.data_ptr(),
            slots.data_ptr(), None if k == 4 else y.data_ptr(),
            None if x is None else x.data_ptr(),
            None if skip is None else skip.data_ptr(),
            None if out is None else out.data_ptr(),
            n, h, wd, cin, cout, k, g, 4 * g + nf, plan.n_width, vec,
            plan.grid, plan.nps, plan.stages, int(plan.bulk),
            plan.smem, _build.stream_ptr())
    _build.check("conv3x3_rdb", err)
    conv3x3_rdb.launches += 1
    return y


conv3x3_rdb.launches = 0


def conv3x3_rdb_f32(k: int, src: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, slots: torch.Tensor,
                    xn: torch.Tensor | None = None,
                    x: torch.Tensor | None = None,
                    skip: torch.Tensor | None = None) -> torch.Tensor:
    """The float32 RDB step (``csrc/rdb_f32.cu``): step k of
    ``conv3x3_rdb`` with every operand float32, one launch of K1f's
    bias-free conv with step k's slice of the assembly in its epilogue.
    Its arguments and result are ``conv3x3_rdb``'s. On the CPU:
    ``conv3x3_rdb_plain``. Anything else raises ``KernelInputError``."""
    if src.device.type == "cpu":
        return conv3x3_rdb_plain(k, src, w, b, slots, xn, x, skip)
    if not src.is_cuda:
        raise KernelInputError(f"conv3x3_rdb_f32: no kernel for device "
                               f"{src.device}")
    g, nf, cout = _check_step(k, src, w, b, slots, xn, x, skip, None,
                              "conv3x3_rdb_f32")
    if src.dtype != torch.float32:
        raise KernelInputError(f"conv3x3_rdb_f32: needs float32 operands, "
                               f"got {src.dtype}")
    n, h, wd, cin = src.shape
    if k < 4:
        y = xn if xn is not None else torch.empty(
            (n, h, wd, g), dtype=torch.float32, device=src.device)
        out = None
    else:
        y = out = torch.empty_like(x)
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        err = lib.nesr_rdb_f32_step(
            src.data_ptr(), w.data_ptr(), b.data_ptr(), slots.data_ptr(),
            None if k == 4 else y.data_ptr(),
            None if x is None else x.data_ptr(),
            None if skip is None else skip.data_ptr(),
            None if out is None else out.data_ptr(),
            n, h, wd, cin, cout, k, g, 4 * g + nf, _build.stream_ptr())
    _build.check("conv3x3_rdb_f32", err)
    conv3x3_rdb_f32.launches += 1
    return y


conv3x3_rdb_f32.launches = 0
