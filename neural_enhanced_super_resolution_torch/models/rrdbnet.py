"""RRDBNet (the Real-ESRGAN backbone) in PyTorch, NHWC, on the port's kernels.

Counterpart of ``neural_enhanced_super_resolution_tpu/models/rrdbnet.py``.
Activations are NHWC in the compute dtype (bf16 on the GPU, f32 for parity
on the CPU); every 3x3 conv goes through K1 (``kernels.conv3x3``), which
accumulates in fp32. The trunk is one of:

* ``"fused"`` (config ``esrgan_trunk`` unset or ``"xla"``): the source-major
  fused RDB (``fuse_rdb``), the JAX package's ``_rdb_fused``: five launches
  of the RDB step (``kernels.conv3x3_rdb``) an RDB, each K1's bias-free conv
  rounded to bf16 with its share of the dense-block assembly (the same
  additions in the same order) in its epilogue, and each RRDB's residual
  folded into its third RDB's last step; in float32 (the parity mode) the
  same five launches of its float32 form (``kernels.conv3x3_rdb_f32``:
  K1f's conv with the assembly in its epilogue);
* ``"dform"``: one K2 launch (``kernels.rdb_fused``) per RDB, bf16 only;
* ``"int8"``: the fused RDB with per-output-channel int8 weights and
  dynamic per-tensor int8 activations: the JAX package's
  ``_rdb_fused_int8``, with its rounding points. Each of its five convs is
  one launch of K4's redesign (``kernels.conv3x3_int8.conv3x3_int8_rdb``),
  which quantises its input while it loads it and does its share of the
  dense-block assembly in its epilogue; the scales pass from launch to
  launch on the device, started by one ``int8_amax`` a forward, and each
  RRDB's residual is folded into its third RDB's last step (the head
  stays on K1 in the compute dtype);
* ``"stock"``: the unfused basicsr RDB (``fuse_rdb: false``).

``TrainableRRDBNet`` is the stock network as the JAX trainer differentiates
it (``tools/train_tiny_esrgan.py``): float32 ``nn.Parameter``s under the
basicsr names, every conv through ``kernels.conv3x3.Conv3x3Function`` (K1f
forward and input gradient on the card).

The upsampling head of the ``fused``, ``dform`` and ``int8`` trunks (the
JAX package's ``fuse_rdb: true`` layouts) is the folded one, as the JAX
package's ``fold_head_params`` / ``_head_forward`` make and run it
(``FoldedHead``): conv_up1 and conv_up2 folded with their nearest x2 into
3x3 convs 64 -> 256 at the lower resolution (K1's head 3x3 form, the
first storing its output depth-to-space), then conv_hr and conv_last
folded into 2x2 convs over the space-to-depth form (K1's 2x2 form; the
first masks the frame, the second stores depth-to-space), with the JAX
package's rounding points, in any compute dtype (K1f's forms in float32). The ``stock`` trunk and ``TrainableRRDBNet`` run the
stock head (nearest x2 + conv, twice, then conv_hr and conv_last), as the
JAX package does for unfused parameters; ``RRDBNet.stock_head`` runs it
on any trunk.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    Conv3x3Function, conv2x2_s2d, conv2x2_s2d_plain, conv3x3, conv3x3_plain,
    d2s, frame_border_mask, pack_conv2x2_weights, pack_conv3x3_weights)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
    conv3x3_int8_plain, conv3x3_int8_rdb, int8_amax,
    pack_conv3x3_int8_weights, quantize_int8)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
    conv3x3_rdb, conv3x3_rdb_plain)
from neural_enhanced_super_resolution_torch.kernels.rdb_fused import (
    rdb_fused, rdb_fused_plain)
from neural_enhanced_super_resolution_torch.models.weights import HEAD_CONVS

__all__ = ["RRDBNetConfig", "RRDBNet", "TrainableRRDBNet", "FusedRDB",
           "Int8RDB", "Conv3x3", "Conv2x2", "FoldedHead",
           "pixel_unshuffle", "nearest_x2", "fuse_rdb", "quantize_rdb",
           "fold_upconv_weights", "fold_s2d2x2_weights", "fold_head_weights",
           "d2s", "frame_border_mask", "TRUNKS"]

TRUNKS = ("fused", "dform", "stock", "int8")


class RRDBNetConfig:
    """Static architecture hyperparameters (hashable)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, scale: int = 4,
                 num_feat: int = 64, num_block: int = 23, num_grow_ch: int = 32):
        if scale not in (1, 2, 4):
            raise ValueError(f"scale must be 1, 2 or 4, got {scale}")
        self.num_in_ch = num_in_ch
        self.num_out_ch = num_out_ch
        self.scale = scale
        self.num_feat = num_feat
        self.num_block = num_block
        self.num_grow_ch = num_grow_ch

    @property
    def conv_first_in_ch(self) -> int:
        # basicsr: scale 2 -> pixel_unshuffle(2), scale 1 -> unshuffle(4).
        return self.num_in_ch * {1: 16, 2: 4, 4: 1}[self.scale]

    def _key(self):
        return (self.num_in_ch, self.num_out_ch, self.scale, self.num_feat,
                self.num_block, self.num_grow_ch)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, RRDBNetConfig) and self._key() == other._key()

    def __repr__(self):
        return f"RRDBNetConfig{self._key()}"


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NHWC pixel-unshuffle with torch channel order (c*r*r + ry*r + rx)."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // r, w // r, c * r * r)


def nearest_x2(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2, mode='nearest') in NHWC."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)


def fuse_rdb(ws: list[torch.Tensor], bs: list[torch.Tensor]
             ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Source-major regrouping of one RDB (exact reparameterisation).

    ws: conv1..conv5 HWIO weights (3, 3, nf + k*gc, gc or nf); bs their
    biases. A dense-block conv over concat([x, x1, .., xk]) is the sum of
    convs over the segments; grouping by source gives five wide convs
    w0..w4 with Cout 4g+nf, 3g+nf, 2g+nf, g+nf, nf. Returns (w0..w4, b)
    with b the concatenated conv1..conv5 biases (4g + nf,).
    Same math as ``fuse_rrdbnet_params`` of the JAX package, per RDB.
    """
    nf, gc = ws[0].shape[2], ws[0].shape[3]

    def seg(w, s):
        return w[:, :, nf + (s - 1) * gc:nf + s * gc, :]

    w0 = torch.cat([ws[0]] + [w[:, :, :nf, :] for w in ws[1:]], dim=-1)
    w1 = torch.cat([seg(w, 1) for w in ws[1:]], dim=-1)
    w2 = torch.cat([seg(w, 2) for w in ws[2:]], dim=-1)
    w3 = torch.cat([seg(w, 3) for w in ws[3:]], dim=-1)
    w4 = seg(ws[4], 4)
    return [w0, w1, w2, w3, w4], torch.cat(list(bs), dim=-1)


def quantize_rdb(fw: list[torch.Tensor]
                 ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-output-channel symmetric int8 weights of one fused RDB (w0..w4
    from ``fuse_rdb``), as ``fuse_rrdbnet_params_int8`` of the JAX package
    makes them, in float32 on the CPU: s = max(max|w| over (ky, kx, Cin),
    1e-12) / 127 and q = clip(round_half_even(w / s), -127, 127). Returns
    (q int8 HWIO, s float32 (Cout,)) per conv."""
    wq, ws = [], []
    for w in fw:
        w = w.detach().to("cpu", torch.float32)
        s = torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
        wq.append(torch.clamp(torch.round(w / s), -127, 127).to(torch.int8))
        ws.append(s)
    return wq, ws


def _hwio(w_oihw: torch.Tensor) -> torch.Tensor:
    return w_oihw.permute(2, 3, 1, 0)


def fold_upconv_weights(w: torch.Tensor, b: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(3,3,C,D) + (D,) -> (3,3,C,4D) + (4D,): conv3x3 o nearest_x2 as one
    3x3 conv at the low resolution (the JAX package's
    ``fold_upconv_weights``, in float32 with its loop order, so the sums
    are its bit for bit).

    Output channel (oi*2+oj)*D + f holds the 2x-res output at subpixel
    (oi, oj); per subpixel, nearest duplication collapses kernel taps:
    oi=0: rows {W[0] | W[1]+W[2]}, oi=1: {W[0]+W[1] | W[2]} (cols same).
    """
    w = w.detach().to("cpu", torch.float32)
    b = b.detach().to("cpu", torch.float32)
    c, d = w.shape[2], w.shape[3]
    rowmaps = {0: {0: [0], 1: [1, 2]}, 1: {1: [0, 1], 2: [2]}}
    out = torch.zeros((3, 3, c, 4 * d))
    for oi in range(2):
        for oj in range(2):
            sub = torch.zeros((3, 3, c, d))
            for drp, srcs_r in rowmaps[oi].items():
                for dcp, srcs_c in rowmaps[oj].items():
                    for dr in srcs_r:
                        for dc in srcs_c:
                            sub[drp, dcp] += w[dr, dc]
            out[..., (oi * 2 + oj) * d:(oi * 2 + oj + 1) * d] = sub
    return out, b.repeat(4)


def fold_s2d2x2_weights(w: torch.Tensor, b: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(3,3,C,D) + (D,) -> (2,2,4C,4D) + (4D,): the 3x3 conv on the
    space-to-depth form (channel (pi*2+pj)*C + c) as a 2x2 conv (the JAX
    package's ``fold_s2d2x2_weights``). Kernel tap (ki,kj) takes w[di,dj]
    with di = 2ki+pi-oi (dj likewise) when within 0..2.

    At padding (1,1) the output gains a row and a column and covers the
    half-pixel frame; a second fold applied VALID consumes that frame and
    restores alignment (``FoldedHead``).
    """
    w = w.detach().to("cpu", torch.float32)
    b = b.detach().to("cpu", torch.float32)
    c, d = w.shape[2], w.shape[3]
    out = torch.zeros((2, 2, 4 * c, 4 * d))
    for ki in range(2):
        for kj in range(2):
            for pi in range(2):
                for pj in range(2):
                    for oi in range(2):
                        for oj in range(2):
                            di, dj = 2 * ki + pi - oi, 2 * kj + pj - oj
                            if 0 <= di <= 2 and 0 <= dj <= 2:
                                ci = (pi * 2 + pj) * c
                                co = (oi * 2 + oj) * d
                                out[ki, kj, ci:ci + c, co:co + d] = w[di, dj]
    return out, b.repeat(4)


def fold_head_weights(sd: Mapping[str, torch.Tensor]
                      ) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """The folded head's float32 HWIO weights and biases from a basicsr
    state dict, under the JAX package's ``fold_head_params`` names:
    up1_fold, up2_fold (3, 3, nf, 4 nf), hr_fold (2, 2, 4 nf, 4 nf),
    last_fold (2, 2, 4 nf, 4 out)."""
    def wb(key):
        return _hwio(sd[f"{key}.weight"]), sd[f"{key}.bias"]

    return {"up1_fold": fold_upconv_weights(*wb("conv_up1")),
            "up2_fold": fold_upconv_weights(*wb("conv_up2")),
            "hr_fold": fold_s2d2x2_weights(*wb("conv_hr")),
            "last_fold": fold_s2d2x2_weights(*wb("conv_last"))}


def _k1(x, w, b, lrelu, packed, plain, to_d2s=False, round_first=False):
    if plain:
        return conv3x3_plain(x, w, b, lrelu, to_d2s, round_first)
    return conv3x3(x, w, b, lrelu, packed=packed, d2s=to_d2s,
                   round_first=round_first)


class Conv3x3(nn.Module):
    """One 3x3 conv through K1: HWIO weight (3, 3, Cin, Cout) in the compute
    dtype, its packed image (packed once at build, for the folded head's
    3x3 form with ``head``; the CPU's plain version reads HWIO), fp32
    bias."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, dtype, device,
                 head: bool = False):
        super().__init__()
        self.register_buffer("w", w.to(device=device, dtype=dtype)
                             .contiguous())
        self.register_buffer("wp", pack_conv3x3_weights(self.w, head))
        self.register_buffer("b", b.to(device=device, dtype=torch.float32)
                             .contiguous())

    def forward(self, x: torch.Tensor, lrelu: bool = False,
                plain: bool = False, d2s: bool = False,
                round_first: bool = False) -> torch.Tensor:
        return _k1(x.contiguous(), self.w, self.b, lrelu, self.wp, plain, d2s,
                   round_first)


class Conv2x2(nn.Module):
    """One 2x2 conv over a space-to-depth form through K1's 2x2 form
    (``conv2x2_s2d``): HWIO weight (2, 2, Cin, Cout) in the compute dtype,
    its packed image (packed once at build), fp32 bias."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, dtype, device):
        super().__init__()
        self.register_buffer("w", w.to(device=device, dtype=dtype)
                             .contiguous())
        self.register_buffer("wp", pack_conv2x2_weights(self.w))
        self.register_buffer("b", b.to(device=device, dtype=torch.float32)
                             .contiguous())

    def forward(self, x: torch.Tensor, lrelu: bool, pad: int, mask: bool,
                d2s: bool, plain: bool = False) -> torch.Tensor:
        x = x.contiguous()
        if plain:
            return conv2x2_s2d_plain(x, self.w, self.b, lrelu, pad, mask, d2s)
        return conv2x2_s2d(x, self.w, self.b, lrelu, pad, mask, d2s,
                           packed=self.wp)


class FoldedHead(nn.Module):
    """The JAX package's folded upsampling head (``_head_forward``), four
    launches (K1's or K1f's head 3x3 form twice, their 2x2 form twice):
    feat (N, H, W, nf) -> (N, 4H, 4W, num_out_ch) in the compute dtype.

    up1: the folded 3x3 conv nf -> 4 nf, bias, LeakyReLU, stored
    depth-to-space (N, 2H, 2W, nf); up2: the same without the
    depth-to-space, (N, 2H, 2W, 4 nf), the space-to-depth form of the 4x
    map; hr: the 2x2 conv 4 nf -> 4 nf at padding 1, LeakyReLU, the frame
    mask, (N, 2H+1, 2W+1, 4 nf); last: the 2x2 conv 4 nf -> 4 out VALID,
    stored depth-to-space. Each rounds as JAX's ``_conv`` then ``_lrelu``:
    fp32 accumulation and bias, the compute dtype, then the LeakyReLU. The
    weights are folded in float32 from the state dict
    (``fold_head_weights``), cast to the compute dtype and packed once."""

    def __init__(self, sd: Mapping[str, torch.Tensor], dtype, device):
        super().__init__()
        f = fold_head_weights(sd)
        self.up1 = Conv3x3(*f["up1_fold"], dtype, device, head=True)
        self.up2 = Conv3x3(*f["up2_fold"], dtype, device, head=True)
        self.hr = Conv2x2(*f["hr_fold"], dtype, device)
        self.last = Conv2x2(*f["last_fold"], dtype, device)

    def forward(self, feat: torch.Tensor, plain: bool = False
                ) -> torch.Tensor:
        y = self.up1(feat, lrelu=True, plain=plain, d2s=True,
                     round_first=True)
        z = self.up2(y, lrelu=True, plain=plain, round_first=True)
        h = self.hr(z, lrelu=True, pad=1, mask=True, d2s=False, plain=plain)
        return self.last(h, lrelu=False, pad=0, mask=False, d2s=True,
                         plain=plain)


def _conv(sd: Mapping[str, torch.Tensor], key: str, dtype, device
          ) -> Conv3x3:
    """The basicsr conv ``key`` (OIHW) as a Conv3x3."""
    return Conv3x3(_hwio(sd[f"{key}.weight"]), sd[f"{key}.bias"], dtype,
                   device)


class _StockRDB(nn.Module):
    """basicsr ResidualDenseBlock: 5 dense convs + 0.2-scaled residual."""

    def __init__(self, sd, prefix, dtype, device):
        super().__init__()
        self.convs = nn.ModuleList(
            _conv(sd, f"{prefix}.conv{i}", dtype, device) for i in range(1, 6))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        c = x
        for conv in self.convs[:4]:
            c = torch.cat([c, conv(c, lrelu=True, plain=plain)], dim=-1)
        return x + 0.2 * self.convs[4](c, plain=plain)

    def folds_skip(self, x: torch.Tensor) -> bool:
        """Whether ``forward`` takes an RRDB's input as ``skip`` (see
        ``_RRDB.forward``): never here."""
        return False


class FusedRDB(nn.Module):
    """Source-major fused RDB: five launches of the RDB step
    (``conv3x3_rdb``: K1's conv with its share of the dense-block assembly
    in the epilogue; in float32, the parity mode, K1f's), or one K2
    (``kernel``, bf16).

    fw: w0..w4 HWIO (from ``fuse_rdb``), fb: the (4g + nf,) biases;
    p0..p4 are their packed images, which K1, its step and K2 read alike
    (the float32 step reads the HWIO weights, as K1f does).
    ``_composition`` (five K1 / K1f convs and the assembly in PyTorch) is
    the steps' yardstick, on no path."""

    def __init__(self, fw, fb, dtype, device, kernel: bool):
        super().__init__()
        for i, w in enumerate(fw):
            self.register_buffer(f"w{i}", w.to(device=device, dtype=dtype)
                                 .contiguous())
            self.register_buffer(f"p{i}", pack_conv3x3_weights(
                getattr(self, f"w{i}")))
        self.register_buffer("b", fb.to(device=device, dtype=torch.float32)
                             .contiguous())
        self.kernel = kernel
        self.gc = fw[1].shape[2]

    def weights(self) -> list[torch.Tensor]:
        return [self.w0, self.w1, self.w2, self.w3, self.w4]

    def packed(self) -> list[torch.Tensor]:
        return [self.p0, self.p1, self.p2, self.p3, self.p4]

    def folds_skip(self, x: torch.Tensor) -> bool:
        """Whether ``forward`` runs the RDB step, and so takes ``skip``:
        the source-major trunk, in bf16 and in float32. (The tests and
        ``chip_smoke.py`` patch it false to run the trunk on
        ``_composition``.)"""
        return not self.kernel

    def forward(self, x: torch.Tensor, plain: bool = False,
                skip: torch.Tensor | None = None) -> torch.Tensor:
        """skip (the RDB step only): an RRDB's input, which makes the
        result the RRDB's, skip + 0.2 * out."""
        if self.kernel:
            if plain:
                return rdb_fused_plain(x, self.weights(), self.b)
            return rdb_fused(x, self.weights(), self.b,
                             packed=self.packed())
        if not self.folds_skip(x):
            if skip is not None:
                raise ValueError("skip is folded by the RDB step only")
            return self._composition(x, plain)
        x = x.contiguous()
        n, h, wd, _ = x.shape
        # The slots, laid out as conv 0's output, and x_1..x_4 in two
        # buffers used in turns: step k reads x_k's halo while it writes
        # x_{k+1}.
        slots = torch.empty((n, h, wd, self.b.numel()), dtype=x.dtype,
                            device=x.device)
        xs = [torch.empty((n, h, wd, self.gc), dtype=x.dtype,
                          device=x.device) for _ in range(2)]
        t = x
        for k, (w, p) in enumerate(zip(self.weights(), self.packed())):
            io = dict(x=x, skip=skip) if k == 4 else dict(xn=xs[k % 2])
            t = (conv3x3_rdb_plain(k, t, w, self.b, slots, **io) if plain
                 else conv3x3_rdb(k, t, w, self.b, slots, packed=p, **io))
        return t

    def _composition(self, x: torch.Tensor, plain: bool = False
                     ) -> torch.Tensor:
        """The RDB as five bias-free K1 (K1f) convs with the dense-block
        assembly in PyTorch between them: what the RDB step equals bit
        for bit, and its yardstick."""
        g, b, dt = self.gc, self.b, x.dtype
        w = self.weights()
        p = self.packed()

        def conv(t, k):
            return _k1(t, w[k], None, False, p[k], plain)

        c = conv(x, 0)
        # Running sums of the later destinations [a2 | a3 | a4 | a5], one
        # add of each conv's tail per stage, in place: the same additions
        # in the same order (rounded to dt after each) as the JAX package's
        # _rdb_fused, which sums c0 + c1 + ... per destination.
        slots = c[..., g:]
        xk = F.leaky_relu(c[..., :g] + b[:g], 0.2).to(dt)
        for k in range(1, 4):
            c = conv(xk, k)
            lo = (k - 1) * g
            xk = F.leaky_relu(slots[..., lo:lo + g] + c[..., :g]
                              + b[k * g:(k + 1) * g], 0.2).to(dt)
            slots[..., lo + g:] += c[..., g:]
        x5 = slots[..., 3 * g:] + conv(xk, 4) + b[4 * g:]
        return x + 0.2 * x5.to(dt)


class Int8RDB(nn.Module):
    """The fused RDB on int8 operands (``_rdb_fused_int8``): five launches
    of ``conv3x3_int8_rdb``, or with ``plain=True`` the composition each
    launch replaces: ``quantize_int8``, ``conv3x3_int8_plain`` and the
    JAX package's float32 assembly in PyTorch.

    wq: w0..w4 int8 HWIO, ws: their (Cout,) float32 scales (from
    ``quantize_rdb``), b: the (4g + nf,) biases; q0..q4 / s0..s4 hold them,
    p0..p4 their packed images. Each conv quantises its input over the
    whole batch tensor, so the output depends on how tiles are batched, as
    in the JAX package."""

    def __init__(self, wq, ws, b, device):
        super().__init__()
        for i in range(5):
            self.register_buffer(f"q{i}", wq[i].to(device).contiguous())
            self.register_buffer(f"s{i}", ws[i].to(device, torch.float32)
                                 .contiguous())
            self.register_buffer(f"p{i}", pack_conv3x3_int8_weights(
                getattr(self, f"q{i}")))
        self.register_buffer("b", b.to(device=device, dtype=torch.float32)
                             .contiguous())
        self.gc = wq[1].shape[2]

    def folds_skip(self, x: torch.Tensor) -> bool:
        """Whether ``forward`` takes ``skip``: always (its last step adds
        the residual, and the plain version adds it after)."""
        return True

    def forward(self, x: torch.Tensor, plain: bool = False,
                scales: torch.Tensor | None = None,
                skip: torch.Tensor | None = None) -> torch.Tensor:
        """scales: the (6,) slice of an ``int8_amax`` chain whose [0] is
        max|x| (made here when None; the steps fill [1..5], [5] being
        max|out|). skip: an RRDB's input, which makes the result the
        RRDB's, skip + 0.2 * out."""
        if plain:
            out = self._composition(x)
            return out if skip is None else skip + 0.2 * out
        x = x.contiguous()
        if scales is None:
            scales = int8_amax(x, 5)
        n, h, w, _ = x.shape
        slots = torch.empty((n, h, w, self.b.numel()), dtype=torch.bfloat16,
                            device=x.device)
        t = x
        for k in range(5):
            last = k == 4
            t = conv3x3_int8_rdb(
                k, t, scales[k], scales[k + 1], getattr(self, f"q{k}"),
                getattr(self, f"s{k}"), self.b, slots,
                x=x if last else None, skip=skip if last else None,
                packed=getattr(self, f"p{k}"))
        return t

    def _composition(self, x: torch.Tensor) -> torch.Tensor:
        g, b = self.gc, self.b

        def conv(h, k):
            q, s_x = quantize_int8(h)
            return conv3x3_int8_plain(q, getattr(self, f"q{k}"), s_x,
                                      getattr(self, f"s{k}"))

        # The conv outputs are bf16; x1..x4 stay float32 (bf16 slices summed
        # left to right in bf16, plus the float32 bias, LeakyReLU), as
        # _rdb_fused_int8 leaves them, and are quantised from float32.
        c = [conv(x, 0)]
        xk = F.leaky_relu(c[0][..., :g] + b[:g], 0.2)
        for k in range(1, 4):
            c.append(conv(xk, k))
            s = c[0][..., k * g:(k + 1) * g]
            for j in range(1, k + 1):
                s = s + c[j][..., (k - j) * g:(k - j + 1) * g]
            xk = F.leaky_relu(s + b[k * g:(k + 1) * g], 0.2)
        c.append(conv(xk, 4))
        x5 = c[0][..., 4 * g:]
        for j in range(1, 5):
            x5 = x5 + c[j][..., (4 - j) * g:]
        return x + 0.2 * (x5 + b[4 * g:]).to(x.dtype)


class _RRDB(nn.Module):
    def __init__(self, sd, i, dtype, device, trunk):
        super().__init__()
        def mk(prefix):
            if trunk == "stock":
                return _StockRDB(sd, prefix, dtype, device)
            fw, fb = fuse_rdb(
                [_hwio(sd[f"{prefix}.conv{c}.weight"]).float()
                 for c in range(1, 6)],
                [sd[f"{prefix}.conv{c}.bias"].float() for c in range(1, 6)])
            if trunk == "int8":
                return Int8RDB(*quantize_rdb(fw), fb, device)
            return FusedRDB(fw, fb, dtype, device, kernel=trunk == "dform")

        self.int8 = trunk == "int8"
        self.rdbs = nn.ModuleList(mk(f"body.{i}.rdb{k}") for k in (1, 2, 3))

    def forward(self, x: torch.Tensor, plain: bool = False,
                scales: torch.Tensor | None = None) -> torch.Tensor:
        """scales (int8 trunk): the (16,) slice of an ``int8_amax`` chain
        whose [0] is max|x| (made here when None); the third RDB's last
        step adds the residual x + 0.2 * out and fills [15] with its
        max, the next RRDB's scale. Where the RDBs fold the residual
        (``folds_skip``: the RDB step in bf16 and float32, the int8
        trunk), the third takes x as ``skip``; otherwise (K2, the stock
        RDB) it is a separate add."""
        if not self.rdbs[0].folds_skip(x):
            out = x
            for rdb in self.rdbs:
                out = rdb(out, plain=plain)
            return x + 0.2 * out
        if self.int8 and not plain and scales is None:
            scales = int8_amax(x, 15)
        out = x
        for r, rdb in enumerate(self.rdbs):
            chain = ({} if scales is None
                     else {"scales": scales[5 * r:5 * r + 6]})
            out = rdb(out, plain=plain, skip=x if r == 2 else None, **chain)
        return out


class RRDBNet(nn.Module):
    """RRDBNet built from a basicsr state dict on an explicit device.

    forward: x (N, H, W, num_in_ch) float in [0, 1] ->
    (N, H*scale, W*scale, num_out_ch) float32.
    """

    def __init__(self, cfg: RRDBNetConfig, state_dict: Mapping[str,
                 torch.Tensor], dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda", trunk: str = "fused"):
        super().__init__()
        if trunk not in TRUNKS:
            raise ValueError(f"unknown trunk {trunk!r}, one of {TRUNKS}")
        if trunk == "dform" and dtype != torch.bfloat16:
            raise ValueError("the dform trunk (K2) runs in bfloat16 only; "
                             f"got {dtype}")
        self.cfg, self.dtype, self.trunk = cfg, dtype, trunk
        sd = state_dict
        for name in HEAD_CONVS:
            setattr(self, name, _conv(sd, name, dtype, device))
        self.body = nn.ModuleList(_RRDB(sd, i, dtype, device, trunk)
                                  for i in range(cfg.num_block))
        # The fused layouts run the folded head, as the JAX package's
        # fuse_rrdbnet_params (and its int8 form) attach it.
        self.folded_head = (None if trunk == "stock"
                            else FoldedHead(sd, dtype, device))

    def body_forward(self, feat: torch.Tensor, plain: bool = False
                     ) -> torch.Tensor:
        """The trunk's RRDBs on conv_first's output. The int8 trunk runs
        one chain of scales for all of them (15 steps an RRDB), started by
        one ``int8_amax``."""
        body = feat
        if self.trunk == "int8" and not plain:
            scales = int8_amax(feat, 15 * len(self.body))
            for i, block in enumerate(self.body):
                body = block(body, scales=scales[15 * i:15 * i + 16])
            return body
        for block in self.body:
            body = block(body, plain=plain)
        return body

    @torch.no_grad()
    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """plain=True runs every kernel's plain version instead (the
        reference a kernel run is held against on the card)."""
        if self.cfg.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.cfg.scale == 1:
            x = pixel_unshuffle(x, 4)
        p = plain
        feat = self.conv_first(x.to(self.dtype), plain=p)
        feat = feat + self.conv_body(self.body_forward(feat, plain=p),
                                     plain=p)
        if self.folded_head is not None:
            return self.folded_head(feat, plain=p).float()
        return self.stock_head(feat, plain=p).float()

    def stock_head(self, feat: torch.Tensor, plain: bool = False
                   ) -> torch.Tensor:
        """The stock upsampling head on the trunk's output: nearest x2 +
        conv_up1, nearest x2 + conv_up2, conv_hr, conv_last (four K1
        launches and two copies), in the compute dtype."""
        p = plain
        feat = self.conv_up1(nearest_x2(feat), lrelu=True, plain=p)
        feat = self.conv_up2(nearest_x2(feat), lrelu=True, plain=p)
        return self.conv_last(self.conv_hr(feat, lrelu=True, plain=p),
                              plain=p)


class _TrainConv(nn.Module):
    """A float32 3x3 conv with basicsr's parameters: ``weight`` (Cout, Cin,
    3, 3), ``bias`` (Cout,)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin, 3, 3)))
        self.bias = nn.Parameter(torch.empty((cout,)))

    def forward(self, x: torch.Tensor, lrelu: bool = False,
                plain: bool = False) -> torch.Tensor:
        w = _hwio(self.weight).contiguous()
        if plain:
            return conv3x3_plain(x, w, self.bias, lrelu)
        return Conv3x3Function.apply(x, w, self.bias, lrelu)


class _TrainRDB(nn.Module):
    """JAX ``_rdb``: five dense convs (concatenated inputs) + x + 0.2 x5."""

    def __init__(self, nf: int, gc: int):
        super().__init__()
        for c in range(1, 6):
            setattr(self, f"conv{c}",
                    _TrainConv(nf + (c - 1) * gc, gc if c < 5 else nf))

    def forward(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        c = x
        for k in range(1, 5):
            c = torch.cat([c, getattr(self, f"conv{k}")(c, True, plain)],
                          dim=-1)
        return x + 0.2 * self.conv5(c, plain=plain)


class _TrainRRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = (_TrainRDB(nf, gc) for _ in range(3))

    def forward(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        out = self.rdb3(self.rdb2(self.rdb1(x, plain), plain), plain)
        return x + 0.2 * out


class TrainableRRDBNet(nn.Module):
    """The stock RRDBNet in float32 with trainable parameters.

    Its parameters carry the basicsr names, so ``state_dict()`` is the
    checkpoint; ``state_dict`` (from ``init_rrdbnet``, ``params_from_jax`` or
    a file) loads strictly. forward: x (N, H, W, num_in_ch) float32 ->
    (N, H*scale, W*scale, num_out_ch) float32, with the stock trunk's
    concatenations and the unfolded head, as JAX ``rrdbnet_forward`` runs
    stock params in float32. plain=True runs ``conv3x3_plain`` (autograd
    through ``F.conv2d``), the reference the kernel path is held against.
    """

    def __init__(self, cfg: RRDBNetConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        nf, gc = cfg.num_feat, cfg.num_grow_ch
        self.conv_first = _TrainConv(cfg.conv_first_in_ch, nf)
        self.body = nn.ModuleList(_TrainRRDB(nf, gc)
                                  for _ in range(cfg.num_block))
        for name in HEAD_CONVS[1:-1]:
            setattr(self, name, _TrainConv(nf, nf))
        self.conv_last = _TrainConv(nf, cfg.num_out_ch)
        self.load_state_dict({k: torch.as_tensor(v).float()
                              for k, v in state_dict.items()})
        self.to(device)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if self.cfg.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.cfg.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = self.conv_first(x.contiguous(), plain=plain)
        body = feat
        for block in self.body:
            body = block(body, plain)
        feat = feat + self.conv_body(body, plain=plain)
        feat = self.conv_up1(nearest_x2(feat), True, plain)
        feat = self.conv_up2(nearest_x2(feat), True, plain)
        return self.conv_last(self.conv_hr(feat, True, plain), plain=plain)
