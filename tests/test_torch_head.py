"""The port's folded RRDBNet head against the JAX package's, on the CPU.

The folds (``fold_upconv_weights``, ``fold_s2d2x2_weights``) equal the JAX
package's bit for bit. The head (the plain versions of K1's 3x3 and 2x2
forms) matches JAX ``_head_forward`` within 1e-5 * max(1, max|ref|) in
float32, and within BF16_TOL relative in bf16 (JAX run op by op outside
``jit``: the two round the same points, but JAX's ``_lrelu`` multiplies by
bf16(0.2) where PyTorch multiplies by 0.2f, and the convs sum in another
order). Inputs and weights are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_tpu.models import rrdbnet as jr
from neural_enhanced_super_resolution_torch.kernels import (
    KernelInputError, conv2x2_s2d, conv2x2_s2d_f32, conv2x2_s2d_plain,
    conv3x3, conv3x3_f32, conv3x3_head, conv3x3_head_f32, conv3x3_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    HEAD_WIDTHS, TILE_WIDTHS_2X2, head_plan, head_tile_width,
    pack_conv2x2_weights, pack_conv3x3_weights, packed_numel, tile_width,
    tile_width_2x2)
from neural_enhanced_super_resolution_torch.models import (
    RRDBNet, RRDBNetConfig, TrainableRRDBNet, init_rrdbnet, params_from_jax)
from neural_enhanced_super_resolution_torch.models.rrdbnet import (
    FoldedHead, d2s, fold_head_weights, fold_s2d2x2_weights,
    fold_upconv_weights, frame_border_mask)
from neural_enhanced_super_resolution_torch.pipeline import (
    SuperResolutionPipeline)

TOL = 1e-5
BF16_TOL = 1e-2   # measured 3.2e-3 to 5.9e-3 on these cases
HEAD = ("conv_up1", "conv_up2", "conv_hr", "conv_last")


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _conv_w(r, cin, cout):
    """A He-scaled HWIO weight and a bias, float32 numpy."""
    return ((r.standard_normal((3, 3, cin, cout)) * (2.0 / (9 * cin)) ** 0.5)
            .astype(np.float32),
            (r.standard_normal(cout) * 0.1).astype(np.float32))


def _head_sd(nf, out_ch, seed=0):
    """The four head convs as a basicsr state dict (OIHW tensors) and as
    the JAX package's params with its folded weights attached."""
    r = np.random.default_rng(seed)
    sd, params = {}, {}
    for name in HEAD:
        w, b = _conv_w(r, nf, out_ch if name == "conv_last" else nf)
        sd[f"{name}.weight"] = torch.from_numpy(w).permute(3, 2, 0, 1)
        sd[f"{name}.bias"] = torch.from_numpy(b)
        params[name] = {"w": w, "b": b}
    return sd, jr.fold_head_params(params)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("fold,cin,cout", [
    ("upconv", 8, 8), ("upconv", 64, 64), ("s2d", 8, 8), ("s2d", 64, 64),
    ("s2d", 8, 3), ("s2d", 64, 3)],
    ids=["up_nf8", "up_nf64", "hr_nf8", "hr_nf64", "last_nf8", "last_nf64"])
def test_folds_equal_jax_bit_for_bit(fold, cin, cout):
    w, b = _conv_w(np.random.default_rng(cin + cout), cin, cout)
    jax_fold, port_fold = {
        "upconv": (jr.fold_upconv_weights, fold_upconv_weights),
        "s2d": (jr.fold_s2d2x2_weights, fold_s2d2x2_weights)}[fold]
    jw, jb = jax_fold(w, b)
    pw, pb = port_fold(torch.from_numpy(w), torch.from_numpy(b))
    assert pw.dtype == torch.float32 and pb.dtype == torch.float32
    assert np.array_equal(_bits(jw), _bits(pw.numpy()))
    assert np.array_equal(_bits(jb), _bits(pb.numpy()))


def test_fold_head_weights_equal_fold_head_params():
    sd, params = _head_sd(16, 3)
    got = fold_head_weights(sd)
    for key in ("up1_fold", "up2_fold", "hr_fold", "last_fold"):
        assert np.array_equal(_bits(params[key]["w"]), _bits(got[key][0]))
        assert np.array_equal(_bits(params[key]["b"]), _bits(got[key][1]))


def _jax_head(params, feat, dt):
    with jax.disable_jit():
        return np.asarray(jr._head_forward(jnp.asarray(feat).astype(dt),
                                           params, dt).astype(jnp.float32))


HEAD_CASES = {"nf8_13x11": (8, 3, (2, 13, 11)),
              "nf16_8x6": (16, 3, (1, 8, 6)),
              "nf8_out4_5x9": (8, 4, (1, 5, 9))}


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_folded_head_matches_jax_float32(case):
    nf, out_ch, (n, h, w) = HEAD_CASES[case]
    sd, params = _head_sd(nf, out_ch)
    feat = np.random.default_rng(1).standard_normal((n, h, w, nf)).astype(
        np.float32)
    got = FoldedHead(sd, torch.float32, "cpu")(torch.from_numpy(feat))
    assert got.shape == (n, 4 * h, 4 * w, out_ch)
    assert _rel(got, _jax_head(params, feat, jnp.float32)) <= TOL


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_folded_head_matches_jax_bf16(case):
    nf, out_ch, (n, h, w) = HEAD_CASES[case]
    sd, params = _head_sd(nf, out_ch)
    feat = np.random.default_rng(2).standard_normal((n, h, w, nf)).astype(
        np.float32)
    got = FoldedHead(sd, torch.bfloat16, "cpu")(
        torch.from_numpy(feat).bfloat16())
    assert got.dtype == torch.bfloat16
    ref = _jax_head(params, feat, jnp.bfloat16)
    assert np.abs(ref).max() > 1.0
    assert _rel(got.float(), ref) <= BF16_TOL


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_folded_head_equals_stock_head_float32(case):
    """The reparameterisation is exact: only float32 sums differ."""
    nf, out_ch, (n, h, w) = HEAD_CASES[case]
    cfg = RRDBNetConfig(12, out_ch, 4, nf, 1, 4)
    sd = dict(init_rrdbnet(cfg, torch.Generator().manual_seed(0)))
    sd.update(_head_sd(nf, out_ch)[0])
    model = RRDBNet(cfg, sd, torch.float32, "cpu", "fused")
    feat = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n, h, w, nf)).astype(np.float32))
    assert _rel(model.folded_head(feat), model.stock_head(feat)) <= TOL


@pytest.mark.parametrize("scale,hw", [(4, (13, 11)), (2, (14, 10))],
                         ids=["x4_13x11", "x2plus_14x10"])
def test_forward_matches_jax_folded_forward(scale, hw):
    """The whole forward (fused trunk, folded head) against JAX
    ``rrdbnet_forward`` on ``fuse_rrdbnet_params``, in float32."""
    arch = dict(num_in_ch=12 if scale == 4 else 3, num_out_ch=3,
                scale=scale, num_feat=8, num_block=2, num_grow_ch=4)
    cfg = RRDBNetConfig(**arch)
    sd = init_rrdbnet(cfg, torch.Generator().manual_seed(4))
    from neural_enhanced_super_resolution_tpu.models import weights as jw
    jp = jw.rrdbnet_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_block=2)
    x = np.random.default_rng(5).uniform(
        0, 1, (1, *hw, arch["num_in_ch"])).astype(np.float32)
    ref = jr.rrdbnet_forward(jr.fuse_rrdbnet_params(jp), jnp.asarray(x),
                             jr.RRDBNetConfig(**arch), "float32")
    model = RRDBNet(cfg, params_from_jax(jax.tree_util.tree_map(
        np.asarray, jp)), torch.float32, "cpu", "fused")
    got = model(torch.from_numpy(x))
    assert got.shape == (1, scale * hw[0], scale * hw[1], 3)
    assert _rel(got, np.asarray(ref)) <= TOL


def test_d2s_and_frame_mask_equal_jax():
    r = np.random.default_rng(6)
    z = r.standard_normal((2, 5, 7, 12)).astype(np.float32)
    assert np.array_equal(d2s(torch.from_numpy(z)).numpy(),
                          np.asarray(jr._d2s(jnp.asarray(z))))
    assert np.array_equal(frame_border_mask(torch.from_numpy(z)).numpy(),
                          np.asarray(jr._frame_border_mask(jnp.asarray(z))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad,lrelu,mask,to_d2s", [
    (1, True, True, True), (1, True, True, False), (0, False, False, True),
    (0, True, False, False)],
    ids=["pad1_mask_d2s", "hr", "last", "pad0_lrelu"])
def test_conv2x2_plain_equals_explicit_composition(dtype, pad, lrelu, mask,
                                                   to_d2s):
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.standard_normal((2, 6, 5, 16)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(r.standard_normal((2, 2, 16, 12)).astype(
        np.float32) * 0.2)
    b = torch.from_numpy(r.standard_normal(12).astype(np.float32))
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.to(dtype).float().permute(3, 2, 0, 1), b,
                 padding=pad).permute(0, 2, 3, 1).to(dtype)
    if lrelu:
        y = torch.where(y >= 0, y, (0.2 * y.float()).to(dtype))
    if mask:
        y = frame_border_mask(y)
    if to_d2s:
        y = d2s(y)
    got = conv2x2_s2d_plain(x, w, b, lrelu, pad, mask, to_d2s)
    ho, wo = 6 + 2 * pad - 1, 5 + 2 * pad - 1
    assert got.shape == ((2, 2 * ho, 2 * wo, 3) if to_d2s
                         else (2, ho, wo, 12))
    assert got.dtype == dtype and torch.equal(got, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_plain_d2s_and_rounding(dtype):
    """d2s is the depth-to-space of the plain output; round_first rounds
    before the LeakyReLU, which then multiplies the rounded value."""
    r = np.random.default_rng(8)
    x = torch.from_numpy(r.standard_normal((1, 5, 4, 8)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(r.standard_normal((3, 3, 8, 16)).astype(
        np.float32) * 0.3).to(dtype)
    b = torch.from_numpy(r.standard_normal(16).astype(np.float32))
    plain = conv3x3_plain(x, w, b, True)
    assert torch.equal(conv3x3_plain(x, w, b, True, d2s=True), d2s(plain))
    y = conv3x3_plain(x, w, b)
    first = torch.where(y >= 0, y, (0.2 * y.float()).to(dtype))
    assert torch.equal(conv3x3_plain(x, w, b, True, round_first=True), first)
    if dtype == torch.float32:
        assert torch.equal(first, plain)


def _unpack_head(packed, kt, cin, cout, lbo=128, sbo=256):
    """The folded head's packed kt x kt weights read back to HWIO through
    the wgmma descriptor's addressing (as tests/test_torch_kernels.py reads
    K1's), with T = kt^2 taps: slab i = (pass i // T, tap i % T) of N tile
    `tile` at (tile * T * Kp + i * 64) * N, k-step s at s * 16 * N,
    element (k, n) at byte (n // 8) * SBO + (n % 8) * 16 + (k // 8) * LBO
    + (k % 8) * 2."""
    nw, tiles = tile_width_2x2(cout) if kt == 2 else head_tile_width(cin,
                                                                     cout)
    kp, taps = -(-cin // 64) * 64, kt * kt
    flat = packed.view(torch.int16)
    out = torch.zeros((kt, kt, kp, tiles * nw), dtype=torch.int16)
    hits = torch.zeros(flat.numel(), dtype=torch.int64)
    k = torch.arange(16).view(16, 1)
    n = torch.arange(nw).view(1, nw)
    inner = ((n // 8) * sbo + (n % 8) * 16 + (k // 8) * lbo
             + (k % 8) * 2) // 2
    for tile in range(tiles):
        for i in range(taps * kp // 64):
            c0, t = i // taps * 64, i % taps
            for s in range(4):
                idx = (tile * taps * kp + i * 64 + s * 16) * nw + inner
                out[t // kt, t % kt, c0 + 16 * s:c0 + 16 * s + 16,
                    tile * nw:(tile + 1) * nw] = flat[idx]
                hits.index_add_(0, idx.reshape(-1),
                                torch.ones(idx.numel(), dtype=torch.int64))
    return out.view(torch.bfloat16), hits


@pytest.mark.parametrize("kt,cin,cout,want", [
    (2, 256, 256, (128, 2)), (2, 256, 12, (16, 1)), (2, 64, 64, (64, 1)),
    (2, 32, 12, (16, 1)), (2, 32, 32, (64, 1)), (2, 64, 320, (128, 3)),
    (3, 64, 256, (128, 2)), (3, 8, 32, (64, 1)), (3, 128, 256, (64, 4)),
    (3, 320, 48, (16, 3)), (3, 600, 12, (8, 2))],
    ids=["hr_nf64", "last_nf64", "hr_nf16", "last_nf8", "hr_nf8",
         "two_tiles", "up_nf64", "up_nf8", "up_cin128_two_passes",
         "up_cin320_five_passes", "up_cin600_ten_passes"])
def test_pack_head_weights_matches_descriptor_layout(kt, cin, cout, want):
    """The folded head's two packings (pack_conv2x2_weights, and
    pack_conv3x3_weights(head=True) for up1 and up2) read back through the
    descriptor's addressing: the HWIO weight, zero past Cin and Cout,
    every packed element read once."""
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (kt, kt, cin, cout)).astype(np.float32)).bfloat16()
    packed = (pack_conv2x2_weights(w) if kt == 2
              else pack_conv3x3_weights(w, head=True))
    if kt == 2:
        assert tile_width_2x2(cout) == want and want[0] in TILE_WIDTHS_2X2
    else:
        # the head kernel keeps an N tile's weights resident: passes x N
        # at most 128
        assert head_tile_width(cin, cout) == want and want[0] in HEAD_WIDTHS
        assert -(-cin // 64) * want[0] <= 128
    assert packed.numel() == packed_numel(cin, cout, taps=kt, head=True)
    got, hits = _unpack_head(packed, kt, cin, cout)
    assert torch.equal(got[:, :, :cin, :cout], w)
    assert not got[:, :, cin:].any() and not got[:, :, :, cout:].any()
    assert torch.equal(hits, torch.ones_like(hits))


@pytest.mark.parametrize("cin,cout", [(64, 256), (8, 32), (64, 12),
                                      (32, 64), (64, 300)])
def test_pack_head_3x3_weights_keep_their_layout(cin, cout):
    """The head 3x3 form's image is the one its kernel
    (conv3x3_head_kernel) was built for, whatever the 2x2 form's kernel
    takes: N tiles of 16, 64 or 128 (256 as 2 x 128) and the SAME conv's
    slab order with 64-channel passes."""
    w = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (3, 3, cin, cout)).astype(np.float32)).bfloat16()
    nw, tiles = tile_width(cout, (16, 64, 128))
    got = pack_conv3x3_weights(w, head=True)
    kp = -(-cin // 64) * 64
    wz = torch.zeros((3, 3, kp, tiles * nw), dtype=torch.bfloat16)
    wz[:, :, :cin, :cout] = w
    want = wz.reshape(9, kp // 64, 4, 2, 8, tiles, nw // 8, 8).permute(
        5, 1, 0, 2, 6, 3, 7, 4).reshape(-1)
    assert torch.equal(got, want)
    assert got.numel() == packed_numel(cin, cout, taps=3, head=True)


@pytest.mark.parametrize("cin,cout", [(256, 256), (256, 12), (32, 12),
                                      (64, 320)])
def test_pack_conv2x2_weights_keeps_its_image(cin, cout):
    """The 2x2 form's image (csrc/conv2x2.cu) is unchanged by the head 3x3
    form's own widths: N tiles of 16, 64 or 128 by ``tile_width_2x2`` and
    the SAME conv's slab order with 4 taps and 64-channel passes."""
    w = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (2, 2, cin, cout)).astype(np.float32)).bfloat16()
    nw, tiles = tile_width(cout, (16, 64, 128))
    kp = -(-cin // 64) * 64
    wz = torch.zeros((2, 2, kp, tiles * nw), dtype=torch.bfloat16)
    wz[:, :, :cin, :cout] = w
    want = wz.reshape(4, kp // 64, 4, 2, 8, tiles, nw // 8, 8).permute(
        5, 1, 0, 2, 6, 3, 7, 4).reshape(-1)
    assert torch.equal(pack_conv2x2_weights(w), want)


@pytest.mark.parametrize("shape,want", [
    ((4, 268, 268, 64, 256), (128, 2, 4556, 66, 132, 227640)),
    ((4, 536, 536, 64, 256), (128, 2, 18224, 66, 132, 227640)),
    ((1, 17, 9, 64, 256), (128, 2, 5, 3, 6, 227640)),
    ((1, 4, 16, 64, 256), (128, 2, 1, 1, 2, 227640)),
    ((2, 21, 37, 16, 48), (64, 1, 36, 18, 18, 137272)),
    ((1, 9, 17, 128, 256), (64, 4, 6, 3, 12, 211000)),
    ((1, 8, 8, 1024, 12), (8, 2, 2, 1, 2, 196440))],
    ids=["up1", "up2", "ragged_one_block_a_pair", "one_tile",
         "nf12_padded", "cin128", "cin1024"])
def test_head_plan(shape, want):
    """The head 3x3 form's launch on a 132-SM card: N width and tiles,
    4 x 16-pixel tiles, blocks an N tile (one an SM, at most one for every
    two tiles), grid, and shared memory within a block's 227 KB."""
    plan = head_plan(*shape, sms=132)
    assert (plan["n_width"], plan["n_tiles"], plan["tiles"], plan["per_nt"],
            plan["grid"], plan["smem"]) == want
    assert plan["smem"] <= 232448
    assert 2 * (plan["per_nt"] - 1) < plan["tiles"]


def test_head_tile_width_refuses_weights_past_shared_memory():
    with pytest.raises(KernelInputError, match="Cin 1025"):
        head_tile_width(1025, 256)


@pytest.mark.parametrize("name", ["conv3x3_head", "conv3x3_head_f32",
                                  "conv3x3", "conv3x3_f32"])
def test_conv3x3_head_wrappers_take_the_plain_version_only_on_the_cpu(name):
    """The head 3x3 forms (and the public wrappers that route d2s and
    round_first to them) call conv3x3_plain on a CPU tensor, launch
    nothing there, and refuse a device without a kernel."""
    x = torch.zeros((1, 4, 4, 8))
    w = torch.zeros((3, 3, 8, 12))
    fn = {"conv3x3_head": conv3x3_head, "conv3x3_head_f32": conv3x3_head_f32,
          "conv3x3": conv3x3, "conv3x3_f32": conv3x3_f32}[name]
    launches = (conv3x3_head.launches, conv3x3_head_f32.launches)
    calls = conv3x3_plain.calls
    kw = {} if name.endswith("f32") else {"round_first": True}
    assert fn(x, w, None, True, d2s=True, **kw).shape == (1, 8, 8, 3)
    assert conv3x3_plain.calls == calls + 1
    assert (conv3x3_head.launches, conv3x3_head_f32.launches) == launches
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(KernelInputError, match="no kernel"):
            fn(x.to("meta", dt), w.to("meta", dt), None, False, d2s=True,
               **kw)
    assert conv3x3_plain.calls == calls + 1


def test_conv2x2_wrappers_take_the_plain_version_only_on_the_cpu():
    x = torch.zeros((1, 4, 4, 8))
    w = torch.zeros((2, 2, 8, 12))
    calls, launches = conv2x2_s2d_plain.calls, conv2x2_s2d.launches
    assert conv2x2_s2d(x, w, None, True, 1, True, True).shape == (1, 10, 10, 3)
    assert conv2x2_s2d_f32(x, w, None, False, 0, False, False).shape == (
        1, 3, 3, 12)
    assert conv2x2_s2d_plain.calls == calls + 2
    assert conv2x2_s2d.launches == launches
    for fn, dt in ((conv2x2_s2d, torch.bfloat16),
                   (conv2x2_s2d_f32, torch.float32)):
        with pytest.raises(KernelInputError, match="no kernel"):
            fn(x.to("meta", dt), w.to("meta", dt), None, False, 1, False,
               False)
    assert conv2x2_s2d_plain.calls == calls + 2


TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=1,
            num_grow_ch=4)


@pytest.mark.parametrize("trunk,dtype", [
    ("fused", torch.float32), ("fused", torch.bfloat16),
    ("dform", torch.bfloat16), ("int8", torch.bfloat16),
    ("int8", torch.float32), ("stock", torch.bfloat16)])
def test_fused_layouts_run_the_folded_head(trunk, dtype):
    """Every fuse_rdb layout runs FoldedHead (2 of its 4 convs on the 2x2
    form); the stock trunk runs the stock head (4 K1 convs, no 2x2)."""
    cfg = RRDBNetConfig(**TINY)
    model = RRDBNet(cfg, init_rrdbnet(cfg, torch.Generator().manual_seed(0)),
                    dtype, "cpu", trunk)
    assert isinstance(model.folded_head, FoldedHead) == (trunk != "stock")
    x = torch.rand((1, 6, 5, 12), generator=torch.Generator().manual_seed(1))
    c3 = conv3x3_plain.calls
    model.body_forward(model.conv_first(x.to(dtype)))
    c3, c2 = 2 * conv3x3_plain.calls - c3, conv2x2_s2d_plain.calls
    out = model(x)
    assert out.shape == (1, 24, 20, 3) and out.dtype == torch.float32
    # Beyond conv_first and the trunk: conv_body and the head's 3x3 convs
    # (2 folded, 4 stock).
    head3 = 4 if trunk == "stock" else 2
    assert (conv3x3_plain.calls - c3,
            conv2x2_s2d_plain.calls - c2) == (1 + head3, 4 - head3)


def test_trainable_rrdbnet_runs_the_stock_head():
    cfg = RRDBNetConfig(**TINY)
    model = TrainableRRDBNet(cfg, init_rrdbnet(
        cfg, torch.Generator().manual_seed(0)), "cpu")
    c2 = conv2x2_s2d_plain.calls
    assert model(torch.rand((1, 6, 5, 12))).shape == (1, 24, 20, 3)
    assert conv2x2_s2d_plain.calls == c2
    assert not hasattr(model, "folded_head")


@pytest.mark.parametrize("overrides,trunk", [
    ({}, "fused"), ({"fuse_rdb": False}, "stock"),
    ({"fuse_rdb": False, "esrgan_trunk": "int8"}, "stock"),
    ({"esrgan_trunk": "int8"}, "int8"),
    ({"esrgan_trunk": "dform", "precision": "bfloat16"}, "dform")])
def test_pipeline_routes_fuse_rdb_to_the_folded_head(tmp_path, overrides,
                                                      trunk):
    """fuse_rdb (default true) selects the fused layouts and the folded
    head; fuse_rdb false the stock trunk and head, whatever the trunk."""
    from neural_enhanced_super_resolution_torch.models import save_state_dict
    cfg = RRDBNetConfig(**TINY)
    ckpt = save_state_dict(init_rrdbnet(cfg, torch.Generator().manual_seed(0)),
                           str(tmp_path / "tiny.pth"))
    conf = {"use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0, "data_parallel": "off",
            "esrgan_model_path": ckpt, "esrgan_arch": dict(TINY),
            "output_dir": str(tmp_path / "out"), **overrides}
    pipe = SuperResolutionPipeline("cpu", conf)
    pipe._load_models()
    model = pipe.models["esrgan"]["model"]
    assert model.trunk == trunk
    assert isinstance(model.folded_head, FoldedHead) == (trunk != "stock")


def _load_script(rel: str):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), rel)
    spec = importlib.util.spec_from_file_location(
        "head_" + os.path.splitext(os.path.basename(rel))[0], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", ["bf16_forward_vs_jax", "int8_vs_jax_jit",
                                  "dform_vs_fused_bf16", "x2plus_runner"])
def test_recorded_divergences(tmp_path, test_image, case):
    """The recorded divergences the head can touch, each held to the bar
    of the test that records it and printed (run with -s to read them):
    the bf16 forward of the fused trunk against JAX ``rrdbnet_forward``
    on ``fuse_rrdbnet_params`` in bf16, op by op (BF16_TOL);
    the int8 request against the JAX package's jitted one (PSNR > 40 dB,
    tests/test_torch_int8.py); the bf16 dform trunk against the bf16 fused
    trunk through the product path on the CPU (mean < 1 level,
    tests/test_torch_pipeline.py); the x2plus runner against the JAX
    runner (mean <= 1 level, tests/test_torch_tools.py; both run the
    stock head, as the JAX runner runs unfused parameters)."""
    import os
    from neural_enhanced_super_resolution_tpu import (
        SuperResolutionPipeline as JaxPipeline)
    from neural_enhanced_super_resolution_torch.models import save_state_dict
    from neural_enhanced_super_resolution_torch.ops.resize import resize
    from neural_enhanced_super_resolution_torch.utils import psnr
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)
    common = {"iterations": 1, "use_diffusion": False,
              "segment_enhancement": False, "denoise_level": 0,
              "output_dir": str(tmp_path / "out")}
    if case == "bf16_forward_vs_jax":
        from neural_enhanced_super_resolution_tpu.models import weights as jw
        arch = dict(TINY, num_block=2)
        cfg = RRDBNetConfig(**arch)
        sd = init_rrdbnet(cfg, torch.Generator().manual_seed(4))
        jp = jw.rrdbnet_params_from_state_dict(
            {k: v.numpy() for k, v in sd.items()}, num_block=2)
        x = np.random.default_rng(5).uniform(0, 1, (1, 13, 11, 12)).astype(
            np.float32)
        with jax.disable_jit():
            ref = np.asarray(jr.rrdbnet_forward(
                jr.fuse_rrdbnet_params(jp), jnp.asarray(x),
                jr.RRDBNetConfig(**arch), "bfloat16"))
        got = RRDBNet(cfg, sd, torch.bfloat16, "cpu", "fused")(
            torch.from_numpy(x)).numpy()
        print(f"DIVERGENCE bf16 forward vs JAX: rel {_rel(got, ref):.3g}, "
              f"mean {np.abs(got - ref).mean():.3g}, "
              f"{np.mean(got == ref):.4f} equal")
        assert _rel(got, ref) <= BF16_TOL
    elif case == "int8_vs_jax_jit":
        fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                               "tiny_trained_x4.safetensors")
        hr = torch.from_numpy(np.array(test_image))
        lr = resize(hr, dsize=(hr.shape[1] // 2, hr.shape[0] // 2),
                    interpolation="bicubic").numpy()
        conf = dict(common, adaptive_sharpening=False,
                    esrgan_model_path=fixture, esrgan_trunk="int8",
                    esrgan_arch=dict(num_in_ch=12, num_out_ch=3, scale=4,
                                     num_feat=16, num_block=2,
                                     num_grow_ch=8))
        got = SuperResolutionPipeline("cpu", conf).enhance_array(lr)
        ref = np.asarray(JaxPipeline(device="cpu", config=conf)
                         .enhance_array(lr))
        db = float(psnr(got, ref))
        print(f"DIVERGENCE int8 request vs JAX jit: PSNR {db:.2f} dB, "
              f"{np.mean(got == ref):.4f} equal, max "
              f"{np.abs(got.astype(int) - ref.astype(int)).max()}")
        assert got.shape == ref.shape and db > 40.0
    elif case == "dform_vs_fused_bf16":
        cfg = RRDBNetConfig(**dict(TINY, num_block=2))
        ckpt = save_state_dict(init_rrdbnet(cfg, torch.Generator(
            ).manual_seed(0)), str(tmp_path / "tiny.pth"))
        img = np.array(test_image[:40, :40])
        outs = [SuperResolutionPipeline("cpu", dict(
            common, esrgan_model_path=ckpt, esrgan_arch=dict(TINY,
                                                             num_block=2),
            data_parallel="off", precision="bfloat16", esrgan_trunk=trunk)
        ).enhance_array(img).astype(int) for trunk in (None, "dform")]
        diff = np.abs(outs[0] - outs[1])
        print(f"DIVERGENCE dform vs fused bf16 product path: mean "
              f"{diff.mean():.4f}, max {diff.max()}")
        assert outs[0].shape == (160, 160, 3) and diff.mean() < 1.0
    else:
        cfg = RRDBNetConfig(num_in_ch=3, num_out_ch=3, scale=2, num_feat=8,
                            num_block=23, num_grow_ch=4)
        ckpt = save_state_dict(init_rrdbnet(cfg, torch.Generator(
            ).manual_seed(5)), str(tmp_path / "x2plus.pth"))
        src = str(tmp_path / "img.png")
        imwrite_rgb(src, test_image[:45, :38])
        outs = []
        for rel in ("standalone/torch_superres_project.py",
                    "standalone/superres_project.py"):
            out_dir = str(tmp_path / rel.split("/")[1].split(".")[0])
            assert _load_script(rel).main(["-i", src, "-o", out_dir, "-n",
                                           "1", "-d", "cpu", "--model",
                                           ckpt]) == 0
            outs.append(imread_rgb(os.path.join(
                out_dir, "img_enhanced_x2.0.png")).astype(int))
        diff = np.abs(outs[0] - outs[1])
        print(f"DIVERGENCE x2plus runner vs JAX runner: mean "
              f"{diff.mean():.4f}, max {diff.max()}")
        assert outs[0].shape == (90, 76, 3) and diff.mean() <= 1.0
