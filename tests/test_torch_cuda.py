"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA GPU and skips without one (the kernels have no
CPU mode). The file imports no JAX and uses no conftest fixture, so on a
machine with the card and without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 1e-2 * max(1, max|plain|) per conv
kernel (bf16 outputs; the two sum in another order), 3e-2 for a whole
forward; K4 (the int8 conv) equals its plain version bit for bit (exact
integer sums, the same float32 epilogue), and so does its redesign, the
int8 RDB step (conv3x3_int8_rdb: x_{k+1} or out, the slots and the scale
chain), with int8_amax; the bf16 RDB step (conv3x3_rdb: K1's conv with
the dense-block assembly) equals the composition it replaces (five K1
convs with the assembly in PyTorch) bit for bit, and its float32 form
(conv3x3_rdb_f32) equals the composition on K1f bit for bit and its plain
version within 1e-5; K3 (flash attention) 2e-2 of max|plain| with no
floor, on q and k
of std 2 so that each softmax row is peaked. The float32 forms (K1f, K3f)
1e-5 of max|plain| (float32 sums in another order), 1e-4 for a forward.
NL-means' kernel (csrc/nlmeans.cu) 1e-5 of max|plain| in float32 and,
rounded to uint8, max |diff| <= 1 on <= 1e-3 of the values; on the card
against the CPU its uint8 Lab max |diff| <= 1 on <= 1e-3 of the values
(its RGB: the test's docstring). SegFormer (no kernel) against the CPU:
bf16 logits 3e-2 * max(1, max|CPU f32|).
"""

import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.kernels import (
    KernelError, KernelInputError, attention_auto, conv3x3, conv3x3_f32,
    conv3x3_int8, conv3x3_int8_plain, conv3x3_int8_rdb,
    conv3x3_int8_rdb_plain, conv3x3_plain, conv3x3_rdb, conv3x3_rdb_f32,
    conv3x3_rdb_plain, flash_attention,
    flash_attention_f32, flash_attention_plain, int8_amax, int8_amax_plain,
    nl_means_fields, nl_means_fields_plain, rdb_fused, rdb_fused_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
    pack_conv3x3_int8_weights)
from neural_enhanced_super_resolution_torch.models import (
    RRDBNet, RRDBNetConfig, init_rrdbnet, save_state_dict)
from neural_enhanced_super_resolution_torch.models.rrdbnet import FusedRDB
from neural_enhanced_super_resolution_torch.models.segformer import (
    SegFormerConfig, load_segformer, write_synthetic_segformer)
from neural_enhanced_super_resolution_torch.ops.blur import saturate_like
from neural_enhanced_super_resolution_torch.ops.color import rgb_to_lab
from neural_enhanced_super_resolution_torch.ops.nlmeans import (
    _denoised_lab, _lab_to_output, nl_means, nl_means_colored)

pytestmark = pytest.mark.cuda

RDB_SHAPES = ((64, 192), (32, 160), (32, 128), (32, 96), (32, 64))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    return ((got - ref).abs().max() / max(1.0, ref.abs().max().item())).item()


def _rdb_args(cuda, shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 0.5).to(cuda, torch.bfloat16)
    ws = [(torch.randn((3, 3, cin, cout), generator=g) * 0.05).to(
        cuda, torch.bfloat16) for cin, cout in RDB_SHAPES]
    b = (torch.randn((192,), generator=g) * 0.1).to(cuda)
    return x, ws, b


@pytest.mark.parametrize("n,h,w,cin,cout,bias,act", [
    (2, 37, 45, 12, 64, True, False), (1, 40, 33, 64, 192, False, False),
    (1, 30, 50, 32, 160, False, False), (2, 21, 19, 64, 3, True, False),
    (1, 18, 70, 64, 64, True, True), (1, 9, 9, 130, 32, True, True),
    (1, 33, 47, 32, 128, False, False), (2, 17, 29, 32, 96, False, False),
    (1, 26, 31, 32, 64, False, False), (1, 7, 5, 8, 24, True, True),
    (2, 19, 21, 3, 64, True, False), (1, 11, 13, 130, 300, True, False),
    (1, 20, 28, 3, 180, True, False), (2, 24, 16, 180, 180, True, False),
    (1, 16, 24, 180, 64, True, True)],
    ids=["conv_first", "w0", "w1", "conv_last", "head_lrelu",
         "two_passes", "w2", "w3", "w4", "tiny", "cin3", "two_n_tiles",
         "swinir_first", "swinir_rstb", "swinir_before_up"])
def test_conv3x3_kernel_matches_plain(cuda, n, h, w, cin, cout, bias, act):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((n, h, w, cin), generator=g).to(cuda, torch.bfloat16)
    wt = (torch.randn((3, 3, cin, cout), generator=g) * 0.1).to(
        cuda, torch.bfloat16)
    b = (torch.randn((cout,), generator=g) * 0.1).to(cuda) if bias else None
    launches, calls = conv3x3.launches, conv3x3_plain.calls
    got = conv3x3(x, wt, b, act)
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3_plain.calls) == (launches + 1, calls)
    assert got.dtype == torch.bfloat16
    assert _rel(got, conv3x3_plain(x, wt, b, act)) <= 1e-2


def test_conv3x3_takes_weights_packed_at_build(cuda):
    """The model path's packed buffer gives the same output as packing in
    the call; a buffer packed for other shapes is refused."""
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        pack_conv3x3_weights)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((1, 20, 24, 32), generator=g).to(cuda, torch.bfloat16)
    wt = (torch.randn((3, 3, 32, 160), generator=g) * 0.1).to(
        cuda, torch.bfloat16)
    packed = pack_conv3x3_weights(wt)
    assert torch.equal(conv3x3(x, wt, packed=packed), conv3x3(x, wt))
    with pytest.raises(KernelInputError, match="packed"):
        conv3x3(x, wt, packed=packed[:-8])
    with pytest.raises(KernelInputError, match="packed"):
        conv3x3(x, wt, packed=packed.float())


@pytest.mark.parametrize("shape", [(1, 8, 8, 64), (2, 37, 45, 64),
                                   (1, 5, 70, 64), (1, 13, 27, 64),
                                   (3, 9, 70, 64)])
def test_rdb_fused_kernel_matches_plain(cuda, shape):
    x, ws, b = _rdb_args(cuda, shape, seed=1)
    launches, calls = rdb_fused.launches, rdb_fused_plain.calls
    got = rdb_fused(x, ws, b)
    torch.cuda.synchronize()
    assert (rdb_fused.launches, rdb_fused_plain.calls) == (launches + 1, calls)
    assert _rel(got, rdb_fused_plain(x, ws, b)) <= 1e-2


def test_rdb_fused_takes_weights_packed_at_build(cuda):
    """The model path's packed buffers give the same output as packing in
    the call; a buffer packed for other shapes, of another dtype or on
    another device is refused."""
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        pack_conv3x3_weights)
    x, ws, b = _rdb_args(cuda, (2, 19, 26, 64), seed=4)
    packed = [pack_conv3x3_weights(w) for w in ws]
    assert torch.equal(rdb_fused(x, ws, b, packed=packed), rdb_fused(x, ws, b))
    for bad in (packed[:4], [packed[0][:-8]] + packed[1:],
                packed[:1] + [packed[2]] * 4,
                [packed[0].float()] + packed[1:],
                [packed[0].cpu()] + packed[1:]):
        with pytest.raises(KernelInputError, match="packed"):
            rdb_fused(x, ws, b, packed=bad)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 8, 8, 64), device=cuda)
    w = torch.zeros((3, 3, 64, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(KernelInputError):
        conv3x3(x, w)                     # f32 activations, bf16 weights
    with pytest.raises(KernelInputError):
        conv3x3(x.bfloat16(), w[:, :, :32])              # Cin mismatch
    with pytest.raises(KernelInputError):
        conv3x3(x.bfloat16().transpose(1, 2), w)         # not contiguous
    with pytest.raises(KernelInputError):
        conv3x3(x.bfloat16(), w, torch.zeros(64, device=cuda,
                                             dtype=torch.bfloat16))
    xb, ws, b = _rdb_args(cuda, (1, 8, 8, 64), seed=2)
    with pytest.raises(KernelInputError):
        rdb_fused(xb, ws[:4], b)
    with pytest.raises(KernelInputError):
        rdb_fused(xb, ws, b[:64])
    with pytest.raises(KernelInputError):
        rdb_fused(torch.zeros((1, 8, 8, 32), device=cuda,
                              dtype=torch.bfloat16), ws, b)
    assert issubclass(KernelInputError, KernelError)
    assert issubclass(KernelInputError, ValueError)
    assert issubclass(KernelError, RuntimeError)


def _int8_args(cuda, n, h, w, cin, cout, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(-127, 128, (n, h, w, cin), generator=g,
                      dtype=torch.int8).to(cuda)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g,
                       dtype=torch.int8).to(cuda)
    w_s = (torch.rand((cout,), generator=g) * 1e-2 + 1e-4).to(cuda)
    s_x = (torch.rand((), generator=g) * 8 + 0.5).to(cuda)
    return q, wq, s_x, w_s


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 24, 40, 64, 192), (2, 24, 40, 32, 160), (2, 24, 40, 32, 128),
    (2, 24, 40, 32, 96), (2, 24, 40, 32, 64),
    (1, 80, 80, 16, 48), (1, 80, 80, 8, 40), (1, 80, 80, 8, 32),
    (1, 80, 80, 8, 24), (1, 80, 80, 8, 16),
    (3, 13, 29, 64, 192), (1, 7, 5, 12, 5), (2, 9, 18, 130, 24)],
    ids=["w0", "w1", "w2", "w3", "w4", "fixture_w0", "fixture_w1",
         "fixture_w2", "fixture_w3", "fixture_w4", "ragged", "ragged_cin12",
         "two_passes"])
def test_conv3x3_int8_kernel_matches_plain(cuda, n, h, w, cin, cout):
    """K4 at the trunk's and the trained fixture's shapes and ragged ones,
    full-range int8 operands: equal to its plain version bit for bit."""
    q, wq, s_x, w_s = _int8_args(cuda, n, h, w, cin, cout, seed=cin + cout)
    got = conv3x3_int8(q, wq, s_x, w_s,
                       packed=pack_conv3x3_int8_weights(wq))
    ref = conv3x3_int8_plain(q, wq, s_x, w_s)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (n, h, w, cout)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


def test_conv3x3_int8_refuses_what_the_kernel_does_not_take(cuda):
    q, wq, s_x, w_s = _int8_args(cuda, 1, 8, 8, 32, 64, seed=1)
    with pytest.raises(KernelInputError):
        conv3x3_int8(q.float(), wq, s_x, w_s)            # not int8
    with pytest.raises(KernelInputError):
        conv3x3_int8(q, wq[:, :, :16], s_x, w_s)         # Cin mismatch
    with pytest.raises(KernelInputError):
        conv3x3_int8(q, wq, s_x.view(1), w_s)            # s_x not 0-d
    with pytest.raises(KernelInputError):
        conv3x3_int8(q, wq, s_x, w_s[:32])               # w_s length
    with pytest.raises(KernelInputError):
        conv3x3_int8(q.transpose(1, 2), wq, s_x, w_s)    # not contiguous
    with pytest.raises(KernelInputError):
        conv3x3_int8(q, wq, s_x, w_s, packed=torch.zeros(
            16, dtype=torch.int8, device=cuda))          # not its packing


def _int8_rdb(cuda, nf, g, seed):
    from neural_enhanced_super_resolution_torch.models.rrdbnet import (
        Int8RDB, quantize_rdb)
    gen = torch.Generator().manual_seed(seed)
    shapes = [(nf, 4 * g + nf)] + [(g, (4 - k) * g + nf) for k in range(1, 5)]
    fw = [torch.randn((3, 3, ci, co), generator=gen) * 0.05
          for ci, co in shapes]
    return Int8RDB(*quantize_rdb(fw), torch.randn((4 * g + nf,),
                                                  generator=gen) * 0.1, cuda)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("n,h,w,nf,g,dtype,skip", [
    (2, 40, 36, 64, 32, torch.bfloat16, False),
    (2, 40, 36, 64, 32, torch.bfloat16, True),
    (1, 80, 80, 16, 8, torch.bfloat16, False),
    (3, 13, 29, 64, 32, torch.float32, True),
    (2, 21, 35, 12, 4, torch.bfloat16, False)],
    ids=["trunk", "trunk_skip", "fixture", "float32_ragged", "scalar_paths"])
def test_int8_rdb_steps_match_plain(cuda, n, h, w, nf, g, dtype, skip):
    """The K4 step at every step of an RDB against its plain version on the
    same inputs, bit for bit: the returned x_{k+1} / out, the whole slot
    buffer and the whole scale chain; int8_amax against its plain version;
    the RDB on the kernels against Int8RDB's plain composition."""
    rdb = _int8_rdb(cuda, nf, g, seed=nf + g)
    gen = torch.Generator().manual_seed(n + h)
    x = (torch.randn((n, h, w, nf), generator=gen) * 0.5).to(cuda, dtype)
    sk = (torch.randn((n, h, w, nf), generator=gen) * 0.5).to(
        cuda, dtype) if skip else None
    scales = int8_amax(x, 5)
    assert torch.equal(_bits(scales), _bits(int8_amax_plain(x, 5)))
    slots = torch.zeros((n, h, w, 4 * g + nf), dtype=torch.bfloat16,
                        device=cuda)
    t = x
    for k in range(5):
        sl, sc = slots.clone(), scales.clone()
        extra = dict(x=x, skip=sk) if k == 4 else {}
        args = (getattr(rdb, f"q{k}"), getattr(rdb, f"s{k}"), rdb.b)
        got = conv3x3_int8_rdb(k, t, scales[k], scales[k + 1], *args, slots,
                               packed=getattr(rdb, f"p{k}"), **extra)
        ref = conv3x3_int8_rdb_plain(k, t, sc[k], sc[k + 1], *args, sl,
                                     **extra)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(ref)), k
        assert torch.equal(_bits(slots), _bits(sl)), k
        assert torch.equal(_bits(scales), _bits(sc)), k
        t = got
    assert torch.equal(_bits(rdb(x, skip=sk)),
                       _bits(rdb(x, plain=True, skip=sk)))


def test_int8_rdb_step_refuses_what_the_kernel_does_not_take(cuda):
    rdb = _int8_rdb(cuda, 64, 32, seed=1)
    x = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16, device=cuda)
    scales = int8_amax(x, 5)
    slots = torch.zeros((1, 8, 8, 192), dtype=torch.bfloat16, device=cuda)
    args = (rdb.q0, rdb.s0, rdb.b)
    with pytest.raises(KernelInputError):     # step 1 takes a float32 x_k
        conv3x3_int8_rdb(1, x[..., :32].contiguous(), scales[1], scales[2],
                         rdb.q1, rdb.s1, rdb.b, slots)
    with pytest.raises(KernelInputError):     # slots must be bf16
        conv3x3_int8_rdb(0, x, scales[0], scales[1], *args, slots.float())
    with pytest.raises(KernelInputError):     # weights of another step
        conv3x3_int8_rdb(0, x, scales[0], scales[1], rdb.q1, rdb.s0, rdb.b,
                         slots)
    with pytest.raises(KernelInputError):     # x belongs to step 4
        conv3x3_int8_rdb(0, x, scales[0], scales[1], *args, slots, x=x)
    with pytest.raises(KernelInputError):     # not contiguous
        conv3x3_int8_rdb(0, x.transpose(1, 2), scales[0], scales[1], *args,
                         slots)
    with pytest.raises(KernelInputError):     # not its packing
        conv3x3_int8_rdb(0, x, scales[0], scales[1], *args, slots,
                         packed=torch.zeros(16, dtype=torch.int8,
                                            device=cuda))
    with pytest.raises(KernelInputError):     # int8_amax: not bf16/float32
        int8_amax(x.half(), 5)


@pytest.mark.parametrize("trunk", ["fused", "dform", "int8"])
def test_full_width_forward_matches_plain(cuda, trunk):
    """12ch x4 at the full width (64 features, growth 32), two blocks."""
    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, num_feat=64,
                        num_block=2, num_grow_ch=32)
    sd = init_rrdbnet(cfg, torch.Generator().manual_seed(3))
    x = torch.rand((2, 40, 36, 12), generator=torch.Generator().manual_seed(4)
                   ).to(cuda)
    model = RRDBNet(cfg, sd, torch.bfloat16, cuda, trunk)
    ref = model(x, plain=True)
    out = model(x)
    assert out.shape == (2, 160, 144, 3) and torch.isfinite(out).all()
    assert _rel(out, ref) <= 3e-2


@pytest.mark.parametrize("trunk", [None, "dform"])
def test_product_path_goes_through_the_kernels(cuda, tmp_path, trunk):
    """enhance_array on the card launches the kernels and never a plain
    version, on the whole-forward and the streamed-final paths."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, num_feat=64,
                        num_block=1, num_grow_ch=32)
    ckpt = save_state_dict(init_rrdbnet(cfg, torch.Generator().manual_seed(5)),
                           str(tmp_path / "w.pth"))
    pipe = SuperResolutionPipeline("cuda", {
        "use_diffusion": False, "segment_enhancement": False,
        "denoise_level": 0, "iterations": 1, "esrgan_model_path": ckpt,
        "esrgan_arch": {"num_block": 1}, "esrgan_trunk": trunk,
        "output_dir": str(tmp_path / "out")})
    assert pipe.config["precision"] == "bfloat16"
    rng = np.random.default_rng(6)
    counts = (conv3x3.launches, rdb_fused.launches, conv3x3_rdb.launches,
              conv3x3_plain.calls, rdb_fused_plain.calls,
              conv3x3_rdb_plain.calls)
    for hw in ((48, 56), (150, 136)):   # whole forward; streamed final
        img = np.kron(rng.integers(0, 256, (hw[0] // 8 + 1, hw[1] // 8 + 1, 3),
                                   dtype=np.uint8),
                      np.ones((8, 8, 1), np.uint8))[:hw[0], :hw[1]]
        out = pipe.enhance_array(img)
        assert out.shape == (4 * hw[0], 4 * hw[1], 3) and out.std() > 0
    assert "esrgan+post/streamed" in pipe.timer.totals
    k1, k2, steps, p1, p2, p3 = (a - b for a, b in zip(
        (conv3x3.launches, rdb_fused.launches, conv3x3_rdb.launches,
         conv3x3_plain.calls, rdb_fused_plain.calls,
         conv3x3_rdb_plain.calls), counts))
    assert k1 > 0 and (k2 > 0) == (trunk == "dform")
    assert (steps > 0) == (trunk != "dform")
    assert p1 == 0 and p2 == 0 and p3 == 0


@pytest.mark.parametrize("overrides", [
    {"esrgan_trunk": "int8"},
    {"parity_tiling": True, "memory_efficient": True, "max_tile_size": 96},
], ids=["int8", "parity_tiling"])
def test_config_modes_go_through_the_kernels(cuda, tmp_path, overrides):
    """The int8 trunk runs its convs on the K4 step (15 launches an RRDB,
    one int8_amax a forward, the standalone K4 never) and its head on K1,
    and a parity-tiling request each tile's forward on K1 and the K1 step;
    no plain version."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, num_feat=64,
                        num_block=1, num_grow_ch=32)
    ckpt = save_state_dict(init_rrdbnet(cfg, torch.Generator().manual_seed(5)),
                           str(tmp_path / "w.pth"))
    pipe = SuperResolutionPipeline("cuda", dict({
        "use_diffusion": False, "segment_enhancement": False,
        "denoise_level": 0, "iterations": 1, "esrgan_model_path": ckpt,
        "esrgan_arch": {"num_block": 1}, "output_dir": str(tmp_path / "out")},
        **overrides))
    img = np.kron(np.random.default_rng(6).integers(0, 256, (20, 19, 3),
                                                    dtype=np.uint8),
                  np.ones((8, 8, 1), np.uint8))[:150, :136]
    def counts():
        return (conv3x3.launches, conv3x3_int8_rdb.launches,
                int8_amax.launches, conv3x3_int8.launches,
                conv3x3_rdb.launches, conv3x3_plain.calls,
                conv3x3_int8_plain.calls, conv3x3_int8_rdb_plain.calls,
                int8_amax_plain.calls, conv3x3_rdb_plain.calls)

    before = counts()
    out = pipe.enhance_array(img)
    k1, k4s, amax, k4, steps, *plain = (
        a - b for a, b in zip(counts(), before))
    want = (300, 272, 3) if overrides.get("parity_tiling") else (600, 544, 3)
    assert out.shape == want and out.std() > 0
    int8 = "esrgan_trunk" in overrides
    assert k1 > 0 and (k4s > 0) == int8 and (amax > 0) == int8
    assert k4s == 15 * amax and k4 == 0 and (steps > 0) == (not int8)
    assert not any(plain)


@pytest.mark.parametrize("nf,g,shape", [(64, 32, (2, 37, 45)),
                                        (16, 8, (1, 33, 20)),
                                        (12, 4, (2, 21, 35)),
                                        (64, 32, (1, 268, 268)),
                                        (64, 32, (1, 17, 9)),
                                        (16, 8, (1, 80, 80)),
                                        (64, 56, (1, 20, 24))],
                         ids=["trunk", "fixture", "scalar_paths",
                              "ragged_walk", "fewer_tiles_than_blocks",
                              "fixture_80", "sweeps_two_stages"])
@pytest.mark.parametrize("skip", [False, True], ids=["", "skip"])
def test_rdb_step_matches_the_composition(cuda, nf, g, shape, skip):
    """The K1 step's five launches an RDB equal FusedRDB._composition on
    K1 bit for bit (with the RRDB skip: skip + 0.2 * it), with no plain
    call; each step within K1's bar of its plain version. The persistent
    walk's edges: 1 x 268^2 is 1,139 tiles, which no grid of at most 132
    blocks of two consumers divides; 1 x 17 x 9 is 5 tiles for 3 blocks,
    the last with one consumer idle; step 0 at nf 64 keeps its weights a
    sweep of one N tile at a time; at nf 64 / g 56 steps 0-2 sweep and
    steps 1-4 run on two stages."""
    gen = torch.Generator().manual_seed(nf + g)
    fw = [(torch.randn((3, 3, ci, co), generator=gen) * 0.05).bfloat16()
          .float() for ci, co in ((nf, 4 * g + nf), (g, 3 * g + nf),
                                  (g, 2 * g + nf), (g, g + nf), (g, nf))]
    rdb = FusedRDB(fw, torch.randn((4 * g + nf,), generator=gen) * 0.1,
                   torch.bfloat16, cuda, kernel=False)
    x, sk = ((torch.randn((*shape, nf), generator=gen) * 0.5).to(
        cuda, torch.bfloat16) for _ in range(2))
    sk = sk if skip else None
    launches, calls = conv3x3_rdb.launches, conv3x3_rdb_plain.calls
    got = rdb(x, skip=sk)
    torch.cuda.synchronize()
    assert (conv3x3_rdb.launches, conv3x3_rdb_plain.calls) == (
        launches + 5, calls)
    ref = rdb._composition(x)
    ref = ref if sk is None else sk + 0.2 * ref
    assert torch.equal(got, ref)
    slots = torch.zeros((*shape, 4 * g + nf), dtype=torch.bfloat16,
                        device=cuda)
    slots_p, t = slots.clone(), x
    for k, (w, p) in enumerate(zip(rdb.weights(), rdb.packed())):
        extra = dict(x=x, skip=sk) if k == 4 else {}
        y = conv3x3_rdb(k, t, w, rdb.b, slots, packed=p, **extra)
        assert _rel(y, conv3x3_rdb_plain(k, t, w, rdb.b, slots_p,
                                         **extra)) <= 1e-2
        assert _rel(slots[..., (k + 1) * g:],
                    slots_p[..., (k + 1) * g:]) <= 1e-2
        t = y


def test_rdb_step_refuses_what_it_does_not_take(cuda):
    """A float32 source and x_{k+1} written over x_k raise before a
    launch."""
    x = torch.zeros((1, 8, 8, 16), device=cuda)
    w = torch.zeros((3, 3, 16, 48), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(48, device=cuda)
    slots = torch.zeros((1, 8, 8, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(KernelInputError, match="bf16"):
        conv3x3_rdb(0, x, w, b, slots)
    xk = torch.zeros((1, 8, 8, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(KernelInputError, match="overwrite"):
        conv3x3_rdb(1, xk, w[:, :, :8, 8:].contiguous(), b, slots, xn=xk)


def _k1f_step(k, src, w, b, slots, x=None, skip=None):
    """Step k as FusedRDB._composition takes it: K1f's bias-free conv,
    then the step's slice of the assembly in PyTorch (slots updated in
    place)."""
    c = conv3x3_f32(src, w)
    g = src.shape[-1] if k else (w.shape[3] - src.shape[-1]) // 4
    lo = k * g
    if k == 4:
        y = x + 0.2 * (slots[..., lo:] + c + b[lo:])
        return y if skip is None else skip + 0.2 * y
    t = c[..., :g] if k == 0 else slots[..., lo:lo + g] + c[..., :g]
    if k == 0:
        slots[..., g:] = c[..., g:]
    else:
        slots[..., lo + g:] += c[..., g:]
    return torch.nn.functional.leaky_relu(t + b[lo:lo + g], 0.2)


@pytest.mark.parametrize("nf,g,shape", [(64, 32, (2, 37, 45)),
                                        (16, 8, (1, 33, 20)),
                                        (12, 4, (2, 21, 35)),
                                        (64, 32, (1, 13, 9)),
                                        (10, 6, (1, 11, 19))],
                         ids=["trunk", "fixture", "g4", "ragged",
                              "widths_off_4"])
@pytest.mark.parametrize("skip", [False, True], ids=["", "skip"])
def test_rdb_f32_step_matches_the_composition(cuda, nf, g, shape, skip):
    """The float32 RDB step's five launches equal FusedRDB._composition on
    K1f bit for bit (with the RRDB skip: skip + 0.2 * it), with no K1f,
    bf16 step or plain call; each step (x_{k+1} or out, and the slots)
    equals the composition's step on K1f bit for bit and is within 1e-5 of
    the plain step (cuDNN, TF32 off). At g 4 a granule holds x_{k+1} and
    slot channels; at nf 10 / g 6 Cin and Cout are off 4 (4-byte staging,
    scalar epilogue)."""
    gen = torch.Generator().manual_seed(nf + g + 1)
    fw = [torch.randn((3, 3, ci, co), generator=gen) * 0.05
          for ci, co in ((nf, 4 * g + nf), (g, 3 * g + nf), (g, 2 * g + nf),
                         (g, g + nf), (g, nf))]
    rdb = FusedRDB(fw, torch.randn((4 * g + nf,), generator=gen) * 0.1,
                   torch.float32, cuda, kernel=False)
    x, sk = ((torch.randn((*shape, nf), generator=gen) * 0.5).to(cuda)
             for _ in range(2))
    sk = sk if skip else None
    counts = (conv3x3_rdb_f32.launches, conv3x3_f32.launches,
              conv3x3_rdb.launches, conv3x3_rdb_plain.calls)
    got = rdb(x, skip=sk)
    torch.cuda.synchronize()
    assert (conv3x3_rdb_f32.launches, conv3x3_f32.launches,
            conv3x3_rdb.launches, conv3x3_rdb_plain.calls) == (
        counts[0] + 5, *counts[1:])
    ref = rdb._composition(x)
    ref = ref if sk is None else sk + 0.2 * ref
    assert torch.equal(_bits(got), _bits(ref))
    slots = torch.zeros((*shape, 4 * g + nf), device=cuda)
    slots_c, slots_p, t = slots.clone(), slots.clone(), x
    for k, w in enumerate(rdb.weights()):
        extra = dict(x=x, skip=sk) if k == 4 else {}
        y = conv3x3_rdb(k, t, w, rdb.b, slots, **extra)
        comp = _k1f_step(k, t, w, rdb.b, slots_c, **extra)
        plain = conv3x3_rdb_plain(k, t, w, rdb.b, slots_p, **extra)
        torch.cuda.synchronize()
        assert torch.equal(_bits(y), _bits(comp)), k
        assert torch.equal(_bits(slots), _bits(slots_c)), k
        assert _rel(y, plain) <= 1e-5, k
        assert _rel(slots[..., (k + 1) * g:],
                    slots_p[..., (k + 1) * g:]) <= 1e-5, k
        t = y


def test_rdb_f32_step_refuses_what_it_does_not_take(cuda):
    """A float32 source with bf16 slots (or a bf16 x_{k+1}), and x_{k+1}
    written over x_k, raise before a launch."""
    x = torch.zeros((1, 8, 8, 16), device=cuda)
    w = torch.zeros((3, 3, 16, 48), device=cuda)
    b = torch.zeros(48, device=cuda)
    slots = torch.zeros((1, 8, 8, 48), device=cuda)
    launches = conv3x3_rdb_f32.launches
    with pytest.raises(KernelInputError, match="bf16"):
        conv3x3_rdb(0, x, w, b, slots.bfloat16())
    with pytest.raises(KernelInputError, match="bf16"):
        conv3x3_rdb_f32(0, x, w, b, slots,
                        xn=torch.zeros((1, 8, 8, 8), dtype=torch.bfloat16,
                                       device=cuda))
    xk = torch.zeros((1, 8, 8, 8), device=cuda)
    with pytest.raises(KernelInputError, match="overwrite"):
        conv3x3_rdb(1, xk, w[:, :, :8, 8:].contiguous(), b, slots, xn=xk)
    assert conv3x3_rdb_f32.launches == launches


def _swinir_ckpt(path, depths=(2, 2)):
    """SwinIR-M's width (embed 180, heads 6, window 8, nearest+conv) at a
    cut depth, seeded, as an official .pth."""
    from neural_enhanced_super_resolution_torch.models import (
        SwinIRConfig, init_swinir)
    cfg = SwinIRConfig(depths=depths, num_heads=(6,) * len(depths))
    return save_state_dict(init_swinir(cfg, torch.Generator().manual_seed(8)),
                           path)


def test_swinir_full_width_forward_matches_plain(cuda, tmp_path):
    """SwinIR at its published width, two RSTBs of two STLs, on a 44x36
    input (reflect-padded to 48x40): K1 against its plain version."""
    from neural_enhanced_super_resolution_torch.models import load_swinir
    model = load_swinir(_swinir_ckpt(str(tmp_path / "s.pth")), "bfloat16",
                        cuda)
    x = torch.rand((2, 44, 36, 3), generator=torch.Generator().manual_seed(9)
                   ).to(cuda)
    launches = conv3x3.launches
    out = model(x)
    assert conv3x3.launches - launches == 9   # 1 + 2 + 1 + 1 + 4
    ref = model(x, plain=True)
    assert out.shape == (2, 176, 144, 3) and torch.isfinite(out).all()
    assert _rel(out, ref) <= 3e-2


def test_swinir_request_goes_through_k1(cuda, tmp_path):
    """enhance_array with use_swinir on the card: SwinIR whole and tiled
    joins the ensemble through K1 and never a plain version."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    pipe = SuperResolutionPipeline("cuda", {
        "use_diffusion": False, "segment_enhancement": False,
        "denoise_level": 0, "iterations": 1, "use_esrgan": False,
        "use_swinir": True, "max_tile_size": 32, "tile_halo": 4,
        "swinir_model_path": _swinir_ckpt(str(tmp_path / "s.pth"), (1,)),
        "output_dir": str(tmp_path / "out")})
    counts = (conv3x3.launches, conv3x3_plain.calls)
    rng = np.random.default_rng(10)
    for hw in ((40, 48), (72, 80)):   # whole; tiled
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        out = pipe.enhance_array(img)
        assert out.shape == (4 * hw[0], 4 * hw[1], 3) and out.std() > 0
    assert "swinir" in pipe.timer.totals
    k1, p1 = (a - b for a, b in zip((conv3x3.launches, conv3x3_plain.calls),
                                    counts))
    assert k1 == 8 * (1 + 9) and p1 == 0   # 8 convs a forward, 1 + 9 tiles


def _qkv(cuda, b, h, sq, skv, d, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.randn(shape, generator=g) * scale).to(
        cuda, torch.bfloat16) for shape, scale in (
            ((b, h, sq, d), 2.0), ((b, h, skv, d), 2.0), ((b, h, skv, d), 1.0)))


@pytest.mark.parametrize("b,h,sq,skv,d", [
    (1, 8, 256, 256, 64), (2, 4, 300, 300, 64), (1, 2, 200, 330, 128),
    (1, 1, 1000, 1000, 512), (1, 2, 240, 240, 8), (1, 1, 960, 960, 16),
    (1, 2, 70, 45, 256), (1, 2, 130, 190, 24), (2, 1, 100, 257, 72),
    (1, 2, 77, 150, 136), (1, 1, 333, 200, 264), (1, 1, 1000, 4000, 512)])
def test_flash_attention_kernel_matches_plain(cuda, b, h, sq, skv, d):
    """Both forms (d <= 128 narrow, above it wide) at head dims padded to
    16..512, query counts off the 64-row block and key counts off the key
    tile (64 or 128), d = 512 over 4000 keys, several (batch, head) pairs."""
    q, k, v = _qkv(cuda, b, h, sq, skv, d, seed=sq)
    launches, calls = flash_attention.launches, flash_attention_plain.calls
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_plain.calls) == (
        launches + 1, calls)
    ref = flash_attention_plain(q, k, v).float()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert ((got.float() - ref).abs().max() / ref.abs().max()).item() <= 2e-2


def test_flash_attention_kernel_masks_padded_keys(cuda):
    """Every real score -2048 on a ragged Skv: uniform over the real keys."""
    q = torch.full((1, 2, 100, 64), 16.0, device=cuda, dtype=torch.bfloat16)
    k = torch.full((1, 2, 100, 64), -16.0, device=cuda, dtype=torch.bfloat16)
    v = torch.randn((1, 2, 100, 64), generator=torch.Generator().manual_seed(
        0)).to(cuda, torch.bfloat16)
    want = v.float().mean(dim=2, keepdim=True).expand(1, 2, 100, 64)
    assert (flash_attention(q, k, v).float() - want).abs().max() <= 2e-3


@pytest.mark.parametrize("dm,heads", [(256, 4), (272, 2), (1024, 2)],
                         ids=["d64", "d136", "d512"])
def test_attention_auto_runs_the_kernel_on_packed_views(cuda, dm, heads):
    """(B, S, H*d) projections go to K3 as (B, H, S, d) views; f32 out."""
    g = torch.Generator().manual_seed(1)
    q, k, v = ((torch.randn((2, 333, dm), generator=g) * 2).to(cuda)
               for _ in range(3))
    launches = flash_attention.launches
    out = attention_auto(q, k, v, heads)
    assert flash_attention.launches == launches + 1
    assert out.dtype == torch.float32 and out.shape == (2, 333, dm)
    views = [t.to(torch.bfloat16).view(2, 333, heads, dm // heads
                                       ).transpose(1, 2) for t in (q, k, v)]
    ref = flash_attention_plain(*views).transpose(1, 2).reshape(2, 333, dm)
    assert ((out - ref.float()).abs().max() / ref.float().abs().max()
            ).item() <= 2e-2


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 2, 64, 64, 64, seed=2)
    with pytest.raises(KernelInputError):
        flash_attention(q.float(), k, v)                 # f32 q, bf16 k
    with pytest.raises(KernelInputError):
        flash_attention(q[..., :12], k[..., :12], v[..., :12])  # d % 8
    with pytest.raises(KernelInputError):
        flash_attention(q, k[:, :, :32], v)              # k, v differ
    with pytest.raises(KernelInputError):
        big = torch.zeros((1, 1, 8, 1024), device=cuda, dtype=torch.bfloat16)
        flash_attention(big, big, big)                   # d > 512
    with pytest.raises(KernelInputError):
        flash_attention(q[:, :, :, 1:9], k[..., :8], v[..., :8])  # alignment


def test_diffusion_product_path_goes_through_k3(cuda, tmp_path):
    """The tiny SD x4 snapshot through enhance_array on the card: K3 runs
    every self-attention (4 per UNet pass, 2 passes a step, and the VAE's),
    never the plain version."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        CLIPTextConfig, UNetConfig, VAEConfig)
    from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
        write_synthetic_snapshot)
    snap = write_synthetic_snapshot(str(tmp_path / "sd"), (
        UNetConfig(block_out_channels=(8, 16), layers_per_block=1,
                   down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                   up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                   cross_attention_dim=16, attention_head_dim=2,
                   num_class_embeds=50, norm_num_groups=4),
        VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                  norm_num_groups=4),
        CLIPTextConfig(vocab_size=100, hidden_size=16, intermediate_size=32,
                       num_hidden_layers=2, num_attention_heads=2,
                       max_position_embeddings=12)),
        torch.Generator().manual_seed(0), init="fixed")
    pipe = SuperResolutionPipeline("cuda", {
        "use_esrgan": False, "segment_enhancement": False, "denoise_level": 0,
        "iterations": 1, "diffusion_model_path": snap,
        "num_inference_steps": 3, "output_dir": str(tmp_path / "out")})
    launches, calls = flash_attention.launches, flash_attention_plain.calls
    img = np.random.default_rng(3).integers(0, 256, (24, 40, 3), np.uint8)
    out = pipe.enhance_array(img)
    assert out.shape == (48, 80, 3)
    assert flash_attention.launches - launches == 4 * 2 * 3 + 1
    assert flash_attention_plain.calls == calls


def test_nl_means_on_the_card_matches_the_cpu(cuda):
    """The joint pass's uint8 Lab within one level on <= 1e-3 of the
    values; the RGB output differs on <= 1e-3 of the values, and by <= 1
    where the Lab agrees (one linear-light Lab level spans up to ~5 RGB
    levels)."""
    g = np.random.default_rng(0)
    x = torch.from_numpy(np.clip(g.normal(128, 40, (3, 70, 90, 3)), 0, 255)
                         .astype(np.uint8))
    ref_lab = _denoised_lab(x, 5.0, 5.0)
    ref = _lab_to_output(ref_lab, x.shape)
    lab = _denoised_lab(x.to(cuda), 5.0, 5.0)
    got = nl_means_colored(x.to(cuda), h=5.0, h_color=5.0).cpu()
    assert torch.equal(got, _lab_to_output(lab, x.shape).cpu())
    dlab = (lab.cpu().int() - ref_lab.int()).abs()
    drgb = (got.int() - ref.int()).abs()
    assert dlab.max().item() <= 1
    assert (dlab > 0).float().mean().item() <= 1e-3
    assert (drgb > 0).float().mean().item() <= 1e-3
    assert (drgb * (dlab == 0).all(-1, keepdim=True)).max().item() <= 1


# NL-means' kernel (csrc/nlmeans.cu) at the chip check's shapes: the
# 32 x 544^2 tile chunk of the denoise path, a whole 768x576 image, a
# ragged batch and an image narrower than the 13-pixel reach (the Lab
# joint pass), and one field with sigma > 0 on a float image.
NLM_CASES = [("lab", (32, 544, 544)), ("lab", (1, 576, 768)),
             ("lab", (2, 37, 23)), ("lab", (1, 9, 11)),
             ("one_sigma", (1, 96, 80))]


def _nlm_input(kind, shape, seed):
    """Flat 16 x 16 patches with noise of std 12, as linear Lab (float32)
    the way _denoised_lab makes it, or as a float image."""
    g = np.random.default_rng(seed)
    n, h, w = shape
    flat = g.integers(0, 256, (n, h // 16 + 1, w // 16 + 1, 3))
    img = np.kron(flat, np.ones((1, 16, 16, 1)))[:, :h, :w]
    img = np.clip(img + g.normal(0, 12, img.shape), 0, 255)
    if kind == "one_sigma":
        return torch.from_numpy(img.astype(np.float32))
    x = torch.from_numpy(img.astype(np.uint8))
    return rgb_to_lab(x.flip(-1), srgb=False).float()


@pytest.mark.parametrize("kind,shape", NLM_CASES,
                         ids=[f"{k}_{'x'.join(map(str, s))}"
                              for k, s in NLM_CASES])
def test_nl_means_kernel_matches_plain(cuda, kind, shape):
    """One launch, no plain call; float32 within 1e-5 of max|plain| (the
    offsets summed in another order); the rounded uint8 Lab within one
    level on <= 1e-3 of the values."""
    x = _nlm_input(kind, shape, sum(shape)).to(cuda)
    fields, sigma = ((((0,), 5.0), ((1, 2), 5.0)), 0.0) if kind == "lab" \
        else ((((0, 1, 2), 9.0),), 6.0)
    launches, calls = nl_means_fields.launches, nl_means_fields_plain.calls
    got = nl_means_fields(x, fields, sigma)
    assert nl_means_fields.launches == launches + 1
    assert nl_means_fields_plain.calls == calls
    ref = nl_means_fields_plain(x, fields, sigma, 7, 21)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    d = (saturate_like(got, torch.uint8).int()
         - saturate_like(ref, torch.uint8).int()).abs()
    assert d.max().item() <= 1
    assert (d > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("channels,shape,sigma", [
    (1, (3, 70, 130), 4.0), (2, (1, 45, 61), 0.0), (4, (1, 45, 61), 5.0),
    (4, (2, 300, 200), 0.0)],
    ids=["gray_27_tiles", "two_channels", "four_channels",
         "four_channels_many_tiles"])
def test_nl_means_kernel_one_field_channels(cuda, channels, shape, sigma):
    """The one-field form at every channel count, on grids that split the
    search rows between a cluster's blocks and on one that does not: the
    same bars as test_nl_means_kernel_matches_plain."""
    x = _nlm_input("one_sigma", shape, sum(shape))
    x = x[..., [i % 3 for i in range(channels)]].contiguous().to(cuda)
    fields = ((tuple(range(channels)), 9.0),)
    launches = nl_means_fields.launches
    got = nl_means_fields(x, fields, sigma)
    assert nl_means_fields.launches == launches + 1
    ref = nl_means_fields_plain(x, fields, sigma, 7, 21)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_nl_means_paths_launch_the_kernel_once(cuda):
    img = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 40, 52, 3), dtype=np.uint8)).to(cuda)
    launches, calls = nl_means_fields.launches, nl_means_fields_plain.calls
    nl_means_colored(img, h=5.0, h_color=5.0)
    nl_means(img[0, ..., 0], h=9.0, sigma=4.0)
    assert nl_means_fields.launches == launches + 2
    assert nl_means_fields_plain.calls == calls


def test_nl_means_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 16, 16, 3), device=cuda)
    fields = (((0,), 5.0), ((1, 2), 5.0))
    with pytest.raises(KernelInputError, match="7x7 template"):
        nl_means_fields(x, fields, 0.0, 5, 21)
    with pytest.raises(KernelInputError, match="fields"):
        nl_means_fields(x, fields, 2.0)
    with pytest.raises(KernelInputError, match="float32"):
        nl_means_fields(x.double(), fields)
    with pytest.raises(KernelInputError, match="C 1..4"):
        nl_means_fields(torch.zeros((1, 8, 8, 5), device=cuda),
                        ((tuple(range(5)), 5.0),))


def test_segformer_on_the_card_matches_the_cpu(cuda, tmp_path):
    cfg = SegFormerConfig(depths=[1, 1, 1, 1], sr_ratios=[4, 2, 2, 1],
                          hidden_sizes=[8, 16, 16, 32],
                          num_attention_heads=[1, 2, 2, 4],
                          mlp_ratios=[2, 2, 2, 2], decoder_hidden_size=16,
                          num_labels=10)
    path = write_synthetic_segformer(str(tmp_path / "seg"), cfg,
                                     torch.Generator().manual_seed(0))
    x = torch.randn((1, 96, 128, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = load_segformer(path, "float32", "cpu").model(x)
        got = load_segformer(path, "bfloat16", "cuda").model(x.to(cuda))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got.cpu(), ref) <= 3e-2


def test_streamed_to_host_on_the_card_equals_process_tiled(cuda):
    """A card uint8 image through the card's tiling, pinned buffers and the
    copy stream, three chunks with a ragged last one (35 tiles of 32 at 16
    a chunk): bit for bit what process_tiled gives on the card."""
    from neural_enhanced_super_resolution_torch.ops.enhance import (
        adaptive_sharpen_batch)
    from neural_enhanced_super_resolution_torch.parallel.tiling import (
        process_tiled, process_tiled_to_host)
    from neural_enhanced_super_resolution_torch.pipeline import esrgan_step
    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, num_feat=64,
                        num_block=1, num_grow_ch=32)
    model = RRDBNet(cfg, init_rrdbnet(cfg, torch.Generator().manual_seed(7)),
                    torch.bfloat16, cuda)

    def model_fn(tiles):
        return adaptive_sharpen_batch(esrgan_step(model, tiles))

    img = np.random.default_rng(8).integers(0, 256, (150, 210, 3), np.uint8)
    kw = dict(tile_size=32, halo=6, scale=4, batch_tiles=16)
    launches = conv3x3.launches
    got = process_tiled_to_host(model_fn, torch.as_tensor(img, device=cuda),
                                **kw)
    assert conv3x3.launches > launches
    ref = process_tiled(model_fn, torch.as_tensor(img, device=cuda),
                        **kw).cpu().numpy()
    assert got.shape == (600, 840, 3)
    np.testing.assert_array_equal(got, ref)


def test_vae_encode_runs_k3_once_and_matches_plain(cuda):
    """vae_encode in bf16 with the mid-block attention at d 512 on K3,
    one launch an encode, within 3e-2 of max|ref| of the same encode on
    the plain attention."""
    from neural_enhanced_super_resolution_torch.kernels import attention
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        AutoencoderKL, VAEConfig, build_module, vae_encode)
    from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
        random_state_dict)
    cfg = VAEConfig(block_out_channels=(64, 128, 512), layers_per_block=1)
    with torch.device("meta"):
        shapes = AutoencoderKL(cfg)
    sd = random_state_dict(shapes, torch.Generator().manual_seed(9))
    vae = build_module(AutoencoderKL, cfg, sd, torch.bfloat16, cuda)
    img = torch.rand((1, 96, 64, 3), generator=torch.Generator().manual_seed(
        10)).to(cuda) * 2 - 1
    launches, calls = flash_attention.launches, flash_attention_plain.calls
    got = vae_encode(vae, img)
    assert flash_attention.launches - launches == 1
    assert flash_attention_plain.calls == calls
    kernel = attention.flash_attention
    attention.flash_attention = attention.flash_attention_plain
    try:
        ref = vae_encode(vae, img)
    finally:
        attention.flash_attention = kernel
    assert got.shape == (1, 24, 16, 8) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 3e-2 * ref.abs().max().item()


def test_float32_request_on_the_card_matches_the_cpu(cuda, tmp_path):
    """precision float32 on the card runs K1's float32 form (TF32 off), no
    bf16 kernel and no plain version; its uint8 output equals the CPU
    float32 request's on >= 99.9% of the values, within one level
    (adaptive sharpening off: its detail threshold turns a one-level
    truncation tie into a many-level pixel)."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, num_feat=16,
                        num_block=1, num_grow_ch=8)
    ckpt = save_state_dict(init_rrdbnet(cfg, torch.Generator().manual_seed(5)),
                           str(tmp_path / "w.pth"))
    base = {"use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0, "iterations": 1, "esrgan_model_path": ckpt,
            "esrgan_arch": {"num_feat": 16, "num_block": 1,
                            "num_grow_ch": 8},
            "precision": "float32", "adaptive_sharpening": False,
            "output_dir": str(tmp_path / "out")}
    img = np.kron(np.random.default_rng(6).integers(0, 256, (19, 17, 3),
                                                    dtype=np.uint8),
                  np.ones((8, 8, 1), np.uint8))[:150, :136]
    ref = SuperResolutionPipeline("cpu", base).enhance_array(img)
    before = (conv3x3.launches, conv3x3_f32.launches, conv3x3_plain.calls,
              conv3x3_rdb_f32.launches, conv3x3_rdb.launches,
              conv3x3_rdb_plain.calls)
    got = SuperResolutionPipeline("cuda", base).enhance_array(img)
    assert conv3x3.launches == before[0]
    assert conv3x3_f32.launches > before[1]
    assert conv3x3_plain.calls == before[2]
    # the trunk on the float32 RDB step: 15 launches an RRDB a forward
    steps = conv3x3_rdb_f32.launches - before[3]
    assert steps > 0 and steps % 15 == 0
    assert (conv3x3_rdb.launches, conv3x3_rdb_plain.calls) == before[4:]
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert got.shape == ref.shape == (600, 544, 3)
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999


@pytest.mark.parametrize("n,h,w,cin,cout,bias,act", [
    (2, 37, 45, 12, 64, True, False), (1, 40, 33, 64, 192, False, False),
    (1, 30, 50, 32, 160, False, False), (2, 21, 19, 64, 3, True, False),
    (1, 18, 70, 64, 64, True, True), (1, 9, 9, 130, 32, True, True),
    (1, 11, 13, 3, 300, True, False), (2, 24, 16, 180, 180, True, False),
    (2, 40, 72, 64, 192, False, False), (2, 40, 72, 32, 160, False, False),
    (2, 40, 72, 32, 128, False, False), (2, 40, 72, 32, 96, False, False),
    (2, 40, 72, 32, 64, False, False), (1, 19, 23, 16, 8, True, True),
    (1, 21, 35, 32, 200, True, False), (1, 17, 29, 64, 300, True, True)],
    ids=["conv_first", "w0", "w1", "conv_last", "head_lrelu",
         "ragged_cin", "cin3_two_blocks", "swinir_rstb", "trunk_w0",
         "trunk_w1", "trunk_w2", "trunk_w3", "trunk_w4", "cout8_one_granule",
         "cout200_two_groups", "cout300_two_groups_bulk"])
def test_conv3x3_f32_kernel_matches_plain(cuda, n, h, w, cin, cout, bias,
                                          act):
    """K1f at the trunk's five and the head's shapes, Cin off the 8-channel
    pass and off 4 (4-byte staging), Cout of one granule, off 8, and above
    the 192 channels of one block (two channel groups, by 4-byte staging
    and by bulk copies), ragged tiles; conv3x3 routes a float32 x to it."""
    g = torch.Generator().manual_seed(cin * cout + h)
    x = torch.randn((n, h, w, cin), generator=g).to(cuda)
    wt = (torch.randn((3, 3, cin, cout), generator=g) * 0.05).to(cuda)
    b = (torch.randn((cout,), generator=g) * 0.1).to(cuda) if bias else None
    launches, k1, calls = (conv3x3_f32.launches, conv3x3.launches,
                           conv3x3_plain.calls)
    got = conv3x3(x, wt, b, act)
    torch.cuda.synchronize()
    assert (conv3x3_f32.launches, conv3x3.launches, conv3x3_plain.calls) == (
        launches + 1, k1, calls)
    ref = conv3x3_plain(x, wt, b, act)
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("b,h,sq,skv,d", [
    (1, 8, 256, 256, 64), (2, 4, 300, 300, 64), (1, 2, 200, 330, 128),
    (1, 1, 1000, 1000, 512), (1, 2, 70, 45, 256), (2, 1, 100, 257, 72),
    (1, 2, 77, 150, 20), (1, 1, 333, 200, 264), (1, 1, 1920, 1920, 512),
    (1, 2, 40, 3000, 64), (1, 8, 4096, 4096, 64)])
def test_flash_attention_f32_kernel_matches_plain(cuda, b, h, sq, skv, d):
    """K3f at head dims padded to 32..512, query counts off the query
    block and key counts off the key tile, key-range splits (the VAE
    mid-block's 1920^2 at d 512, and Skv far above Sq) and the UNet's
    64^2 self-attention with none; flash_attention routes a float32 q to
    it."""
    q, k, v = (t.float() for t in _qkv(cuda, b, h, sq, skv, d, seed=sq))
    launches, k3 = flash_attention_f32.launches, flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention_f32.launches, flash_attention.launches) == (
        launches + 1, k3)
    ref = flash_attention_plain(q, k, v)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5


def test_float32_forms_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 8, 8, 16), device=cuda)
    w = torch.zeros((3, 3, 16, 16), device=cuda)
    with pytest.raises(KernelInputError):
        conv3x3_f32(x, w.bfloat16())                     # bf16 weights
    with pytest.raises(KernelInputError):
        conv3x3_f32(x, w, torch.zeros(8, device=cuda))   # bias length
    with pytest.raises(KernelInputError):
        conv3x3_f32(x.transpose(1, 2), w)                # not contiguous
    q = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(KernelInputError):
        flash_attention_f32(q, q.bfloat16(), q)          # bf16 k
    with pytest.raises(KernelInputError):
        flash_attention_f32(q[..., :6], q[..., :6], q[..., :6])  # d % 4
    with pytest.raises(KernelInputError):
        flash_attention_f32(q[..., 1:9], q[..., :8], q[..., :8])  # alignment


def test_vae_encode_in_float32_runs_k3f_once(cuda):
    """vae_encode in float32: the mid-block attention on K3's float32 form,
    one launch an encode, within 1e-4 of max|ref| of the plain attention
    (a whole forward, as the bf16 forms' forwards take a looser bar than
    one kernel)."""
    from neural_enhanced_super_resolution_torch.kernels import attention
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        AutoencoderKL, VAEConfig, build_module, vae_encode)
    from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
        random_state_dict)
    cfg = VAEConfig(block_out_channels=(64, 128, 512), layers_per_block=1)
    with torch.device("meta"):
        shapes = AutoencoderKL(cfg)
    sd = random_state_dict(shapes, torch.Generator().manual_seed(9))
    vae = build_module(AutoencoderKL, cfg, sd, torch.float32, cuda)
    img = torch.rand((1, 96, 64, 3), generator=torch.Generator().manual_seed(
        10)).to(cuda) * 2 - 1
    launches, k3 = flash_attention_f32.launches, flash_attention.launches
    got = vae_encode(vae, img)
    assert flash_attention_f32.launches - launches == 1
    kernel = attention.flash_attention
    attention.flash_attention = attention.flash_attention_plain
    try:
        ref = vae_encode(vae, img)
    finally:
        attention.flash_attention = kernel
    assert flash_attention.launches == k3
    assert got.shape == (1, 24, 16, 8) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
