"""The folded RRDBNet head's kernel forms on the card, against their plain
versions: K1's and K1f's head 3x3 forms (``conv3x3_head``,
``conv3x3_head_f32``) and 2x2 forms, and ``FoldedHead``; the bf16 3x3 form
also bit for bit against K1's SAME conv with the bias, then LeakyReLU in
bf16, then depth-to-space.

Every test needs a CUDA GPU and skips without one (the kernels have no CPU
mode). The file imports no JAX and uses no conftest fixture, so on the
machine with the card it runs as

    python -m pytest --noconftest -q tests/test_torch_head_cuda.py

Tolerance: max|kernel - plain| <= 1e-2 * max(1, max|plain|) a conv in
bf16 (bf16 outputs; the two sum in another order), 1e-5 in float32
(float32 sums in another order); 3e-2 and 1e-4 for the whole head.
"""

import pytest
import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_torch.kernels import (
    conv2x2_s2d, conv2x2_s2d_f32, conv2x2_s2d_plain, conv3x3, conv3x3_head,
    conv3x3_head_f32, conv3x3_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import d2s as \
    depth_to_space
from neural_enhanced_super_resolution_torch.models import (
    RRDBNetConfig, init_rrdbnet)
from neural_enhanced_super_resolution_torch.models.rrdbnet import FoldedHead

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("taps,n,h,w,cin,cout,act,pad,mask,d2s", [
    (3, 2, 21, 37, 64, 256, True, 1, False, True),
    (3, 1, 17, 40, 64, 256, True, 1, False, False),
    (3, 1, 9, 7, 8, 32, True, 1, False, True),
    (3, 1, 5, 17, 64, 256, True, 1, False, True),
    (3, 1, 8, 32, 64, 256, True, 1, False, False),
    (3, 1, 268, 268, 64, 256, True, 1, False, True),
    (3, 2, 13, 19, 16, 64, True, 1, False, True),
    (3, 2, 13, 19, 16, 64, True, 1, False, False),
    (3, 1, 30, 22, 32, 128, True, 1, False, True),
    (3, 1, 11, 21, 12, 48, True, 1, False, True),
    (3, 1, 11, 21, 12, 48, False, 1, False, False),
    (3, 1, 9, 17, 128, 256, True, 1, False, True),
    (2, 2, 21, 37, 256, 256, True, 1, True, False),
    (2, 2, 22, 38, 256, 12, False, 0, False, True),
    (2, 1, 9, 7, 32, 32, True, 1, True, False),
    (2, 1, 10, 8, 32, 12, False, 0, False, True),
    (2, 1, 13, 11, 64, 64, True, 1, True, True),
    (2, 1, 6, 19, 48, 20, True, 0, True, False),
    (2, 1, 7, 32, 256, 256, True, 1, True, False),
    (2, 1, 4, 6, 256, 256, True, 1, True, False),
    (2, 2, 16, 32, 256, 256, True, 1, True, False),
    (2, 1, 18, 34, 256, 12, False, 0, False, True),
    (2, 1, 12, 20, 64, 64, True, 0, False, True),
    (2, 2, 9, 23, 64, 64, True, 1, True, False),
    (2, 1, 10, 18, 256, 256, True, 0, False, False),
    (2, 1, 11, 13, 64, 12, False, 1, True, True),
    (2, 1, 6, 10, 12, 12, True, 1, True, False),
    (2, 1, 9, 17, 320, 64, True, 1, True, False),
    (2, 1, 9, 17, 64, 320, True, 1, False, False)],
    ids=["up1", "up2", "up1_nf8", "up1_one_past_tiles", "up2_under_one_wave",
         "up1_odd_tail", "up1_nf16", "up2_nf16", "up1_nf32", "up1_nf12",
         "up2_nf12", "up1_cin128_two_passes",
         "hr", "last", "hr_nf8", "last_nf8",
         "hr_nf16_d2s", "ragged_nf12", "hr_odd_tile_count",
         "hr_under_one_wave", "hr_one_past_tiles", "last_one_past_tiles",
         "nf16_pad0", "nf16_pad1", "nf64_pad0", "nf16_pad1_to12",
         "cin12_padded", "cin320_patch_ring", "cout320_two_tiles"])
def test_folded_head_forms_match_plain(cuda, dtype, taps, n, h, w, cin, cout,
                                       act, pad, mask, d2s):
    """K1's and K1f's d2s and 2x2 forms (the folded head's convs) against
    their plain versions: 1e-2 in bf16, 1e-5 in float32; shapes included,
    and each call one launch of its form and no plain call."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn((n, h, w, cin), generator=g).to(cuda, dtype)
    wt = (torch.randn((taps, taps, cin, cout), generator=g)
          * (2.0 / (taps * taps * cin)) ** 0.5).to(cuda, dtype)
    b = (torch.randn((cout,), generator=g) * 0.1).to(cuda)
    bf16 = dtype == torch.bfloat16
    if taps == 3:
        kernel = conv3x3_head if bf16 else conv3x3_head_f32
        launches, calls = kernel.launches, conv3x3_plain.calls
        got = conv3x3(x, wt, b, act, d2s=d2s, round_first=True)
        assert (kernel.launches, conv3x3_plain.calls) == (launches + 1, calls)
        ref = conv3x3_plain(x, wt, b, act, d2s, True)
    else:
        kernel = conv2x2_s2d if bf16 else conv2x2_s2d_f32
        launches, calls = kernel.launches, conv2x2_s2d_plain.calls
        got = conv2x2_s2d(x, wt, b, act, pad, mask, d2s)
        assert (kernel.launches, conv2x2_s2d_plain.calls) == (launches + 1,
                                                              calls)
        ref = conv2x2_s2d_plain(x, wt, b, act, pad, mask, d2s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    assert _rel(got, ref) <= (1e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_folded_head_on_the_card_matches_plain(cuda, dtype):
    """FoldedHead at full width on a ragged trunk output: four launches
    (two 3x3, two 2x2) against its plain versions."""
    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, num_feat=64,
                        num_block=1, num_grow_ch=32)
    head = FoldedHead(init_rrdbnet(cfg, torch.Generator().manual_seed(12)),
                      dtype, cuda)
    feat = torch.randn((2, 23, 31, 64), generator=torch.Generator(
        ).manual_seed(13)).to(cuda, dtype)
    bf16 = dtype == torch.bfloat16
    k3, k2 = ((conv3x3_head, conv2x2_s2d) if bf16
              else (conv3x3_head_f32, conv2x2_s2d_f32))
    before = (k3.launches, k2.launches)
    out = head(feat)
    assert (k3.launches, k2.launches) == (before[0] + 2, before[1] + 2)
    assert out.shape == (2, 92, 124, 3) and torch.isfinite(out).all()
    assert _rel(out, head(feat, plain=True)) <= (3e-2 if bf16 else 1e-4)


@pytest.mark.parametrize("n,h,w,d2s", [
    (4, 268, 268, True), (1, 17, 9, True), (1, 17, 9, False),
    (2, 21, 37, False)],
    ids=["up1", "ragged_up1", "ragged_up2", "up2_small"])
def test_conv3x3_head_equals_k1_composition(cuda, n, h, w, d2s):
    """K1's head 3x3 form at nf 64 equals, in every bf16 value, K1's SAME
    conv with the bias (the same N tiles of 128 and K order), then
    F.leaky_relu in bf16, then depth-to-space: the head's output before
    the form had a kernel of its own."""
    g = torch.Generator().manual_seed(15)
    x = torch.randn((n, h, w, 64), generator=g).to(cuda, torch.bfloat16)
    wt = (torch.randn((3, 3, 64, 256), generator=g) * (2.0 / 576) ** 0.5).to(
        cuda, torch.bfloat16)
    b = (torch.randn((256,), generator=g) * 0.1).to(cuda)
    got = conv3x3_head(x, wt, b, True, d2s=d2s, round_first=True)
    ref = F.leaky_relu(conv3x3(x, wt, b, False), 0.2)
    if d2s:
        ref = depth_to_space(ref)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
