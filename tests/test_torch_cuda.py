"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA GPU and skips without one (the kernels have no
CPU mode). The file imports no JAX and uses no conftest fixture, so on a
machine with the card and without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 1e-2 * max(1, max|plain|) per kernel
(bf16 outputs; the two sum in another order), 3e-2 for a whole forward.
"""

import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.kernels import (
    KernelError, KernelInputError, conv3x3, conv3x3_plain, rdb_fused,
    rdb_fused_plain)
from neural_enhanced_super_resolution_torch.models import (
    RRDBNet, RRDBNetConfig, init_rrdbnet, save_state_dict)

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
    (1, 18, 70, 64, 64, True, True), (1, 9, 9, 130, 32, True, True)])
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


@pytest.mark.parametrize("shape", [(1, 8, 8, 64), (2, 37, 45, 64),
                                   (1, 5, 70, 64)])
def test_rdb_fused_kernel_matches_plain(cuda, shape):
    x, ws, b = _rdb_args(cuda, shape, seed=1)
    launches, calls = rdb_fused.launches, rdb_fused_plain.calls
    got = rdb_fused(x, ws, b)
    torch.cuda.synchronize()
    assert (rdb_fused.launches, rdb_fused_plain.calls) == (launches + 1, calls)
    assert _rel(got, rdb_fused_plain(x, ws, b)) <= 1e-2


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 8, 8, 64), device=cuda)
    w = torch.zeros((3, 3, 64, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(KernelInputError):
        conv3x3(x, w)                                    # f32 activations
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


@pytest.mark.parametrize("trunk", ["fused", "dform"])
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
    counts = (conv3x3.launches, rdb_fused.launches, conv3x3_plain.calls,
              rdb_fused_plain.calls)
    for hw in ((48, 56), (150, 136)):   # whole forward; streamed final
        img = np.kron(rng.integers(0, 256, (hw[0] // 8 + 1, hw[1] // 8 + 1, 3),
                                   dtype=np.uint8),
                      np.ones((8, 8, 1), np.uint8))[:hw[0], :hw[1]]
        out = pipe.enhance_array(img)
        assert out.shape == (4 * hw[0], 4 * hw[1], 3) and out.std() > 0
    assert "esrgan+post/streamed" in pipe.timer.totals
    k1, k2, p1, p2 = (a - b for a, b in zip(
        (conv3x3.launches, rdb_fused.launches, conv3x3_plain.calls,
         rdb_fused_plain.calls), counts))
    assert k1 > 0 and (k2 > 0) == (trunk == "dform")
    assert p1 == 0 and p2 == 0
