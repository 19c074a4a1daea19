"""The port's int8 trunk against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; the JAX side runs as its own tests
run it (XLA's int8 convolution with int32 accumulation on the CPU).
Tolerances:

* weights, scales, the quantised activations and ``conv3x3_int8_plain``:
  bit for bit (the same float32 operations in the same order, and an
  exact integer sum);
* one ``Int8RDB`` in float32: bit for bit; in bf16: max|diff| at most one
  bf16 ulp of max|ref| (XLA keeps excess precision across fused bf16 adds
  on the CPU, and a value that rounds apart can move a quantisation step;
  measured on the fixture 0.03125 at max|ref| 7.47, 13% of outputs
  apart; on the tiny model 0.00098 at 3.53, 0.8% apart);
* the whole trained-fixture forward in float32 against ``rrdbnet_forward``
  with int8 params run op by op (``jax.disable_jit``): max|diff| /
  max|ref| <= 1e-5; measured 4.9e-7. Jitted, XLA's excess precision on the
  CPU keeps the trunk's conv outputs in float32 where the JAX code rounds
  them to bf16: 8.0e-3 on the same input;
* the quality gate: the JAX package's bars (int8 vs the exact trunk > 40
  dB, measured 50.95; |dPSNR| against the Lanczos reference < 0.15 dB,
  measured 0.011), and the port's int8 request against the JAX
  package's with its ESRGAN step op by op: >= 99% of uint8 values equal
  and max <= 2 levels (measured 99.998%, max 1). Against the JAX request
  as it runs jitted, 64.6% are equal and the max is 10 levels: per-tensor
  activation scales turn XLA's float32 conv outputs and its 1-ulp input
  stack into rounding flips across the image; held to the int8 budget
  (PSNR > 40 dB, measured 50.77);
* ``psnr`` and ``ssim`` against the JAX package's within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from neural_enhanced_super_resolution_tpu import (
    SuperResolutionPipeline as JaxPipeline)
from neural_enhanced_super_resolution_tpu.models import rrdbnet as jr
from neural_enhanced_super_resolution_tpu.models import weights as jw
from neural_enhanced_super_resolution_tpu.utils import psnr as jax_psnr
from neural_enhanced_super_resolution_tpu.utils import ssim as jax_ssim
from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
from neural_enhanced_super_resolution_torch.kernels import (
    KernelInputError, conv3x3_int8, conv3x3_int8_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    tile_width)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
    pack_conv3x3_int8_weights, pass_width_int8, quantize_int8)
from neural_enhanced_super_resolution_torch.models import (
    Int8RDB, RRDBNet, RRDBNetConfig, init_rrdbnet, int8_rrdbnet_params_from_jax,
    load_state_dict)
from neural_enhanced_super_resolution_torch.ops.resize import resize
from neural_enhanced_super_resolution_torch.utils import psnr, ssim

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny_trained_x4.safetensors")
TRAINED = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=16,
               num_block=2, num_grow_ch=8)
TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=2,
            num_grow_ch=4)

needs_fixture = pytest.mark.skipif(not os.path.exists(FIXTURE),
                                   reason="trained fixture missing")


def _source(name):
    """(architecture, basicsr state dict, the JAX package's int8 params as
    numpy) of the trained fixture or a seeded tiny model."""
    if name == "fixture":
        arch, sd = TRAINED, load_state_dict(FIXTURE)
    else:
        arch = TINY
        sd = init_rrdbnet(RRDBNetConfig(**arch),
                          torch.Generator().manual_seed(7))
    jp = jw.rrdbnet_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_block=arch["num_block"])
    q = jax.tree_util.tree_map(np.asarray, jr.fuse_rrdbnet_params_int8(jp))
    return arch, sd, q


SOURCES = [pytest.param("fixture", marks=needs_fixture), "tiny_seeded"]


@pytest.mark.parametrize("source", SOURCES)
def test_int8_weights_match_jax(source):
    """The port quantises the fused trunk to the JAX package's int8
    weights and scales bit for bit, and carries its biases."""
    arch, sd, q = _source(source)
    model = RRDBNet(RRDBNetConfig(**arch), sd, torch.float32, "cpu", "int8")
    ref = int8_rrdbnet_params_from_jax(q)
    assert len(ref) == 3 * arch["num_block"]
    for i, block in enumerate(model.body):
        for k, rdb in enumerate(block.rdbs, 1):
            want = ref[f"body.{i}.rdb{k}"]
            assert isinstance(rdb, Int8RDB)
            for c in range(5):
                got_q, got_s = getattr(rdb, f"q{c}"), getattr(rdb, f"s{c}")
                assert got_q.dtype == torch.int8
                assert got_s.dtype == torch.float32
                assert torch.equal(got_q, want["wq"][c]), (i, k, c)
                assert torch.equal(got_s, want["ws"][c]), (i, k, c)
            assert torch.equal(rdb.b, want["b"])


def _jax_quantize(h):
    s_x = jnp.maximum(jnp.max(jnp.abs(h.astype(jnp.float32))), 1e-8)
    q = jnp.clip(jnp.round(h.astype(jnp.float32) * (127.0 / s_x)),
                 -127, 127).astype(jnp.int8)
    return np.asarray(q), np.asarray(s_x)


def test_quantize_matches_jax():
    """The per-tensor activation quantiser, rounding ties included."""
    r = np.random.default_rng(3)
    h = (r.standard_normal((2, 9, 11, 16)) * 3).astype(np.float32)
    h[0, 0, 0, :4] = [6.0, -6.0, 0.0, 1.5]   # 127 / s_x * h lands on ties
    q, s_x = quantize_int8(torch.from_numpy(h))
    jq, js = _jax_quantize(jnp.asarray(h))
    assert s_x.dim() == 0 and float(s_x) == float(js)
    np.testing.assert_array_equal(q.numpy(), jq)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 9, 10, 64, 192), (2, 7, 13, 32, 160), (1, 12, 8, 16, 48),
    (2, 11, 9, 8, 40), (1, 5, 17, 8, 16), (1, 1, 3, 12, 5)],
    ids=["trunk_w0", "trunk_w1", "fixture_w0", "fixture_w1", "fixture_w4",
         "ragged"])
def test_conv3x3_int8_plain_matches_jax_int8_conv(n, h, w, cin, cout):
    """conv3x3_int8_plain equals conv_q's int8 lax.conv (int32 sums) and
    its dequantisation bit for bit, at full-range int8 operands."""
    r = np.random.default_rng(cin * cout + h)
    q = r.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wq = r.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    w_s = (r.uniform(1e-4, 1e-2, cout)).astype(np.float32)
    s_x = np.float32(r.uniform(0.5, 8.0))
    y = lax.conv_general_dilated(
        jnp.asarray(q), jnp.asarray(wq), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    ref = (y.astype(jnp.float32) * ((jnp.asarray(s_x) / 127.0)
                                    * jnp.asarray(w_s))).astype(jnp.bfloat16)
    got = conv3x3_int8_plain(torch.from_numpy(q), torch.from_numpy(wq),
                             torch.tensor(s_x), torch.from_numpy(w_s))
    assert got.dtype == torch.bfloat16 and got.shape == (n, h, w, cout)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    # On the CPU the wrapper takes the plain version.
    again = conv3x3_int8(torch.from_numpy(q), torch.from_numpy(wq),
                         torch.tensor(s_x), torch.from_numpy(w_s))
    assert torch.equal(again, got)


def _unpack_int8_by_descriptor(packed, cin, cout, lbo=128, sbo=256):
    """Read K4's packed weights back to HWIO the way its wgmma does: with
    kc = pass_width_int8(Cin) and Kp = Cin padded to kc, slab i = (pass
    i // 9, tap i % 9) of N tile `tile` at (tile * 9 * Kp + i * kc) * N
    bytes, k-step s (32 channels) of a slab at s * 32 * N, and within a
    k-step byte (k, n) at (n // 8) * SBO + (n % 8) * 16 + (k // 16) * LBO
    + k % 16 from the descriptor's start (K-major, no swizzle). Returns
    (HWIO padded to (3, 3, Kp, tiles * N), reads of each packed byte)."""
    nw, tiles = tile_width(cout)
    kc = pass_width_int8(cin)
    kp = -(-cin // kc) * kc
    out = torch.zeros((3, 3, kp, tiles * nw), dtype=torch.int8)
    hits = torch.zeros(packed.numel(), dtype=torch.int64)
    k = torch.arange(32).view(32, 1)
    n = torch.arange(nw).view(1, nw)
    inner = (n // 8) * sbo + (n % 8) * 16 + (k // 16) * lbo + k % 16
    for tile in range(tiles):
        for i in range(9 * kp // kc):
            c0, t = i // 9 * kc, i % 9
            for s in range(kc // 32):
                idx = (tile * 9 * kp + i * kc) * nw + s * 32 * nw + inner
                out[t // 3, t % 3, c0 + 32 * s:c0 + 32 * s + 32,
                    tile * nw:(tile + 1) * nw] = packed[idx]
                hits.index_add_(0, idx.reshape(-1),
                                torch.ones(idx.numel(), dtype=torch.int64))
    return out, hits


@pytest.mark.parametrize("cin,cout", [(64, 192), (32, 160), (32, 64),
                                      (16, 48), (8, 40), (130, 24)])
def test_pack_conv3x3_int8_weights_matches_descriptor_layout(cin, cout):
    """K4's weight image, read back through the 8-bit wgmma descriptor's
    addressing, is the HWIO weight, zero past Cin and Cout, and every
    packed byte is read exactly once."""
    r = np.random.default_rng(cin + cout)
    wq = torch.from_numpy(r.integers(-127, 128, (3, 3, cin, cout))
                          .astype(np.int8))
    packed = pack_conv3x3_int8_weights(wq)
    nw, tiles = tile_width(cout)
    kp = {8: 32, 16: 32, 32: 32, 64: 64, 130: 192}[cin]
    assert packed.dtype == torch.int8 and packed.dim() == 1
    assert packed.numel() == tiles * 9 * kp * nw
    got, hits = _unpack_int8_by_descriptor(packed, cin, cout)
    assert torch.equal(got[:, :, :cin, :cout], wq)
    assert not got[:, :, cin:].any() and not got[:, :, :, cout:].any()
    assert torch.equal(hits, torch.ones_like(hits))


def test_conv3x3_int8_refuses_a_device_without_a_kernel():
    q = torch.zeros((1, 4, 4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(KernelInputError, match="no kernel"):
        conv3x3_int8(q, torch.zeros((3, 3, 8, 8), dtype=torch.int8,
                                    device="meta"),
                     torch.zeros((), device="meta"),
                     torch.zeros(8, device="meta"))


def _rdb_case(source, rdb="rdb2", block=1):
    arch, _, q = _source(source)
    ref = int8_rrdbnet_params_from_jax(q)[f"body.{block}.{rdb}"]
    p = {k: jnp.asarray(v[block]) for k, v in q["body"][rdb].items()}
    return arch, Int8RDB(**ref, device="cpu"), p


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("shape,scale", [((2, 20, 24), 1.0),
                                         ((1, 13, 9), 4.0)])
def test_int8_rdb_matches_jax_float32(source, shape, scale):
    """One Int8RDB in float32 is _rdb_fused_int8 bit for bit: the same
    quantisation, exact sums, and the same bf16/float32 rounding points."""
    arch, rdb, p = _rdb_case(source)
    x = (np.random.default_rng(sum(shape)).standard_normal(
        (*shape, arch["num_feat"])) * scale).astype(np.float32)
    ref = np.asarray(jr._rdb_fused_int8(jnp.asarray(x), p,
                                        arch["num_grow_ch"]))
    got = rdb(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("source", SOURCES)
def test_int8_rdb_bf16_within_one_ulp(source):
    arch, rdb, p = _rdb_case(source, rdb="rdb3", block=0)
    x = np.random.default_rng(5).standard_normal(
        (2, 20, 24, arch["num_feat"])).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    ref = np.asarray(jr._rdb_fused_int8(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), p,
        arch["num_grow_ch"]).astype(jnp.float32))
    got = rdb(xb)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert diff.max() <= ulp, (diff.max(), ulp)


@needs_fixture
def test_int8_forward_matches_jax():
    """The whole trained-fixture forward (nf 16, 2 blocks, growth 8) in
    float32 against rrdbnet_forward with int8 params, run op by op: the
    JAX package's rounding points as written. (Under jit, XLA's excess
    precision on the CPU keeps the conv outputs in float32 instead of
    rounding them to bf16; that forward is ~1% away, see the module
    docstring.)"""
    arch, sd, q = _source("fixture")
    x = np.random.default_rng(1).uniform(0, 1, (2, 20, 18, 12)).astype(
        np.float32)
    with jax.disable_jit():
        ref = np.asarray(jr.rrdbnet_forward(
            q, jnp.asarray(x), jr.RRDBNetConfig(**arch), "float32"))
    model = RRDBNet(RRDBNetConfig(**arch), sd, torch.float32, "cpu", "int8")
    got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


@pytest.fixture(scope="module")
def quality_outputs(test_image, tmp_path_factory):
    """The JAX package's quality-gate request (a 2x bicubic-downscaled
    fixture image, the trained model, 1 iteration, sharpening off): the
    port exact and int8, and the JAX package int8, jitted as it runs and
    with its ESRGAN step op by op (its trunk's rounding points as
    written; the rest of its pipeline jitted), all on the CPU."""
    hr = torch.from_numpy(np.array(test_image))
    lr = resize(hr, dsize=(hr.shape[1] // 2, hr.shape[0] // 2),
                interpolation="bicubic").numpy()
    common = {"iterations": 1, "use_diffusion": False,
              "segment_enhancement": False, "denoise_level": 0,
              "adaptive_sharpening": False, "esrgan_model_path": FIXTURE,
              "esrgan_arch": dict(TRAINED),
              "output_dir": str(tmp_path_factory.mktemp("quality"))}
    out = {trunk: SuperResolutionPipeline(device="cpu", config=dict(
        common, esrgan_trunk=trunk)).enhance_array(lr)
        for trunk in (None, "int8")}
    jax_pipe = JaxPipeline(device="cpu", config=dict(common,
                                                     esrgan_trunk="int8"))
    out["jax jit"] = np.asarray(jax_pipe.enhance_array(lr))
    step = jax_pipe._esrgan_batch_forward

    def op_by_op(tiles, three_channel):
        with jax.disable_jit():
            return step(tiles, three_channel)

    jax_pipe._esrgan_batch_forward = op_by_op
    out["jax"] = np.asarray(jax_pipe.enhance_array(lr))
    return out


@needs_fixture
def test_int8_trunk_quality(test_image, quality_outputs):
    """The JAX package's int8 quality gate (tests/test_quality.py) on the
    port: int8 vs the exact trunk > 40 dB, and within 0.15 dB of the exact
    trunk against the Lanczos-upscaled original."""
    exact, q = quality_outputs[None], quality_outputs["int8"]
    assert q.shape == exact.shape == (320, 320, 3)
    assert psnr(q, exact) > 40.0
    ref = resize(torch.from_numpy(np.array(test_image)),
                 dsize=(q.shape[1], q.shape[0]),
                 interpolation="lanczos4").numpy()
    assert abs(psnr(q, ref) - psnr(exact, ref)) < 0.15


@needs_fixture
def test_int8_request_matches_jax(quality_outputs):
    """The port's int8 request against the JAX package's: with its ESRGAN
    step op by op, >= 99% of uint8 values equal and max <= 2 levels; as it
    runs jitted, within the int8 trunk's own budget (PSNR > 40 dB): XLA
    keeps the conv outputs in float32 there, and the per-tensor activation
    scale turns such differences into rounding flips across the image."""
    got = quality_outputs["int8"].astype(int)
    ref = quality_outputs["jax"].astype(int)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert np.mean(diff == 0) >= 0.99 and diff.max() <= 2, (
        np.mean(diff == 0), diff.max())
    assert psnr(got, quality_outputs["jax jit"]) > 40.0


@pytest.mark.parametrize("shape", [(48, 40), (48, 40, 3)],
                         ids=["gray", "rgb"])
def test_metrics_match_jax(shape):
    r = np.random.default_rng(len(shape))
    a = r.integers(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(int) + r.integers(-12, 13, shape), 0,
                255).astype(np.uint8)
    assert abs(psnr(a, b) - float(jax_psnr(a, b))) <= 1e-4
    assert abs(ssim(a, b) - float(jax_ssim(a, b))) <= 1e-4
    assert psnr(a, a) == pytest.approx(float(jax_psnr(a, a)), abs=1e-4)
