"""K4's redesign, the int8 RDB step, against the K4 composition and the
JAX package's ``_rdb_fused_int8``, on the CPU.

``conv3x3_int8_rdb`` takes its plain version ``conv3x3_int8_rdb_plain`` on
a CPU tensor: quantise with the chain's scale, ``conv3x3_int8_plain``, then
step k's slice of the assembly. Five steps make one RDB. Inputs are made
with numpy from a seed. Tolerances, those of ``tests/test_torch_int8.py``:

* float32: bit for bit against ``Int8RDB(plain=True)`` (the composition:
  ``quantize_int8`` -> ``conv3x3_int8_plain`` -> the PyTorch assembly) and
  against JAX ``_rdb_fused_int8``;
* bf16: bit for bit against the composition, and within one bf16 ulp of
  max|ref| against JAX (XLA keeps excess precision across fused bf16 adds
  on the CPU);
* the scale chain, the slots, the per-block max and the RRDB residual
  fold: bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_tpu.models import rrdbnet as jr
from neural_enhanced_super_resolution_tpu.models import weights as jw
from neural_enhanced_super_resolution_torch.kernels import (
    KernelInputError, conv3x3_int8_rdb, conv3x3_int8_rdb_plain, int8_amax,
    int8_amax_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_int8 import (
    STEP_TILE, block_amax, conv3x3_int8_plain, quantize_int8, rdb_growth)
from neural_enhanced_super_resolution_torch.models import (
    Int8RDB, RRDBNet, RRDBNetConfig, init_rrdbnet,
    int8_rrdbnet_params_from_jax, load_state_dict)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny_trained_x4.safetensors")
TRAINED = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=16,
               num_block=2, num_grow_ch=8)
TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=2,
            num_grow_ch=4)
WIDE = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=32, num_block=1,
            num_grow_ch=16)

needs_fixture = pytest.mark.skipif(not os.path.exists(FIXTURE),
                                   reason="trained fixture missing")
SOURCES = [pytest.param("fixture", marks=needs_fixture), "tiny_seeded",
           "wide_seeded"]


def _source(name):
    """(architecture, basicsr state dict, the JAX package's int8 params as
    numpy) of the trained fixture (growth 8) or a seeded model."""
    if name == "fixture":
        arch, sd = TRAINED, load_state_dict(FIXTURE)
    else:
        arch = TINY if name == "tiny_seeded" else WIDE
        sd = init_rrdbnet(RRDBNetConfig(**arch),
                          torch.Generator().manual_seed(7))
    jp = jw.rrdbnet_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_block=arch["num_block"])
    q = jax.tree_util.tree_map(np.asarray, jr.fuse_rrdbnet_params_int8(jp))
    return arch, sd, q


def _rdb(source, rdb="rdb2", block=0):
    arch, _, q = _source(source)
    ref = int8_rrdbnet_params_from_jax(q)[f"body.{block}.{rdb}"]
    p = {k: jnp.asarray(v[block]) for k, v in q["body"][rdb].items()}
    return arch, Int8RDB(**ref, device="cpu"), p


def _steps(rdb, x, skip=None):
    """The five steps by hand: (out, scales, slots after each step, the
    steps' outputs)."""
    scales = int8_amax_plain(x, 5)
    slots = torch.zeros((*x.shape[:3], rdb.b.numel()), dtype=torch.bfloat16)
    t, after, ys = x, [], []
    for k in range(5):
        extra = dict(x=x, skip=skip) if k == 4 else {}
        t = conv3x3_int8_rdb_plain(k, t, scales[k], scales[k + 1],
                                   getattr(rdb, f"q{k}"),
                                   getattr(rdb, f"s{k}"), rdb.b, slots,
                                   **extra)
        after.append(slots.clone())
        ys.append(t)
    return t, scales, after, ys


def _x(arch, shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(
        (*shape, arch["num_feat"])) * scale).astype(np.float32)


def _bits(t):
    it = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(it)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("shape,scale", [((2, 20, 24), 1.0),
                                         ((1, 13, 9), 4.0)])
def test_steps_match_composition_and_jax_float32(source, shape, scale):
    """Five plain steps are Int8RDB's plain composition and JAX
    _rdb_fused_int8 bit for bit in float32, and so is Int8RDB on the
    steps (the path it takes without plain=True)."""
    arch, rdb, p = _rdb(source)
    x = _x(arch, shape, sum(shape), scale)
    ref = np.asarray(jr._rdb_fused_int8(jnp.asarray(x), p,
                                        arch["num_grow_ch"]))
    xt = torch.from_numpy(x)
    got, _, _, _ = _steps(rdb, xt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(_bits(got), _bits(rdb(xt, plain=True)))
    assert torch.equal(_bits(got), _bits(rdb(xt)))


@pytest.mark.parametrize("source", SOURCES)
def test_steps_bf16_match_composition_within_one_ulp_of_jax(source):
    arch, rdb, p = _rdb(source, rdb="rdb3")
    xb = torch.from_numpy(_x(arch, (2, 20, 24), 5)).bfloat16()
    ref = np.asarray(jr._rdb_fused_int8(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), p,
        arch["num_grow_ch"]).astype(jnp.float32))
    got, _, _, _ = _steps(rdb, xb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(rdb(xb, plain=True)))
    diff = np.abs(got.float().numpy() - ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert diff.max() <= ulp, (diff.max(), ulp)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scale_chain_is_each_conv_inputs_max(source, dtype):
    """Each scale of the chain is max|h| of the conv input the composition
    quantises (quantize_int8's s_x before its 1e-8 floor), and the last
    is max|out|: the next RDB's."""
    arch, rdb, _ = _rdb(source)
    x = torch.from_numpy(_x(arch, (2, 17, 21), 3)).to(dtype)
    out, scales, _, ys = _steps(rdb, x)
    for k, h in enumerate([x] + ys[:4]):
        _, s_x = quantize_int8(h)
        assert float(scales[k]) == float(h.float().abs().amax())
        assert float(scales[k].clamp_min(1e-8)) == float(s_x)
    assert float(scales[5]) == float(out.float().abs().amax())


@pytest.mark.parametrize("source", SOURCES)
def test_slot_map_matches_the_assembly(source):
    """After step k the slot buffer holds, at slot channel k g + j, the
    sum the assembly builds there: the composition's conv outputs c_0..c_k
    added left to right in bf16, each at its own offset; slot k + 1's
    completed sum is what x_{k+1} is made of."""
    arch, rdb, _ = _rdb(source)
    g, nf = arch["num_grow_ch"], arch["num_feat"]
    x = torch.from_numpy(_x(arch, (1, 11, 19), 9))
    _, scales, after, ys = _steps(rdb, x)
    cs = []
    for k, h in enumerate([x] + ys[:4]):
        q, s_x = quantize_int8(h)
        cs.append(conv3x3_int8_plain(q, getattr(rdb, f"q{k}"), s_x,
                                     getattr(rdb, f"s{k}")))
    for k in range(5):
        for slot in range(k + 2, 6):
            lo = (slot - 1) * g
            width = g if slot < 5 else nf
            want = cs[0][..., lo:lo + width]
            for j in range(1, k + 1):
                want = want + cs[j][..., lo - j * g:lo - j * g + width]
            assert torch.equal(_bits(after[k][..., lo:lo + width]),
                               _bits(want)), (k, slot)
        if k < 4:
            lo = k * g
            t = cs[0][..., lo:lo + g]
            for j in range(1, k + 1):
                t = t + cs[j][..., lo - j * g:lo - j * g + g]
            xk = torch.nn.functional.leaky_relu(t + rdb.b[lo:lo + g], 0.2)
            assert torch.equal(_bits(ys[k]), _bits(xk)), k


@pytest.mark.parametrize("shape", [(1, 8, 16, 3), (2, 9, 17, 5),
                                   (3, 23, 35, 2), (1, 1, 1, 4)])
def test_block_max_maxed_again_is_the_tensor_max(shape):
    """Per STEP_TILE output tile (all channels), then across tiles: the
    tensor's max, wherever the max lies and however ragged the edge."""
    r = np.random.default_rng(sum(shape))
    t = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    assert float(block_amax(t)) == float(t.abs().amax())
    n, h, w, c = shape
    t[n - 1, h - 1, w - 1, c - 1] = -50.0   # the last, most ragged tile
    assert float(block_amax(t)) == 50.0
    assert STEP_TILE == (4, 16)


def test_all_zero_input_gives_the_floor_scale_and_zero_codes():
    """max|x| = 0: the chain holds 0, the step takes s = 1e-8 (the JAX
    package's floor), every code is 0, so c = 0 and x1 = lrelu(b)."""
    arch, rdb, _ = _rdb("tiny_seeded")
    x = torch.zeros((1, 6, 7, arch["num_feat"]))
    scales = int8_amax_plain(x, 5)
    assert torch.equal(scales, torch.zeros(6))
    q, s_x = quantize_int8(x)
    assert float(s_x) == float(torch.tensor(1e-8)) and not q.any()
    g = arch["num_grow_ch"]
    slots = torch.zeros((1, 6, 7, rdb.b.numel()), dtype=torch.bfloat16)
    x1 = conv3x3_int8_rdb(0, x, scales[0], scales[1], rdb.q0, rdb.s0, rdb.b,
                          slots)
    want = torch.nn.functional.leaky_relu(rdb.b[:g], 0.2).expand_as(x1)
    assert torch.equal(x1, want) and not slots[..., g:].float().any()


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rrdb_residual_fold_matches_the_rrdb(source, dtype):
    """The third RDB's last step with skip = the RRDB input is the RRDB's
    x + 0.2 * out, bit for bit, and the chain's last scale is its max."""
    arch, sd, _ = _source(source)
    model = RRDBNet(RRDBNetConfig(**arch), sd, dtype, "cpu", "int8")
    block = model.body[0]
    x = torch.from_numpy(_x(arch, (2, 12, 18), 11)).to(dtype)
    ref = block(x, plain=True)
    scales = int8_amax(x, 15)
    got = block(x, scales=scales)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(ref))
    assert float(scales[15]) == float(ref.float().abs().amax())
    out = x
    for rdb in block.rdbs:
        out = rdb(out, plain=True)
    assert torch.equal(_bits(block.rdbs[2](
        block.rdbs[1](block.rdbs[0](x)), skip=x)), _bits(ref))
    assert torch.equal(_bits(x + 0.2 * out), _bits(ref))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_forward_on_the_steps_equals_the_composition(source, dtype):
    """The whole int8 forward (one scale chain for the trunk, the folded
    residuals) equals the forward on the composition bit for bit, and so
    does its trunk."""
    arch, sd, _ = _source(source)
    model = RRDBNet(RRDBNetConfig(**arch), sd, dtype, "cpu", "int8")
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2, 14, 10, arch["num_in_ch"])).astype(np.float32))
    assert torch.equal(model(x), model(x, plain=True))
    feat = model.conv_first(x.to(dtype))
    assert torch.equal(_bits(model.body_forward(feat)),
                       _bits(model.body_forward(feat, plain=True)))


@pytest.mark.parametrize("k,cin,cs,want", [
    (0, 64, 192, (32, 64)), (1, 32, 192, (32, 64)), (4, 32, 192, (32, 64)),
    (0, 16, 48, (8, 16)), (3, 8, 48, (8, 16)), (0, 8, 24, (4, 8))])
def test_rdb_growth(k, cin, cs, want):
    assert rdb_growth(k, cin, cs) == want


def test_step_counts_one_plain_call_per_step_on_the_cpu():
    arch, rdb, _ = _rdb("tiny_seeded")
    x = torch.from_numpy(_x(arch, (1, 9, 9), 4))
    calls = conv3x3_int8_rdb_plain.calls, int8_amax_plain.calls
    launches = conv3x3_int8_rdb.launches, int8_amax.launches
    rdb(x)
    assert (conv3x3_int8_rdb_plain.calls - calls[0],
            int8_amax_plain.calls - calls[1]) == (5, 1)
    assert (conv3x3_int8_rdb.launches, int8_amax.launches) == launches


def test_wrappers_refuse_a_device_without_a_kernel():
    m = dict(device="meta")
    with pytest.raises(KernelInputError, match="no kernel"):
        int8_amax(torch.zeros((1, 4, 4, 8), **m), 5)
    s = torch.zeros((), **m)
    with pytest.raises(KernelInputError, match="no kernel"):
        conv3x3_int8_rdb(0, torch.zeros((1, 4, 4, 8), **m), s, s,
                         torch.zeros((3, 3, 8, 24), dtype=torch.int8, **m),
                         torch.zeros(24, **m), torch.zeros(24, **m),
                         torch.zeros((1, 4, 4, 24), dtype=torch.bfloat16,
                                     **m))
