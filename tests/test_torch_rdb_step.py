"""The K1 step, the bf16 trunk's RDB step, against ``FusedRDB._composition``
and the JAX package's ``_rdb_fused``, on the CPU.

``conv3x3_rdb`` takes its plain version ``conv3x3_rdb_plain`` on a CPU
tensor: ``conv3x3_plain`` without bias (rounded to the working dtype),
then step k's slice of the dense-block assembly. Five steps make one RDB.
Inputs are made with numpy from a seed. Tolerances:

* bf16 and float32: bit for bit against the composition (five bias-free
  K1 convs with the assembly in PyTorch between them), whose rounding
  points the steps keep;
* bf16: within one bf16 ulp of max|ref| against JAX ``_rdb_fused`` run op
  by op (``jax.disable_jit``; jitted, XLA on the CPU keeps excess
  precision across fused bf16 ops). The ulp has a named cause: JAX's
  weak-typed 0.2 in ``x + 0.2 * x5`` becomes bf16(0.2) = 0.2001953125 and
  the product is rounded from it, where PyTorch multiplies by 0.2f;
* float32: 1e-5 of max(1, max|ref|) against JAX, whose convs sum in
  another order;
* the slot map, the RRDB residual fold and the whole fused forward: bit
  for bit.
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
    KernelInputError, conv3x3_plain, conv3x3_rdb, conv3x3_rdb_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
    _check_step)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    pack_conv3x3_weights)
from neural_enhanced_super_resolution_torch.models import (
    RRDBNet, RRDBNetConfig, init_rrdbnet, load_state_dict)
from neural_enhanced_super_resolution_torch.models.rrdbnet import FusedRDB

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny_trained_x4.safetensors")
TRAINED = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=16,
               num_block=2, num_grow_ch=8)
NARROW = TRAINED   # the fixture's widths, seeded weights
WIDE = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=32, num_block=1,
            num_grow_ch=16)

needs_fixture = pytest.mark.skipif(not os.path.exists(FIXTURE),
                                   reason="trained fixture missing")
SOURCES = [pytest.param("fixture", marks=needs_fixture), "narrow_seeded",
           "wide_seeded"]
DTYPES = [torch.bfloat16, torch.float32]


def _source(name):
    """(architecture, basicsr state dict) of the trained fixture (growth 8)
    or a seeded model; the seeded ones at 3x init_rrdbnet's scale, so that
    each conv of the dense chain moves the RDB's output."""
    if name == "fixture":
        return TRAINED, load_state_dict(FIXTURE)
    arch = NARROW if name == "narrow_seeded" else WIDE
    sd = init_rrdbnet(RRDBNetConfig(**arch), torch.Generator().manual_seed(7))
    return arch, {k: v * 3.0 if k.endswith("weight") else v
                  for k, v in sd.items()}


def _model(source, dtype):
    arch, sd = _source(source)
    return arch, sd, RRDBNet(RRDBNetConfig(**arch), sd, dtype, "cpu",
                             "fused")


def _jax_rdb(arch, sd, rdb="rdb2", block=0):
    """The JAX package's fused params of one RDB (jnp, float32)."""
    jp = jw.rrdbnet_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_block=arch["num_block"])
    fused = jr.fuse_rrdbnet_params(jp)
    return {k: jnp.asarray(np.asarray(v)[block])
            for k, v in fused["body"][rdb].items()}


def _x(arch, shape, seed, dtype, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(
        (*shape, arch["num_feat"])) * scale).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _steps(rdb, x, skip=None):
    """The five plain steps by hand: (out, slots after each step, the
    steps' outputs)."""
    slots = torch.zeros((*x.shape[:3], rdb.b.numel()), dtype=x.dtype)
    t, after, ys = x, [], []
    for k, w in enumerate(rdb.weights()):
        extra = dict(x=x, skip=skip) if k == 4 else {}
        t = conv3x3_rdb_plain(k, t, w, rdb.b, slots, **extra)
        after.append(slots.clone())
        ys.append(t)
    return t, after, ys


def _bits(t):
    it = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(it)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,scale", [((2, 20, 24), 1.0),
                                         ((1, 13, 9), 4.0)])
def test_steps_equal_the_composition(source, dtype, shape, scale):
    """Five plain steps are FusedRDB's composition bit for bit, and so is
    FusedRDB on its own path (the steps in bf16, the composition in
    float32)."""
    arch, _, model = _model(source, dtype)
    rdb = model.body[0].rdbs[1]
    x = _x(arch, shape, sum(shape), dtype, scale)
    ref = rdb._composition(x)
    got, _, _ = _steps(rdb, x)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(_bits(rdb(x)), _bits(ref))
    assert rdb.folds_skip(x) == (dtype == torch.bfloat16)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("rdb_name", ["rdb1", "rdb3"])
def test_steps_bf16_within_one_ulp_of_jax(source, rdb_name):
    """bf16: JAX _rdb_fused op by op; the ulp is the 0.2 of the residual
    (bf16(0.2) in JAX, 0.2f in PyTorch)."""
    arch, sd, model = _model(source, torch.bfloat16)
    rdb = model.body[0].rdbs[int(rdb_name[-1]) - 1]
    xb = _x(arch, (2, 20, 24), 5, torch.bfloat16)
    with jax.disable_jit():
        ref = np.asarray(jr._rdb_fused(
            jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
            _jax_rdb(arch, sd, rdb_name), arch["num_grow_ch"],
            jnp.bfloat16).astype(jnp.float32))
    got, _, _ = _steps(rdb, xb)
    diff = np.abs(got.float().numpy() - ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert diff.max() <= ulp, (diff.max(), ulp)


@pytest.mark.parametrize("source", SOURCES)
def test_steps_float32_match_jax(source):
    arch, sd, model = _model(source, torch.float32)
    rdb = model.body[0].rdbs[1]
    x = _x(arch, (2, 17, 21), 6, torch.float32)
    with jax.disable_jit():
        ref = np.asarray(jr._rdb_fused(jnp.asarray(x.numpy()),
                                       _jax_rdb(arch, sd), arch[
                                           "num_grow_ch"], jnp.float32))
    got, _, _ = _steps(rdb, x)
    err = np.abs(got.numpy() - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= 1e-5, err


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_slot_map_matches_the_assembly(source, dtype):
    """After step k the slot buffer holds, at slot channel k g + j, the
    sum the assembly builds there: the conv outputs c_0..c_k added left to
    right in the working dtype, each at its own offset; slot k + 1's
    completed sum, plus its bias, through the LeakyReLU, is x_{k+1}."""
    arch, _, model = _model(source, dtype)
    rdb = model.body[0].rdbs[0]
    g, nf = arch["num_grow_ch"], arch["num_feat"]
    x = _x(arch, (1, 11, 19), 9, dtype)
    _, after, ys = _steps(rdb, x)
    cs = [conv3x3_plain(h, w) for h, w in zip([x] + ys[:4], rdb.weights())]
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
            xk = torch.nn.functional.leaky_relu(
                t + rdb.b[lo:lo + g], 0.2).to(dtype)
            assert torch.equal(_bits(ys[k]), _bits(xk)), k


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rrdb_residual_fold_matches_the_rrdb(source, dtype):
    """The third RDB's last step with skip = the RRDB input is the RRDB's
    x + 0.2 * out (JAX _rrdb's residual) bit for bit; the RRDB folds it
    in bf16 and keeps the separate add in float32."""
    arch, _, model = _model(source, dtype)
    block = model.body[0]
    x = _x(arch, (2, 12, 18), 11, dtype)
    out = x
    for rdb in block.rdbs:
        out = rdb._composition(out)
    ref = x + 0.2 * out
    assert torch.equal(_bits(block(x)), _bits(ref))
    assert torch.equal(_bits(block(x, plain=True)), _bits(ref))
    if dtype == torch.bfloat16:
        folded = block.rdbs[2](block.rdbs[1](block.rdbs[0](x)), skip=x)
        assert torch.equal(_bits(folded), _bits(ref))
    else:
        with pytest.raises(ValueError, match="skip"):
            block.rdbs[2](x, skip=x)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("arch_scale", [4, 2])
def test_fused_forward_on_the_steps_equals_the_composition(
        source, arch_scale, monkeypatch):
    """The whole bf16 fused forward on the steps (residuals folded) equals
    the forward on the composition (each RRDB's residual a separate add)
    bit for bit, and runs 15 steps an RRDB and no composition; at x4 and
    in the x2plus form (3 channels, pixel-unshuffled to conv_first's 12)."""
    arch, sd = _source(source)
    cfg = dict(arch, scale=arch_scale,
               num_in_ch=3 if arch_scale == 2 else arch["num_in_ch"])
    model = RRDBNet(RRDBNetConfig(**cfg), sd, torch.bfloat16, "cpu",
                    "fused")
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2, 14, 10, cfg["num_in_ch"])).astype(np.float32))
    calls = conv3x3_rdb_plain.calls
    got = model(x)
    assert conv3x3_rdb_plain.calls - calls == 15 * cfg["num_block"]
    monkeypatch.setattr(FusedRDB, "folds_skip", lambda self, t: False)
    calls = conv3x3_rdb_plain.calls
    ref = model(x)
    assert conv3x3_rdb_plain.calls == calls
    assert torch.equal(got, ref)


def test_step_counts_one_plain_call_per_step_on_the_cpu():
    arch, _, model = _model("narrow_seeded", torch.bfloat16)
    rdb = model.body[0].rdbs[0]
    x = _x(arch, (1, 9, 9), 4, torch.bfloat16)
    calls, launches = conv3x3_rdb_plain.calls, conv3x3_rdb.launches
    rdb(x)
    assert conv3x3_rdb_plain.calls - calls == 5
    assert conv3x3_rdb.launches == launches


@pytest.mark.parametrize("k", [0, 4])
def test_wrapper_refuses_a_device_without_a_kernel(k):
    m = dict(device="meta")
    cin = 16 if k == 0 else 8
    cout = 48 if k == 0 else 16
    extra = {"x": torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16, **m)} \
        if k == 4 else {}
    with pytest.raises(KernelInputError, match="no kernel"):
        conv3x3_rdb(k, torch.zeros((1, 4, 4, cin), dtype=torch.bfloat16, **m),
                    torch.zeros((3, 3, cin, cout), dtype=torch.bfloat16,
                                **m),
                    torch.zeros(48, **m),
                    torch.zeros((1, 4, 4, 48), dtype=torch.bfloat16, **m),
                    **extra)


def _operands(k=1, nf=16, g=8, dtype=torch.bfloat16):
    src = torch.zeros((1, 5, 6, nf if k == 0 else g), dtype=dtype)
    cout = 4 * g + nf - k * g
    w = torch.zeros((3, 3, src.shape[3], cout), dtype=dtype)
    return dict(k=k, src=src, w=w, b=torch.zeros(4 * g + nf),
                slots=torch.zeros((1, 5, 6, 4 * g + nf), dtype=dtype),
                xn=None, x=None, skip=None,
                packed=pack_conv3x3_weights(w.bfloat16()))


@pytest.mark.parametrize("case,match", [
    ("ok", None),
    ("step5", "not 0..4"),
    ("float32", "needs bf16"),
    ("bad_w", "no RDB conv"),
    ("x_early", "belong to step 4"),
    ("xn_is_src", "must not overwrite"),
    ("bad_packed", "packed is not"),
])
def test_step_checks(case, match):
    """The checks the wrapper makes before a launch (the kernel's
    contract), on CPU tensors."""
    o = _operands()
    if case == "step5":
        o["k"] = 5
    elif case == "float32":
        o = _operands(dtype=torch.float32)
    elif case == "bad_w":
        o["w"] = torch.zeros((3, 3, 8, 30), dtype=torch.bfloat16)
    elif case == "x_early":
        o["x"] = torch.zeros((1, 5, 6, 16), dtype=torch.bfloat16)
    elif case == "xn_is_src":
        o["xn"] = o["src"]
    elif case == "bad_packed":
        o["packed"] = o["packed"][:-8]
    if match is None:
        assert _check_step(**o) == (8, 16, 40)
    else:
        with pytest.raises(KernelInputError, match=match):
            _check_step(**o)
