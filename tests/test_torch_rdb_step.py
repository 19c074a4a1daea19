"""The RDB step, the fused trunk's RDB step in bf16 (the K1 step) and in
float32 (its float32 form), against ``FusedRDB._composition`` and the JAX
package's ``_rdb_fused``, on the CPU.

``conv3x3_rdb`` (and ``conv3x3_rdb_f32``) takes its plain version
``conv3x3_rdb_plain`` on a CPU tensor: ``conv3x3_plain`` without bias
(rounded to the working dtype), then step k's slice of the dense-block
assembly. Five steps make one RDB.
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

The kernel's launch plan (``step_plan``: instantiation, sweeps, stages,
shared memory, grid) is host logic and is held here exactly, with the
walk of its persistent grid and its resident weights read back.
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
    KernelInputError, conv3x3_plain, conv3x3_rdb, conv3x3_rdb_f32,
    conv3x3_rdb_plain)
from neural_enhanced_super_resolution_torch.kernels.conv3x3_rdb import (
    STEP_SMEM, _bulk_fits, _check_step, step_plan, step_smem, step_tiles)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    pack_conv3x3_weights, pass_width, tile_width)
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


def _over_dtypes(cases):
    """Each case (a tuple of a test's other parameters, with its id) in
    both dtypes: the bf16 case keeps the id it had when the test was bf16
    only, the float32 one adds "-float32"."""
    out = []
    for dtype in DTYPES:
        for values, ident, marks in cases:
            suffix = "-float32" if dtype == torch.float32 else ""
            out.append(pytest.param(dtype, *values, id=ident + suffix,
                                    marks=marks))
    return out


def _sources_by(scales):
    """(arch_scale, source) cases with pytest's ids "scale-source"."""
    cases = []
    for scale in scales:
        for s in SOURCES:
            name, marks = (s.values[0], s.marks) if hasattr(s, "values") \
                else (s, ())
            cases.append(((scale, name), f"{scale}-{name}", marks))
    return cases


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
    FusedRDB on its own path, the steps, in both dtypes."""
    arch, _, model = _model(source, dtype)
    rdb = model.body[0].rdbs[1]
    x = _x(arch, shape, sum(shape), dtype, scale)
    ref = rdb._composition(x)
    got, _, _ = _steps(rdb, x)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(_bits(rdb(x)), _bits(ref))
    assert rdb.folds_skip(x)


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
    in both dtypes. The composition (the trunk where folds_skip is
    patched false) takes no skip."""
    arch, _, model = _model(source, dtype)
    block = model.body[0]
    x = _x(arch, (2, 12, 18), 11, dtype)
    out = x
    for rdb in block.rdbs:
        out = rdb._composition(out)
    ref = x + 0.2 * out
    assert torch.equal(_bits(block(x)), _bits(ref))
    assert torch.equal(_bits(block(x, plain=True)), _bits(ref))
    folded = block.rdbs[2](block.rdbs[1](block.rdbs[0](x)), skip=x)
    assert torch.equal(_bits(folded), _bits(ref))
    block.rdbs[2].folds_skip = lambda t: False
    with pytest.raises(ValueError, match="skip"):
        block.rdbs[2](x, skip=x)


@pytest.mark.parametrize("dtype,arch_scale,source",
                         _over_dtypes(_sources_by([4, 2])))
def test_fused_forward_on_the_steps_equals_the_composition(
        dtype, arch_scale, source, monkeypatch):
    """The whole fused forward on the steps (residuals folded) equals the
    forward on the composition (each RRDB's residual a separate add) bit
    for bit, and runs 15 steps an RRDB and no composition, in bf16 and in
    float32; at x4 and in the x2plus form (3 channels, pixel-unshuffled to
    conv_first's 12)."""
    arch, sd = _source(source)
    cfg = dict(arch, scale=arch_scale,
               num_in_ch=3 if arch_scale == 2 else arch["num_in_ch"])
    model = RRDBNet(RRDBNetConfig(**cfg), sd, dtype, "cpu", "fused")
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


@pytest.mark.parametrize("skip", [False, True])
def test_float32_steps_at_growth_6_equal_the_composition(skip):
    """nf 18 / g 6, where neither g nor nf is a multiple of 4 (on the card
    the float32 step's scalar epilogue and K1f's 4-byte copies of patch and
    weights): five plain steps in float32 are the composition bit for bit,
    with and without the RRDB skip, and so is FusedRDB on the steps."""
    rng = np.random.default_rng(24)
    nf, g = 18, 6
    fw = [torch.from_numpy((rng.standard_normal(
        (3, 3, nf if k == 0 else g, 4 * g + nf - k * g)) * 0.05).astype(
            np.float32)) for k in range(5)]
    b = torch.from_numpy((rng.standard_normal(4 * g + nf) * 0.1).astype(
        np.float32))
    rdb = FusedRDB(fw, b, torch.float32, "cpu", kernel=False)
    x, res = (torch.from_numpy((rng.standard_normal((2, 21, 35, nf))
                                * 0.5).astype(np.float32)) for _ in range(2))
    skip = res if skip else None
    ref = rdb._composition(x)
    ref = ref if skip is None else skip + 0.2 * ref
    got, _, _ = _steps(rdb, x, skip)
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(_bits(rdb(x, skip=skip)), _bits(ref))


def test_float64_plain_forward_agrees_with_float32():
    """The plain path with float64 operands (the card's reference for a
    crop of the float32 forward in chip_smoke.py) against the float32
    plain forward: a 2-RRDB net at nf 16 / g 8 (seeded, 3x init scale), to
    1e-5 of max(1, max|ref|) (float32's rounding carried through 38
    convs), and not bit-equal (its convs run in float64)."""
    arch, sd = _source("narrow_seeded")
    cfg = RRDBNetConfig(**arch)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (2, 14, 10, arch["num_in_ch"])).astype(np.float32))
    y64 = RRDBNet(cfg, sd, torch.float64, "cpu", "fused")(x, plain=True)
    y32 = RRDBNet(cfg, sd, torch.float32, "cpu", "fused")(x, plain=True)
    err = (y64 - y32).abs().max() / max(1.0, y64.abs().max().item())
    assert 0 < err <= 1e-5, err


def test_step_counts_one_plain_call_per_step_on_the_cpu():
    arch, _, model = _model("narrow_seeded", torch.bfloat16)
    rdb = model.body[0].rdbs[0]
    x = _x(arch, (1, 9, 9), 4, torch.bfloat16)
    calls, launches = conv3x3_rdb_plain.calls, conv3x3_rdb.launches
    rdb(x)
    assert conv3x3_rdb_plain.calls - calls == 5
    assert conv3x3_rdb.launches == launches


def test_float32_step_takes_the_plain_version_only_on_the_cpu():
    """A float32 RDB on the CPU: five plain calls, no launch of either
    step; conv3x3_rdb_f32 on CPU tensors is the plain step."""
    arch, _, model = _model("narrow_seeded", torch.float32)
    rdb = model.body[0].rdbs[0]
    x = _x(arch, (1, 9, 9), 4, torch.float32)
    counts = (conv3x3_rdb_plain.calls, conv3x3_rdb.launches,
              conv3x3_rdb_f32.launches)
    rdb(x)
    assert (conv3x3_rdb_plain.calls - counts[0], conv3x3_rdb.launches,
            conv3x3_rdb_f32.launches) == (5, *counts[1:])
    slots = torch.zeros((1, 9, 9, rdb.b.numel()))
    slots_p = slots.clone()
    got = conv3x3_rdb_f32(0, x, rdb.w0, rdb.b, slots)
    ref = conv3x3_rdb_plain(0, x, rdb.w0, rdb.b, slots_p)
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(_bits(slots), _bits(slots_p))


@pytest.mark.parametrize("dtype,k", _over_dtypes(
    [((0,), "0", ()), ((4,), "4", ())]))
def test_wrapper_refuses_a_device_without_a_kernel(dtype, k):
    m = dict(device="meta")
    cin = 16 if k == 0 else 8
    cout = 48 if k == 0 else 16
    extra = {"x": torch.zeros((1, 4, 4, 16), dtype=dtype, **m)} \
        if k == 4 else {}
    args = (k, torch.zeros((1, 4, 4, cin), dtype=dtype, **m),
            torch.zeros((3, 3, cin, cout), dtype=dtype, **m),
            torch.zeros(48, **m),
            torch.zeros((1, 4, 4, 48), dtype=dtype, **m))
    with pytest.raises(KernelInputError, match="no kernel"):
        conv3x3_rdb(*args, **extra)
    if dtype == torch.float32:
        with pytest.raises(KernelInputError, match="no kernel"):
            conv3x3_rdb_f32(*args, **extra)


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
    ("mixed_xn", "needs bf16"),
    ("bf16_bias", "needs bf16"),
    ("bad_w", "no RDB conv"),
    ("x_early", "belong to step 4"),
    ("xn_is_src", "must not overwrite"),
    ("bad_packed", "packed is not"),
])
def test_step_checks(case, match):
    """The checks the wrapper makes before a launch (the kernel's
    contract), on CPU tensors: operands all bf16 or all float32, with
    float32 biases."""
    o = _operands()
    if case == "step5":
        o["k"] = 5
    elif case == "float32":
        # all float32 is the float32 step's (packed unused); a mix is
        # refused
        o = _operands(dtype=torch.float32)
        assert _check_step(**o) == (8, 16, 40)
        o["slots"] = o["slots"].bfloat16()
    elif case == "mixed_xn":
        o["xn"] = torch.zeros((1, 5, 6, 8))
    elif case == "bf16_bias":
        o = _operands(dtype=torch.float32)
        o["b"] = o["b"].bfloat16()
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


# The launch plan of the kernel (csrc/rdb_bf16.cu), computed on the host:
# the instantiation <n_width, ks> and N tiles of each step, the N tiles a
# sweep keeps resident, the stages, and the shared memory, which the
# kernel's own layout must equal (the C entry point refuses another).
PLANS = {
    (64, 32): [((96, 4, 2), 1, 226384), ((80, 2, 2), 2, 213072),
               ((128, 2, 1), 1, 178256), ((96, 2, 1), 1, 143440),
               ((64, 2, 1), 1, 174160)],
    (16, 8): [((64, 1, 1), 1, 76368), ((64, 1, 1), 1, 76368),
              ((32, 1, 1), 1, 50768), ((32, 1, 1), 1, 50768),
              ((16, 1, 1), 1, 54352)],
    # widths the 16-byte paths do not take: cp.async and scalar stores
    (12, 4): [((32, 1, 1), 1, 50768), ((32, 1, 1), 1, 50768),
              ((32, 1, 1), 1, 50768), ((16, 1, 1), 1, 37968),
              ((16, 1, 1), 1, 50256)],
}


@pytest.mark.parametrize("nf,g", list(PLANS))
@pytest.mark.parametrize("k", range(5))
def test_step_plan_per_step(nf, g, k):
    """Each step's instantiation at the trunk's, the fixture's and the
    scalar paths' widths: K1's N tiles (tile_width) and passes, every N
    tile in one resident sweep where the weights fit beside four stages
    (w0 at nf 64: two sweeps of one N tile), and the bytes of the layout,
    within an H100 block's 227 KB."""
    cin, cout = (nf if k == 0 else g), 4 * g + nf - k * g
    vec = nf % 8 == 0 and g % 8 == 0
    plan = step_plan(k, cin, cout, nf, 4, 268, 268, 132, vec)
    (nw, ks, tiles), nps, smem = PLANS[(nf, g)][k]
    assert (plan.n_width, plan.ks, plan.n_tiles) == (nw, ks, tiles)
    assert (nw, tiles) == tile_width(cout) and 16 * ks == pass_width(cin)
    assert (plan.nps, plan.stages) == (nps, 4)
    assert plan.bulk == vec
    assert plan.smem == smem == step_smem(k, cin, cout, nf, nps)
    assert plan.smem <= STEP_SMEM
    # a sweep's weights: nps N tiles of the packed image (the trunk's w1
    # 92,160 B down to w4's 36,864; w0 221,184 in two sweeps)
    weights = nps * 9 * -(-cin // (16 * ks)) * 16 * ks * nw * 2
    if (nf, g) == (64, 32):
        assert weights * tiles // nps == (221184, 92160, 73728, 55296,
                                          36864)[k]
    assert weights < smem


def test_step_plan_falls_back_and_refuses():
    """Where every N tile does not fit, a sweep an N tile; where that does
    not fit with four stages, two; where nothing fits, KernelInputError.
    The bulk path needs x_{k+1}'s channels in the first sweep, TMA boxes
    of at most 256 channels and the dense output within the patch.
    """
    assert step_plan(0, 64, 192, 64, 1, 8, 8, 132).nps == 1
    # w0's first sweep: x_1 (channels 0-31) and the slots 32-95
    assert _bulk_fits(0, 64, 192, 64, 1)
    assert not _bulk_fits(0, 64, 704, 64, 1)      # x_1 in two sweeps
    assert not _bulk_fits(1, 256, 1088, 64, 2)    # a 264-channel box
    assert not step_plan(0, 64, 704, 64, 1, 8, 8, 132).bulk
    plan = step_plan(0, 64, 320, 64, 1, 8, 8, 132)   # g 64: N 128 x 3
    assert (plan.n_width, plan.n_tiles, plan.nps, plan.stages) == (
        128, 3, 1, 2)
    assert plan.smem == step_smem(0, 64, 320, 64, 1, 2) <= STEP_SMEM
    assert step_smem(0, 64, 320, 64, 1, 4) > STEP_SMEM
    with pytest.raises(KernelInputError, match="does not fit"):
        step_plan(0, 256, 512, 256, 1, 8, 8, 132)


@pytest.mark.parametrize("shape,sms,tiles,grid", [
    ((4, 268, 268), 132, 4556, 132),   # the tile batch: 17 x 67 tiles
    ((1, 268, 268), 132, 1139, 132),   # a count no grid of 132 divides
    ((1, 17, 9), 132, 5, 3),           # fewer tiles than blocks
    ((1, 80, 80), 132, 100, 50),
    ((2, 21, 35), 132, 36, 18),
    ((1, 1, 1), 132, 1, 1),
    ((4, 268, 268), 114, 4556, 114),   # a card of another SM count
])
def test_step_grid_and_walk(shape, sms, tiles, grid):
    """The persistent grid: min(SMs, ceil(tiles / 2)) blocks, consumer c
    of block b walking tiles 2 (b + i grid) + c. Every tile is walked
    once; every block's first consumer has a tile and its second one as
    many or one fewer, which the two consumers' turns at the tensor cores
    (named barriers ORD0 / ORD1) and the weight epochs rely on: every
    barrier arrival has its wait."""
    plan = step_plan(1, 32, 160, 64, *shape, sms)
    assert (plan.tiles, plan.grid) == (tiles, grid)
    assert step_tiles(*shape) == tiles
    seen = []
    for b in range(plan.grid):
        its = []
        for c in range(2):
            mine = list(range(2 * b + c, tiles, 2 * plan.grid))
            seen += mine
            its.append(len(mine))
        it0, it1 = its
        assert it0 >= 1 and it1 in (it0, it0 - 1)
        # ORD1: consumer 0 arrives after round i if consumer 1 has it;
        # consumer 1 waits at each of its rounds.
        assert sum(it1 > i for i in range(it0)) == it1
        # ORD0: consumer 1 arrives after round i if consumer 0 has round
        # i + 1; consumer 0 waits at each round but its first.
        assert sum(it0 > i + 1 for i in range(it1)) == it0 - 1
        for epoch in (it0, 1):
            loads = -(-it0 // epoch)
            begun = sum(i % epoch == 0 for i in range(it0))
            ended = sum(i % epoch == epoch - 1 or i == it0 - 1
                        for i in range(it0))
            assert loads == begun == ended
    assert sorted(seen) == list(range(tiles))


@pytest.mark.parametrize("cin,cout,nf", [(64, 192, 64), (32, 160, 64),
                                         (32, 64, 64), (8, 40, 16),
                                         (4, 24, 12)])
def test_sweep_slabs_read_back_the_weight(cin, cout, nf):
    """The kernel's reads of a sweep's resident weights: N tile nt of
    sweep sw, pass pc, tap t and k-step kk at slab ((nt - sw nps) npass +
    pc) 9 + t of the sweep's copy of the packed image (slabs sw nps npass
    9 on), core matrices by the wgmma descriptor (128 bytes along K, 256
    along N). Read back this way the packing is the HWIO weight, bit for
    bit, zero past Cin and Cout."""
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(
        np.float32)).bfloat16()
    packed = pack_conv3x3_weights(w)
    k = 0 if cin == nf else (4 * (cin) + nf - cout) // cin
    plan = step_plan(k, cin, cout, nf, 1, 8, 8, 132)
    nw, kc = plan.n_width, 16 * plan.ks
    npass = -(-cin // kc)
    slab = kc * nw
    got = torch.zeros((3, 3, npass * kc, plan.n_tiles * nw),
                      dtype=torch.bfloat16)
    sweeps = -(-plan.n_tiles // plan.nps)
    for sw in range(sweeps):
        chunk = packed[sw * plan.nps * npass * 9 * slab:]
        for nt in range(sw * plan.nps,
                        min((sw + 1) * plan.nps, plan.n_tiles)):
            for pc in range(npass):
                for t in range(9):
                    base = ((nt - sw * plan.nps) * npass + pc) * 9 + t
                    b = chunk[base * slab:(base + 1) * slab]
                    # k-step kk, core (j, h), row r (out), column q (in)
                    cores = b.reshape(kc // 16, nw // 8, 2, 8, 8)
                    blk = cores.permute(0, 2, 4, 1, 3).reshape(kc, nw)
                    got[t // 3, t % 3, pc * kc:(pc + 1) * kc,
                        nt * nw:(nt + 1) * nw] = blk
    assert torch.equal(got[:, :, :cin, :cout], w)
    assert not got[:, :, cin:].any() and not got[:, :, :, cout:].any()
