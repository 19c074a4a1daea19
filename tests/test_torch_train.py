"""The port's training path against the JAX trainer, on the CPU in float32.

The JAX side is ``jax.value_and_grad`` of ``tools/train_tiny_esrgan.py``'s
loss, rebuilt here from ``rrdbnet_forward``, ``gaussian_blur`` and
``preprocess`` on the same numpy batches, with the same parameters carried
to the port by ``params_from_jax``. Bars: the differentiable conv against
float64 autograd of ``F.conv2d`` at rel 1e-5 (max |err| / max |ref|); the
loss at rel 1e-5, every gradient at rel 1e-4 (norm of the difference over
the norm); each of three Adam steps, from the same parameters and Adam
state, within 1e-5 absolute of optax's (an Adam step moves a parameter by
about lr = 2e-3, so 1e-5 is 0.5% of a step).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from neural_enhanced_super_resolution_tpu.models import rrdbnet as jr
from neural_enhanced_super_resolution_tpu.models import weights as jw
from neural_enhanced_super_resolution_tpu.ops.blur import (
    gaussian_blur as jax_gaussian_blur)
from neural_enhanced_super_resolution_tpu.ops.enhance import (
    preprocess as jax_preprocess)
from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
    Conv3x3Function, conv3x3_plain)
from neural_enhanced_super_resolution_torch.models import (
    RRDBNet, RRDBNetConfig, TrainableRRDBNet, init_rrdbnet, load_state_dict,
    params_from_jax)
from neural_enhanced_super_resolution_torch.ops.enhance import (
    contrast_stage, denoise_stage, preprocess)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "torch_train_tiny_esrgan",
    os.path.join(ROOT, "tools", "torch_train_tiny_esrgan.py"))
tt = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(tt)

LR_RATE = 2e-3
JCFG = jr.RRDBNetConfig(**tt.TINY)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _norm_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("lrelu", [False, True])
@pytest.mark.parametrize("cout", [3, 8, 16])
@pytest.mark.parametrize("cin", [3, 12, 16])
def test_conv3x3_function_gradients_match_autograd(cin, cout, lrelu):
    rng = np.random.default_rng(cin * 100 + cout)
    x = rng.standard_normal((2, 9, 7, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout))
         * (2.0 / (9 * cin)) ** 0.5).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    gy = rng.standard_normal((2, 9, 7, cout)).astype(np.float32)

    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = Conv3x3Function.apply(xt, wt, bt, lrelu)
    y.backward(torch.from_numpy(gy))

    xr, wr, br = (torch.from_numpy(a).double().requires_grad_()
                  for a in (x, w, b))
    yr = F.conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), br,
                  padding=1).permute(0, 2, 3, 1)
    if lrelu:
        yr = F.leaky_relu(yr, 0.2)
    yr.backward(torch.from_numpy(gy).double())

    assert _rel(y.detach(), yr.detach()) <= 1e-5
    for got, ref in ((xt, xr), (wt, wr), (bt, br)):
        assert _rel(got.grad, ref.grad) <= 1e-5


def test_conv3x3_function_skips_the_input_gradient_it_is_not_asked_for():
    """conv_first's input needs no gradient: its backward runs no conv."""
    x = torch.ones((1, 5, 5, 3))
    w = torch.ones((3, 3, 3, 4), requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    y = Conv3x3Function.apply(x, w, b, True)
    calls = conv3x3_plain.calls
    y.sum().backward()
    assert conv3x3_plain.calls == calls
    assert x.grad is None and w.grad is not None and b.grad is not None


def _jax_loss(params, lr, hr):
    """tools/train_tiny_esrgan.py's loss_fn on its stack12."""
    bgr = lr[..., ::-1]
    blurred = jax.vmap(lambda t: jax_gaussian_blur(t, (3, 3), 0.0))(bgr)
    x = jnp.concatenate([bgr, jnp.clip(bgr * 1.1, 0, 1), bgr * 0.9,
                         blurred], axis=-1)
    out = jr.rrdbnet_forward(params, x, JCFG, "float32")
    return jnp.mean(jnp.abs(out[..., ::-1] - hr))


# jitted, as the JAX trainer's step is
_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_loss))


@pytest.fixture(scope="module")
def data():
    """The tool's images and a seeded sampler over them (batch 2, 48 px)."""
    img, lr_full = tt.training_images()
    rng = np.random.default_rng(0)
    batches = [tt.sample_batch(rng, img, lr_full, 2, 48) for _ in range(3)]
    sd = init_rrdbnet(RRDBNetConfig(**tt.TINY),
                      torch.Generator().manual_seed(0))
    params = jw.rrdbnet_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_block=JCFG.num_block)
    return batches, jax.tree_util.tree_map(np.asarray, params)


def _model(params) -> TrainableRRDBNet:
    return TrainableRRDBNet(RRDBNetConfig(**tt.TINY), params_from_jax(params),
                            "cpu")


def test_training_step_matches_jax(data):
    batches, params = data
    lr, hr = batches[0]
    loss, grads = _jax_value_and_grad(params, jnp.asarray(lr),
                                      jnp.asarray(hr))
    model = _model(params)
    got = tt.l1_loss(model, torch.from_numpy(lr), torch.from_numpy(hr))
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * float(loss)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    worst = max(_norm_rel(named[k].grad, ref[k]) for k in ref)
    assert worst <= 1e-4, worst


def _adam_from_optax(model, state, rate):
    """torch Adam on ``model`` holding optax's Adam state (count, mu, nu)."""
    adam = state[0]
    opt = torch.optim.Adam(model.parameters(), rate)
    mu, nu = (params_from_jax(jax.tree_util.tree_map(np.asarray, t))
              for t in (adam.mu, adam.nu))
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(adam.count)),
                        "exp_avg": mu[name].clone(),
                        "exp_avg_sq": nu[name].clone()}
    return opt


@jax.jit
def _jax_adam_step(params, state, lr, hr):
    """tools/train_tiny_esrgan.py's step: the loss's gradient, optax's Adam
    update, applied."""
    _, grads = jax.value_and_grad(_jax_loss)(params, lr, hr)
    updates, state = optax.adam(LR_RATE).update(grads, state)
    return optax.apply_updates(params, updates), state


def test_three_adam_steps_match_optax(data):
    """Each of three steps, from the JAX trainer's parameters and Adam
    state before it, gives its parameters after it. (Run free, the two
    drift apart: a gradient element near zero, where Adam divides by about
    |g|, turns the float32 gradients' ~4e-6 relative difference into up to
    ~4% of a step by the third.)"""
    batches, params = data
    state = optax.adam(LR_RATE).init(params)
    jparams = params
    worst = []
    for lr, hr in batches:
        model = _model(jparams)
        step = tt.make_step(model, _adam_from_optax(model, state, LR_RATE))
        step(torch.from_numpy(lr), torch.from_numpy(hr))
        jparams, state = _jax_adam_step(jparams, state, jnp.asarray(lr),
                                        jnp.asarray(hr))
        jparams = jax.tree_util.tree_map(np.asarray, jparams)
        ref = params_from_jax(jparams)
        got = model.state_dict()
        worst.append(max(float((got[k] - ref[k]).abs().max()) for k in ref))
    assert max(worst) <= 1e-5, worst


@pytest.mark.parametrize("level", [0, 0.5])
def test_preprocess_matches_jax(test_image, level):
    """The port's preprocess is its two stages, and against the JAX one on
    the fixture it keeps contrast_stage's bar (tests/test_torch_ops.py):
    at most 1 level on at most 1e-3 of the values (3 of 76,800 differ by
    1 here). With NL-means first (level 0.5) a value one stage rounds the
    other way moves CLAHE's mapping: 6 values differ, by up to 8 levels,
    so only the share is held there."""
    src = torch.from_numpy(np.array(test_image))
    got = preprocess(src, level)
    stages = denoise_stage(src, level) if level > 0 else src
    assert torch.equal(got, contrast_stage(stages))
    ref = np.asarray(jax_preprocess(test_image, level))
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert np.mean(diff > 0) <= 1e-3
    if level == 0:
        assert diff.max() <= 1


def test_trainer_checkpoint_loads_in_the_jax_package(tmp_path, capsys):
    out = str(tmp_path / "tiny.safetensors")
    assert tt.main(["--steps", "2", "--batch", "2", "--cpu", "--out",
                    out]) == 0
    assert "s/step on cpu" in capsys.readouterr().out
    sd_np = jw.load_state_dict(out)
    params = jw.rrdbnet_params_from_state_dict(sd_np, num_block=2)
    x = np.random.default_rng(1).uniform(0, 1, (1, 10, 9, 12)).astype(
        np.float32)
    ref = np.asarray(jr.rrdbnet_forward(params, jnp.asarray(x), JCFG,
                                        "float32"))
    sd = load_state_dict(out)
    assert set(sd) == set(jw.rrdbnet_state_dict_from_params(params, 2))
    model = RRDBNet(RRDBNetConfig(**tt.TINY), sd, torch.float32, "cpu",
                    "stock")
    got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-3 * max(1.0, np.abs(ref).max())


def test_trainable_net_takes_the_ports_seeded_weights():
    """init_rrdbnet's state dict loads strictly and comes back unchanged,
    and the forward equals the serving stock network's."""
    cfg = RRDBNetConfig(**dict(tt.TINY, num_in_ch=3, scale=2))
    sd = init_rrdbnet(cfg, torch.Generator().manual_seed(3))
    model = TrainableRRDBNet(cfg, sd, "cpu")
    assert all(torch.equal(model.state_dict()[k], sd[k]) for k in sd)
    x = torch.rand((1, 6, 8, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = model(x)
    ref = RRDBNet(cfg, sd, torch.float32, "cpu", "stock")(x)
    assert _rel(got, ref) <= 1e-6
