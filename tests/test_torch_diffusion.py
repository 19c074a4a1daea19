"""The port's diffusion branch against the JAX package, on the CPU.

Tiny configs of tests/test_diffusion.py. Weights are made with numpy from a
seed in the JAX layout and carried into the port's modules with
``diffusion_params_from_jax``; snapshots are written by the port's own
``write_synthetic_snapshot`` and read by both packages. Tolerances, stated
per test: float32 forwards within 1e-4 of max(1, max|jax|); the bf16 UNet
within 3e-2; scheduler steps within 1e-6; ``trace_latents`` latents within
1e-3 of max|jax| and the final uint8 within one level.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_enhanced_super_resolution_tpu.models.diffusion import (
    clip_text as jclip, layers as jlayers, scheduler as jsched, unet as junet,
    vae as jvae)
from neural_enhanced_super_resolution_tpu.models.diffusion import (
    load_upscale_pipeline as jax_load_pipeline)
from neural_enhanced_super_resolution_tpu.models.diffusion.specs import (
    clip_param_shapes, unet_param_shapes, vae_param_shapes)
from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
from neural_enhanced_super_resolution_torch.kernels import (
    KernelError, attention as torch_attention)
from neural_enhanced_super_resolution_torch.models import (
    RRDBNetConfig, init_rrdbnet, save_state_dict)
from neural_enhanced_super_resolution_torch.models.diffusion import (
    AutoencoderKLDecoder, CLIPTextConfig, CLIPTextModel, DDIMScheduler,
    DDPMScheduler, UNet2DConditionModel, UNetConfig, VAEConfig, build_module,
    layers, load_upscale_pipeline, unet_forward, vae_decode)
from neural_enhanced_super_resolution_torch.models.diffusion.convert import (
    diffusion_params_from_jax, load_component)
from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
    random_state_dict, write_synthetic_snapshot)
from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
    Transformer2DModel, crossattn_layer_names, precompute_context_kv)
from neural_enhanced_super_resolution_torch.runtime.config import merge_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = dict(sample_size=16, in_channels=7, out_channels=4,
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
            block_out_channels=(8, 16), layers_per_block=1,
            cross_attention_dim=16, attention_head_dim=2, num_class_embeds=50,
            norm_num_groups=4)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4,
           norm_num_groups=4, scaling_factor=0.08333)
CLIP = dict(vocab_size=100, hidden_size=16, intermediate_size=32,
            num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=12)


# one XLA program for the whole tiny UNet: faster than op-by-op dispatch
_jax_unet = jax.jit(junet.unet_forward, static_argnames=("cfg",
                                                        "compute_dtype"))


def _np_params(spec, seed):
    """JAX-layout params: N(0, 0.2), norm weights 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(spec.items()):
        v = rng.normal(0, 0.2, shape).astype(np.float32)
        if name.endswith(".weight") and "norm" in name.split(".")[-2]:
            v = 1.0 + 0.5 * v
        out[name] = v
    return out


def _pair(spec, cls, cfg, seed, dtype=torch.float32):
    np_params = _np_params(spec, seed)
    module = build_module(cls, cfg, diffusion_params_from_jax(np_params),
                          dtype, "cpu")
    return {k: jnp.asarray(v) for k, v in np_params.items()}, module


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: one intra-op thread per test worker keeps
    torch from oversubscribing the cores the other workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def unet_pair():
    return _pair(unet_param_shapes(junet.UNetConfig(**UNET)),
                 UNet2DConditionModel, UNetConfig(**UNET), 0)


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((2, 16, 16, 7)).astype(np.float32),
            rng.standard_normal((2, 12, 16)).astype(np.float32),
            np.asarray([3, 7]))


def _close(got, ref, tol):
    got = got.numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


# ---------------------------------------------------------------- layers ----

def _layer_cases():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    w3 = rng.normal(0, 0.3, (3, 3, 8, 12)).astype(np.float32)
    w1 = rng.normal(0, 0.3, (1, 1, 8, 12)).astype(np.float32)
    wl = rng.normal(0, 0.3, (8, 12)).astype(np.float32)
    b = rng.normal(0, 0.3, (12,)).astype(np.float32)
    g = (1 + rng.normal(0, 0.2, (8,))).astype(np.float32)
    gb = rng.normal(0, 0.2, (8,)).astype(np.float32)
    q, k, v = (rng.standard_normal((2, 9, 16)).astype(np.float32)
               for _ in range(3))
    kc, vc = (rng.standard_normal((2, 5, 16)).astype(np.float32)
              for _ in range(2))
    mask = np.where(rng.random((1, 1, 9, 5)) < 0.3, -np.inf,
                    0.0).astype(np.float32)
    mask[..., 0] = 0.0
    t = np.asarray([0, 10, 999])

    def conv(w, padding, stride=1):
        m = torch.nn.Conv2d(8, 12, w.shape[0], bias=True)
        m.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
        m.bias.data = torch.from_numpy(b)
        return (lambda: jlayers.conv2d(jnp.asarray(x), {"c.weight": w,
                                                        "c.bias": b}, "c",
                                       stride, padding, jnp.float32),
                lambda: layers.conv2d(torch.from_numpy(x), m, stride,
                                      padding))

    lin = torch.nn.Linear(8, 12)
    lin.weight.data = torch.from_numpy(wl.T.copy())
    lin.bias.data = torch.from_numpy(b)
    gn = torch.nn.GroupNorm(4, 8, eps=1e-6)
    gn.weight.data, gn.bias.data = torch.from_numpy(g), torch.from_numpy(gb)
    ln = torch.nn.LayerNorm(8)
    ln.weight.data, ln.bias.data = torch.from_numpy(g), torch.from_numpy(gb)
    jp = {"n.weight": g, "n.bias": gb}
    tt = [torch.from_numpy(a) for a in (q, k, v, kc, vc)]
    return {
        "conv3x3": conv(w3, 1),
        "conv3x3_stride2": conv(w3, 1, 2),
        "conv1x1": conv(w1, 0),
        "linear": (lambda: jlayers.linear(jnp.asarray(x), {
            "l.weight": wl, "l.bias": b}, "l", jnp.float32),
            lambda: layers.linear(torch.from_numpy(x), lin)),
        "group_norm": (lambda: jlayers.group_norm(jnp.asarray(x), jp, "n", 4,
                                                  1e-6),
                       lambda: layers.group_norm(torch.from_numpy(x), gn)),
        "layer_norm": (lambda: jlayers.layer_norm(jnp.asarray(x), jp, "n"),
                       lambda: layers.layer_norm(torch.from_numpy(x), ln)),
        "silu": (lambda: jlayers.silu(jnp.asarray(x)),
                 lambda: layers.silu(torch.from_numpy(x))),
        "attention_masked": (
            lambda: jlayers.attention(jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), 2, jnp.asarray(mask),
                                      jnp.float32),
            lambda: layers.attention(tt[0], tt[3], tt[4], 2,
                                     torch.from_numpy(mask), torch.float32)),
        "attention_qmajor": (
            lambda: jlayers.attention_qmajor(jnp.asarray(q), jnp.asarray(kc),
                                             jnp.asarray(vc), 2,
                                             dtype=jnp.float32),
            lambda: layers.attention_qmajor(tt[0], tt[3], tt[4], 2,
                                            dtype=torch.float32)),
        "attention_qmajor_masked": (
            lambda: jlayers.attention_qmajor(
                jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 2,
                jnp.asarray(mask), jnp.float32),
            lambda: layers.attention_qmajor(tt[0], tt[3], tt[4], 2,
                                            torch.from_numpy(mask),
                                            torch.float32)),
        "timestep_embedding": (
            lambda: jlayers.timestep_embedding(jnp.asarray(t), 33),
            lambda: layers.timestep_embedding(torch.from_numpy(t), 33)),
        "nearest_upsample_x2": (
            lambda: jlayers.nearest_upsample_x2(jnp.asarray(x)),
            lambda: layers.nearest_upsample_x2(torch.from_numpy(x))),
    }


LAYER_IDS = list(_layer_cases())


@pytest.mark.parametrize("name", LAYER_IDS)
def test_layer_matches_jax(name):
    """Each building block, f32: 1e-5 of max(1, max|jax|)."""
    jax_fn, torch_fn = _layer_cases()[name]
    with torch.no_grad():
        _close(torch_fn(), jax_fn(), 1e-5)


# ---------------------------------------------------------------- models ----

def test_clip_text_matches_jax():
    """Causal CLIP tower with exact GELU, f32: 1e-4 of max(1, |jax|); token
    ids past the vocabulary are clamped in both packages."""
    jp, model = _pair(clip_param_shapes(jclip.CLIPTextConfig(**CLIP)),
                      CLIPTextModel, CLIPTextConfig(**CLIP), 2)
    ids = np.random.default_rng(4).integers(0, 100, (2, 12))
    ids[1, 0] = 49406
    ref = jclip.clip_text_forward(jp, jnp.asarray(ids),
                                  jclip.CLIPTextConfig(**CLIP), "float32")
    _close(model(torch.from_numpy(ids)), ref, 1e-4)


@pytest.fixture(scope="module")
def unet_ref(unet_pair, unet_inputs):
    """The JAX UNet's f32 output (the same with the context K/V hoisted:
    tests/test_diffusion.py pins the two bit-exact)."""
    x, ctx, labels = unet_inputs
    return np.asarray(_jax_unet(
        unet_pair[0], jnp.asarray(x), jnp.int32(40), jnp.asarray(ctx),
        jnp.asarray(labels), cfg=junet.UNetConfig(**UNET),
        compute_dtype="float32"))


@pytest.mark.parametrize("hoisted", [False, True], ids=["in_layer_kv",
                                                        "context_kv"])
def test_unet_matches_jax(unet_pair, unet_inputs, unet_ref, hoisted):
    """Whole UNet forward (tanh GEGLU, class embedding by noise level),
    with the context K/V in the layer or hoisted, f32: 1e-4 of
    max(1, |jax|)."""
    _, model = unet_pair
    x, ctx, labels = unet_inputs
    ref = unet_ref
    tctx = torch.from_numpy(ctx)
    kv = precompute_context_kv(model, tctx) if hoisted else None
    got = unet_forward(model, torch.from_numpy(x), 40, tctx,
                       torch.from_numpy(labels), kv)
    _close(got, ref, 1e-4)


def test_unet_bf16_matches_jax(unet_inputs):
    """bf16 compute in both packages (f32 residual stream): 3e-2 of
    max(1, |jax|)."""
    jp, model = _pair(unet_param_shapes(junet.UNetConfig(**UNET)),
                      UNet2DConditionModel, UNetConfig(**UNET), 0,
                      torch.bfloat16)
    x, ctx, labels = unet_inputs
    ref = _jax_unet(jp, jnp.asarray(x), jnp.int32(40), jnp.asarray(ctx),
                    jnp.asarray(labels), cfg=junet.UNetConfig(**UNET),
                    compute_dtype="bfloat16")
    got = unet_forward(model, torch.from_numpy(x), 40, torch.from_numpy(ctx),
                       torch.from_numpy(labels))
    assert got.dtype == torch.float32
    _close(got, ref, 3e-2)


def test_crossattn_layers_and_context_kv_match_jax(unet_pair, unet_inputs):
    jp, model = unet_pair
    cfg = junet.UNetConfig(**UNET)
    assert crossattn_layer_names(UNetConfig(**UNET)) == \
        junet.crossattn_layer_names(cfg)
    ctx = unet_inputs[1]
    ref = junet.precompute_context_kv(jp, jnp.asarray(ctx), cfg, "float32")
    got = precompute_context_kv(model, torch.from_numpy(ctx))
    assert set(got) == set(ref)
    for name, (k, v) in got.items():
        _close(k, ref[name][0], 1e-5)
        _close(v, ref[name][1], 1e-5)


def test_vae_decode_matches_jax():
    """VAE decoder (mid-block attention through attention_auto), f32: 1e-4
    of max(1, |jax|)."""
    jp, model = _pair(vae_param_shapes(jvae.VAEConfig(**VAE),
                                       decoder_only=True),
                      AutoencoderKLDecoder, VAEConfig(**VAE), 1)
    lat = np.random.default_rng(5).standard_normal((1, 6, 10, 4)).astype(
        np.float32)
    ref = jvae.vae_decode(jp, jnp.asarray(lat), jvae.VAEConfig(**VAE),
                          "float32")
    _close(vae_decode(model, torch.from_numpy(lat)), ref, 1e-4)


# ------------------------------------------------------------ schedulers ----

SCHED = [("ddim_eps", "ddim", dict(set_alpha_to_one=False)),
         ("ddim_v", "ddim", dict(prediction_type="v_prediction",
                                 steps_offset=1)),
         ("ddim_clip", "ddim", dict(clip_sample=True)),
         ("ddpm_eps", "ddpm", dict()),
         ("ddpm_linear_v", "ddpm", dict(beta_schedule="linear",
                                        prediction_type="v_prediction")),
         ("ddpm_cos", "ddpm", dict(beta_schedule="squaredcos_cap_v2"))]


@pytest.mark.parametrize("kind,kw", [s[1:] for s in SCHED],
                         ids=[s[0] for s in SCHED])
def test_scheduler_matches_jax(kind, kw):
    """Timesteps equal; add_noise and every step of a 10-step walk with the
    same model outputs and noise within 1e-6 (f32)."""
    jcls, tcls = ((jsched.DDIMScheduler, DDIMScheduler) if kind == "ddim"
                  else (jsched.DDPMScheduler, DDPMScheduler))
    js, ts = jcls(**kw), tcls(**kw)
    steps = js.timesteps(10)
    np.testing.assert_array_equal(ts.timesteps(10), steps)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 4, 5, 2)).astype(np.float32)
    _close(ts.add_noise(torch.from_numpy(x), torch.from_numpy(x * 0.5), 123),
           js.add_noise(jnp.asarray(x), jnp.asarray(x * 0.5), 123), 1e-6)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i, t in enumerate(int(s) for s in steps):
        prev = int(steps[i + 1]) if i + 1 < len(steps) else -1
        eps = rng.standard_normal(x.shape).astype(np.float32)
        args = [(jnp.asarray(eps), jnp.int32(t), jnp.int32(prev), jx),
                (torch.from_numpy(eps), t, prev, tx)]
        if kind == "ddpm":
            noise = rng.standard_normal(x.shape).astype(np.float32)
            args[0] += (jnp.asarray(noise),)
            args[1] += (torch.from_numpy(noise),)
        jx, tx = js.step(*args[0]), ts.step(*args[1])
        _close(tx, jx, 1e-6)


# -------------------------------------------------------------- pipeline ----

@pytest.fixture(scope="module")
def tiny_snapshot(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sd_x4_tiny"))
    return write_synthetic_snapshot(
        path, (UNetConfig(**UNET), VAEConfig(**VAE), CLIPTextConfig(**CLIP)),
        torch.Generator().manual_seed(0), torch.float32, init="fixed")


def test_synthetic_snapshot_layout_and_init(tiny_snapshot):
    """diffusers layout; norm weights 1, biases 0, the rest N(0, 0.05^2)
    (fixed) or N(0, 1/fan_in) (fan_in)."""
    for sub in ("unet", "vae", "text_encoder", "scheduler",
                "low_res_scheduler"):
        assert os.path.isdir(os.path.join(tiny_snapshot, sub))
    assert not os.path.exists(os.path.join(tiny_snapshot, "tokenizer"))
    _, sd = load_component(os.path.join(tiny_snapshot, "unet"))
    assert torch.equal(sd["conv_norm_out.weight"], torch.ones(8))
    assert torch.equal(sd["conv_in.bias"], torch.zeros(8))
    assert abs(sd["down_blocks.1.resnets.0.conv1.weight"].std() - 0.05) < 0.01
    with torch.device("meta"):
        module = Transformer2DModel(1024, 1024, 8, 32)   # the mid-block's
    big = random_state_dict(module, torch.Generator().manual_seed(0))
    assert abs(big["proj_in.weight"].std().item() * 32 - 1.0) < 0.02
    assert torch.equal(big["norm.weight"], torch.ones(1024))
    assert len(big) == len(module.state_dict())


def test_trace_latents_matches_jax(tiny_snapshot):
    """Both packages load the same snapshot and replay the same injected
    noise (3 DDIM steps): per-step latents within 1e-3 of max|jax|, the
    final uint8 within one level. JAX batches the CFG pass; the port splits
    it by default."""
    rng = np.random.default_rng(8)
    args = ("a photo", rng.integers(0, 256, (8, 12, 3), dtype=np.uint8),
            rng.standard_normal((8, 12, 3)).astype(np.float32),
            rng.standard_normal((8, 12, 4)).astype(np.float32))
    ref_lats, ref = jax_load_pipeline(
        tiny_snapshot, compute_dtype="float32").trace_latents(
            *args, num_inference_steps=3)
    pipe = load_upscale_pipeline(tiny_snapshot, device="cpu",
                                 compute_dtype="float32")
    assert pipe.cfg_split
    lats, out = pipe.trace_latents(*args, num_inference_steps=3)
    assert lats.shape == ref_lats.shape == (3, 8, 12, 4)
    assert np.abs(lats - ref_lats).max() <= 1e-3 * np.abs(ref_lats).max()
    assert out.shape == ref.shape == (16, 24, 3)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("scheduler", ["ddim", "ddpm"])
def test_split_cfg_matches_batched(tiny_snapshot, scheduler):
    """Two batch-n UNet passes against one batch-2n pass, same seed (and,
    for DDPM, the same step noises): uint8 within one level."""
    img = np.random.default_rng(9).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    outs = []
    for split in (True, False):
        pipe = load_upscale_pipeline(tiny_snapshot, device="cpu",
                                     compute_dtype="float32", cfg_split=split)
        if scheduler == "ddpm":
            pipe.scheduler = DDPMScheduler()
        outs.append(pipe("a photo", img, num_inference_steps=3).numpy())
    assert outs[0].shape == (16, 16, 3) and outs[0].dtype == np.uint8
    assert np.abs(outs[0].astype(int) - outs[1].astype(int)).max() <= 1


def test_pipeline_seed_determinism_and_noise_guard(tiny_snapshot):
    pipe = load_upscale_pipeline(tiny_snapshot, device="cpu",
                                 compute_dtype="float32")
    img = np.random.default_rng(10).integers(0, 256, (8, 8, 3),
                                             dtype=np.uint8)
    a, b = (pipe("a photo", img, num_inference_steps=2, seed=s)
            for s in (0, 0))
    assert torch.equal(a, b)
    assert not torch.equal(a, pipe("a photo", img, num_inference_steps=2,
                                   seed=1))
    with pytest.raises(ValueError, match="noise_level"):
        pipe("x", img, noise_level=9999)


def test_load_pipeline_from_deprecated_attention_keys(tiny_snapshot,
                                                      tmp_path):
    """A VAE saved with the pre-0.15 attention names (query/key/value/
    proj_attn, one of them as a 1x1 conv) and encoder tensors loads, and
    decodes exactly as the canonical one."""
    import shutil
    snap = str(tmp_path / "old")
    shutil.copytree(tiny_snapshot, snap)
    path = os.path.join(snap, "vae", "diffusion_pytorch_model.bin")
    sd = torch.load(path, weights_only=True)
    old = {}
    for name, t in sd.items():
        for new, dep in ((".to_q.", ".query."), (".to_k.", ".key."),
                         (".to_v.", ".value."), (".to_out.0.",
                                                 ".proj_attn.")):
            if new in name:
                name = name.replace(new, dep)
                if dep == ".key." and t.dim() == 2:
                    t = t[:, :, None, None]
        old[name] = t
    old["encoder.conv_in.weight"] = torch.zeros(8, 3, 3, 3)
    assert any(".query." in k for k in old)
    torch.save(old, path)
    new_pipe = load_upscale_pipeline(tiny_snapshot, device="cpu",
                                     compute_dtype="float32")
    old_pipe = load_upscale_pipeline(snap, device="cpu",
                                     compute_dtype="float32")
    lat = torch.randn((1, 6, 6, 4), generator=torch.Generator().manual_seed(0))
    assert torch.equal(vae_decode(old_pipe.vae, lat),
                       vae_decode(new_pipe.vae, lat))


def test_broken_tokenizer_falls_back_as_in_jax(tiny_snapshot, tmp_path,
                                               caplog):
    """A snapshot whose tokenizer/ fails to load (empty vocab.json) loads in
    both packages, each logging the failure, and both tokenize a prompt to
    the same word-hash ids."""
    import logging
    import shutil
    snap = str(tmp_path / "broken_tok")
    shutil.copytree(tiny_snapshot, snap)
    os.makedirs(os.path.join(snap, "tokenizer"))
    open(os.path.join(snap, "tokenizer", "vocab.json"), "w").close()
    open(os.path.join(snap, "tokenizer", "merges.txt"), "w").close()
    with caplog.at_level(logging.WARNING):
        port = load_upscale_pipeline(snap, device="cpu",
                                     compute_dtype="float32")
        ref = jax_load_pipeline(snap, compute_dtype="float32")
    assert port.tokenizer is None and ref.tokenizer is None
    assert sum("tokenizer load failed" in r.getMessage()
               for r in caplog.records) == 2
    for prompt in ("a photo of a lighthouse on a cliff", ""):
        got = port._tokenize(prompt)
        assert got.shape == (1, CLIP["max_position_embeddings"])
        np.testing.assert_array_equal(got, np.asarray(ref._tokenize(prompt)))


def test_missing_tensor_fails_strict_load(tiny_snapshot, tmp_path):
    import shutil
    snap = str(tmp_path / "broken")
    shutil.copytree(tiny_snapshot, snap)
    path = os.path.join(snap, "unet", "diffusion_pytorch_model.bin")
    sd = torch.load(path, weights_only=True)
    del sd["conv_out.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        load_upscale_pipeline(snap, device="cpu", compute_dtype="float32")


# ----------------------------------------------------------- product path ---

@pytest.fixture(scope="module")
def esrgan_ckpt(tmp_path_factory):
    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8,
                        num_block=1, num_grow_ch=4)
    return save_state_dict(init_rrdbnet(cfg, torch.Generator().manual_seed(0)),
                           str(tmp_path_factory.mktemp("esr") / "w.pth"))


def _sr(tmp_path, snap, ckpt=None, **overrides):
    cfg = {"iterations": 1, "segment_enhancement": False, "denoise_level": 0,
           "use_diffusion": True, "diffusion_model_path": snap,
           "num_inference_steps": 2, "output_dir": str(tmp_path / "out")}
    if ckpt:
        cfg.update(esrgan_model_path=ckpt, esrgan_arch={
            "num_feat": 8, "num_block": 1, "num_grow_ch": 4})
    else:
        cfg["use_esrgan"] = False
    cfg.update(overrides)
    stages = []
    cfg["progress_callback"] = lambda s, *a: stages.append(s)
    return SuperResolutionPipeline("cpu", cfg), stages


def test_product_path_diffusion_only(tiny_snapshot, tmp_path, test_image):
    """8x8 -> 16x16 (the tiny VAE upsamples once), sub-stages traced: the
    always-on spans nest in the ``diffusion`` stage, one ``diffusion/step``
    a step run."""
    pipe, _ = _sr(tmp_path, tiny_snapshot, adaptive_sharpening=False)
    out = pipe.enhance_array(np.array(test_image[:8, :8]))
    assert "diffusion" in pipe.models and out.shape == (16, 16, 3)
    timer = pipe.timer
    assert {"diffusion/clip", "diffusion/denoise",
            "diffusion/vae"} <= set(timer.totals)
    assert timer.counts["diffusion/step"] == 2   # num_inference_steps
    spans = timer.requests[-1].spans
    steps = [sp for sp in spans if sp.name == "diffusion/step"]
    assert [sp.parent.name for sp in steps] == ["diffusion/denoise"] * 2
    assert steps[0].parent.parent.name == "diffusion"
    assert {sp.request for sp in spans} == {timer.requests[-1].id}


def test_product_path_esrgan_plus_diffusion(tiny_snapshot, esrgan_ckpt,
                                            tmp_path, test_image):
    """Both branches ensembled: ESRGAN 8 -> 32, diffusion 8 -> 16, aligned
    to 32x32; the stages in the JAX package's order."""
    pipe, stages = _sr(tmp_path, tiny_snapshot, esrgan_ckpt)
    out = pipe.enhance_array(np.array(test_image[:8, :8]))
    assert out.shape == (32, 32, 3)
    assert stages == ["Enhancement", "Preprocessing", "ESRGAN", "Diffusion",
                      "Ensemble", "Postprocessing"]
    # the sub-stages are spans, on without a switch
    assert "diffusion/denoise" in pipe.timer.totals
    assert pipe.timer.counts["diffusion/step"] == 2


def test_product_path_cap_skips_diffusion(tiny_snapshot, esrgan_ckpt,
                                          tmp_path, test_image):
    """Above diffusion_max_megapixels the branch is skipped: the output is
    ESRGAN's alone."""
    img = np.array(test_image[:8, :8])
    pipe, _ = _sr(tmp_path, tiny_snapshot, esrgan_ckpt,
                  diffusion_max_megapixels=1e-5)
    ref, _ = _sr(tmp_path, tiny_snapshot, esrgan_ckpt, use_diffusion=False)
    np.testing.assert_array_equal(pipe.enhance_array(img),
                                  ref.enhance_array(img))
    assert "diffusion/denoise" not in pipe.timer.totals


@pytest.mark.parametrize("cap,streamed", [(None, False), (1e-3, True)],
                         ids=["diffusion_runs", "capped"])
def test_streamed_final_veto(tiny_snapshot, esrgan_ckpt, tmp_path,
                             test_image, cap, streamed):
    """The last iteration streams ESRGAN + sharpen only when diffusion
    would not run on it (above its cap)."""
    pipe, _ = _sr(tmp_path, tiny_snapshot, esrgan_ckpt, max_tile_size=48,
                  tile_halo=8, diffusion_max_megapixels=cap)
    out = pipe.enhance_array(np.array(test_image[:64, :80]))
    assert out.shape == (256, 320, 3)
    assert ("esrgan+post/streamed" in pipe.timer.totals) == streamed
    assert ("diffusion" in pipe.timer.totals) != streamed


def test_kernel_fault_in_attention_propagates(tiny_snapshot, esrgan_ckpt,
                                              tmp_path, test_image,
                                              monkeypatch):
    """A KernelError inside attention_auto ends the request: the ladder does
    not turn it into an ESRGAN-only image."""
    def broken(*args):
        raise KernelError("planted K3 fault")

    monkeypatch.setattr(torch_attention, "flash_attention", broken)
    pipe, _ = _sr(tmp_path, tiny_snapshot, esrgan_ckpt)
    with pytest.raises(KernelError, match="planted"):
        pipe.enhance_array(np.array(test_image[:8, :8]))


def test_missing_snapshot_disables_the_branch(tmp_path, esrgan_ckpt,
                                              test_image, monkeypatch):
    """diffusion_model_path null resolves through the model registry; a
    missing snapshot logs and turns the branch off."""
    monkeypatch.setenv("NESR_MODELS_DIR", str(tmp_path / "models"))
    pipe, stages = _sr(tmp_path, None, esrgan_ckpt)
    assert pipe.enhance_array(np.array(test_image[:8, :8])).shape == \
        (32, 32, 3)
    assert "diffusion" not in pipe.models
    assert not pipe.config["use_diffusion"] and "Diffusion" not in stages


def test_cuda_config_allows_diffusion_with_the_cap():
    cfg = merge_config("cuda", {"use_diffusion": True,
                                "segment_enhancement": False,
                                "denoise_level": 0})
    assert cfg["use_diffusion"] and cfg["diffusion_max_megapixels"] == 0.27
    from neural_enhanced_super_resolution_tpu.runtime.config import (
        merge_config as jax_merge)
    assert cfg["diffusion_max_megapixels"] == jax_merge(
        "tpu", None)["diffusion_max_megapixels"]
    # segmentation and NL-means are ported: the defaults merge unchanged
    for key, value in (("segment_enhancement", True), ("denoise_level", 0.5)):
        assert merge_config("cuda", dict(cfg, **{key: value}))[key] == value


def test_diffusion_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import neural_enhanced_super_resolution_torch.models.diffusion\n"
            "import neural_enhanced_super_resolution_torch.models.diffusion"
            ".specs\n"
            "import neural_enhanced_super_resolution_torch.models.diffusion"
            ".tokenizer\n"
            "import neural_enhanced_super_resolution_torch.kernels.attention\n"
            "import neural_enhanced_super_resolution_torch.utils.downloader\n"
            "import neural_enhanced_super_resolution_torch.pipeline\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m, v in sys.modules.items() if v is not None)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
