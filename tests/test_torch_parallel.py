"""The port's multi-device layer against the JAX package's, on the CPU.

A mesh here is the CPU listed n times (``[cpu] * n``); the JAX side runs
on the conftest's 8 virtual CPU devices. The pipeline sees 8 slots through
a replaced ``runtime.device.visible_devices``. Toy models are the JAX
tests' (tests/test_tiling.py): a depthwise 3x3 blur with nearest x2, and
a per-member scale. Tolerances, stated per test: tile DP 1e-6 (and bit
for bit against the port's own single-device tiling), strips 1e-5, the
member ensemble 1e-6, the TP forward 2e-5 in float32, split-CFG bit for
bit against the port's cfg_split and within 1e-3 of max|jax| against the
JAX sharded loop (the bar of tests/test_torch_diffusion.py), pipelines
bit for bit between "auto" and "off" and within one uint8 level on at
most 0.5% of values against the JAX pipeline.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from neural_enhanced_super_resolution_tpu import (
    SuperResolutionPipeline as JaxPipeline)
from neural_enhanced_super_resolution_tpu.models.diffusion import (
    load_upscale_pipeline as jax_load_pipeline, scheduler as jsched,
    unet as junet)
from neural_enhanced_super_resolution_tpu.models.diffusion.cfg_shard import (
    cfg_mesh as jax_cfg_mesh, denoise_cfg_sharded as jax_cfg_sharded)
from neural_enhanced_super_resolution_tpu.models.diffusion.specs import (
    unet_param_shapes)
from neural_enhanced_super_resolution_tpu.parallel import (
    ensemble_members_sharded as jax_ensemble, make_mesh as jax_mesh,
    process_strips_sharded as jax_strips,
    process_tiled_sharded as jax_tiled_sharded)
from neural_enhanced_super_resolution_tpu.parallel import sharded as jsharded
from neural_enhanced_super_resolution_tpu.parallel.overlap import (
    split_mesh as jax_split_mesh)
from neural_enhanced_super_resolution_tpu.parallel.tensor import (
    tp_mesh as jax_tp_mesh, tp_spec_for as jax_tp_spec_for)

from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
from neural_enhanced_super_resolution_torch.kernels import KernelError
from neural_enhanced_super_resolution_torch.models import (
    RRDBNetConfig, SwinIRConfig, SwinIRModel, init_rrdbnet, init_swinir,
    members_from_jax, params_from_jax, save_state_dict)
from neural_enhanced_super_resolution_torch.models.diffusion import (
    CLIPTextConfig, DDPMScheduler, UNet2DConditionModel, UNetConfig,
    VAEConfig, build_module, load_upscale_pipeline, unet_forward)
from neural_enhanced_super_resolution_torch.models.diffusion.cfg_shard import (
    cfg_mesh, denoise_cfg_sharded)
from neural_enhanced_super_resolution_torch.models.diffusion.convert import (
    diffusion_params_from_jax)
from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
    write_synthetic_snapshot)
from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
    precompute_context_kv)
from neural_enhanced_super_resolution_torch.models.swinir import (
    swinir_params_from_state_dict)
from neural_enhanced_super_resolution_torch.parallel import (
    ensemble_members_sharded, halo_exchange_strips, make_mesh,
    process_strips_sharded, process_tiled, process_tiled_sharded, replicate,
    shard_tiles, sharded)
from neural_enhanced_super_resolution_torch.parallel.dryrun import (
    dryrun_multichip)
from neural_enhanced_super_resolution_torch.parallel.dryrun import (
    main as dryrun_main)
from neural_enhanced_super_resolution_torch.parallel.mesh import (
    module_device, module_on)
from neural_enhanced_super_resolution_torch.parallel.overlap import (
    overlap_branches, split_mesh)
from neural_enhanced_super_resolution_torch.parallel.tensor import (
    TensorParallelUNet, _TPBlock, shard_transformer_params, tp_mesh,
    tp_spec_for)
from neural_enhanced_super_resolution_torch.pipeline import (
    EnhancementCancelled)
from neural_enhanced_super_resolution_torch.runtime import device as devices
from neural_enhanced_super_resolution_torch.runtime import profiler
from neural_enhanced_super_resolution_torch.utils.metrics import psnr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=2,
            num_grow_ch=4)
UNET = dict(sample_size=16, in_channels=7, out_channels=4,
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
            block_out_channels=(8, 16), layers_per_block=1,
            cross_attention_dim=16, attention_head_dim=2, num_class_embeds=50,
            norm_num_groups=4)   # the JAX tests' TINY UNet
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4,
           norm_num_groups=4, scaling_factor=0.08333)
CLIP = dict(vocab_size=100, hidden_size=16, intermediate_size=32,
            num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=12)
KERNEL = np.array([[0.05, 0.1, 0.05], [0.1, 0.4, 0.1], [0.05, 0.1, 0.05]],
                  np.float32)


def _up2_torch(tiles):
    """tests/test_tiling.py's _upscale2x_model: a depthwise 3x3 blur on a
    reflect-padded tile, then nearest x2."""
    c = tiles.shape[-1]
    x = F.pad(tiles.float().permute(0, 3, 1, 2), (1, 1, 1, 1),
              mode="reflect")
    y = F.conv2d(x, torch.from_numpy(KERNEL).expand(c, 1, 3, 3), groups=c)
    y = y.permute(0, 2, 3, 1)
    return y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _up2_jax(tiles):
    c = tiles.shape[-1]
    filt = jnp.broadcast_to(jnp.asarray(KERNEL)[:, :, None, None],
                            (3, 3, 1, c))
    x = jnp.pad(tiles.astype(jnp.float32), ((0, 0), (1, 1), (1, 1), (0, 0)),
                mode="reflect")
    y = jax.lax.conv_general_dilated(
        x, filt, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c)
    return jnp.repeat(jnp.repeat(y, 2, axis=1), 2, axis=2)


def _cpus(n):
    return [CPU] * n


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def eight_slots(monkeypatch):
    """The pipeline sees 8 devices, as the JAX one sees the conftest's 8."""
    monkeypatch.setattr(devices, "visible_devices",
                        lambda device: _cpus(8))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    sd = init_rrdbnet(RRDBNetConfig(**TINY), torch.Generator().manual_seed(0))
    return save_state_dict(sd, str(tmp_path_factory.mktemp("ckpt")
                                   / "tiny_x4.pth"))


@pytest.fixture(scope="module")
def tiny_snapshot(tmp_path_factory):
    return write_synthetic_snapshot(
        str(tmp_path_factory.mktemp("sd_x4_tiny")),
        (UNetConfig(**UNET), VAEConfig(**VAE), CLIPTextConfig(**CLIP)),
        torch.Generator().manual_seed(0), torch.float32, init="fixed")


def _config(tmp_path, ckpt, who, **overrides):
    cfg = {"iterations": 1, "use_diffusion": False,
           "segment_enhancement": False, "denoise_level": 0,
           "esrgan_model_path": ckpt, "esrgan_arch": dict(TINY),
           "output_dir": str(tmp_path / who)}
    cfg.update(overrides)
    return cfg


def _pipe(tmp_path, ckpt, **overrides):
    return SuperResolutionPipeline("cpu", _config(tmp_path, ckpt, "t",
                                                  **overrides))


TILED = dict(adaptive_sharpening=False, enable_tiling=True,
             max_megapixels=0.001, max_tile_size=48)


# ------------------------------------------------------------ mesh helpers --

def test_mesh_helpers():
    mesh = make_mesh(3, devices=_cpus(8))
    assert mesh == (CPU,) * 3
    batch = torch.arange(24.0).reshape(6, 4)
    shards = shard_tiles(batch, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 4)] * 3
    assert torch.equal(torch.cat(shards), batch)
    with pytest.raises(ValueError):
        shard_tiles(batch[:5], mesh)
    copies = replicate(batch, mesh)
    assert all(c is copies[0] for c in copies)  # one copy a distinct device
    module = torch.nn.Linear(2, 2)
    assert module_on(module, CPU) is module and module_device(module) == CPU
    with pytest.raises(ValueError):
        make_mesh(devices=[])


# ----------------------------------------------------------------- tile DP --

@pytest.mark.parametrize("hw,batch_tiles,shard_sizes", [
    ((96, 96), None, [8] * 8),
    ((70, 90), 3, [3] * 8 + [1] * 8),
    ((70, 90), 1, [1] * 32),
], ids=["whole_batch", "cap3_ragged_tail", "cap1"])
def test_process_tiled_sharded_matches_jax(hw, batch_tiles, shard_sizes):
    """8 slots: the JAX chunk policy (tiles a slot a chunk, a power-of-two
    bucket a slot, the tail padded with the last tile), against the JAX
    sharded tiler (1e-6) and the port's single-device tiler (bit for
    bit)."""
    img = np.random.default_rng(0).random((*hw, 3), dtype=np.float32)
    seen = []

    def model(tiles):
        seen.append(int(tiles.shape[0]))
        return _up2_torch(tiles)

    got = process_tiled_sharded(model, torch.from_numpy(img), _cpus(8), 16,
                                2, 2, batch_tiles=batch_tiles).numpy()
    ref = np.asarray(jax_tiled_sharded(_up2_jax, img, jax_mesh(8), 16, 2, 2,
                                       batch_tiles=batch_tiles))
    single = process_tiled(_up2_torch, torch.from_numpy(img), 16, 2, 2,
                           batch_tiles=batch_tiles).numpy()
    assert seen == shard_sizes
    assert got.shape == ref.shape == (hw[0] * 2, hw[1] * 2, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got, single)


def test_process_tiled_sharded_takes_one_callable_a_slot():
    """The one model callable runs once a slot a chunk, on that slot's
    shard, and the stitched result equals process_tiled."""
    img = torch.rand((64, 64, 3), generator=torch.Generator().manual_seed(1))
    shards = []

    def fn(tiles):
        shards.append(int(tiles.shape[0]))
        return _up2_torch(tiles)

    got = process_tiled_sharded(fn, img, _cpus(4), 16, 2, 2, batch_tiles=2)
    assert shards == [2] * 8   # 16 tiles: 2 chunks of 4 slots x 2 tiles
    assert torch.equal(got, process_tiled(_up2_torch, img, 16, 2, 2))


# ------------------------------------------------------------------ strips --

def _jax_shard_map():
    return getattr(jax, "shard_map", None) or __import__(
        "jax.experimental.shard_map", fromlist=["shard_map"]).shard_map


def test_halo_exchange_strips_matches_jax():
    """Each slot's strip with its neighbours' rows (or its reflected edge)
    against the JAX ppermute exchange inside shard_map, bit for bit."""
    img = np.random.default_rng(2).random((64, 12, 3), dtype=np.float32)
    exchanged = _jax_shard_map()(
        lambda s: jsharded.halo_exchange_strips(s, 3, "dp"),
        mesh=jax_mesh(8), in_specs=P("dp", None, None),
        out_specs=P("dp", None, None))(jnp.asarray(img))
    strips = list(torch.from_numpy(img).chunk(8))
    got = torch.cat(halo_exchange_strips(strips, 3)).numpy()
    assert got.shape == (8 * (8 + 6), 12, 3)
    np.testing.assert_array_equal(got, np.asarray(exchanged))


@pytest.mark.parametrize("h", [64, 70], ids=["divides", "reflect_padded"])
def test_process_strips_sharded_matches_jax(h):
    img = np.random.default_rng(3).random((h, 48, 3), dtype=np.float32)
    got = process_strips_sharded(_up2_torch, torch.from_numpy(img), _cpus(8),
                                 halo=4, scale=2).numpy()
    ref = np.asarray(jax_strips(_up2_jax, img, jax_mesh(8), halo=4, scale=2))
    assert got.shape == ref.shape == (2 * h, 96, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    whole = _up2_torch(torch.from_numpy(img)[None])[0].numpy()
    np.testing.assert_allclose(got[8:-8], whole[8:-8], atol=1e-5, rtol=0)


# --------------------------------------------------------- overlap, members --

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_split_mesh_matches_jax(n):
    esr, diff = split_mesh(_cpus(n))
    jmesh, jdiff = jax_split_mesh(jax.devices()[:n])
    assert (len(esr), len(diff)) == (jmesh.devices.size, len(jdiff))
    assert [d.id for d in jmesh.devices.flat] == list(esr)
    assert [d.id for d in jdiff] == list(diff)


def test_overlap_branches_dispatches_both():
    order = []
    a, b = overlap_branches(lambda: order.append("a") or 1,
                            lambda: order.append("b") or 2)
    assert (a, b, order) == (1, 2, ["a", "b"])
    assert overlap_branches(lambda: 3, None) == (3, None)


def test_ensemble_members_sharded_matches_jax():
    """8 members, member i scaling the image by s_i, weights 1:2; the
    stacked JAX params become one state dict a member."""
    img = np.random.default_rng(4).random((16, 16, 3), dtype=np.float32)
    scales = np.linspace(0.5, 1.2, 8).astype(np.float32)
    stacked = {"s": scales.reshape(8, 1)}
    weights = np.asarray([1, 1, 1, 1, 2, 2, 2, 2], np.float32)
    weights /= weights.sum()
    ref = np.asarray(jax_ensemble(lambda p, x: x * p["s"][0],
                                  {"s": jnp.asarray(stacked["s"])}, img,
                                  jax_mesh(8), weights=weights))
    members = members_from_jax(stacked, convert=lambda p: {
        k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    got = ensemble_members_sharded(lambda m, x: x * m["s"][0], members,
                                   torch.from_numpy(img), _cpus(8),
                                   weights=list(weights)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _jax_rrdbnet_params(rng):
    """TINY in the JAX package's stock layout (HWIO, the body stacked on a
    leading num_block axis)."""
    nf, gc, nb = TINY["num_feat"], TINY["num_grow_ch"], TINY["num_block"]

    def conv(cin, cout, lead=()):
        return {"w": rng.standard_normal((*lead, 3, 3, cin, cout)).astype(
                    np.float32),
                "b": rng.standard_normal((*lead, cout)).astype(np.float32)}

    params = {name: conv(cin, cout) for name, cin, cout in (
        ("conv_first", 12, nf), ("conv_body", nf, nf), ("conv_up1", nf, nf),
        ("conv_up2", nf, nf), ("conv_hr", nf, nf), ("conv_last", nf, 3))}
    params["body"] = {rdb: {f"conv{c}": conv(nf + (c - 1) * gc,
                                             gc if c < 5 else nf, (nb,))
                            for c in range(1, 6)}
                      for rdb in ("rdb1", "rdb2", "rdb3")}
    return params


def test_members_from_jax_splits_stacked_rrdbnet_params():
    rng = np.random.default_rng(7)
    params = [_jax_rrdbnet_params(rng) for _ in range(2)]
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), *params)
    members = members_from_jax(stacked)
    for member, p in zip(members, params):
        want = params_from_jax(p)
        assert member.keys() == want.keys()
        assert all(torch.equal(member[k], want[k]) for k in want)


# --------------------------------------------------------------- split CFG --

def _draws(key, n, h, w, steps, ddpm):
    """The JAX package's draws (cfg_shard.denoise_cfg_sharded)."""
    k_latent, k_img, k_loop = jax.random.split(key, 3)
    img_noise = jax.random.normal(k_img, (n, h, w, 3), jnp.float32)
    latents = jax.random.normal(k_latent, (n, h, w, 4), jnp.float32)
    step = (jax.random.normal(k_loop, (steps, n, h, w, 4), jnp.float32)
            if ddpm else None)
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in (img_noise, latents, step)]


@pytest.mark.parametrize("scheduler", ["ddim", "ddpm"])
def test_cfg_sharded_matches_cfg_split_and_jax(tiny_snapshot, scheduler):
    """Uncond on slot 0, cond on slot 1, 3 steps: the latents equal the
    port's single-device cfg_split bit for bit, and JAX's sharded loop (its
    own draws passed in) within 1e-3 of max|jax|."""
    ddpm = scheduler == "ddpm"
    jpipe = jax_load_pipeline(tiny_snapshot, compute_dtype="float32",
                              cfg_split=True)
    pipe = load_upscale_pipeline(tiny_snapshot, device="cpu",
                                 compute_dtype="float32", cfg_split=True)
    if ddpm:
        kw = dict(num_train_timesteps=1000, beta_start=0.0001,
                  beta_end=0.02, beta_schedule="scaled_linear")
        jpipe.scheduler = jsched.DDPMScheduler(**kw)
        pipe.scheduler = DDPMScheduler(**kw)
    img_u8 = np.random.default_rng(5).integers(0, 256, (8, 8, 3), np.uint8)
    image = torch.from_numpy(img_u8).float()[None] / 127.5 - 1.0
    embeds = np.array(jpipe.encode_prompt("a photo"))
    timesteps = pipe.scheduler.timesteps(3)
    key = jax.random.PRNGKey(0)
    noise, latents, steps = _draws(key, 1, 8, 8, 3, ddpm)
    args = (torch.from_numpy(embeds), image, noise, latents, steps,
            timesteps, 20, 7.5)
    single = pipe._denoise(*args)
    got = denoise_cfg_sharded([pipe.unet, pipe.unet], *args, pipe.scheduler,
                              pipe.low_res_scheduler, cfg_mesh(_cpus(2)))
    assert torch.equal(got, single)
    pipe.cfg_shard_mesh = cfg_mesh(_cpus(2))   # the pipeline's own route
    assert torch.equal(pipe._denoise(*args), single)
    ref = np.asarray(jax_cfg_sharded(
        jpipe.unet_params, jnp.asarray(image.numpy()), jnp.asarray(embeds),
        jnp.asarray(timesteps), 20, 7.5, key, jpipe.unet_cfg,
        jpipe.scheduler, jpipe.low_res_scheduler, "float32",
        jax_cfg_mesh(jax.devices()[:2])))
    assert np.abs(got.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    with pytest.raises(ValueError):
        cfg_mesh(_cpus(1))


def test_to_device_keeps_the_seeded_draws(tiny_snapshot):
    pipe = load_upscale_pipeline(tiny_snapshot, device="cpu",
                                 compute_dtype="float32")
    img = np.random.default_rng(6).integers(0, 256, (8, 8, 3), np.uint8)
    before = pipe("a photo", img, num_inference_steps=2)
    assert pipe.to_device(CPU) is pipe
    assert pipe.device == CPU and pipe.unet.conv_in.weight.device == CPU
    assert torch.equal(pipe("a photo", img, num_inference_steps=2), before)


# ---------------------------------------------------------- tensor parallel --

def test_tp_spec_for_matches_jax():
    """tests/test_tensor_parallel.py's cases, the torch layout being the
    transpose of the JAX one: column-parallel shards dim 0, row-parallel
    dim 1, non-dividing dims replicate."""
    base = "down_blocks.1.attentions.0.transformer_blocks.0"
    mid = "mid_block.attentions.0.transformer_blocks.0"
    cases = [(f"{base}.attn1.to_q.weight", (16, 16), 0),
             (f"{base}.attn1.to_out.0.weight", (16, 16), 1),
             (f"{mid}.ff.net.0.proj.weight", (16, 128), 0),
             (f"{mid}.ff.net.2.weight", (64, 16), 1),
             (f"{mid}.ff.net.0.proj.bias", (128,), 0),
             ("down_blocks.0.resnets.0.conv1.weight", (3, 3, 8, 8), None),
             (f"{base}.attn1.to_q.weight", (16, 9), None)]
    jmesh = jax_tp_mesh(2)
    for name, jshape, dim in cases:
        tshape = jshape[::-1] if len(jshape) == 2 else jshape
        assert tp_spec_for(name, tshape, tp_mesh(2, _cpus(2))) == dim, name
        jspec = jax_tp_spec_for(name, jshape, jmesh)
        want = None if jspec == P() else (1 - jspec.index("tp")
                                          if len(jshape) == 2 else 0)
        assert dim == want, (name, jspec)


@pytest.fixture(scope="module")
def tp_case():
    jcfg = junet.UNetConfig(**UNET)
    rng = np.random.default_rng(1)
    # the JAX tests' random_params made with numpy: N(0, 0.05), norms 1
    jparams = {name: (np.ones(shape, np.float32)
                      if name.endswith(".weight")
                      and "norm" in name.split(".")[-2]
                      else 0.05 * rng.standard_normal(shape).astype(
                          np.float32))
               for name, shape in sorted(unet_param_shapes(jcfg).items())}
    unet = build_module(UNet2DConditionModel, UNetConfig(**UNET),
                        diffusion_params_from_jax(jparams), torch.float32,
                        "cpu")
    x = rng.standard_normal((1, 16, 16, 7)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 16)).astype(np.float32)
    ref = np.asarray(jax.jit(junet.unet_forward, static_argnames=(
        "cfg", "compute_dtype"))(
        jparams, jnp.asarray(x), jnp.int32(3), jnp.asarray(ctx),
        jnp.int32([20]), cfg=jcfg, compute_dtype="float32"))
    return unet, jparams, torch.from_numpy(x), torch.from_numpy(ctx), ref


@pytest.mark.parametrize("hoisted", [False, True], ids=["kv_in_layer",
                                                        "kv_hoisted"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_unet_forward_matches_replicated_and_jax(tp_case, tp, hoisted,
                                                    monkeypatch):
    """TINY has 2 heads a block: at tp 2 each slot runs one head's
    attention; at tp 4 the attentions stay replicated and the GEGLU FF
    splits. Against the port's replicated forward and JAX's unet_forward,
    atol 2e-5 (float32). Each slot runs one self-attention a block (K3 on
    the card)."""
    unet, _, x, ctx, ref = tp_case
    labels = torch.tensor([20])
    kv = precompute_context_kv(unet, ctx) if hoisted else None
    tp_unet = TensorParallelUNet(unet, _cpus(tp))
    per_slot = [0] * tp
    slot_attention = _TPBlock._attention

    def counted(self, i, q, k, v, cross):
        per_slot[i] += not cross
        return slot_attention(self, i, q, k, v, cross)

    monkeypatch.setattr(_TPBlock, "_attention", counted)
    got = tp_unet(x, 3, ctx, labels, kv).numpy()
    want = unet_forward(unet, x, 3, ctx, labels, kv).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    blocks = tp_unet.blocks.values()
    assert all(b.split_ff for b in blocks)
    assert all(b.split_attn1 == b.split_attn2 == (tp == 2) for b in blocks)
    assert per_slot == [len(blocks) if tp == 2 else 0] * tp


def test_tp_shards_the_tensors_jax_shards(tp_case):
    """Both packages shard the same diffusers-named tensors of the UNet."""
    unet, jparams, *_ = tp_case
    for tp in (2, 4):
        jmesh = jax_tp_mesh(tp)
        shards = shard_transformer_params(unet.state_dict(), _cpus(tp))
        for name, t in unet.state_dict().items():
            sharded_port = tp_spec_for(name, tuple(t.shape), _cpus(tp))
            jspec = jax_tp_spec_for(name, tuple(jparams[name].shape), jmesh)
            assert (sharded_port is None) == (jspec == P()), name
            if sharded_port is not None:
                assert shards[0][name].numel() * tp == t.numel()
                if "ff.net.0.proj" not in name:   # GEGLU: value|gate blocks
                    assert torch.equal(torch.cat(
                        [s[name] for s in shards], sharded_port), t)


# ---------------------------------------------------------------- pipeline --

def test_data_parallel_auto_matches_off(tmp_path, ckpt, test_image,
                                        eight_slots):
    """The tile batch sharded over 8 slots equals one device bit for bit,
    and the JAX pipeline's sharded request within one level."""
    img = np.array(test_image[:96, :96])
    out_off = _pipe(tmp_path, ckpt, data_parallel="off",
                    **TILED).enhance_array(img)
    pipe = _pipe(tmp_path, ckpt, data_parallel="auto", **TILED)
    out_auto = pipe.enhance_array(img)
    assert pipe._parallel_layout()["mesh"] == (CPU,) * 8
    np.testing.assert_array_equal(out_auto, out_off)
    ref = JaxPipeline(device="cpu", config=_config(
        tmp_path, ckpt, "jax", data_parallel="auto", **TILED)
    ).enhance_array(img)
    diff = np.abs(out_auto.astype(int) - ref.astype(int))
    assert out_auto.shape == ref.shape and diff.max() <= 1
    assert np.mean(diff > 0) <= 5e-3


def test_data_parallel_int_caps_the_slots(tmp_path, ckpt, eight_slots):
    assert _pipe(tmp_path, ckpt, data_parallel=3)._parallel_layout()[
        "mesh"] == (CPU,) * 3
    for off in ("off", 0, 1, None):
        assert _pipe(tmp_path, ckpt, data_parallel=off)._parallel_layout()[
            "mesh"] is None


def test_strip_sharding_through_the_product(tmp_path, ckpt, test_image,
                                            eight_slots, monkeypatch):
    """shard_strategy "strips" routes the upscale through
    process_strips_sharded: PSNR > 30 dB against tiles (the 8-px halo is
    below the 2-block net's ~35-px receptive field, so the seams differ)."""
    calls = []
    strips = sharded.process_strips_sharded
    monkeypatch.setattr(sharded, "process_strips_sharded",
                        lambda *a, **k: calls.append(1) or strips(*a, **k))
    img = np.array(test_image[:128, :128])
    kw = dict(TILED, tile_halo=8, data_parallel="auto")
    out_strips = _pipe(tmp_path, ckpt, shard_strategy="strips",
                       **kw).enhance_array(img)
    out_tiles = _pipe(tmp_path, ckpt, shard_strategy="tiles",
                      **kw).enhance_array(img)
    assert calls and out_strips.shape == out_tiles.shape
    assert float(psnr(out_strips, out_tiles)) > 30.0


def test_strip_sharding_interior_exact_vs_whole(tmp_path, ckpt, test_image,
                                                eight_slots):
    """At halo 36 >= the receptive field the strips equal the untiled
    forward bit for bit outside the top and bottom border band (320x128
    over 8 slots: 40-row strips)."""
    img = np.tile(test_image, (2, 1, 1))[:320, :128]
    kw = dict(adaptive_sharpening=False, upscale_factor=4.0)
    whole = _pipe(tmp_path, ckpt, enable_tiling=False, data_parallel="off",
                  **kw).enhance_array(img)
    pipe = _pipe(tmp_path, ckpt, shard_strategy="strips", enable_tiling=True,
                 max_megapixels=0.001, max_tile_size=64, tile_halo=36,
                 data_parallel="auto", **kw)
    strips = pipe.enhance_array(img)
    assert pipe._parallel_layout()["mesh"] is not None
    assert strips.shape == whole.shape == (1280, 512, 3)
    np.testing.assert_array_equal(strips[160:-160], whole[160:-160])
    assert float(psnr(strips, whole)) > 30.0


def test_thin_strips_fall_back_to_tiles(tmp_path, ckpt, test_image,
                                        eight_slots, caplog):
    """16 rows a slot against a 16-px halo: the guard logs and tiles."""
    img = np.array(test_image[:128, :128])
    kw = dict(TILED, tile_halo=16, data_parallel="auto")
    with caplog.at_level(logging.WARNING, logger="nesr"):
        out = _pipe(tmp_path, ckpt, shard_strategy="strips",
                    **kw).enhance_array(img)
    ref = _pipe(tmp_path, ckpt, shard_strategy="tiles",
                **kw).enhance_array(img)
    np.testing.assert_array_equal(out, ref)
    msgs = [r.getMessage() for r in caplog.records]
    assert any("thinner than" in m for m in msgs)
    assert not any("Strip-sharded path failed" in m for m in msgs)


def test_layout_splits_for_the_diffusion_overlap(tmp_path, ckpt,
                                                 eight_slots):
    """use_diffusion + stage_overlap: 6 ESRGAN slots, the diffusion slot
    outside them; stage_overlap off keeps all 8 for the tiles."""
    layout = _pipe(tmp_path, ckpt, use_diffusion=True)._parallel_layout()
    assert layout["slots"] == tuple(range(6)) and len(layout["mesh"]) == 6
    assert layout["diffusion_slot"] == 7
    assert layout["diffusion_slot"] not in layout["slots"]
    assert layout["diffusion_device"] == CPU
    plain = _pipe(tmp_path, ckpt, use_diffusion=True,
                  stage_overlap=False)._parallel_layout()
    assert plain["slots"] == tuple(range(8))
    assert plain["diffusion_slot"] is None
    off = _pipe(tmp_path, ckpt, data_parallel="off")._parallel_layout()
    assert off["mesh"] is None and off["diffusion_device"] is None


def test_sharded_failure_degrades_to_single_device(tmp_path, ckpt,
                                                   test_image, eight_slots,
                                                   monkeypatch, caplog):
    def boom(*a, **k):
        raise RuntimeError("injected sharded failure")

    monkeypatch.setattr(sharded, "process_tiled_sharded", boom)
    img = np.array(test_image[:96, :96])
    with caplog.at_level(logging.WARNING, logger="nesr"):
        out = _pipe(tmp_path, ckpt, data_parallel="auto",
                    **TILED).enhance_array(img)
    ref = _pipe(tmp_path, ckpt, data_parallel="off",
                **TILED).enhance_array(img)
    np.testing.assert_array_equal(out, ref)
    assert any("Sharded tile path failed" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("strategy", ["tiles", "strips"])
def test_sharded_kernel_fault_propagates(tmp_path, ckpt, test_image,
                                         eight_slots, monkeypatch, strategy):
    """A kernel fault under sharding ends the request: no logged fallback
    to another rung."""
    def broken(*a, **k):
        raise KernelError("planted K1 fault")

    monkeypatch.setattr(sharded, "process_tiled_sharded", broken)
    monkeypatch.setattr(sharded, "process_strips_sharded", broken)
    pipe = _pipe(tmp_path, ckpt, data_parallel="auto", shard_strategy=strategy,
                 **dict(TILED, tile_halo=8))
    with pytest.raises(KernelError, match="planted"):
        pipe.enhance_array(np.array(test_image[:128, :128]))


def test_sharded_cancel_raises(tmp_path, ckpt, test_image, eight_slots):
    calls = {"n": 0}

    def cancel_after_two():
        calls["n"] += 1
        return calls["n"] > 2

    pipe = _pipe(tmp_path, ckpt, data_parallel="auto", tile_batch=1,
                 tile_halo=4, cancel_check=cancel_after_two,
                 **dict(TILED, max_tile_size=24))
    with pytest.raises(EnhancementCancelled):
        pipe.enhance_array(np.array(test_image[:96, :96]))
    assert calls["n"] > 2


def test_no_streamed_final_while_a_mesh_is_active(tmp_path, ckpt, test_image,
                                                  eight_slots):
    img = np.array(test_image[:80, :96])
    kw = dict(max_tile_size=48, tile_halo=8)
    single = _pipe(tmp_path, ckpt, data_parallel="off", **kw)
    single.enhance_array(img)
    assert "esrgan+post/streamed" in single.timer.totals
    meshed = _pipe(tmp_path, ckpt, data_parallel="auto", **kw)
    assert meshed.enhance_array(img).shape == (320, 384, 3)
    assert "esrgan+post/streamed" not in meshed.timer.totals
    assert "esrgan" in meshed.timer.totals


def test_swinir_sharded_equals_single(tmp_path, ckpt, test_image,
                                      eight_slots, monkeypatch):
    cfg = SwinIRConfig(embed_dim=8, depths=(1,), num_heads=(2,),
                       window_size=4, num_feat=8, upsampler="nearest+conv",
                       scale=4)
    model = SwinIRModel(cfg, swinir_params_from_state_dict(init_swinir(
        cfg, torch.Generator().manual_seed(2))), torch.float32, "cpu").eval()
    calls = []
    tiled = sharded.process_tiled_sharded
    monkeypatch.setattr(sharded, "process_tiled_sharded",
                        lambda *a, **k: calls.append(1) or tiled(*a, **k))
    img = torch.from_numpy(np.array(test_image[:48, :40]))
    outs = {}
    for mode in ("auto", "off"):
        pipe = _pipe(tmp_path, ckpt, data_parallel=mode, max_tile_size=16,
                     tile_halo=4, use_swinir=True)
        pipe.models["swinir"] = model
        outs[mode] = pipe._apply_swinir(img)
    assert calls == [1]   # the "auto" pipeline sharded
    assert torch.equal(outs["auto"], outs["off"])
    assert tuple(outs["off"].shape) == (192, 160, 3)


def test_stage_overlap_and_sd_cfg_shard_through_the_product(
        tmp_path, ckpt, tiny_snapshot, test_image, eight_slots):
    """ESRGAN + diffusion over 8 slots: the diffusion branch on slot 7,
    split CFG over the last two slots with sd_cfg_shard; the request equals
    the single-device one bit for bit."""
    img = np.array(test_image[:8, :8])
    kw = dict(use_diffusion=True, diffusion_model_path=tiny_snapshot,
              num_inference_steps=2)
    outs = {}
    for name, over in (("off", dict(data_parallel="off")),
                       ("overlap", {}),
                       ("cfg_shard", dict(sd_cfg_shard=True))):
        pipe = _pipe(tmp_path, ckpt, **kw, **over)
        outs[name] = pipe.enhance_array(img)
        diff = pipe.models["diffusion"]
        assert pipe._overlap_active()
        assert (pipe._parallel_layout()["diffusion_slot"] == 7) == (
            name != "off")
        assert diff.cfg_shard_mesh == ((CPU, CPU) if name == "cfg_shard"
                                       else None)
    assert outs["off"].shape == (32, 32, 3)
    np.testing.assert_array_equal(outs["overlap"], outs["off"])
    np.testing.assert_array_equal(outs["cfg_shard"], outs["off"])


def _record_syncs(monkeypatch) -> list:
    """CUDA reported present; each torch.cuda.synchronize call recorded."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    return synced


def test_stage_timer_synchronises_every_gpu(monkeypatch):
    """A stage waits for every CUDA device it is given, each once, and for
    the current GPU when given none; an end left open waits for none."""
    synced = _record_syncs(monkeypatch)
    cards = [torch.device("cuda", i) for i in range(3)]
    timer = profiler.StageTimer()
    with timer.stage("a", devices=cards + [cards[0], CPU]):
        pass
    assert synced == cards * 2
    synced.clear()
    with timer.stage("b"):
        pass
    assert synced == [None, None]
    synced.clear()
    with timer.stage("esrgan", sync_end=False, devices=cards):
        pass
    with timer.stage("diffusion", sync_start=False, sync_end=False,
                     devices=cards):
        pass
    assert synced == cards
    # and the timer counts its waits: 6 + 2 + 3 synchronizations
    assert timer.counts == {"a": 1, "b": 1, "esrgan": 1, "diffusion": 1,
                            "sync": 11}


@pytest.mark.parametrize("mode,used", [("off", 1), ("auto", 4)])
def test_stages_synchronise_only_the_layouts_devices(tmp_path, ckpt,
                                                     monkeypatch, mode, used):
    """On a host with 4 GPUs a one-device layout's stages synchronise its
    own card only (a synchronize on another card would open a CUDA context
    there); a 4-slot layout's stages synchronise each of its cards."""
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(devices, "visible_devices", lambda device: cards)
    pipe = _pipe(tmp_path, ckpt, data_parallel=mode)
    pipe.device = "cuda"   # the layout only: no tensor is placed
    synced = _record_syncs(monkeypatch)
    with pipe._stage("esrgan"):
        pass
    assert synced == cards[:used] * 2


# --------------------------------------------------------- dry run, imports --

def test_dryrun_multichip_over_eight_cpu_slots(capsys):
    dryrun_multichip(_cpus(8))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("PASS ")]
    assert [ln.split(":")[0][5:] for ln in lines] == [
        "1", "2", "3", "3b", "4", "5", "5b", "6b", "6"]


def test_dryrun_entry_point_takes_the_card_unless_cpu_is_asked(
        monkeypatch, capsys):
    """With no argument the dry run asks for the card and raises without
    one; ``cpu N`` runs it over N CPU slots."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dryrun_main([])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dryrun_main(["cuda"])
    dryrun_main(["cpu", "2"])
    out = capsys.readouterr().out
    assert out.count("PASS ") == 9 and "tile DP over 2 slots" in out


def test_multi_device_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import neural_enhanced_super_resolution_torch.parallel\n"
            "import neural_enhanced_super_resolution_torch.parallel.mesh\n"
            "import neural_enhanced_super_resolution_torch.parallel.sharded\n"
            "import neural_enhanced_super_resolution_torch.parallel.overlap\n"
            "import neural_enhanced_super_resolution_torch.parallel.ensemble\n"
            "import neural_enhanced_super_resolution_torch.parallel.tensor\n"
            "import neural_enhanced_super_resolution_torch.parallel.dryrun\n"
            "import neural_enhanced_super_resolution_torch.models.diffusion"
            ".cfg_shard\n"
            "import neural_enhanced_super_resolution_torch.runtime"
            ".distributed\n"
            "import neural_enhanced_super_resolution_torch.pipeline\n"
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('neural_enhanced_super_resolution_tpu') "
            "for m, v in sys.modules.items() if v is not None)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
