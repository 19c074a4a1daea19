"""The port's VAE encoder against the JAX package's, on the CPU in float32.

* ``vae_encode`` of tiny VAE configs, their params made from a seed with
  numpy and carried across with ``diffusion_params_from_jax``, against the
  JAX ``vae_encode``: max|err| <= 1e-4 * max|ref|.
* A snapshot's VAE loads strictly, encoder and ``quant_conv`` included:
  the port's loaded encoder agrees with the JAX package's encode of the
  same snapshot, and a snapshot that lacks an encoder tensor fails to
  load.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.models.diffusion import (
    AutoencoderKL, CLIPTextConfig, UNetConfig, VAEConfig, build_module,
    load_upscale_pipeline, vae_decode, vae_encode)
from neural_enhanced_super_resolution_torch.models.diffusion.convert import (
    diffusion_params_from_jax)
from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
    write_synthetic_snapshot)
from neural_enhanced_super_resolution_tpu.models.diffusion import (
    vae as jvae)
from neural_enhanced_super_resolution_tpu.models.diffusion.pipeline import (
    load_upscale_pipeline as jax_load_pipeline)
from neural_enhanced_super_resolution_tpu.models.diffusion.specs import (
    vae_param_shapes)

VAES = {
    "two_blocks": dict(block_out_channels=(8, 16), layers_per_block=1,
                       latent_channels=4, norm_num_groups=4),
    "three_blocks": dict(block_out_channels=(8, 16, 16), layers_per_block=2,
                         latent_channels=4, norm_num_groups=4),
}


def _np_params(spec, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(spec.items()):
        v = rng.normal(0, 0.2, shape).astype(np.float32)
        if name.endswith(".weight") and "norm" in name.split(".")[-2]:
            v = 1.0 + 0.5 * v
        out[name] = v
    return out


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name,hw", [
    ("two_blocks", (12, 20)), ("two_blocks", (13, 9)),
    ("three_blocks", (16, 12))], ids=["even", "odd", "three_blocks"])
def test_vae_encode_matches_jax(name, hw):
    """Odd sizes take diffusers' (0, 1, 0, 1) pad before each stride-2
    conv like even ones; moments (N, H // f, W // f, 8)."""
    cfg = VAES[name]
    np_params = _np_params(vae_param_shapes(jvae.VAEConfig(**cfg),
                                            decoder_only=False), 7)
    sd = diffusion_params_from_jax(np_params)
    with torch.device("meta"):
        names = set(AutoencoderKL(VAEConfig(**cfg)).state_dict())
    assert set(sd) == names   # the carried params are the module's, all
    vae = build_module(AutoencoderKL, VAEConfig(**cfg), sd, torch.float32,
                       "cpu")
    img = np.random.default_rng(8).uniform(-1, 1, (2, *hw, 3)).astype(
        np.float32)
    ref = jvae.vae_encode({k: jnp.asarray(v) for k, v in np_params.items()},
                          jnp.asarray(img), jvae.VAEConfig(**cfg), "float32")
    got = vae_encode(vae, torch.from_numpy(img))
    f = 2 ** (len(cfg["block_out_channels"]) - 1)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, hw[0] // f, hw[1] // f, 8)
    assert _rel(got.numpy(), ref) <= 1e-4


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sd_x4_enc"))
    unet = dict(sample_size=16, in_channels=7, out_channels=4,
                down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                block_out_channels=(8, 16), layers_per_block=1,
                cross_attention_dim=16, attention_head_dim=2,
                num_class_embeds=50, norm_num_groups=4)
    clip = dict(vocab_size=100, hidden_size=16, intermediate_size=32,
                num_hidden_layers=1, num_attention_heads=2,
                max_position_embeddings=12)
    return write_synthetic_snapshot(
        path, (UNetConfig(**unet), VAEConfig(**VAES["two_blocks"]),
               CLIPTextConfig(**clip)),
        torch.Generator().manual_seed(0), torch.float32, init="fixed")


def test_snapshot_vae_loads_strictly_with_its_encoder(snapshot, tmp_path):
    pipe = load_upscale_pipeline(snapshot, device="cpu",
                                 compute_dtype="float32")
    assert isinstance(pipe.vae, AutoencoderKL)
    ref_pipe = jax_load_pipeline(snapshot, compute_dtype="float32")
    img = np.random.default_rng(9).uniform(-1, 1, (1, 8, 12, 3)).astype(
        np.float32)
    ref = jvae.vae_encode(ref_pipe.vae_params, jnp.asarray(img),
                          ref_pipe.vae_cfg, "float32")
    got = vae_encode(pipe.vae, torch.from_numpy(img))
    assert _rel(got.numpy(), ref) <= 1e-4
    lat = got[..., :4] / pipe.vae.cfg.scaling_factor   # the mean half
    assert vae_decode(pipe.vae, lat).shape == (1, 8, 12, 3)

    broken = str(tmp_path / "no_encoder")
    shutil.copytree(snapshot, broken)
    path = os.path.join(broken, "vae", "diffusion_pytorch_model.bin")
    sd = torch.load(path, weights_only=True)
    del sd["encoder.conv_out.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="encoder.conv_out.bias"):
        load_upscale_pipeline(broken, device="cpu", compute_dtype="float32")
