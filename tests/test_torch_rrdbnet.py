"""The port's RRDBNet against the JAX package's, on the CPU in float32.

Inputs are made with numpy from a seed; the JAX side runs as its own tests
run it. Tolerance: max|port - jax| <= 1e-3 * max(1, max|jax|), the bar the
JAX package holds itself to against torch.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_tpu.models import rrdbnet as jr
from neural_enhanced_super_resolution_tpu.models import weights as jw
from neural_enhanced_super_resolution_tpu.pipeline import _esrgan_jit
from neural_enhanced_super_resolution_torch.models import (
    RRDBNet, RRDBNetConfig, fuse_rdb, init_rrdbnet, load_state_dict,
    params_from_jax, pixel_unshuffle, save_state_dict)
from neural_enhanced_super_resolution_torch.pipeline import esrgan_step

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny_trained_x4.safetensors")
TOL = 1e-3

TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=2,
            num_grow_ch=4)


def _jax_params(arch, seed=0):
    """Seeded synthetic weights as the JAX package's pytree (numpy)."""
    sd = init_rrdbnet(RRDBNetConfig(**arch),
                      torch.Generator().manual_seed(seed))
    params = jw.rrdbnet_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_block=arch["num_block"])
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, err


FORWARD_CASES = {
    "tiny_12ch_x4": (TINY, (2, 13, 11, 12)),
    "x2plus_scale2": (dict(TINY, num_in_ch=3, scale=2), (1, 14, 10, 3)),
    "full_width_64_23_32": (dict(num_in_ch=12, num_out_ch=3, scale=4,
                                 num_feat=64, num_block=23, num_grow_ch=32),
                            (1, 12, 12, 12)),
}


@functools.lru_cache(maxsize=None)
def _jax_forward(case):
    """(pytree, input, JAX output) of a case, shared by both trunks."""
    arch, shape = FORWARD_CASES[case]
    jp = _jax_params(arch)
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    ref = jr.rrdbnet_forward(jr.fuse_rrdbnet_params(jp), jnp.asarray(x),
                             jr.RRDBNetConfig(**arch), "float32")
    return jp, x, np.asarray(ref)


@pytest.mark.parametrize("trunk", ["fused", "stock"])
@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case, trunk):
    jp, x, ref = _jax_forward(case)
    model = RRDBNet(RRDBNetConfig(**FORWARD_CASES[case][0]),
                    params_from_jax(jp), torch.float32, "cpu", trunk)
    _close(model(torch.from_numpy(x)), ref)


@pytest.mark.skipif(not os.path.exists(FIXTURE), reason="fixture missing")
def test_trained_fixture_matches_jax():
    arch = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=16,
                num_block=2, num_grow_ch=8)
    jp = jw.rrdbnet_params_from_state_dict(jw.load_state_dict(FIXTURE),
                                           num_block=2)
    x = np.random.default_rng(1).uniform(0, 1, (1, 20, 18, 12)).astype(
        np.float32)
    ref = jr.rrdbnet_forward(jr.fuse_rrdbnet_params(jp), jnp.asarray(x),
                             jr.RRDBNetConfig(**arch), "float32")
    model = RRDBNet(RRDBNetConfig(**arch), load_state_dict(FIXTURE),
                    torch.float32, "cpu")
    _close(model(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("mode,arch,hw", [
    ("stack12", TINY, (21, 19)),
    ("repeat12", TINY, (16, 20)),
    ("direct", dict(TINY, num_in_ch=3, scale=2), (15, 13)),
])
def test_tile_step_matches_jax(mode, arch, hw):
    """uint8 tiles -> BGR stack -> RRDBNet -> truncated uint8, including the
    scale-2 edge pad of an odd size: identical to the JAX tile step but for
    truncation flips of at most one level."""
    jp = _jax_params(arch, seed=3)
    tiles = np.random.default_rng(2).integers(0, 256, (2, *hw, 3),
                                              dtype=np.uint8)
    ref = np.asarray(_esrgan_jit(jr.fuse_rrdbnet_params(jp),
                                 jnp.asarray(tiles), jr.RRDBNetConfig(**arch),
                                 "float32", mode)).astype(int)
    model = RRDBNet(RRDBNetConfig(**arch), params_from_jax(jp),
                    torch.float32, "cpu")
    got = esrgan_step(model, torch.from_numpy(tiles), mode).numpy()
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref)
    assert diff.max() <= 1 and np.mean(diff > 0) <= 5e-3


def test_fuse_rdb_matches_jax_fuse():
    jp = _jax_params(TINY)
    fused = jax.tree_util.tree_map(np.asarray, jr.fuse_rrdbnet_params(jp))
    sd = params_from_jax(jp)
    ws = [sd[f"body.1.rdb2.conv{i}.weight"].permute(2, 3, 1, 0)
          for i in range(1, 6)]
    bs = [sd[f"body.1.rdb2.conv{i}.bias"] for i in range(1, 6)]
    fw, fb = fuse_rdb(ws, bs)
    for i in range(5):
        np.testing.assert_array_equal(fw[i].numpy(),
                                      fused["body"]["rdb2"][f"w{i}"][1])
    np.testing.assert_array_equal(fb.numpy(), fused["body"]["rdb2"]["b"][1])


def test_params_from_jax_inverts_the_jax_converter():
    sd = init_rrdbnet(RRDBNetConfig(**TINY), torch.Generator().manual_seed(5))
    jp = jw.rrdbnet_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_block=2)
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert set(back) == set(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_pixel_unshuffle_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        pixel_unshuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(jr.pixel_unshuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize("ext", [".pth", ".safetensors"])
def test_synthetic_weights_roundtrip(tmp_path, ext):
    """init_rrdbnet is deterministic per seed and survives save/load; the
    JAX package loads the same file to the same weights."""
    cfg = RRDBNetConfig(**TINY)
    sd = init_rrdbnet(cfg, torch.Generator().manual_seed(7))
    again = init_rrdbnet(cfg, torch.Generator().manual_seed(7))
    path = save_state_dict(sd, str(tmp_path / f"w{ext}"))
    loaded = load_state_dict(path)
    assert set(loaded) == set(sd) == set(jw.rrdbnet_state_dict_keys(2))
    for k in sd:
        torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0)
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0)
    jp = jw.rrdbnet_params_from_state_dict(jw.load_state_dict(path),
                                           num_block=2)
    np.testing.assert_array_equal(
        np.asarray(jp["conv_first"]["w"]),
        sd["conv_first.weight"].permute(2, 3, 1, 0).numpy())


def test_dform_trunk_requires_bf16():
    sd = init_rrdbnet(RRDBNetConfig(**TINY), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="bfloat16"):
        RRDBNet(RRDBNetConfig(**TINY), sd, torch.float32, "cpu", "dform")
