"""The port's SegFormer against the JAX package's and against Hugging Face
``transformers``, on the CPU in float32.

A tiny config (as tests/test_segformer.py) with seeded fan-in weights
(``write_synthetic_segformer``, so the logits are O(1), not the ~1e-8 of
HF's 0.02-std init). Bars: logits max |diff| <= 2e-3 against
``segformer_logits(..., "float32")`` (weights carried by
``segformer_params_from_jax``) and against HF's forward on the same
snapshot; ``SegFormerModel.segment`` gives the same class map as the JAX
package's, exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.models import segformer as ts
from neural_enhanced_super_resolution_torch.models.diffusion.layers import (
    materialize)
from neural_enhanced_super_resolution_torch.models.weights import (
    segformer_params_from_jax)
from neural_enhanced_super_resolution_tpu.models import segformer as js
from neural_enhanced_super_resolution_tpu.models.diffusion.convert import (
    convert_state_dict)

transformers = pytest.importorskip("transformers")

TINY = dict(num_channels=3, num_encoder_blocks=4, depths=[1, 1, 1, 1],
            sr_ratios=[4, 2, 2, 1], hidden_sizes=[8, 16, 16, 32],
            patch_sizes=[7, 3, 3, 3], strides=[4, 2, 2, 2],
            num_attention_heads=[1, 2, 2, 4], mlp_ratios=[2, 2, 2, 2],
            decoder_hidden_size=16, num_labels=10)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """(HF model, its save_pretrained snapshot, the JAX package's params)
    for seeded fan-in weights written by the port."""
    ours = ts.write_synthetic_segformer(
        str(tmp_path_factory.mktemp("seg_port")), ts.SegFormerConfig(**TINY),
        torch.Generator().manual_seed(0))
    hf = transformers.SegformerForSemanticSegmentation(
        transformers.SegformerConfig(**TINY)).eval()
    from safetensors.torch import load_file
    missing, unexpected = hf.load_state_dict(
        load_file(os.path.join(ours, "model.safetensors")), strict=False)
    assert not unexpected and all("num_batches_tracked" in k
                                  for k in missing)
    snap = str(tmp_path_factory.mktemp("seg_hf"))
    hf.save_pretrained(snap, safe_serialization=True)
    params = convert_state_dict({k: v.numpy()
                                 for k, v in hf.state_dict().items()})
    return hf, snap, params


def _x(seed=0, hw=64):
    return np.random.default_rng(seed).standard_normal(
        (1, hw, hw, 3)).astype(np.float32)


def test_param_shapes_are_hf_state_dict(snapshot):
    hf = snapshot[0]
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert ts.segformer_param_shapes(ts.SegFormerConfig(**TINY)) == want


def test_logits_match_jax(snapshot):
    _, _, params = snapshot
    x = _x()
    ref = np.asarray(js.segformer_logits(
        params, jnp.asarray(x), js.SegFormerConfig(**TINY), "float32"))
    with torch.device("meta"):
        model = ts.SegFormer(ts.SegFormerConfig(**TINY))
    sd = segformer_params_from_jax({k: v for k, v in params.items()
                                    if not k.endswith("num_batches_tracked")})
    model = materialize(model, sd, torch.float32, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 16, 16, 10)
    assert np.abs(ref).max() > 0.1   # O(1) logits, not a vacuous bar
    assert np.abs(got - ref).max() <= 2e-3


def test_load_segformer_matches_hf(snapshot):
    hf, snap, _ = snapshot
    x = _x(1)
    seg = ts.load_segformer(snap, "float32", "cpu")
    assert seg.cfg.num_labels == 10   # from the snapshot's id2label
    with torch.no_grad():
        ref = hf(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits
        got = seg.model(torch.from_numpy(x))
    ref = ref.numpy().transpose(0, 2, 3, 1)
    assert np.abs(ref).max() > 0.1
    assert np.abs(got.numpy() - ref).max() <= 2e-3


def test_segment_caps_the_long_side_like_jax(snapshot):
    _, snap, params = snapshot
    img = np.random.default_rng(2).integers(0, 256, (1100, 60, 3),
                                            dtype=np.uint8)
    ref = js.SegFormerModel(params, js.SegFormerConfig(**TINY), "float32",
                            input_size=64).segment(img)
    got = ts.SegFormerModel(ts.load_segformer(snap, "float32", "cpu").model,
                            input_size=64).segment(torch.from_numpy(img))
    assert ref.shape == (1024, 55) and got.dtype == torch.int32
    assert len(np.unique(ref)) > 1
    np.testing.assert_array_equal(got.numpy(), ref)


def test_jax_loader_reads_the_port_snapshot(snapshot, tmp_path):
    """The port's writer gives a snapshot the JAX package's loader takes,
    with the same logits: the pipeline tests hand both the same files."""
    path = ts.write_synthetic_segformer(
        str(tmp_path / "seg"), ts.SegFormerConfig(**TINY),
        torch.Generator().manual_seed(3))
    x = _x(4)
    ref = js.load_segformer(path, "float32")
    ref = np.asarray(js.segformer_logits(ref.params, jnp.asarray(x), ref.cfg,
                                         "float32"))
    with torch.no_grad():
        got = ts.load_segformer(path, "float32", "cpu").model(
            torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 2e-3
