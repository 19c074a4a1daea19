"""The port's SwinIR against the JAX package's, on the CPU in float32.

The same parameters (the JAX package's ``init_swinir``, with the bias
tables redrawn at std 1 and every bias at std 0.05 from a numpy seed, so
the position bias and the biases move the output) and the same input go
through ``swinir_forward(..., "float32")`` of the JAX package, the port's
``SwinIRModel`` and the independent twin ``tests/torch_twin_swinir.py``.
Bars: max abs error <= 2e-4 on outputs in [0, 1]-ish (float32, different
summation orders); the port's bf16 forward on the CPU within 3e-2 of its
f32 max|out|; pipeline requests within one uint8 level on at most 0.5% of
values of the JAX pipeline's (``tests/test_torch_pipeline.py:_agree``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
from neural_enhanced_super_resolution_torch import pipeline as torch_pipeline
from neural_enhanced_super_resolution_torch.kernels import KernelError
from neural_enhanced_super_resolution_torch.models import (
    RRDBNetConfig, init_rrdbnet, save_state_dict, swinir_params_from_jax)
from neural_enhanced_super_resolution_torch.models import swinir as T
from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                             imwrite_rgb)
from neural_enhanced_super_resolution_tpu import (
    SuperResolutionPipeline as JaxPipeline)
from neural_enhanced_super_resolution_tpu.models import swinir as J

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_pipeline import _agree  # noqa: E402
from torch_twin_swinir import torch_swinir_forward  # noqa: E402

KW = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4,
          mlp_ratio=2.0, num_feat=8, upsampler="nearest+conv", scale=4)
KW_PS = dict(embed_dim=16, depths=(2,), num_heads=(2,), window_size=4,
             mlp_ratio=2.0, num_feat=8, upsampler="pixelshuffle", scale=2)
TINY = T.SwinIRConfig(**KW)          # the JAX tests' TINY
TINY_PS = T.SwinIRConfig(**KW_PS)    # and TINY_PS
ESRGAN = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=1,
              num_grow_ch=4)


def _jax_params(kw, seed=0):
    """The JAX package's flat params (numpy), bias tables std 1, biases
    std 0.05."""
    params = {k: np.asarray(v) for k, v in J.init_swinir(
        jax.random.PRNGKey(seed), J.SwinIRConfig(**kw)).items()}
    rng = np.random.default_rng(seed)
    for k, v in sorted(params.items()):
        if k.endswith("bias_table"):
            params[k] = rng.standard_normal(v.shape).astype(np.float32)
        elif k.endswith(".bias"):
            params[k] = (0.05 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return params


def _port_model(params, cfg, dtype=torch.float32):
    sd = swinir_params_from_jax(params)
    return T.SwinIRModel(cfg, T.swinir_params_from_state_dict(sd), dtype,
                         "cpu")


@pytest.fixture(scope="module")
def swin_ckpt(tmp_path_factory):
    """TINY in the official layout, as a basicsr-style .pth (params_ema)."""
    return save_state_dict(swinir_params_from_jax(_jax_params(KW)), str(
        tmp_path_factory.mktemp("swin") / "swinir_tiny.pth"))


@pytest.fixture(scope="module")
def esrgan_ckpt(tmp_path_factory):
    sd = init_rrdbnet(RRDBNetConfig(**ESRGAN),
                      torch.Generator().manual_seed(3))
    return save_state_dict(sd, str(tmp_path_factory.mktemp("esr")
                                   / "tiny_x4.pth"))


@pytest.mark.parametrize("kw,h,w", [(KW, 12, 16), (KW_PS, 8, 8),
                                    (KW, 10, 14)],
                         ids=["nearest_conv", "pixelshuffle", "pad_10x14"])
def test_forward_matches_jax_and_twin(kw, h, w):
    params = _jax_params(kw)
    x = np.random.default_rng(1).uniform(0, 1, (2, h, w, 3)).astype(
        np.float32)
    ref = np.asarray(J.swinir_forward(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        J.SwinIRConfig(**kw), "float32"))
    cfg = T.SwinIRConfig(**kw)
    got = _port_model(params, cfg)(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        twin = torch_swinir_forward(
            swinir_params_from_jax(params),
            torch.from_numpy(x.transpose(0, 3, 1, 2)), cfg).numpy()
    twin = twin.transpose(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, h * cfg.scale, w * cfg.scale, 3)
    assert np.abs(got - ref).max() <= 2e-4, np.abs(got - ref).max()
    assert np.abs(got - twin).max() <= 2e-4, np.abs(got - twin).max()


def test_static_tables_match_jax():
    """The bias-table index and the shifted-window mask (-100 across
    regions) are the JAX package's."""
    from neural_enhanced_super_resolution_tpu.models.swinir import (
        _relative_position_index, _shift_attn_mask)
    for w in (4, 8):
        np.testing.assert_array_equal(
            T.relative_position_index(w).numpy(), _relative_position_index(w))
    for hp, wp, w in ((8, 12, 4), (272, 272, 8), (16, 8, 8)):
        np.testing.assert_array_equal(T.shift_attn_mask(hp, wp, w, w // 2)
                                      .numpy(),
                                      _shift_attn_mask(hp, wp, w, w // 2))


def test_param_spec_is_the_jax_spec_transposed():
    for kw in (KW, KW_PS, {}):   # {}: the published SwinIR-M x4
        ours = T.swinir_param_shapes(T.SwinIRConfig(**kw))
        theirs = J.swinir_param_shapes(J.SwinIRConfig(**kw))
        assert set(ours) == set(theirs)
        for k, s in theirs.items():
            want = ((s[3], s[2], s[0], s[1]) if len(s) == 4 else
                    (s[1], s[0]) if len(s) == 2 and "bias_table" not in k
                    else s)
            assert ours[k] == tuple(want), k
    init = T.init_swinir(TINY, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        T.swinir_param_shapes(TINY)


@pytest.mark.parametrize("kw", [KW, KW_PS], ids=["nearest_conv",
                                                 "pixelshuffle"])
def test_state_dict_roundtrip_infers_the_config(tmp_path, kw):
    """swinir_params_from_jax -> an official .pth (params_ema, with an
    attn_mask buffer the converter drops) -> load_swinir with no cfg: the
    architecture comes from the checkpoint, and the model is the one built
    from the JAX params."""
    params = _jax_params(kw, seed=2)
    sd = swinir_params_from_jax(params)
    sd["layers.0.residual_group.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
    path = save_state_dict(sd, str(tmp_path / "swin.pth"))
    model = T.load_swinir(path, compute_dtype="float32", device="cpu")
    assert model.cfg == T.SwinIRConfig(**kw)
    x = np.random.default_rng(3).integers(0, 256, (1, 8, 12, 3), np.uint8)
    out = model.upscale_batch(torch.from_numpy(x))
    s = kw["scale"]
    assert out.shape == (1, 8 * s, 12 * s, 3) and out.dtype == torch.uint8
    ref = np.asarray(J.SwinIRModel(
        {k: jnp.asarray(v) for k, v in params.items()},
        J.SwinIRConfig(**kw), "float32").upscale_batch(x))
    diff = np.abs(out.numpy().astype(int) - ref.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 5e-3


def test_bf16_on_cpu_close_to_f32():
    params = _jax_params(KW)
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, 16, 20, 3)).astype(np.float32))
    f32 = _port_model(params, TINY)(x)
    bf16 = _port_model(params, TINY, torch.bfloat16)(x)
    assert bf16.dtype == torch.float32 and torch.isfinite(bf16).all()
    rel = (bf16 - f32).abs().max() / f32.abs().max()
    assert rel <= 3e-2, rel


def _config(tmp_path, who, swin, esrgan=None, **overrides):
    cfg = {"iterations": 1, "use_diffusion": False,
           "segment_enhancement": False, "denoise_level": 0,
           "data_parallel": "off", "use_swinir": True,
           "swinir_model_path": swin, "use_esrgan": esrgan is not None,
           "output_dir": str(tmp_path / who)}
    if esrgan is not None:
        cfg.update(esrgan_model_path=esrgan, esrgan_arch=dict(ESRGAN))
    cfg.update(overrides)
    return cfg


@pytest.mark.parametrize("esrgan,hw,overrides", [
    (False, (24, 28), {}),
    (False, (64, 56), dict(max_tile_size=16, tile_halo=4)),
    (True, (24, 28), {}),
    (True, (64, 56), dict(max_tile_size=16, tile_halo=4,
                          swinir_tile_batch=3)),
], ids=["swinir_whole", "swinir_tiled", "ensemble_whole", "ensemble_tiled"])
def test_request_matches_jax(tmp_path, swin_ckpt, esrgan_ckpt, test_image,
                             esrgan, hw, overrides):
    """enhance_image with SwinIR alone, and with ESRGAN + SwinIR into the
    ensemble, whole and tiled: the JAX pipeline's picture, stages and
    output name. Adaptive sharpening is off: it thresholds a detail map at
    10, so where the two packages' float32 forwards truncate one value to
    neighbouring uint8 levels the mask can flip and that pixel moves by the
    whole unsharp step (11 levels at one pixel in the tiled SwinIR case);
    the sharpening itself is held to the JAX package's in
    tests/test_torch_ops.py."""
    src = str(tmp_path / "in.png")
    imwrite_rgb(src, test_image[:hw[0], :hw[1]])
    out, stages, pipes = {}, {}, {}
    for who, cls in (("jax", JaxPipeline), ("torch", SuperResolutionPipeline)):
        seen = []
        pipes[who] = cls(device="cpu", config=_config(
            tmp_path, who, swin_ckpt, esrgan_ckpt if esrgan else None,
            progress_callback=lambda s, *a, seen=seen: seen.append(s),
            adaptive_sharpening=False, **overrides))
        out[who] = pipes[who].enhance_image(src)
        stages[who] = seen
    assert os.path.basename(out["torch"]) == os.path.basename(out["jax"])
    assert stages["torch"] == stages["jax"] and "SwinIR" in stages["torch"]
    _agree(imread_rgb(out["torch"]), imread_rgb(out["jax"]))
    got = imread_rgb(out["torch"])
    assert got.shape == (hw[0] * 4, hw[1] * 4, 3)
    assert {"swinir", "ensemble"} <= set(pipes["torch"].timer.totals)
    assert ("esrgan" in pipes["torch"].models) == esrgan


def test_missing_weights_skip_the_branch(tmp_path, esrgan_ckpt, test_image,
                                         caplog):
    """Both packages log the failed load, leave SwinIR out and give the
    same ESRGAN-only picture."""
    src = str(tmp_path / "in.png")
    imwrite_rgb(src, test_image[:24, :24])
    images = {}
    with caplog.at_level("WARNING"):
        for who, cls in (("jax", JaxPipeline),
                         ("torch", SuperResolutionPipeline)):
            pipe = cls(device="cpu", config=_config(
                tmp_path, who, str(tmp_path / "missing.pth"), esrgan_ckpt))
            images[who] = imread_rgb(pipe.enhance_image(src))
            assert "swinir" not in pipe.models
            assert "swinir" not in pipe.timer.totals
    assert sum("SwinIR model loading failed" in r.getMessage()
               for r in caplog.records) == 2
    _agree(images["torch"], images["jax"])


def test_registry_path_is_the_jax_one(monkeypatch, tmp_path):
    from neural_enhanced_super_resolution_torch.utils import downloader
    from neural_enhanced_super_resolution_tpu.utils import (
        downloader as jax_downloader)
    monkeypatch.setenv("NESR_MODELS_DIR", str(tmp_path))
    assert downloader.get_model_path("swinir") == \
        jax_downloader.get_model_path("swinir") == \
        str(tmp_path / "weights" / "SwinIR_realSR_M_x4_GAN.pth")


def test_branch_uses_its_own_tile_batch(tmp_path, swin_ckpt, test_image):
    """Tiled SwinIR runs swinir_tile_batch tiles a forward (default 1),
    not the trunk's tile_batch; the batch size changes no pixel."""
    outs, seen = {}, {}
    for batch in (None, 4):
        extra = {} if batch is None else {"swinir_tile_batch": batch}
        pipe = SuperResolutionPipeline("cpu", _config(
            tmp_path, "t", swin_ckpt, max_tile_size=16, tile_halo=4,
            **extra))
        pipe._load_models()
        sizes = []
        model = pipe.models["swinir"]
        orig = model.upscale_batch
        model.upscale_batch = lambda t, orig=orig, sizes=sizes: (
            sizes.append(t.shape[0]) or orig(t))
        outs[batch] = pipe.enhance_array(np.array(test_image[:64, :64]))
        seen[batch] = sizes
    assert set(seen[None]) == {1} and len(seen[None]) == 16
    assert seen[4] == [4, 4, 4, 4]
    np.testing.assert_array_equal(outs[None], outs[4])


@pytest.mark.parametrize("fault", [
    KernelError("planted kernel fault"),
    RuntimeError("CUDA error: planted illegal memory access"),
    ValueError("planted ordinary failure")],
    ids=["kernel", "cuda", "ordinary"])
def test_device_faults_in_swinir_are_not_hidden(tmp_path, swin_ckpt,
                                                esrgan_ckpt, test_image,
                                                monkeypatch, fault):
    """A kernel or CUDA fault in the SwinIR branch ends the request; an
    ordinary failure skips the branch, as in the JAX package."""
    def broken(*args, **kwargs):
        raise fault

    pipe = SuperResolutionPipeline("cpu", _config(tmp_path, "t", swin_ckpt,
                                                  esrgan_ckpt))
    pipe._load_models()
    monkeypatch.setattr(pipe.models["swinir"], "upscale_batch", broken)
    img = np.array(test_image[:24, :24])
    if isinstance(fault, ValueError):
        assert pipe.enhance_array(img).shape == (96, 96, 3)
    else:
        with pytest.raises(type(fault), match="planted"):
            pipe.enhance_array(img)


def test_swinir_vetoes_the_streamed_final(tmp_path, swin_ckpt, esrgan_ckpt,
                                          test_image):
    """With SwinIR on, the last iteration takes the ensemble, not the
    ESRGAN-only streamed tail."""
    pipe = SuperResolutionPipeline("cpu", _config(
        tmp_path, "t", swin_ckpt, esrgan_ckpt, max_tile_size=48,
        tile_halo=8))
    out = pipe.enhance_array(np.array(test_image[:80, :96]))
    assert out.shape == (320, 384, 3)
    assert "esrgan+post/streamed" not in pipe.timer.totals
    assert {"esrgan", "swinir", "ensemble"} <= set(pipe.timer.totals)
    assert not torch_pipeline.SuperResolutionPipeline._stream_final_ok(
        pipe, 0, 1, torch.zeros((80, 96, 3), dtype=torch.uint8))


def test_cancel_during_swinir_tiles_raises(tmp_path, swin_ckpt, test_image):
    """Cancellation between SwinIR tile chunks ends the request as
    EnhancementCancelled, never as a skipped branch."""
    from neural_enhanced_super_resolution_torch.pipeline import (
        EnhancementCancelled)
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 2   # let the iteration start, stop mid-tiles

    pipe = SuperResolutionPipeline("cpu", _config(
        tmp_path, "t", swin_ckpt, max_tile_size=16, tile_halo=4,
        cancel_check=cancel))
    with pytest.raises(EnhancementCancelled, match="SwinIR"):
        pipe.enhance_array(np.array(test_image[:64, :64]))
