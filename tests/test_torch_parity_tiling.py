"""The port's parity tiler (``parity_tiling``) against the JAX package's.

``process_with_tiling_parity`` runs the same numpy processors as the JAX
package's tests (tests/test_tiling.py), wrapped to take and give tensors;
inputs are made with numpy from a seed. Tolerances: at factor 2 the
function's output equals the JAX one's exactly (the same crop arithmetic,
and the port's Lanczos and bicubic resize equal the JAX package's on these
uint8 tiles); at a fractional factor within one level on at most 0.5% of
values (the resize's own rounding). A request through both pipelines on
the CPU in float32 agrees within one uint8 level on at most 0.5% of
values (the bar of tests/test_torch_pipeline.py). Faults: a kernel fault
or a CUDA error in the probe or in a tile propagates, an ordinary
exception takes the bicubic rung, as in the JAX package.
"""

import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_tpu import (
    SuperResolutionPipeline as JaxPipeline)
from neural_enhanced_super_resolution_tpu.parallel.tiling import (
    process_with_tiling_parity as jax_parity)
from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
from neural_enhanced_super_resolution_torch import pipeline as torch_pipeline
from neural_enhanced_super_resolution_torch.kernels import KernelError
from neural_enhanced_super_resolution_torch.models import (
    RRDBNetConfig, init_rrdbnet, save_state_dict)
from neural_enhanced_super_resolution_torch.parallel.tiling import (
    TilingCancelled, process_with_tiling_parity)
from neural_enhanced_super_resolution_torch.pipeline import (
    EnhancementCancelled)

TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=2,
            num_grow_ch=4)


def _x2(tile):
    return np.repeat(np.repeat(tile, 2, axis=0), 2, axis=1)


def _x4(tile):
    return np.repeat(np.repeat(tile, 4, axis=0), 4, axis=1)


def _exploded(tile):
    raise RuntimeError("model exploded")


def _port(proc, img, *args, **kwargs):
    """The port's tiler on a tensor, with a numpy processor."""
    out = process_with_tiling_parity(
        lambda t: torch.from_numpy(np.ascontiguousarray(proc(t.numpy()))),
        torch.from_numpy(img), *args, **kwargs)
    assert out.dtype == torch.uint8
    return out.numpy()


@pytest.mark.parametrize("proc,factor,hw,tile,pad", [
    (_x2, 2, (70, 90), 32, 4),
    (_x4, 2, (70, 90), 32, 4),
    (_x2, 2, (20, 20), 32, 4),
    (_exploded, 2, (70, 90), 32, 4),
], ids=["x2_repeat", "x4_at_factor_2_lanczos", "small_bypasses",
        "probe_failure_bicubic"])
def test_parity_tiler_matches_jax(rng, proc, factor, hw, tile, pad):
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = np.asarray(jax_parity(proc, img, upscale_factor=factor,
                                tile_size=tile, padding=pad))
    got = _port(proc, img, upscale_factor=factor, tile_size=tile,
                padding=pad)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if proc is _x2:
        # away from every seam the stitch is the plain x2 repeat
        assert np.array_equal(got[:60, :60], _x2(img)[:60, :60])


def test_parity_tiler_ragged_factor_matches_jax(rng):
    """A ragged image at factor 1.5: every region is Lanczos-resized at a
    fractional ratio, where the two packages' float32 resize sums round a
    value to neighbouring uint8 levels now and then (measured: 0.21% of
    values, one level); the crop arithmetic is the same."""
    img = rng.integers(0, 256, (61, 47, 3), dtype=np.uint8)
    ref = np.asarray(jax_parity(_x4, img, upscale_factor=1.5, tile_size=24,
                                padding=5)).astype(int)
    got = _port(_x4, img, upscale_factor=1.5, tile_size=24, padding=5)
    assert got.shape == ref.shape == (91, 70, 3)
    diff = np.abs(got.astype(int) - ref)
    assert diff.max() <= 1 and np.mean(diff > 0) <= 5e-3


def test_parity_small_image_calls_the_processor_once(rng):
    img = rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
    calls = []

    def proc(tile):
        calls.append(tile.shape)
        return _x2(tile)

    out = _port(proc, img, 2, tile_size=32, padding=4)
    assert len(calls) == 1 and out.shape == (40, 40, 3)


@pytest.mark.parametrize("where", ["probe", "tile"])
@pytest.mark.parametrize("fault", [
    KernelError("planted kernel fault"),
    RuntimeError("CUDA error: planted illegal memory access")],
    ids=["kernel", "cuda"])
def test_parity_tiler_propagates_device_faults(rng, where, fault):
    """A device fault in the probe or in a later tile ends the call; the
    bicubic rungs are for ordinary failures only."""
    img = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
    calls = []

    def proc(tile):
        calls.append(tile.shape)
        if where == "probe" or len(calls) == 4:
            raise fault
        return _x2(tile)

    with pytest.raises(type(fault), match="planted"):
        _port(proc, img, 2, tile_size=32, padding=4)


def test_parity_tiler_bicubic_rung_for_one_failing_tile(rng):
    """An ordinary exception in one tile gives that tile the bicubic rung,
    as in the JAX package."""
    img = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)

    def flaky():
        calls = []

        def proc(tile):
            calls.append(1)
            if len(calls) == 4:
                raise RuntimeError("model exploded")
            return _x2(tile)
        return proc

    ref = np.asarray(jax_parity(flaky(), img, 2, tile_size=32, padding=4))
    got = _port(flaky(), img, 2, tile_size=32, padding=4)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, _port(_x2, img, 2, tile_size=32,
                                         padding=4))


def test_parity_tiler_cancels_between_tiles(rng):
    img = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
    calls = []

    def proc(tile):
        calls.append(1)
        return _x2(tile)

    with pytest.raises(TilingCancelled):
        _port(proc, img, 2, tile_size=32, padding=4,
              cancel_check=lambda: len(calls) >= 3)
    assert len(calls) == 3


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    sd = init_rrdbnet(RRDBNetConfig(**TINY), torch.Generator().manual_seed(2))
    return save_state_dict(sd, str(tmp_path_factory.mktemp("ckpt")
                                   / "tiny_x4.pth"))


def _config(tmp_path, ckpt, **overrides):
    cfg = {"iterations": 1, "use_diffusion": False,
           "segment_enhancement": False, "denoise_level": 0,
           "data_parallel": "off", "esrgan_model_path": ckpt,
           "esrgan_arch": dict(TINY), "output_dir": str(tmp_path),
           "parity_tiling": True, "max_tile_size": 48, "tile_halo": 8}
    cfg.update(overrides)
    return cfg


@pytest.mark.parametrize("overrides", [
    dict(max_megapixels=0.001),
    dict(memory_efficient=True),
], ids=["tiled_canvas", "memory_efficient"])
def test_parity_request_matches_jax(tmp_path, ckpt, test_image, overrides):
    """A parity-tiling request (each tile through the whole-image forward,
    stitched on the configured x2 canvas) through both pipelines."""
    img = np.array(test_image[:100, :84])
    outs = {}
    for who, cls in (("jax", JaxPipeline),
                     ("torch", SuperResolutionPipeline)):
        pipe = cls(device="cpu", config=_config(tmp_path / who, ckpt,
                                                **overrides))
        outs[who] = np.asarray(pipe.enhance_array(img)).astype(int)
    assert outs["torch"].shape == outs["jax"].shape == (200, 168, 3)
    diff = np.abs(outs["torch"] - outs["jax"])
    assert diff.max() <= 1 and np.mean(diff > 0) <= 5e-3, (
        diff.max(), np.mean(diff > 0))


def test_parity_request_runs_the_parity_tiler(tmp_path, ckpt, test_image,
                                              monkeypatch):
    seen = []
    real = torch_pipeline.process_with_tiling_parity

    def spy(*args, **kwargs):
        seen.append(kwargs["tile_size"])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_pipeline, "process_with_tiling_parity", spy)
    pipe = SuperResolutionPipeline("cpu", _config(tmp_path, ckpt,
                                                  memory_efficient=True))
    out = pipe.enhance_array(np.array(test_image[:100, :84]))
    assert seen == [48] and out.shape == (200, 168, 3)
    assert "esrgan+post/streamed" not in pipe.timer.totals


@pytest.mark.parametrize("fault", [KernelError, RuntimeError])
def test_parity_request_does_not_hide_a_kernel_fault(tmp_path, ckpt,
                                                     test_image, monkeypatch,
                                                     fault):
    """A KernelError inside a tile (not the probe) propagates out of the
    request instead of becoming a bicubic image; an ordinary error in
    every forward takes the JAX package's ladder down to a picture."""
    calls = []
    real = torch_pipeline.esrgan_step

    def broken(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            raise fault("planted kernel fault")
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_pipeline, "esrgan_step", broken)
    pipe = SuperResolutionPipeline("cpu", _config(tmp_path, ckpt,
                                                  memory_efficient=True))
    img = np.array(test_image[:100, :84])
    if fault is KernelError:
        with pytest.raises(KernelError, match="planted"):
            pipe.enhance_array(img)
    else:
        assert pipe.enhance_array(img).shape == (200, 168, 3)


def test_parity_request_cancels(tmp_path, ckpt, test_image):
    polls = []

    def cancel():
        polls.append(1)
        return len(polls) > 3

    pipe = SuperResolutionPipeline("cpu", _config(
        tmp_path, ckpt, memory_efficient=True, cancel_check=cancel))
    with pytest.raises(EnhancementCancelled):
        pipe.enhance_array(np.array(test_image[:100, :84]))
