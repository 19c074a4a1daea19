"""The port's product path against the JAX package's, on the CPU in float32.

Both pipelines load the same tiny basicsr checkpoint (seeded synthetic
weights) and, where segmentation is on, the same tiny SegFormer snapshot,
with the same config, and enhance the same image. Bar: uint8 outputs
differ by at most one level on at most 0.5% of pixels, the progress
callbacks name the same stages, and the saved file has the same name.
Also: the port imports without JAX, the JAX package's default config
merges and runs, and a request for the GPU without one raises instead of
moving to the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
from neural_enhanced_super_resolution_torch import pipeline as torch_pipeline
from neural_enhanced_super_resolution_torch.cli import main as torch_cli
from neural_enhanced_super_resolution_torch.kernels import (KernelError,
                                                            KernelInputError)
from neural_enhanced_super_resolution_torch.models import (
    RRDBNetConfig, init_rrdbnet, save_state_dict)
from neural_enhanced_super_resolution_torch.models.segformer import (
    SegFormerConfig, write_synthetic_segformer)
from neural_enhanced_super_resolution_torch.runtime.config import merge_config
from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                             imwrite_rgb)
from neural_enhanced_super_resolution_tpu import (
    SuperResolutionPipeline as JaxPipeline)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=2,
            num_grow_ch=4)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    sd = init_rrdbnet(RRDBNetConfig(**TINY), torch.Generator().manual_seed(0))
    return save_state_dict(sd, str(tmp_path_factory.mktemp("ckpt")
                                   / "tiny_x4.pth"))


@pytest.fixture(scope="module")
def seg_snapshot(tmp_path_factory):
    """A tiny SegFormer (as tests/test_segformer.py) in the HF layout."""
    cfg = SegFormerConfig(depths=[1, 1, 1, 1], sr_ratios=[4, 2, 2, 1],
                          hidden_sizes=[8, 16, 16, 32],
                          num_attention_heads=[1, 2, 2, 4],
                          mlp_ratios=[2, 2, 2, 2], decoder_hidden_size=16,
                          num_labels=10)
    return write_synthetic_segformer(str(tmp_path_factory.mktemp("seg")),
                                     cfg, torch.Generator().manual_seed(0))


def _config(tmp_path, ckpt, who, **overrides):
    cfg = {"iterations": 1, "use_diffusion": False,
           "segment_enhancement": False, "denoise_level": 0,
           "data_parallel": "off", "esrgan_model_path": ckpt,
           "esrgan_arch": dict(TINY), "output_dir": str(tmp_path / who)}
    cfg.update(overrides)
    return cfg


def _agree(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff > 0) <= 5e-3, np.mean(diff > 0)


def _default_config(tmp_path, ckpt, who, **overrides):
    """The JAX package's default config with only the model paths and the
    output directory set (the SD x4 snapshot resolves through the model
    registry and is missing, so both packages turn that branch off)."""
    cfg = {"esrgan_model_path": ckpt, "esrgan_arch": dict(TINY),
           "output_dir": str(tmp_path / who)}
    cfg.update(overrides)
    return cfg


def _run_both(tmp_path, src, make_config, **overrides):
    paths, images, stages, pipes = {}, {}, {}, {}
    for who, cls in (("jax", JaxPipeline), ("torch", SuperResolutionPipeline)):
        seen = []
        cfg = make_config(
            who, progress_callback=lambda s, *a, seen=seen: seen.append(s),
            **overrides)
        pipes[who] = cls(device="cpu", config=cfg)
        paths[who] = pipes[who].enhance_image(src)
        images[who] = imread_rgb(paths[who])
        stages[who] = seen
    assert os.path.basename(paths["torch"]) == os.path.basename(paths["jax"])
    assert stages["torch"] == stages["jax"]
    _agree(images["torch"], images["jax"])
    return pipes, stages["torch"]


@pytest.mark.parametrize("hw,iterations,overrides", [
    ((40, 36), 1, {}),
    ((64, 80), 1, dict(max_megapixels=0.001, max_tile_size=48, tile_halo=8)),
    ((80, 96), 1, dict(max_tile_size=48, tile_halo=8)),
    ((24, 24), 2, dict(max_tile_size=48, tile_halo=8)),
    ((40, 36), 1, dict(denoise_level=0.5)),
    ((48, 40), 1, dict(segment_enhancement=True)),
], ids=["whole", "tiled_canvas", "streamed_final", "two_iterations",
        "denoise", "segmentation"])
def test_pipeline_matches_jax(tmp_path, ckpt, seg_snapshot, test_image, hw,
                              iterations, overrides):
    src = str(tmp_path / "input.png")
    imwrite_rgb(src, test_image[:hw[0], :hw[1]])
    if overrides.get("segment_enhancement"):
        overrides = dict(overrides, segmentation_model_path=seg_snapshot)
    pipes, stages = _run_both(
        tmp_path, src, lambda who, **kw: _config(
            tmp_path, ckpt, who, iterations=iterations, **kw), **overrides)
    assert ("Segmentation" in stages) == bool(
        overrides.get("segment_enhancement"))
    assert ("pre/denoise" in pipes["torch"].timer.totals) == bool(
        overrides.get("denoise_level"))


def test_default_config_matches_jax(tmp_path, ckpt, seg_snapshot,
                                    test_image, monkeypatch):
    """The JAX package's defaults (3 iterations, denoise 0.5, segmentation,
    diffusion) run through the port and give the JAX package's picture."""
    monkeypatch.setenv("NESR_MODELS_DIR", str(tmp_path / "models"))
    src = str(tmp_path / "input.png")
    imwrite_rgb(src, test_image[:8, :8])
    pipes, stages = _run_both(
        tmp_path, src, lambda who, **kw: _default_config(
            tmp_path, ckpt, who, segmentation_model_path=seg_snapshot, **kw))
    assert stages.count("Segmentation") == 3 and "Diffusion" not in stages
    assert {"pre/denoise", "pre/contrast", "segmentation"} <= set(
        pipes["torch"].timer.totals)
    assert set(pipes["torch"].models) == {"esrgan", "segmentation"}


def test_missing_segmentation_snapshot_disables_the_branch(
        tmp_path, ckpt, test_image, caplog):
    """Both packages log the error, turn segmentation off and give the
    same picture."""
    src = str(tmp_path / "input.png")
    imwrite_rgb(src, test_image[:40, :36])
    with caplog.at_level("ERROR"):
        pipes, stages = _run_both(
            tmp_path, src, lambda who, **kw: _config(tmp_path, ckpt, who,
                                                     **kw),
            segment_enhancement=True,
            segmentation_model_path=str(tmp_path / "no_such_snapshot"))
    assert "Segmentation" not in stages
    for pipe in pipes.values():
        assert "segmentation" not in pipe.models
        assert not pipe.config["segment_enhancement"]
    assert sum("Error loading segmentation model" in r.getMessage()
               for r in caplog.records) == 2


def test_streamed_final_engages_and_matches_standard_chain(tmp_path, ckpt,
                                                           test_image):
    img = np.array(test_image[:80, :96])
    outs = {}
    for streamed in (True, False):
        pipe = SuperResolutionPipeline("cpu", _config(
            tmp_path, ckpt, "t", max_tile_size=48, tile_halo=8,
            streamed_output=streamed))
        outs[streamed] = pipe.enhance_array(img)
        assert ("esrgan+post/streamed" in pipe.timer.totals) == streamed
    # tiled sharpening sees each tile's halo, not the whole image: the same
    # pixels except within the usual tiled-op border band
    core = (slice(40, -40), slice(40, -40))
    np.testing.assert_array_equal(outs[True][core], outs[False][core])


def test_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import neural_enhanced_super_resolution_torch.pipeline\n"
            "import neural_enhanced_super_resolution_torch.cli\n"
            "import neural_enhanced_super_resolution_torch.kernels\n"
            "import neural_enhanced_super_resolution_torch.ops.nlmeans\n"
            "import neural_enhanced_super_resolution_torch.models.segformer\n"
            "import neural_enhanced_super_resolution_torch.models.swinir\n"
            "import neural_enhanced_super_resolution_torch.runtime.executor\n"
            "import neural_enhanced_super_resolution_torch.runtime.native\n"
            "import neural_enhanced_super_resolution_torch.gui\n"
            "import neural_enhanced_super_resolution_torch.utils\n"
            "import neural_enhanced_super_resolution_torch.utils.downloader\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m, v in sys.modules.items() if v is not None)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


def test_cuda_request_without_gpu_raises(tmp_path, ckpt, test_image,
                                         monkeypatch, capsys):
    """Without a GPU, "cuda", "auto" and the defaults of the pipeline and
    the CLI raise; nothing moves to the CPU unless "cpu" is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"use_diffusion": False, "segment_enhancement": False,
           "denoise_level": 0, "output_dir": str(tmp_path)}
    for device in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            SuperResolutionPipeline(device=device, config=cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SuperResolutionPipeline(config=cfg)
    src = str(tmp_path / "in.png")
    imwrite_rgb(src, test_image[:16, :16])
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(_config(tmp_path, ckpt, "cli"), f)
    out = str(tmp_path / "res" / "final.png")
    assert torch_cli(["--cli", "-i", src, "-c", cfg_path, "-n", "1",
                      "-o", out]) == 1
    assert "no CUDA GPU" in capsys.readouterr().out
    assert not os.path.exists(out)
    pipe = SuperResolutionPipeline(device="cpu", config=cfg)
    assert pipe.device == "cpu" and pipe.config["precision"] == "float32"


@pytest.mark.parametrize("key,value", [
    ("esrgan_trunk", "s2d"), ("parity_tiling", True),
    ("esrgan_trunk", "int8")])
def test_unported_features_raise(tmp_path, ckpt, test_image, key, value):
    """The three config modes this port once refused (the name is kept
    from then) now merge and run: a tiny tiled CPU request against the JAX
    pipeline's, within one uint8 level on at most 0.5% of values. "s2d"
    runs the fused trunk in both packages. For "int8" the JAX ESRGAN step
    runs op by op: jitted, XLA keeps the trunk's conv outputs in float32
    where its code rounds them to bf16 (tests/test_torch_int8.py)."""
    import jax
    merged = merge_config("cpu", {key: value})
    assert merged[key] == value
    src = str(tmp_path / "input.png")
    imwrite_rgb(src, test_image[:64, :80])
    images = {}
    for who, cls in (("jax", JaxPipeline), ("torch", SuperResolutionPipeline)):
        pipe = cls(device="cpu", config=_config(
            tmp_path, ckpt, who, max_megapixels=0.001, max_tile_size=48,
            tile_halo=8, **{key: value}))
        if who == "jax" and value == "int8":
            step = pipe._esrgan_batch_forward

            def op_by_op(tiles, three_channel, step=step):
                with jax.disable_jit():
                    return step(tiles, three_channel)

            pipe._esrgan_batch_forward = op_by_op
        images[who] = imread_rgb(pipe.enhance_image(src))
        if who == "torch":
            trunk = pipe.models["esrgan"]["model"].trunk
            assert trunk == ("int8" if value == "int8" else "fused")
    assert images["torch"].shape == (128, 160, 3)
    _agree(images["torch"], images["jax"])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_default_config_merges_like_jax(device):
    """No config at all: nothing raises, and every key but the device
    overlays (the cuda one; the tpu one's remote-host switches prewarm and
    fallback_to_cpu), the port's esrgan_trunk and the JAX package's
    sub-stage switch equals the JAX package's defaults on the CPU."""
    from neural_enhanced_super_resolution_tpu.runtime.config import (
        merge_config as jax_merge)
    ours, theirs = merge_config(device, None), jax_merge("cpu", None)
    assert ours["segment_enhancement"] and ours["denoise_level"] == 0.5
    overlay = set(ours["device_specific"].get(device, {}))
    # the JAX package's switch for synced diffusion sub-stages: the port
    # traces them always, unsynced (runtime/profiler)
    jax_only = {k for k in theirs if k.endswith("_stage_detail")}
    assert len(jax_only) == 1
    assert set(ours) ^ set(theirs) <= ({"esrgan_trunk", "prewarm"} | overlay
                                       | jax_only)
    differ = {k for k in set(ours) & set(theirs) if ours[k] != theirs[k]}
    assert differ <= {"device_specific"} | overlay, differ


def test_cuda_overlay_tiles_like_the_tpu_overlay():
    from neural_enhanced_super_resolution_tpu.runtime.config import (
        merge_config as jax_merge)
    base = {"use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0}
    ours, theirs = merge_config("cuda", base), jax_merge("tpu", base)
    for key in ("max_megapixels", "max_tile_size", "tile_halo", "tile_batch"):
        assert ours[key] == theirs[key], key
    assert ours["tile_tail"] == "bucket" and "prewarm" not in ours


def test_dform_trunk_in_float32_runs_the_fused_trunk_as_jax(tmp_path, ckpt,
                                                           test_image):
    """As in the JAX package, dform applies in bfloat16 only: a float32
    request runs the fused trunk, here a tiny tiled CPU request against the
    JAX pipeline's (the bar of the config tests)."""
    src = str(tmp_path / "input.png")
    imwrite_rgb(src, test_image[:64, :80])
    pipes, _ = _run_both(tmp_path, src, lambda who, **kw: _config(
        tmp_path, ckpt, who, max_megapixels=0.001, max_tile_size=48,
        tile_halo=8, esrgan_trunk="dform", **kw))
    assert pipes["torch"].models["esrgan"]["model"].trunk == "fused"


def test_float32_request_matches_jax(tmp_path, ckpt, test_image):
    """precision "float32", the JAX package's parity mode, asked for: the
    request (streamed final) against the JAX pipeline in float32."""
    src = str(tmp_path / "input.png")
    imwrite_rgb(src, test_image[:80, :96])
    pipes, _ = _run_both(tmp_path, src, lambda who, **kw: _config(
        tmp_path, ckpt, who, precision="float32", max_tile_size=48,
        tile_halo=8, **kw))
    assert pipes["torch"].config["precision"] == "float32"
    assert "esrgan+post/streamed" in pipes["torch"].timer.totals


def test_float32_on_the_gpu_runs_the_float32_kernels(tmp_path, ckpt,
                                                     monkeypatch, caplog):
    """float32 on cuda is a mode, not a refusal: the pipeline turns TF32
    off and says, once, that the kernels' float32 forms run."""
    import logging
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with caplog.at_level(logging.INFO, logger="nesr"):
        pipe = SuperResolutionPipeline("cuda", _config(
            tmp_path, ckpt, "t", precision="float32", esrgan_trunk="dform"))
    assert pipe.config["precision"] == "float32"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert sum("the kernels' float32 forms run" in r.getMessage()
               for r in caplog.records) == 1


@pytest.mark.parametrize("overrides,match", [
    (dict(precision="bfloat16", esrgan_trunk="dform"), "64 features"),
], ids=["dform_narrow_width"])
def test_gpu_config_the_kernels_cannot_run_raises(tmp_path, ckpt, monkeypatch,
                                                  overrides, match):
    """What the kernels do not take is refused up front on the GPU, instead
    of failing every rung of the ladder down to a bicubic image."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=match):
        SuperResolutionPipeline("cuda", _config(tmp_path, ckpt, "t",
                                                **overrides))._load_models()


def test_dform_trunk_bf16_through_the_product_path(tmp_path, ckpt,
                                                   test_image):
    """bf16 on the CPU takes every kernel's plain version: the K2 trunk and
    the K1 trunk give the same picture up to bf16 rounding."""
    img = np.array(test_image[:40, :40])
    outs = [SuperResolutionPipeline("cpu", _config(
        tmp_path, ckpt, "t", precision="bfloat16", esrgan_trunk=trunk)
    ).enhance_array(img).astype(int) for trunk in (None, "dform")]
    assert outs[0].shape == (160, 160, 3)
    assert np.mean(np.abs(outs[0] - outs[1])) < 1.0


@pytest.mark.parametrize("fault", [
    KernelError("planted kernel fault"),
    RuntimeError("CUDA error: planted illegal memory access"),
    ValueError("planted ordinary failure")],
    ids=["kernel", "cuda", "ordinary"])
@pytest.mark.parametrize("stage", ["denoise", "segmentation",
                                   "masked_sharpen"])
def test_device_faults_in_the_new_stages_are_not_hidden(
        tmp_path, ckpt, seg_snapshot, test_image, monkeypatch, stage, fault):
    """A kernel or CUDA fault in the denoise, segmentation or masked-sharpen
    stage ends the request; an ordinary failure skips the step, as in the
    JAX package."""
    def broken(*args, **kwargs):
        raise fault

    pipe = SuperResolutionPipeline("cpu", _config(
        tmp_path, ckpt, "t", denoise_level=0.5, segment_enhancement=True,
        segmentation_model_path=seg_snapshot))
    pipe._load_models()
    if stage == "segmentation":
        monkeypatch.setattr(pipe.models["segmentation"], "segment", broken)
    else:
        monkeypatch.setattr(torch_pipeline, {
            "denoise": "denoise_stage",
            "masked_sharpen": "masked_sharpen"}[stage], broken)
    img = np.array(test_image[:24, :24])
    if isinstance(fault, ValueError):
        assert pipe.enhance_array(img).shape == (96, 96, 3)
    else:
        with pytest.raises(type(fault), match="planted"):
            pipe.enhance_array(img)


@pytest.mark.parametrize("fault", [KernelError, KernelInputError])
@pytest.mark.parametrize("hw", [(40, 40), (150, 136)],
                         ids=["whole", "streamed"])
def test_kernel_faults_are_not_hidden_by_the_ladder(tmp_path, ckpt,
                                                    test_image, monkeypatch,
                                                    fault, hw):
    """A kernel that fails, or a wrapper that refuses its input, ends the
    request instead of falling down the ladder to a bicubic image."""
    def broken(*args, **kwargs):
        raise fault("planted kernel fault")

    monkeypatch.setattr(torch_pipeline, "esrgan_step", broken)
    pipe = SuperResolutionPipeline("cpu", _config(tmp_path, ckpt, "t"))
    with pytest.raises(fault, match="planted"):
        pipe.enhance_array(np.array(test_image[:hw[0], :hw[1]]))


def test_missing_weights_fall_back_to_bicubic(tmp_path, test_image):
    pipe = SuperResolutionPipeline("cpu", _config(
        tmp_path, str(tmp_path / "nonexistent.pth"), "t"))
    assert pipe.enhance_array(np.array(test_image[:40, :40])).shape == \
        (80, 80, 3)


def test_cancel_raises(tmp_path, ckpt, test_image):
    from neural_enhanced_super_resolution_torch.pipeline import (
        EnhancementCancelled)
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 1   # let the iteration start, stop mid-tiles

    pipe = SuperResolutionPipeline("cpu", _config(
        tmp_path, ckpt, "t", max_tile_size=24, tile_batch=1, tile_halo=4,
        cancel_check=cancel))
    with pytest.raises(EnhancementCancelled):
        pipe.enhance_array(np.array(test_image[:64, :64]))


def test_cli_single_image_and_clean_errors(tmp_path, ckpt, test_image,
                                           capsys):
    src = str(tmp_path / "in.png")
    imwrite_rgb(src, test_image[:32, :32])
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(_config(tmp_path, ckpt, "cli"), f)
    out = str(tmp_path / "res" / "final.png")
    assert torch_cli(["--cli", "-i", src, "-c", cfg, "-n", "1", "-o", out,
                      "-d", "cpu"]) == 0
    assert imread_rgb(out).shape == (128, 128, 3)
    # a directory is batch mode: its one image, named {base}_enhanced{ext}
    batch = str(tmp_path / "batch_out")
    assert torch_cli(["--cli", "-i", str(tmp_path), "-c", cfg, "-n", "1",
                      "-o", batch, "-d", "cpu"]) == 0
    assert os.listdir(batch) == ["in_enhanced.png"]
    assert imread_rgb(os.path.join(batch, "in_enhanced.png")).shape == \
        (128, 128, 3)
    assert "Batch complete: 1/1 succeeded" in capsys.readouterr().out
    assert torch_cli(["--cli"]) == 2


def test_batch_executor_keeps_order_and_survives_a_failed_load(tmp_path,
                                                               test_image):
    from neural_enhanced_super_resolution_torch.runtime.executor import (
        BatchExecutor)
    good1, good2 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    bad = str(tmp_path / "missing.png")
    imwrite_rgb(good1, test_image[:16, :16])
    imwrite_rgb(good2, test_image[:8, :12])

    class FakePipe:
        def enhance_array(self, img, prompt=None, iterations=None):
            return np.repeat(np.repeat(img, 2, 0), 2, 1)

    with BatchExecutor(FakePipe(), prefetch=2) as ex:
        results = list(ex.map_paths([good1, bad, good2]))
    assert [p for p, _ in results] == [good1, bad, good2]
    assert results[0][1].shape == (32, 32, 3)
    assert isinstance(results[1][1], ValueError)
    assert results[2][1].shape == (16, 24, 3)


def test_batch_executor_closes_after_an_abandoned_iteration():
    """Abandoning map_paths early must not deadlock close() or leak the
    staging thread blocked on the bounded queue."""
    import threading
    import time

    from neural_enhanced_super_resolution_torch.runtime.executor import (
        BatchExecutor)

    class FakePipe:
        def enhance_array(self, img, prompt=None):
            return img

    n_before = threading.active_count()
    ex = BatchExecutor(FakePipe(), prefetch=1,
                       loader=lambda p: np.zeros((4, 4, 3), np.uint8))
    it = ex.map_paths([f"img{i}" for i in range(50)])
    next(it)  # consume one, then abandon: the staging thread blocks on put
    t0 = time.time()
    ex.close()
    assert time.time() - t0 < 3.0, "close() hung"
    deadline = time.time() + 2.0
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= n_before, "staging thread leaked"


def test_cli_batch_mode_over_a_directory(tmp_path, ckpt, test_image,
                                         capsys):
    """Every image of the directory through one pipeline: the JAX package's
    names, a FAILED line for the unreadable file, exit 1, the others
    written; an image-free directory exits 2."""
    src = tmp_path / "imgs"
    src.mkdir()
    imwrite_rgb(str(src / "one.png"), test_image[:16, :16])
    imwrite_rgb(str(src / "two.jpg"), test_image[:12, :20])
    (src / "broken.png").write_bytes(b"not an image")
    (src / "notes.txt").write_text("skipped: not an image extension")
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(_config(tmp_path, ckpt, "unused"), f)
    out = tmp_path / "out"
    rc = torch_cli(["--cli", "-i", str(src), "-c", cfg, "-n", "1", "-o",
                    str(out), "-d", "cpu", "--no_diffusion"])
    text = capsys.readouterr().out
    assert rc == 1
    assert f"FAILED {src / 'broken.png'}" in text
    assert "Batch complete: 2/3 succeeded" in text
    assert sorted(os.listdir(out)) == ["one_enhanced.png", "two_enhanced.jpg"]
    assert imread_rgb(str(out / "one_enhanced.png")).shape == (64, 64, 3)
    assert imread_rgb(str(out / "two_enhanced.jpg")).shape == (48, 80, 3)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert torch_cli(["--cli", "-i", str(empty), "-d", "cpu"]) == 2
    assert "No images found" in capsys.readouterr().out


def test_cli_batch_mode_drops_intermediate_saves(tmp_path, ckpt, test_image):
    """As in the JAX package, --intermediate_saves is dropped for a
    directory (every image would overwrite intermediate_iter{n}.png); a
    single image still writes them."""
    src = tmp_path / "imgs"
    src.mkdir()
    imwrite_rgb(str(src / "a.png"), test_image[:16, :16])
    imwrite_rgb(str(src / "b.png"), test_image[:12, :20])
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(_config(tmp_path, ckpt, "unused"), f)
    out = tmp_path / "out"
    assert torch_cli(["--cli", "-i", str(src), "-c", cfg, "-n", "2", "-o",
                      str(out), "-d", "cpu", "--intermediate_saves"]) == 0
    assert sorted(os.listdir(out)) == ["a_enhanced.png", "b_enhanced.png"]
    single = tmp_path / "single"
    assert torch_cli(["--cli", "-i", str(src / "a.png"), "-c", cfg, "-n",
                      "1", "-o", str(single / "r.png"), "-d", "cpu",
                      "--intermediate_saves"]) == 0
    assert "intermediate_iter1.png" in os.listdir(single)
