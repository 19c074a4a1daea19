"""The port's GUI layer against the JAX package's, on the CPU (no Qt here).

The controller's cases of tests/test_gui_controller.py run on both
controllers side by side: the presets and settings (``to_config`` equal
for every preset), the degradation state machine, the workers' events,
cancellation and errors, the zoom and view math; and ``--gui`` without
PyQt5 exits 2 with the JAX CLI's message.
"""

import dataclasses
import time

import numpy as np
import pytest

from neural_enhanced_super_resolution_torch.cli import main as torch_cli
from neural_enhanced_super_resolution_torch.gui import app as torch_app
from neural_enhanced_super_resolution_torch.gui import controller as ours
from neural_enhanced_super_resolution_torch.runtime.config import (
    default_config)
from neural_enhanced_super_resolution_tpu import cli as jax_cli
from neural_enhanced_super_resolution_tpu.gui import controller as theirs


@pytest.mark.parametrize("preset", sorted(theirs.PRESETS))
def test_presets_and_settings_match_jax(preset):
    assert ours.PRESETS == theirs.PRESETS
    assert [(f.name, f.default) for f in dataclasses.fields(
        ours.EnhancementSettingsState)] == [
        (f.name, f.default) for f in dataclasses.fields(
            theirs.EnhancementSettingsState)]
    s, t = ours.EnhancementSettingsState(), theirs.EnhancementSettingsState()
    s.apply_preset(preset)
    t.apply_preset(preset)
    assert dataclasses.asdict(s) == dataclasses.asdict(t)
    assert s.to_config() == t.to_config()
    assert set(s.to_config()) <= set(default_config())


def test_degradation_state_machine_matches_jax(test_image):
    img = np.ascontiguousarray(test_image[:64, :96])
    states = {"ours": ours.DegradationState(),
              "theirs": theirs.DegradationState()}
    outs = {}
    for who, d in states.items():
        with pytest.raises(ValueError):
            d.preview()
        with pytest.raises(ValueError):
            d.apply()
        d.load(img)
        outs[who] = d.preview(downscale=0.5, blur_radius=1, jpeg_quality=80)
        assert np.array_equal(d.apply(), outs[who])
        assert np.array_equal(d.reset(), img) and d.degraded is None
    assert outs["ours"].shape == outs["theirs"].shape == (32, 48, 3)
    diff = np.abs(outs["ours"].astype(int) - outs["theirs"].astype(int))
    assert diff.max() <= 2 and np.mean(diff > 0) <= 0.02
    d = states["ours"]
    d.load(img)
    noisy = d.preview(noise_amount=0.05, generator=3)
    assert noisy.shape == img.shape and not np.array_equal(noisy, img)
    assert np.array_equal(noisy, d.preview(noise_amount=0.05, generator=3))


class _FakePipeline:
    def __init__(self, delay=0.0, fail=False, iterations=3):
        self.config = {"iterations": iterations}
        self.delay = delay
        self.fail = fail

    def enhance_image(self, path, prompt=None):
        cb = self.config.get("progress_callback")
        for i in range(self.config["iterations"]):
            if self.config["cancel_check"]():
                from neural_enhanced_super_resolution_torch.pipeline import (
                    EnhancementCancelled)
                raise EnhancementCancelled("stopped")
            cb("Enhancement", i, self.config["iterations"], f"iter {i}")
            if self.delay:
                time.sleep(self.delay)
        if self.fail:
            raise RuntimeError("boom")
        self.config["image_callback"](np.zeros((4, 4, 3), np.uint8))
        cb("Complete", self.config["iterations"],
           self.config["iterations"], "done")
        return "out.png"


def test_enhancement_worker_events_error_and_cancel():
    events = {"progress": [], "finished": [], "images": [], "errors": []}
    w = ours.EnhancementWorker(
        _FakePipeline(), "in.png",
        on_progress=lambda *a: events["progress"].append(a),
        on_image=lambda im: events["images"].append(im.shape),
        on_finished=events["finished"].append)
    w.start()
    w.join(10)
    assert events["finished"] == ["out.png"]
    assert events["images"] == [(4, 4, 3)]
    assert [e[0] for e in events["progress"]] == ["Enhancement"] * 3 + [
        "Complete"]
    assert not w.running

    w = ours.EnhancementWorker(_FakePipeline(fail=True), "in.png",
                               on_error=events["errors"].append)
    w.start()
    w.join(10)
    assert events["errors"] == ["boom"]

    progressed = []
    w = ours.EnhancementWorker(
        _FakePipeline(delay=0.05, iterations=100), "in.png",
        on_progress=lambda *a: progressed.append(a),
        on_finished=lambda p: progressed.append(("FINISHED",)))
    w.start()
    time.sleep(0.2)
    w.stop()
    w.join(10)
    assert not w._thread.is_alive()
    assert ("FINISHED",) not in progressed and len(progressed) < 100


def test_model_download_worker_and_status(tmp_path, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    monkeypatch.setenv("NESR_MODELS_DIR", str(tmp_path))
    status = ours.check_model_status()
    assert status == theirs.check_model_status()
    assert status["missing_required"] == ["esrgan_x2", "sd_upscaler",
                                          "segmentation"]
    from neural_enhanced_super_resolution_torch.utils import downloader
    monkeypatch.setattr(downloader, "download_models",
                        lambda keys, cb: {k: True for k in keys})
    done = []
    w = ours.ModelDownloadWorker(["swinir"], on_finished=done.append)
    w.start()
    w.join(10)
    assert done == [{"swinir": True}]


@pytest.mark.parametrize("image_hw,viewport_hw", [
    ((100, 200), (50, 200)), ((100, 100), (1000, 50)), ((10, 10), (1e4, 1e4)),
    ((1e4, 1e4), (10, 10)), ((0, 10), (10, 10))])
def test_fit_zoom_matches_jax(image_hw, viewport_hw):
    assert ours.fit_zoom(image_hw, viewport_hw) == \
        theirs.fit_zoom(image_hw, viewport_hw)


@pytest.mark.parametrize("mode,split,after_hw", [
    ("side-by-side", 0.5, (20, 30)), ("split", 0.3, (20, 30)),
    ("split", 0.5, (80, 120)), ("before", 0.5, (20, 30)),
    ("after", 0.5, (20, 30)), ("side-by-side", 0.5, (40, 60))])
def test_compose_view_matches_jax(test_image, mode, split, after_hw):
    before = np.ascontiguousarray(test_image[:20, :30])
    after = np.ascontiguousarray(test_image[:after_hw[0], :after_hw[1]])
    got = ours.compose_view(before, after, mode, split)
    ref = np.asarray(theirs.compose_view(before, after, mode, split))
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert ours.compose_view(None, None) is None
    assert ours.VIEW_MODES == theirs.VIEW_MODES
    for x, width in ((0, 100), (99, 100), (50, 101), (-5, 100), (3, 1)):
        assert ours.drag_split_position(x, width) == \
            theirs.drag_split_position(x, width)


def test_gui_without_qt_exits_2_with_the_jax_message(capsys):
    if torch_app.HAS_QT:
        pytest.skip("PyQt5 is installed: the no-Qt path does not run")
    with pytest.raises(ImportError):
        torch_app.NESRApplication()

    class FakeApp:
        def setStyle(self, name):  # noqa: N802 - the Qt name
            self.style = name

    assert torch_app.apply_theme(FakeApp()) in ("qtmodern-dark", "fusion",
                                                "default")
    assert jax_cli.launch_gui() == 2
    want = capsys.readouterr().out
    assert want.startswith("GUI unavailable (")
    for argv in (["--gui"], []):
        assert torch_cli(argv) == 2
        assert capsys.readouterr().out == want
