"""A whole run on the CPU at test size, past the look for a chip: sound,
it is correct; with the timed path broken underneath, it is not. The
faults a one-chip serving cell can have: a denoise step that returns its
state unchanged, half of a batch left out (the tile batch, the CFG pair),
an answer altered where it is produced. (No cell spans chips, so there is
no exchange between chips to leave out.)"""

import time

import pytest
import torch

from conftest import tiny_cell
from portbench import harness


def _run(which, seed, fault=None, seconds=None):
    res, rows = harness.run(tiny_cell(which), seed,
                            seconds or {"esrgan": 8.0, "sdx4": 3.0}[which],
                            False, time.perf_counter(), "cpu", None,
                            fault=fault, log=lambda m: None)
    return res, {k: v for k, v, _ in rows}


@pytest.mark.parametrize("which", ["esrgan", "sdx4"])
def test_sound_run_is_correct(which):
    res, nums = _run(which, 2 ** 31 + 5)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert {"setup_s", "mp_out_per_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"


def _alter_block(out):
    out = out.clone()
    out[..., :64, :64, :] = torch.clamp(out[..., :64, :64, :].int() + 64,
                                        0, 255).to(out.dtype)
    return out


def _tiles_half(system):
    pipe = system.pipeline
    orig = pipe._esrgan_batch_forward

    def half(tiles, three):
        n = tiles.shape[0]
        out = orig(tiles[:max(1, n // 2)], three)   # the rest never run
        rest = out.new_zeros((n - out.shape[0],) + tuple(out.shape[1:]))
        return torch.cat([out, rest])

    pipe._esrgan_batch_forward = half


def _tile_altered(system):
    pipe = system.pipeline
    orig = pipe._esrgan_batch_forward
    pipe._esrgan_batch_forward = lambda t, three: _alter_block(orig(t, three))


@pytest.mark.parametrize("fault", [_tiles_half, _tile_altered])
def test_esrgan_faults_are_not_correct(fault):
    res, nums = _run("esrgan", 2 ** 31 + 6, fault)
    assert not res["correct"], nums


def _step_unchanged(system):
    sch = system.pipeline.models["diffusion"].scheduler
    orig = sch.step

    def unchanged(model_output, t, prev_t, sample):
        orig(model_output, t, prev_t, sample)
        if sch.record:
            sch.record[-1] = sch.record[-1][:4] + (sample,)
        return sample

    sch.step = unchanged


def _decode_altered(system):
    diff = system.pipeline.models["diffusion"]
    orig = diff._decode
    diff._decode = lambda latents: _alter_block(orig(latents))


def _uncond_left_out(monkeypatch):
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        pipeline as sd_pipeline)
    orig = sd_pipeline.guided_step

    def cond_only(scheduler, eps_u, eps_c, *args):
        return orig(scheduler, eps_c, eps_c, *args)

    monkeypatch.setattr(sd_pipeline, "guided_step", cond_only)


@pytest.mark.parametrize("fault", ["step", "decode", "cfg"])
def test_diffusion_faults_are_not_correct(fault, monkeypatch):
    if fault == "cfg":
        _uncond_left_out(monkeypatch)
        res, nums = _run("sdx4", 2 ** 31 + 7)
    else:
        res, nums = _run("sdx4", 2 ** 31 + 7, {"step": _step_unchanged,
                                                "decode": _decode_altered}[
                                                    fault])
    assert not res["correct"], nums


@pytest.mark.parametrize("which", ["esrgan", "sdx4"])
def test_traced_run_reports_per_layer_metrics(which):
    """--trace 1: the measured window runs untraced and gives the spans and
    mfu_pct; a traced window follows; the check is the same."""
    seconds = {"esrgan": 8.0, "sdx4": 3.0}[which]
    res, rows = harness.run(tiny_cell(which), 2 ** 31 + 9, seconds, True,
                            time.perf_counter(), "cpu", None,
                            log=lambda m: None)
    assert res["correct"], res["checks"]
    got = set(res["metrics"])
    assert {"stage_ms.pre", "stage_ms.segmentation", "mfu_pct"} <= got
    assert not got & {"setup_s", "mp_out_per_s"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert list(res)[-1] == "checks"
