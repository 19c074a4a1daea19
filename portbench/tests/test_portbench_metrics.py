"""Every per-layer metric's reader on a small recorded trace (written
here in the Chrome format that ``torch.profiler`` exports)."""

import json
import os

import pytest

from portbench import harness
from portbench.chrome_trace import load_trace
from portbench.counts import attention
from portbench.counts import rrdbnet as rr

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TID = 119


class _Rec:
    """A Chrome trace being written: host ranges, launches, kernels."""

    def __init__(self):
        self.ev, self.corr = [], 0

    def range(self, name, t0, t1):
        self.ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                        "pid": TID, "tid": TID, "ts": t0, "dur": t1 - t0})

    def kernel(self, name, launch_ts, ts, dur, cat="kernel"):
        self.corr += 1
        self.ev.append({"ph": "X", "cat": "cuda_runtime",
                        "name": "cudaLaunchKernel", "pid": TID, "tid": TID,
                        "ts": launch_ts, "dur": 1.0,
                        "args": {"correlation": self.corr}})
        self.ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                        "tid": 7, "ts": ts, "dur": dur,
                        "args": {"correlation": self.corr}})

    def write(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.ev}, f)
        return path


def _esrgan_request(rec, t0, launches=345):
    """One 640x480 request: pre-stages, segmentation, the streamed final
    with ``launches`` K1 step kernels of 100 us; returns its end."""
    rec.range("portbench/request", t0, t0 + 100_000)
    rec.range("nesr/pre/denoise", t0 + 1000, t0 + 5000)
    rec.kernel("nlmeans_kernel<1, 3>", t0 + 1100, t0 + 1200, 1000)
    rec.range("nesr/segmentation", t0 + 6000, t0 + 20_000)
    rec.kernel("segformer_gemm", t0 + 6100, t0 + 6200, 2000)
    rec.range("nesr/esrgan+post/streamed", t0 + 21_000, t0 + 99_000)
    for k in range(launches):
        rec.kernel("void rdb_bf16_step_kernel<96, 4>(Maps, Params)",
                   t0 + 21_000 + k, t0 + 22_000 + 100 * k, 100)
    rec.kernel("Memcpy DtoH", t0 + 98_000, t0 + 98_000, 500,
               cat="gpu_memcpy")
    return t0 + 100_000


def _ctx(path, cell_name, traced, stages, measured=None):
    """The traced window's requests ``traced``; the measured window's
    ``measured`` (the traced ones when None) and its StageTimer totals."""
    cell = harness.load_cell(cell_name, ROOT)
    tr = load_trace(path)
    ran = [dict(r, t_start=0.0, t_end=0.0) for r in (measured or traced)]
    window = harness.Window(0.0, 0.0, ran, 1.0, stages)
    return harness.Ctx(tr, traced, window, cell, {})


def test_esrgan_readers(tmp_path):
    rec = _Rec()
    end = _esrgan_request(rec, 1_000_000)
    end = _esrgan_request(rec, end)
    reqs = [{"h": 480, "w": 640}, {"h": 480, "w": 640}]
    # the spans' totals are over the measured window's four requests, the
    # device times over the traced window's two
    stages = {"pre/denoise": (0.016, 4), "pre/contrast": (0.008, 4),
              "segmentation": (0.056, 4)}
    ctx = _ctx(rec.write(tmp_path / "t.json"), "esrgan-photos", reqs, stages,
               measured=reqs * 2)
    read = {m: harness.load_part("metrics", m).read(ctx) for m in (
        "stage_ms.pre", "stage_ms.segmentation", "device_ms.esrgan_branch",
        "k1_step_roofline", "device_idle_pct", "device_ms.diffusion",
        "k3_roofline", "host_ms.diffusion")}
    assert read["stage_ms.pre"] == pytest.approx(6.0)
    assert read["stage_ms.segmentation"] == pytest.approx(14.0)
    # 345 kernels of 100 us a request, launched in the streamed stage
    assert read["device_ms.esrgan_branch"] == pytest.approx(34.5)
    bound = rr.trunk_bound_s(6, 268, ctx.config["esrgan"])
    assert read["k1_step_roofline"] == pytest.approx(
        100 * 2 * bound / (2 * 345 * 100e-6))
    busy = 2 * (345 * 100 + 1000 + 2000 + 500)
    assert read["device_idle_pct"] == pytest.approx(
        100 * (1 - busy / 200_000))
    assert read["device_ms.diffusion"] is None
    assert read["k3_roofline"] is None and read["host_ms.diffusion"] is None
    assert ctx.trace.idle_gaps(1)[0][0] in ("portbench/request",
                                           "nesr/esrgan+post/streamed",
                                           "nesr/segmentation",
                                           "nesr/pre/denoise")


def test_k1_roofline_reads_nothing_when_a_launch_is_missing(tmp_path):
    rec = _Rec()
    _esrgan_request(rec, 1_000_000, launches=344)
    ctx = _ctx(rec.write(tmp_path / "t.json"), "esrgan-photos",
               [{"h": 480, "w": 640}], {})
    assert harness.load_part("metrics", "k1_step_roofline").read(ctx) is None
    assert harness.load_part("metrics", "stage_ms.pre").read(ctx) is None


def test_diffusion_readers_and_mfu(tmp_path):
    rec = _Rec()
    t0 = 1_000_000
    rec.range("portbench/request", t0, t0 + 2_000_000)
    rec.range("nesr/esrgan", t0 + 1000, t0 + 50_000)
    for k in range(345):
        rec.kernel("rdb_bf16_step_kernel<64, 2>", t0 + 1000 + k,
                   t0 + 2000 + 100 * k, 100)
    rec.range("nesr/diffusion", t0 + 50_000, t0 + 1_900_000)
    for k in range(641):
        name = "flash_wide<512>" if k == 640 else "flash_narrow<64>"
        rec.kernel(name, t0 + 50_001 + k, t0 + 60_000 + 2000 * k, 1000)
    cell = harness.load_cell("sdx4-web448", ROOT)
    d = cell["config"]["diffusion"]
    reqs = [{"h": 336, "w": 448}]
    stages = {"diffusion": (1.85, 1)}
    ctx = _ctx(rec.write(tmp_path / "t.json"), "sdx4-web448", reqs, stages)
    read = {m["name"]: harness.load_part("metrics", m["name"]).read(ctx)
            for m in cell["per_layer"] if m["name"] != "mfu_pct"}
    assert read["device_ms.diffusion"] == pytest.approx(641.0)
    assert read["device_ms.esrgan_branch"] == pytest.approx(34.5)
    assert read["host_ms.diffusion"] == pytest.approx(1850.0)
    bound, n = attention.request_bound_s(d["unet"], d["vae"], 336, 448, 40)
    assert n == 641
    assert read["k3_roofline"] == pytest.approx(100 * bound / 0.641)
    assert read["k1_step_roofline"] == pytest.approx(
        100 * rr.trunk_bound_s(4, 268, cell["config"]["esrgan"]) / 0.0345)
    assert read["stage_ms.pre"] is None


def test_mfu_counts_the_requests_over_the_window(tmp_path):
    """mfu_pct on the realesrgan configuration's small weights: RRDBNet
    over the input pixels plus SegFormer-b0 at 512 px, over the measured
    window's completed requests and the span to the last completion."""
    import torch
    from portbench.counts import model_flops
    from portbench.models.nesr_pipeline import segformer_weights, _shapes
    from neural_enhanced_super_resolution_torch.models.segformer import (
        SegFormer, SegFormerConfig)
    rec = _Rec()
    _esrgan_request(rec, 1_000_000)
    cell = harness.load_cell("esrgan-photos", ROOT)
    with torch.device("meta"):
        net = SegFormer(SegFormerConfig(**cell["config"]["segformer"]))
    seg = segformer_weights(_shapes(net), torch.Generator().manual_seed(0),
                            "cpu")
    tr = load_trace(rec.write(tmp_path / "t.json"))
    # the measured window: one request done 0.1 s after the window opened,
    # one still running at its close (not counted)
    window = harness.Window(5.0, 0.0, [
        {"h": 480, "w": 640, "t_start": 5.0, "t_end": 5.1},
        {"h": 960, "w": 1280, "t_start": 5.1, "t_end": 7.0}], 1.0)
    ctx = harness.Ctx(tr, [], window, cell, {"segformer": seg})
    flops = (2 * rr.macs_per_input_pixel(cell["config"]["esrgan"]) * 480 * 640
             + model_flops.segformer_flops(seg, cell["config"]["segformer"],
                                           512))
    assert harness.load_part("metrics", "mfu_pct").read(ctx) == \
        pytest.approx(100 * flops / (0.1 * 989e12))
