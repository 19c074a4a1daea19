"""The readers of the program's spans and counters (the StageTimer's
``device/``, ``count/`` and host totals) on a synthetic measured window,
their ``BENCHMARK.json`` entries, and a traced CPU run that reports the
ones the CPU has (the device clock and the device waits need a card)."""

import json
import os
import time

import pytest

from conftest import tiny_cell
from portbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

NEW = {  # name: (layer, cells)
    "idle_ms.esrgan_stream": ("parallel/tiling", ["esrgan-photos"]),
    "host_ms.tile_land": ("parallel/tiling", ["esrgan-photos"]),
    "tile_useful_px_pct": ("parallel/tiling",
                           ["esrgan-photos", "sdx4-web448"]),
    "host_ms.unet_step": ("models/diffusion/pipeline", ["sdx4-web448"]),
    "device_ms.unet_step": ("models/diffusion", ["sdx4-web448"]),
    "host_wait_ms.request": ("device", ["esrgan-photos", "sdx4-web448"]),
}


def _ctx(stages, n_requests=4):
    """A measured window of ``n_requests`` requests with the StageTimer's
    totals ``stages`` ({name: (total, count)}); no trace."""
    ran = [{"index": i, "w": 640, "h": 480, "t_start": 0.0, "t_end": 0.0}
           for i in range(n_requests)]
    window = harness.Window(0.0, 0.0, ran, 1.0, stages)
    cell = {"config": {}}
    return harness.Ctx(None, [], window, cell, {})


def _read(name, ctx):
    return harness.load_part("metrics", name).read(ctx)


def test_idle_inside_the_streamed_final():
    # 4 streamed stages of 180 ms on the device; grid 1 ms, chunks 150 ms
    ctx = _ctx({"device/esrgan+post/streamed": (0.720, 4),
                "device/tiling/grid": (0.004, 4),
                "device/tiling/chunk": (0.600, 6),
                "esrgan+post/streamed": (0.728, 4)})
    assert _read("idle_ms.esrgan_stream", ctx) == pytest.approx(29.0)


def test_landing_and_waits_a_request():
    ctx = _ctx({"tiling/land": (0.048, 6), "sync": (0.040, 24)})
    assert _read("host_ms.tile_land", ctx) == pytest.approx(12.0)
    assert _read("host_wait_ms.request", ctx) == pytest.approx(10.0)


def test_useful_share_of_the_tiles():
    # one 640x480 (6 tiles of 268^2) and one 800x600 (12 tiles)
    ctx = _ctx({"count/tile_image_px": (307_200 + 480_000, 2),
                "count/tile_px": (18 * 268 ** 2, 2),
                "count/tiles": (18, 2)}, 2)
    assert _read("tile_useful_px_pct", ctx) == pytest.approx(
        100 * 787_200 / 1_292_832)


def test_unet_step_on_both_clocks():
    ctx = _ctx({"diffusion/step": (4.6, 20),
                "device/diffusion/step": (4.8, 20)}, 1)
    assert _read("host_ms.unet_step", ctx) == pytest.approx(230.0)
    assert _read("device_ms.unet_step", ctx) == pytest.approx(240.0)


@pytest.mark.parametrize("name", sorted(NEW))
def test_nothing_to_read_reads_none(name):
    """A program without the spans (the parent of the change that added
    them) or a window without requests: no number, no error."""
    assert _read(name, _ctx({"pre/denoise": (0.01, 4)})) is None
    assert _read(name, _ctx({}, 0)) is None


def test_the_entries_in_benchmark_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    per = {m["name"]: m for m in bench["per_layer"]}
    assert list(per)[-len(NEW):] == list(NEW)   # appended, in this order
    for name, (layer, cells) in NEW.items():
        m = per[name]
        assert (m["layer"], m["workloads"]) == (layer, cells)
        assert m["moves"] == "mp_out_per_s"
        assert m["source"] == ("program_counter" if name.endswith("_pct")
                               else "program_span")
        assert (m["unit"], m["better"]) == (
            ("%", "higher") if name.endswith("_pct") else ("ms", "lower"))
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           name + ".py"))


def test_traced_cpu_run_reports_the_host_spans_and_counters():
    """The tiny ESRGAN cell on the CPU: the tiles' share and the landings
    are read from the measured window; the device clock's and the device
    waits' metrics need a card and are left out."""
    res, _ = harness.run(tiny_cell("esrgan"), 2 ** 31 + 11, 8.0, True,
                         time.perf_counter(), "cpu", None,
                         log=lambda m: None)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # 160x136 runs 1 tile of 268^2, 272x144 two: 30.3% and 27.3% useful
    share = got["tile_useful_px_pct"]["value"]
    assert 100 * 272 * 144 / (2 * 268 ** 2) <= share <= \
        100 * 160 * 136 / 268 ** 2
    assert got["host_ms.tile_land"]["value"] > 0
    assert not set(got) & {"idle_ms.esrgan_stream", "host_wait_ms.request",
                           "device_ms.unet_step", "host_ms.unet_step"}
