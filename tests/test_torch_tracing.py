"""The port's tracer (``runtime/profiler.StageTimer``): spans nest and carry
their request, counters reach the totals, records stay bounded, device
clocks are read from timing events without a wait, a request makes as many
device waits as before spans, and the tiled path's counters and spans.

CPU tests, with a fake event class for the device clock; one card test
(marker ``cuda``) reads a real stream's events. The file imports no JAX.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
from neural_enhanced_super_resolution_torch.models import (
    RRDBNetConfig, init_rrdbnet, save_state_dict)
from neural_enhanced_super_resolution_torch.models.diffusion import (
    CLIPTextConfig, UNetConfig, VAEConfig)
from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
    write_synthetic_snapshot)
from neural_enhanced_super_resolution_torch.parallel.sharded import (
    process_tiled_sharded)
from neural_enhanced_super_resolution_torch.parallel.tiling import (
    process_tiled, process_tiled_to_host)
from neural_enhanced_super_resolution_torch.runtime import profiler
from neural_enhanced_super_resolution_torch.runtime.profiler import (
    StageTimer)

CARD = torch.device("cuda", 0)


class _FakeEvent:
    """A timing event on a fake clock: ``record`` stamps the clock's time,
    ``query`` says whether the stamp has run (``ran`` in the clock)."""

    def __init__(self, clock):
        self.clock, self.t = clock, None
        clock["made"] += 1

    def record(self, stream=None):
        self.t = self.clock["now"]
        self.clock["now"] += self.clock["step"]

    def query(self):
        return self.t is not None and self.t < self.clock["ran"]

    def elapsed_time(self, end):
        assert self.query() and end.query(), "read before it ran"
        return end.t - self.t   # ms


@pytest.fixture()
def fake_clock(monkeypatch):
    """Timing events on a fake clock (ms); every stamp has run unless the
    test lowers ``ran``."""
    clock = {"now": 0.0, "step": 2.0, "ran": float("inf"), "made": 0}
    monkeypatch.setattr(profiler, "_event", lambda: _FakeEvent(clock))
    monkeypatch.setattr(profiler, "_stream", lambda device: None)
    return clock


@pytest.fixture()
def fake_cuda(monkeypatch):
    """CUDA faked as available: synchronize records its device."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    return synced


# ------------------------------------------------------------- records --

def test_spans_nest_and_carry_their_request():
    timer = StageTimer()
    for _ in range(2):
        with timer.request("cpu") as rec:
            with timer.stage("esrgan+post/streamed") as stage:
                with timer.span("tiling/chunk") as chunk:
                    with timer.span("tiling/copy") as copy:
                        pass
                assert timer.current() is stage
            with timer.span("diffusion/step") as step:
                pass
    assert [r.id for r in timer.requests] == [0, 1]
    assert rec.id == 1 and timer.current() is None
    names = [sp.name for sp in rec.spans]
    assert names == ["tiling/copy", "tiling/chunk", "esrgan+post/streamed",
                     "diffusion/step", "request"]
    top = rec.spans[-1]
    assert top.parent is None and stage.parent is top and step.parent is top
    assert chunk.parent is stage and copy.parent is chunk
    assert {sp.request for sp in rec.spans} == {1}
    assert all(sp.device_s is None for sp in rec.spans)   # on the CPU
    assert timer.counts["request"] == 2 and timer.counts["tiling/copy"] == 2


def test_a_span_on_another_thread_takes_the_parent_it_is_given(fake_clock):
    """A pool thread's span takes its parent from the caller, reads the
    host clock only and is not subtracted from the parent's self time."""
    timer = StageTimer()
    with timer.request(CARD) as rec:
        with timer.span("esrgan+post/streamed") as parent:
            def land():
                with timer.span("tiling/land", parent=timer_parent) as sp:
                    seen.append(sp)
            seen, timer_parent = [], timer.current()
            t = threading.Thread(target=land)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    (sp,) = seen
    assert sp.parent is parent and sp.request == rec.id
    assert sp.thread != parent.thread and parent.child_s == 0.0
    assert "tiling/land" in timer.totals
    assert sp.device_s is None and parent.device_s is not None


def test_counters_reach_totals_and_counts():
    timer = StageTimer()
    with timer.request("cpu"):
        timer.count("tiles", 6)
        timer.count("tiles", 12)
    timer.count("tile_px", 430_944)
    assert timer.totals["count/tiles"] == 18
    assert timer.counts["count/tiles"] == 2
    assert timer.totals["count/tile_px"] == 430_944
    lines = "\n".join(timer.summary_lines())
    assert "count/tiles" in lines and "18" in lines


def test_records_stay_bounded(fake_clock):
    """A resident process keeps the last REQUESTS_KEPT requests, at most
    SPANS_KEPT spans a request, and reuses its timing events."""
    timer = StageTimer()
    for _ in range(3 * profiler.REQUESTS_KEPT):
        with timer.request(CARD):
            for _ in range(5):
                with timer.span("diffusion/step"):
                    pass
    assert len(timer.requests) == profiler.REQUESTS_KEPT
    assert timer.requests[-1].id == 3 * profiler.REQUESTS_KEPT - 1
    assert timer.counts["device/diffusion/step"] == \
        15 * profiler.REQUESTS_KEPT
    # a pair a span of the first request, reused by every later one
    assert fake_clock["made"] == 10
    with timer.request("cpu") as rec:
        for _ in range(profiler.SPANS_KEPT + 10):
            with timer.span("tiling/land"):
                pass
    assert len(rec.spans) == profiler.SPANS_KEPT
    assert timer.counts["tiling/land"] == profiler.SPANS_KEPT + 10


# --------------------------------------------------------- device clock --

def test_device_clock_is_read_when_the_request_ends(fake_clock, fake_cuda):
    """Inside a request on a CUDA home, stages and spans record a pair of
    events each and read them in one batch at the request's end; the
    request's own span, a span on another device or outside a request
    reads the host clock only; no span waits for the device."""
    timer = StageTimer()
    with timer.span("outside"):
        pass
    with timer.request(CARD) as rec:
        with timer.stage("esrgan+post/streamed", devices=[CARD]):
            with timer.span("tiling/chunk", CARD):
                pass
            with timer.span("diffusion/step", torch.device("cuda", 1)):
                pass
        assert "device/tiling/chunk" not in timer.totals   # not yet read
    assert fake_cuda == [CARD, CARD]   # the stage's two waits, no other
    assert timer.counts["sync"] == 2 and timer.totals["sync"] >= 0
    spans = {sp.name: sp for sp in rec.spans}
    # the stage's events: start, the chunk's pair, end (2 ms a stamp)
    assert spans["esrgan+post/streamed"].device_s == pytest.approx(6e-3)
    assert spans["tiling/chunk"].device_s == pytest.approx(2e-3)
    assert timer.totals["device/tiling/chunk"] == pytest.approx(2e-3)
    for name in ("diffusion/step", "request"):
        assert spans[name].device_s is None
        assert f"device/{name}" not in timer.totals
    assert "device/outside" not in timer.totals
    line = next(ln for ln in timer.summary_lines() if "tiling/chunk" in ln)
    assert line.split()[-1] == "0.002"   # the device column


def test_a_stage_on_more_devices_than_the_home_reads_the_host_clock(
        fake_clock, fake_cuda):
    """A stage whose ``devices`` hold another device than the home one (a
    multi-device layout) waits for each but reads the host clock only; one
    listing only the home device reads the device clock."""
    timer = StageTimer()
    other = torch.device("cuda", 1)
    with timer.request(CARD) as rec:
        with timer.stage("diffusion", devices=[CARD, other]):
            pass
        with timer.stage("ensemble", devices=[CARD, CARD]):
            pass
    assert fake_cuda == [CARD, other, CARD, other, CARD, CARD]
    spans = {sp.name: sp for sp in rec.spans}
    assert spans["diffusion"].device_s is None
    assert "device/diffusion" not in timer.totals
    assert spans["ensemble"].device_s == pytest.approx(2e-3)
    assert timer.counts["diffusion"] == 1


def test_an_end_not_yet_run_is_read_by_a_later_request(fake_clock):
    timer = StageTimer()
    with timer.request(CARD):
        with timer.span("a"):
            pass
        fake_clock["ran"] = fake_clock["now"] - fake_clock["step"]
    assert "device/a" not in timer.totals and len(timer._pending) == 1
    fake_clock["ran"] = float("inf")
    with timer.request(CARD):
        pass
    assert timer.totals["device/a"] == pytest.approx(2e-3)
    assert not timer._pending


def test_a_raising_stage_is_recorded_and_its_clock_left_unread(fake_clock):
    timer = StageTimer()
    with pytest.raises(RuntimeError):
        with timer.request(CARD):
            with timer.stage("segmentation"):
                raise RuntimeError("boom")
    assert timer.counts["segmentation"] == 1
    assert "device/segmentation" not in timer.totals
    with timer.request(CARD):
        pass
    assert timer.counts["device/segmentation"] == 1


def test_summary_has_self_time_and_no_throughput_line():
    timer = StageTimer()
    with timer.stage("esrgan+post/streamed"):
        with timer.span("tiling/chunk"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    lines = timer.summary_lines()
    assert lines[0].split() == ["span", "host", "s", "calls", "self", "s",
                                "device", "s"]
    assert not any("throughput" in ln for ln in lines)
    row = dict((ln.split()[0], ln.split()[1:]) for ln in lines[1:])
    total, calls, own = row["esrgan+post/streamed"][:3]
    assert calls == "1" and float(own) <= float(total)


# ------------------------------------------------------ the tiled paths --

@pytest.mark.parametrize("batch", [4, 16])
def test_tile_counters_and_spans_on_the_cpu_path(batch):
    """640x480 at tile 256, halo 6: 6 tiles of 268^2, 430,944 px run for
    the image's 307,200; a grid span, a chunk and a landing a chunk."""
    timer = StageTimer()
    img = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8)
    with timer.request("cpu"):
        with timer.stage("esrgan+post/streamed"):
            out = process_tiled_to_host(lambda t: t, img, tile_size=256,
                                        halo=6, scale=1, batch_tiles=batch,
                                        timer=timer)
    np.testing.assert_array_equal(out, img.numpy())
    assert timer.totals["count/tiles"] == 6
    assert timer.totals["count/tile_px"] == 430_944
    assert timer.totals["count/tile_image_px"] == 640 * 480
    chunks = -(-6 // batch)
    assert timer.counts["tiling/grid"] == 1
    assert timer.counts["tiling/chunk"] == chunks
    assert timer.counts["tiling/land"] == chunks
    parents = {sp.name: sp.parent.name for sp in timer.requests[-1].spans
               if sp.name.startswith("tiling/")}
    assert set(parents.values()) == {"esrgan+post/streamed"}


def test_every_tiled_path_counts_its_grid():
    timer = StageTimer()
    img = torch.randint(0, 256, (336, 448, 3), dtype=torch.uint8)
    process_tiled(lambda t: t, img, tile_size=256, halo=6, scale=1,
                  timer=timer)
    # 448x336 pads to 2x2 tiles: 52.4% of the pixels run are the image's
    assert timer.totals["count/tiles"] == 4
    assert 100 * timer.totals["count/tile_image_px"] / \
        timer.totals["count/tile_px"] == pytest.approx(52.39, abs=0.01)


def test_the_sharded_path_counts_its_padded_tail():
    """640x480 at tile 256 over four slots: 6 tiles pad to 8 (2 a slot),
    and the 2 repeated tiles run too."""
    timer = StageTimer()
    img = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8)
    out = process_tiled_sharded(lambda t: t, img, [torch.device("cpu")] * 4,
                                tile_size=256, halo=6, scale=1, timer=timer)
    torch.testing.assert_close(out, img)
    assert timer.totals["count/tiles"] == 8
    assert timer.totals["count/tile_px"] == 8 * 268 ** 2
    assert timer.totals["count/tile_image_px"] == 640 * 480


# ------------------------------------------------- the product path --

TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8, num_block=1,
            num_grow_ch=4)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    sd = init_rrdbnet(RRDBNetConfig(**TINY), torch.Generator().manual_seed(0))
    return save_state_dict(sd, str(tmp_path_factory.mktemp("ckpt")
                                   / "tiny_x4.pth"))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    unet = UNetConfig(
        sample_size=16, in_channels=7, out_channels=4,
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
        block_out_channels=(8, 16), layers_per_block=1,
        cross_attention_dim=16, attention_head_dim=2, num_class_embeds=50,
        norm_num_groups=4)
    vae = VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                    latent_channels=4, norm_num_groups=4,
                    scaling_factor=0.08333)
    clip = CLIPTextConfig(vocab_size=100, hidden_size=16,
                          intermediate_size=32, num_hidden_layers=2,
                          num_attention_heads=2, max_position_embeddings=12)
    return write_synthetic_snapshot(
        str(tmp_path_factory.mktemp("sd_x4_tiny")), (unet, vae, clip),
        torch.Generator().manual_seed(0), torch.float32, init="fixed")


# Waits a request made before the spans (the parent tree, same requests):
# two a synced stage, one a stage left open at one end.
WAITS = {"streamed": ({}, 6), "chain": ({"streamed_output": False}, 12),
         "two_iterations": ({"iterations": 2}, 16),
         "diffusion": ({"use_diffusion": True, "num_inference_steps": 2,
                        "denoise_level": 0}, 8)}


@pytest.mark.parametrize("case", sorted(WAITS))
def test_a_request_makes_as_many_waits_as_before(case, tmp_path, ckpt,
                                                 snapshot, fake_cuda,
                                                 monkeypatch):
    overrides, waits = WAITS[case]
    cfg = {"iterations": 1, "segment_enhancement": False,
           "denoise_level": 0.5, "use_diffusion": False,
           "esrgan_model_path": ckpt, "diffusion_model_path": snapshot,
           "esrgan_arch": {k: TINY[k] for k in ("num_feat", "num_block",
                                                "num_grow_ch")},
           "max_tile_size": 48, "tile_halo": 8,
           "output_dir": str(tmp_path / "out"), **overrides}
    pipe = SuperResolutionPipeline("cpu", cfg)
    img = np.random.default_rng(0).integers(0, 256, (40, 56, 3), np.uint8)
    pipe.enhance_array(img)   # loads the models
    calls = []
    inner = profiler._sync

    def counted(devices):
        calls.append(devices)
        return inner(devices)

    monkeypatch.setattr(profiler, "_sync", counted)
    pipe.enhance_array(img)
    assert len(calls) == waits
    assert not fake_cuda   # a CPU home: nothing on a card to wait for
    rec = pipe.timer.requests[-1]
    assert rec.spans[-1].name == "request"
    assert {"request", "request/upload"} <= set(pipe.timer.totals)


def test_streamed_request_traces_the_tiles(tmp_path, ckpt):
    """The streamed final's spans nest under its stage, and the counters
    read the request's tile grid."""
    pipe = SuperResolutionPipeline("cpu", {
        "iterations": 1, "segment_enhancement": False, "denoise_level": 0,
        "use_diffusion": False, "esrgan_model_path": ckpt,
        "esrgan_arch": {k: TINY[k] for k in ("num_feat", "num_block",
                                             "num_grow_ch")},
        "max_tile_size": 32, "tile_halo": 4, "tile_batch": 4,
        "output_dir": str(tmp_path / "out")})
    img = np.random.default_rng(1).integers(0, 256, (40, 72, 3), np.uint8)
    pipe.enhance_array(img)
    t = pipe.timer
    assert t.totals["count/tiles"] == 6          # 2 x 3 tiles of 32
    assert t.totals["count/tile_px"] == 6 * 40 ** 2
    assert t.totals["count/tile_image_px"] == 40 * 72
    assert t.counts["tiling/chunk"] == 2 and t.counts["tiling/land"] == 2
    spans = t.requests[-1].spans
    stream = next(sp for sp in spans if sp.name == "esrgan+post/streamed")
    assert {sp.parent.name for sp in spans if sp.name.startswith(
        "tiling/")} == {"esrgan+post/streamed"}
    assert stream.parent.name == "request"


# ---------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: reads a real stream's events")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_device_clock_on_the_card(cuda, monkeypatch):
    """On the card a span's events read the stream's time without a wait:
    a span around 20 matmuls of 2048^2 reads more device than host time,
    its parent at least its own, and the request adds no synchronize."""
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: (syncs.append(device),
                                             real(device)))
    a = torch.randn(2048, 2048, device=cuda)
    torch.matmul(a, a)
    real()
    timer = StageTimer()
    with timer.request(cuda) as rec:
        with timer.stage("work", devices=[cuda]):
            with timer.span("matmuls", cuda):
                for _ in range(20):
                    b = torch.matmul(a, a)
    assert float(b[0, 0]) == float(b[0, 0])
    assert len(syncs) == 2   # the stage's own
    spans = {sp.name: sp for sp in rec.spans}
    mm, work = spans["matmuls"], spans["work"]
    assert mm.device_s > 0 and work.device_s >= mm.device_s
    assert mm.device_s > mm.host_s
    assert timer.totals["device/matmuls"] == mm.device_s
