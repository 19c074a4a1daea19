"""The port's host side against the JAX package's, on the CPU.

* The host stager (``runtime/native``, built from the port's
  ``csrc/nesr_host.cpp``) against its numpy versions, the port's
  ``extract_tiles`` and the JAX package's stager: bit for bit; a failed
  build raises, with no numpy fallback.
* ``process_tiled_to_host`` against ``process_tiled(...).numpy()`` at one,
  two and three chunks with a ragged last chunk: bit for bit;
  cancellation and errors mid-stream.
* The downloader against ``file://`` URLs and a localhost HTTP server
  that honours ``Range`` (never the network), and its registry against
  the JAX package's.
* ``utils/image_utils`` against the JAX functions: the deterministic ones
  within one uint8 level, the noise by its mean and standard deviation.
* ``runtime/config.snapshot`` against the JAX one.
"""

import hashlib
import http.server
import os
import threading

import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.kernels import KernelError
from neural_enhanced_super_resolution_torch.parallel.tiling import (
    TilingCancelled, extract_tiles, process_tiled, process_tiled_to_host)
from neural_enhanced_super_resolution_torch.runtime import native
from neural_enhanced_super_resolution_torch.runtime.config import (
    merge_config, snapshot)
from neural_enhanced_super_resolution_torch.utils import downloader
from neural_enhanced_super_resolution_torch.utils import image_utils
from neural_enhanced_super_resolution_tpu.runtime import native as jax_native
from neural_enhanced_super_resolution_tpu.runtime.config import (
    snapshot as jax_snapshot)
from neural_enhanced_super_resolution_tpu.utils import (
    downloader as jax_downloader, image_utils as jax_image_utils)


# ------------------------------------------------------------ host stager ---

@pytest.mark.parametrize("h,w,c,tile,halo", [
    (64, 96, 3, 32, 4), (48, 48, 3, 16, 8), (40, 24, 1, 8, 3),
    (32, 64, 12, 32, 0)])
def test_host_stager_matches_numpy_and_extract_tiles(h, w, c, tile, halo):
    img = np.random.default_rng(h + w).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)
    got = native.extract_tiles_u8(img, tile, halo)
    np.testing.assert_array_equal(got,
                                  native.extract_tiles_u8_plain(img, tile,
                                                                halo))
    np.testing.assert_array_equal(
        got, extract_tiles(torch.from_numpy(img), tile, halo).numpy())
    np.testing.assert_array_equal(got, jax_native.extract_tiles_u8(img, tile,
                                                                   halo))
    ny, nx = h // tile, w // tile
    back = native.stitch_tiles_u8(got, ny, nx, tile, halo)
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(
        back, native.stitch_tiles_u8_plain(got, ny, nx, tile, halo))


def test_host_stager_stack12_and_out_buffer():
    img = np.random.default_rng(1).integers(0, 256, (21, 34, 3),
                                            dtype=np.uint8)
    got = native.stack12_u8(img)
    np.testing.assert_array_equal(got, native.stack12_u8_plain(img))
    np.testing.assert_array_equal(got, jax_native.stack12_u8(img))
    pad = np.pad(img, ((0, 3), (0, 6), (0, 0)), mode="reflect")
    out = np.zeros((15, 12, 12, 3), np.uint8)   # 24 x 40 in tiles of 8
    assert native.extract_tiles_u8(pad, 8, 2, out=out) is out
    np.testing.assert_array_equal(out, native.extract_tiles_u8_plain(pad, 8,
                                                                     2))
    with pytest.raises(ValueError, match="out must be"):
        native.extract_tiles_u8(pad, 8, 2, out=out[:, :, :, :2])
    with pytest.raises(ValueError, match="pad to the tile grid"):
        native.extract_tiles_u8(img, 8, 2)


def test_host_stager_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises KernelError from every entry
    of the stager: no numpy fallback."""
    bad = tmp_path / "nesr_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("NESR_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    img = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(KernelError, match="host stager build failed"):
        native.extract_tiles_u8(img, 8, 2)
    with pytest.raises(KernelError, match="host stager build failed"):
        native.stack12_u8(img)


def _model(t: torch.Tensor) -> torch.Tensor:
    """A position-dependent uint8 x2 upscale: any misplaced tile shows."""
    up = t.repeat_interleave(2, 1).repeat_interleave(2, 2).int()
    ramp = torch.arange(up.shape[2], dtype=torch.int32)[None, None, :, None]
    return ((up * 3 + ramp + 7) % 256).to(torch.uint8)


@pytest.mark.parametrize("batch_tiles,chunks", [(12, 1), (8, 2), (5, 3)])
def test_streamed_to_host_equals_process_tiled(batch_tiles, chunks):
    """40x56 at tile 16 pads to 3 x 4 tiles: 12, 8 + 4, 5 + 5 + 2."""
    img = np.random.default_rng(2).integers(0, 256, (40, 56, 3),
                                            dtype=np.uint8)
    calls = []

    def model(t):
        calls.append(t.shape[0])
        return _model(t)

    kw = dict(tile_size=16, halo=4, scale=2, batch_tiles=batch_tiles)
    ref = process_tiled(_model, torch.from_numpy(img), **kw).numpy()
    got = process_tiled_to_host(model, torch.from_numpy(img), **kw)
    assert len(calls) == chunks and sum(calls) == 12
    assert got.shape == (80, 112, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_streamed_to_host_cancels_and_propagates_mid_stream():
    img = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (40, 56, 3), dtype=np.uint8))
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 1

    seen = []

    def model(t):
        seen.append(t.shape[0])
        return _model(t)

    kw = dict(tile_size=16, halo=4, scale=2, batch_tiles=5)
    with pytest.raises(TilingCancelled, match="tile 5/12"):
        process_tiled_to_host(model, img, cancel_check=cancel, **kw)
    assert seen == [5]

    def broken(t):
        if seen:
            raise KernelError("planted fault in chunk 2")
        seen.append(t.shape[0])
        return _model(t)

    seen.clear()
    with pytest.raises(KernelError, match="chunk 2"):
        process_tiled_to_host(broken, img, **kw)


# ------------------------------------------------------------- downloader ---

@pytest.fixture(autouse=True)
def _no_hub(monkeypatch):
    """Both packages' availability checks ask huggingface_hub's cache;
    here it is absent, so nothing can reach for the network."""
    import sys
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)


PAYLOAD = np.random.default_rng(4).integers(0, 256, 300_000,
                                            dtype=np.uint8).tobytes()
PAYLOAD_MD5 = hashlib.md5(PAYLOAD).hexdigest()


class _RangeHandler(http.server.BaseHTTPRequestHandler):
    honour_range = True
    requests: list = []

    def do_GET(self):  # noqa: N802 - the http.server hook
        rng = self.headers.get("Range")
        self.requests.append(rng)
        if self.path != "/weights.bin":
            self.send_error(404)
            return
        body, status = PAYLOAD, 200
        if rng and self.honour_range:
            start = int(rng.split("=")[1].split("-")[0])
            if start >= len(PAYLOAD):
                self.send_response(416)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body, status = PAYLOAD[start:], 206
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture
def server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    _RangeHandler.requests = []
    _RangeHandler.honour_range = True
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join(10)
    assert not thread.is_alive()


def test_registry_and_md5_match_jax(tmp_path, monkeypatch):
    assert downloader.MODELS == jax_downloader.MODELS
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello world")
    assert downloader.calculate_md5(str(p)) == \
        jax_downloader.calculate_md5(str(p)) == \
        "5eb63bbbe01eeed093cb22bb8f5acdc3"
    monkeypatch.setenv("NESR_MODELS_DIR", str(tmp_path / "models"))
    ours, theirs = downloader.get_model_info(), jax_downloader.get_model_info()
    assert ours == theirs
    assert not any(v["exists"] for v in ours.values())


def test_download_file_from_a_file_url(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(PAYLOAD)
    dest = str(tmp_path / "out" / "w.bin")
    fractions = []
    assert downloader.download_file(src.as_uri(), dest, len(PAYLOAD),
                                    PAYLOAD_MD5, fractions.append)
    with open(dest, "rb") as f:
        assert f.read() == PAYLOAD
    assert fractions[-1] == 1.0 and not os.path.exists(dest + ".partial")
    # a wrong MD5 deletes the download and reports failure
    assert not downloader.download_file(src.as_uri(), dest + "2",
                                        expected_md5="0" * 32)
    assert not os.path.exists(dest + "2.partial")
    assert not downloader.download_file((tmp_path / "missing").as_uri(),
                                        dest + "3")


@pytest.mark.parametrize("honour_range", [True, False],
                         ids=["resume", "server_ignores_range"])
def test_download_file_resumes_over_http(tmp_path, server, honour_range):
    _RangeHandler.honour_range = honour_range
    dest = str(tmp_path / "w.bin")
    with open(dest + ".partial", "wb") as f:
        f.write(PAYLOAD[:123_456])
    assert downloader.download_file(f"{server}/weights.bin", dest,
                                    len(PAYLOAD), PAYLOAD_MD5)
    with open(dest, "rb") as f:
        assert f.read() == PAYLOAD
    assert _RangeHandler.requests == ["bytes=123456-"]
    # complete already: the server answers 416 and the file is kept
    with open(dest + ".partial", "wb") as f:
        f.write(PAYLOAD)
    _RangeHandler.honour_range = True
    assert downloader.download_file(f"{server}/weights.bin", dest,
                                    expected_md5=PAYLOAD_MD5)
    assert not downloader.download_file(f"{server}/missing.bin",
                                        str(tmp_path / "m.bin"))


def test_download_models_and_cli(tmp_path, server, monkeypatch, capsys):
    """The required models through the CLI's --download_models: the two
    file entries from localhost, the Hugging Face ones failing as the JAX
    package's do where the hub cannot be reached."""
    from neural_enhanced_super_resolution_torch.cli import main as torch_cli
    monkeypatch.setenv("NESR_MODELS_DIR", str(tmp_path / "models"))
    models = {k: dict(v) for k, v in downloader.MODELS.items()}
    for key in ("esrgan_x2", "swinir"):
        models[key].update(url=f"{server}/weights.bin", size=len(PAYLOAD),
                           md5=PAYLOAD_MD5, required=True)
    monkeypatch.setattr(downloader, "MODELS", models)
    monkeypatch.setattr(downloader, "download_huggingface_model",
                        lambda key, cb=None: False)
    progress = []
    results = downloader.download_models(progress_callback=progress.append)
    assert results == {"esrgan_x2": True, "swinir": True,
                       "sd_upscaler": False, "segmentation": False}
    assert progress == sorted(progress) and 0 < progress[-1] < 1
    assert downloader.check_models_exist()["esrgan_x2"]
    assert torch_cli(["--download_models"]) == 0
    assert "Model download complete." in capsys.readouterr().out
    assert _RangeHandler.requests == [None, None]   # present: not fetched


def test_huggingface_download_without_the_package(tmp_path, monkeypatch):
    monkeypatch.setenv("NESR_MODELS_DIR", str(tmp_path))
    assert downloader.download_huggingface_model("segmentation") is False
    assert jax_downloader.download_huggingface_model("segmentation") is False
    assert downloader.check_models_exist()["segmentation"] is False


# ------------------------------------------------------------ image utils ---

def _levels(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    return int(np.abs(got.astype(int) - ref.astype(int)).max())


@pytest.mark.parametrize("fn,args", [
    ("blur_image", ("gaussian", 3)), ("blur_image", ("box", 2)),
    ("blur_image", ("motion", 3)), ("blur_image", ("gaussian", 0)),
    ("downsample_image", (0.5, "bicubic")),
    ("downsample_image", (0.37, "lanczos")),
    ("downsample_image", (0.5, "nearest")),
    ("downsample_image", (0.6, "bilinear")),
    ("apply_jpeg_compression", (50,)), ("add_text_to_image", ("hello",)),
    ("add_text_to_image", ("x4", "bottom"))])
def test_image_utils_match_jax(test_image, fn, args):
    img = np.ascontiguousarray(test_image[:48, :64])
    got = getattr(image_utils, fn)(img, *args)
    ref = np.asarray(getattr(jax_image_utils, fn)(img, *args))
    assert _levels(got, ref) <= 1


@pytest.mark.parametrize("orientation", ["horizontal", "vertical"])
def test_comparison_image_matches_jax(test_image, orientation):
    small = np.ascontiguousarray(test_image[:40, :60])
    big = np.ascontiguousarray(test_image[:90, :130])
    got = image_utils.create_comparison_image(small, big, orientation)
    ref = jax_image_utils.create_comparison_image(small, big, orientation)
    assert _levels(got, ref) <= 1


@pytest.mark.parametrize("kind,amount", [
    ("gaussian", 0.1), ("salt_pepper", 0.05), ("speckle", 0.2),
    ("poisson", 0.5)])
def test_noise_matches_jax_by_its_moments(kind, amount):
    """On a mid-grey image the noise's mean and standard deviation agree
    with the JAX function's within a few percent of 255; a seed or a
    generator replays the same noise; amount 0 returns the image."""
    img = np.full((128, 128, 3), 128, np.uint8)
    got = image_utils.add_noise(img, kind, amount, generator=5).astype(float)
    ref = jax_image_utils.add_noise(img, kind, amount,
                                    rng=np.random.default_rng(5)).astype(
                                        float)
    assert abs(got.mean() - ref.mean()) < 0.02 * 255
    assert abs(got.std() - ref.std()) < 0.03 * 255 + 0.05 * ref.std()
    np.testing.assert_array_equal(
        image_utils.add_noise(img, kind, amount, generator=5),
        image_utils.add_noise(img, kind, amount,
                              generator=torch.Generator().manual_seed(5)))
    np.testing.assert_array_equal(image_utils.add_noise(img, kind, 0.0), img)


# --------------------------------------------------------------- snapshot ---

def test_snapshot_matches_jax():
    """The port's snapshot and the JAX one give the same dict of the same
    merged config: a deep copy without the two callbacks."""
    cfg = merge_config("cpu", {"progress_callback": print,
                               "image_callback": print, "iterations": 2,
                               "esrgan_arch": {"num_feat": 8}})
    snap = snapshot(cfg)
    assert snap == jax_snapshot(cfg)
    assert "progress_callback" not in snap and "image_callback" not in snap
    assert snap == {k: v for k, v in cfg.items()
                    if k not in ("progress_callback", "image_callback")}
    snap["esrgan_arch"]["num_feat"] = 64
    snap["device_specific"]["cuda"]["tile_batch"] = 1
    assert cfg["esrgan_arch"]["num_feat"] == 8   # a deep copy
    assert cfg["device_specific"]["cuda"]["tile_batch"] == 16
