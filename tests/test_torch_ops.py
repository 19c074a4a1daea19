"""The port's image ops and tiling against the JAX package's, on the CPU.

uint8 results must be identical or off by at most one level; each test
states the largest share of such pixels it allows (summation order and
fused multiply-adds differ between XLA and PyTorch, so a value that lands
on .5 can round the other way).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.ops.pad import reflect_pad
from neural_enhanced_super_resolution_torch.parallel import tiling as tt
from neural_enhanced_super_resolution_tpu.parallel import tiling as jt


def _mods(name):
    return (importlib.import_module(f"neural_enhanced_super_resolution_tpu"
                                    f".ops.{name}"),
            importlib.import_module(f"neural_enhanced_super_resolution_torch"
                                    f".ops.{name}"))


def _agree(got, ref, share: float):
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff > 0) <= share, np.mean(diff > 0)


@pytest.fixture
def img(test_image):
    return np.array(test_image)  # writable, so torch.from_numpy shares it


@pytest.mark.parametrize("ksize,sigma", [((3, 3), 0.0), ((0, 0), 3.0),
                                         ((0, 0), 2.0)])
def test_gaussian_blur_uint8(img, ksize, sigma):
    jb, tb = _mods("blur")
    _agree(tb.gaussian_blur(torch.from_numpy(img), ksize, sigma),
           jb.gaussian_blur(img, ksize, sigma), share=1e-3)


def test_gaussian_blur_batched_matches_per_image(img):
    _, tb = _mods("blur")
    batch = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    out = tb.gaussian_blur(batch, (3, 3), 0.0)
    for i in range(2):
        torch.testing.assert_close(out[i], tb.gaussian_blur(batch[i], (3, 3),
                                                            0.0))


def test_gray_and_lab(img):
    jc, tc = _mods("color")
    t = torch.from_numpy(img)
    _agree(tc.rgb_to_gray(t), jc.rgb_to_gray(jnp.asarray(img)), share=0.0)
    lab = np.asarray(jc.rgb_to_lab(jnp.asarray(img)))
    _agree(tc.rgb_to_lab(t), lab, share=1e-3)
    _agree(tc.lab_to_rgb(torch.from_numpy(lab.copy())),
           jc.lab_to_rgb(jnp.asarray(lab)), share=1e-3)


@pytest.mark.parametrize("hw", [(160, 160), (97, 131)])
def test_clahe(img, hw):
    jc, tc = _mods("color")
    jcl, tcl = _mods("clahe")
    big = np.tile(img, (2, 2, 1))[:hw[0], :hw[1]]
    lum = np.ascontiguousarray(np.asarray(jc.rgb_to_lab(jnp.asarray(big)))
                               [:, :, 0])
    _agree(tcl.clahe(torch.from_numpy(lum)), jcl.clahe(lum), share=0.0)


def test_contrast_stage(img):
    je, te = _mods("enhance")
    _agree(te.contrast_stage(torch.from_numpy(img)), je.contrast_stage(img),
           share=1e-3)


@pytest.mark.parametrize("mode", ["bicubic", "lanczos4"])
@pytest.mark.parametrize("dsize", [(333, 250), (80, 70)])
def test_resize(img, mode, dsize):
    jr, tr = _mods("resize")
    _agree(tr.resize(torch.from_numpy(img), dsize, interpolation=mode),
           jr.resize(img, dsize, interpolation=mode), share=1e-3)


@pytest.mark.parametrize("hw", [(160, 160), (900, 800)],
                         ids=["whole", "tiled_above_768"])
def test_adaptive_sharpen(img, hw):
    je, te = _mods("enhance")
    big = np.ascontiguousarray(np.tile(img, (6, 5, 1))[:hw[0], :hw[1]])
    _agree(te.adaptive_sharpen(torch.from_numpy(big)),
           je.adaptive_sharpen(big), share=0.0)


def test_ensemble_single_and_mean(img):
    je, te = _mods("enhance")
    a, b = img, img[::-1].copy()
    _agree(te.ensemble([torch.from_numpy(a), torch.from_numpy(b)]),
           je.ensemble([a, b]), share=0.0)
    assert te.ensemble([torch.from_numpy(a)]) is not None


@pytest.mark.parametrize("n,before,after", [(5, 2, 3), (4, 9, 11), (1, 0, 0)])
def test_reflect_pad_is_numpy_reflect(n, before, after):
    x = torch.arange(n * 2, dtype=torch.uint8).reshape(n, 2)
    want = np.pad(x.numpy(), ((before, after), (0, 0)), mode="reflect") \
        if n > 1 else x.numpy()
    np.testing.assert_array_equal(reflect_pad(x, 0, before, after).numpy(),
                                  want)


@pytest.mark.parametrize("tail", ["bucket", "full"])
def test_process_tiled_matches_jax(img, tail):
    """Whatever tail padding the JAX package uses, the port gives the same
    pixels and runs the partial last chunk at its own size."""
    def jfn(t):
        return jnp.repeat(jnp.repeat(t, 2, axis=1), 2, axis=2) // 2 + t.max()

    seen = []

    def tfn(t):
        seen.append(int(t.shape[0]))
        up = t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return up // 2 + t.max()

    sub = img[:150, :130]   # 4 x 3 tiles of 48: chunks of 5, 5 and 2
    ref = np.asarray(jt.process_tiled(jfn, jnp.asarray(sub), tile_size=48,
                                      halo=6, scale=2, batch_tiles=5,
                                      tail=tail))
    got = tt.process_tiled(tfn, torch.from_numpy(sub), tile_size=48, halo=6,
                           scale=2, batch_tiles=5)
    np.testing.assert_array_equal(got.numpy(), ref)
    host = tt.process_tiled_to_host(tfn, torch.from_numpy(sub), tile_size=48,
                                    halo=6, scale=2, batch_tiles=5)
    np.testing.assert_array_equal(host, ref)
    assert seen == [5, 5, 2, 5, 5, 2]


def test_extract_tiles_halo_wider_than_image(img):
    sub = img[:40, :40]
    ref = jt.extract_tiles(jt.pad_to_grid(jnp.asarray(sub), 32)[0], 32, 50)
    got = tt.extract_tiles(tt.pad_to_grid(torch.from_numpy(sub), 32)[0], 32,
                           50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_process_tiled_cancel(img):
    with pytest.raises(tt.TilingCancelled):
        tt.process_tiled(lambda t: t, torch.from_numpy(img), tile_size=32,
                         halo=4, scale=1, batch_tiles=2,
                         cancel_check=lambda: True)
