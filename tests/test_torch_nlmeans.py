"""The port's NL-means, denoise and masked-sharpen stages, small filters and
linear Lab against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages. Bars:

* uint8 results (NL-means, denoise_stage, masked_sharpen, dilate,
  box_blur, linear Lab): max |diff| <= 1 and a differing share <= 1e-3;
  exact where the test says so. On these inputs the two packages' float32
  NL-means agree to the bit (its box sums are exact integers); the bar
  leaves room for a value rounded on the other side of .5.
* the float32 joint Lab pass: max |diff| / max |ref| <= 1e-5.
* a batch against per-image calls: exact (every op is per image).
* filter2d: against JAX's with point-symmetric kernels (the JAX package
  flips the kernel before its correlation, which only they survive), and
  against cv2.filter2D with an asymmetric one; <= 1 on <= 1e-3.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.ops import blur as tb
from neural_enhanced_super_resolution_torch.ops import color as tc
from neural_enhanced_super_resolution_torch.ops import enhance as te
from neural_enhanced_super_resolution_torch.ops import nlmeans as tn
from neural_enhanced_super_resolution_tpu.ops import blur as jb
from neural_enhanced_super_resolution_tpu.ops import color as jc
from neural_enhanced_super_resolution_tpu.ops import enhance as je
from neural_enhanced_super_resolution_tpu.ops import nlmeans as jn


def _agree(got, ref, share: float = 1e-3):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff > 0) <= share, np.mean(diff > 0)


def _noisy(rng, shape):
    return np.clip(rng.normal(128, 45, shape), 0, 255).astype(np.uint8)


@pytest.fixture
def img(test_image):
    return np.array(test_image)


@pytest.mark.parametrize("which", ["fixture", "noisy"])
def test_nl_means_colored(img, which):
    src = img[:48, :40] if which == "fixture" else _noisy(
        np.random.default_rng(1), (32, 36, 3))
    src = np.ascontiguousarray(src)
    _agree(tn.nl_means_colored(torch.from_numpy(src), h=5.0, h_color=7.0),
           jn.nl_means_colored(src, h=5.0, h_color=7.0))


def test_nl_means_gray_with_sigma():
    gray = _noisy(np.random.default_rng(2), (30, 34))
    _agree(tn.nl_means(torch.from_numpy(gray), h=10.0, sigma=5.0),
           jn.nl_means(gray, h=10.0, sigma=5.0))


def test_nl_means_lab_joint_f32():
    lab = np.random.default_rng(3).integers(0, 256, (36, 40, 3)).astype(
        np.float32)
    ref = np.asarray(jn._nl_means_lab_joint(
        jnp.asarray(lab), jnp.float32(5.0), jnp.float32(7.0), 7, 21))
    got = tn._nl_means_lab_joint(torch.from_numpy(lab)[None], 5.0, 7.0)[0]
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() <= 1e-5


def test_nl_means_batch_equals_per_image(img):
    rng = np.random.default_rng(4)
    batch = torch.from_numpy(np.stack([img[:24, :28], _noisy(rng, (24, 28, 3)),
                                       img[-24:, -28:]]))
    out = tn.nl_means_colored(batch, h=6.0, h_color=6.0)
    for i in range(batch.shape[0]):
        torch.testing.assert_close(
            out[i], tn.nl_means_colored(batch[i], h=6.0, h_color=6.0),
            rtol=0, atol=0)


@pytest.mark.parametrize("srgb", [True, False])
def test_lab_both_ways(img, srgb):
    """srgb=False is exact both ways; the sRGB round trip keeps the bar of
    tests/test_torch_ops.py (its gamma powers differ by an ulp)."""
    _agree(tc.rgb_to_lab(torch.from_numpy(img), srgb=srgb),
           jc.rgb_to_lab(img, srgb=srgb), share=0.0)
    lab = np.asarray(jc.rgb_to_lab(img, srgb=srgb))
    _agree(tc.lab_to_rgb(torch.from_numpy(lab.copy()), srgb=srgb),
           jc.lab_to_rgb(lab, srgb=srgb), share=1e-3 if srgb else 0.0)


@pytest.mark.parametrize("ksize", [(3, 3), (5, 3)])
def test_box_blur(img, ksize):
    _agree(tb.box_blur(torch.from_numpy(img), ksize),
           jb.box_blur(img, ksize), share=0.0)


@pytest.mark.parametrize("kind", ["motion5", "symmetric_random"])
def test_filter2d_matches_jax(img, kind):
    if kind == "motion5":   # the JAX package's motion-blur kernel
        kern = np.zeros((5, 5), np.float32)
        kern[2, :] = 1.0 / 5
    else:
        k = np.random.default_rng(5).random((3, 3)).astype(np.float32)
        kern = (k + k[::-1, ::-1]) / (2 * k.sum())
    _agree(tb.filter2d(torch.from_numpy(img), kern), jb.filter2d(img, kern))


def test_filter2d_is_correlation_like_cv2(img):
    kern = np.random.default_rng(6).random((3, 5)).astype(np.float32)
    kern /= kern.sum()
    _agree(tb.filter2d(torch.from_numpy(img), kern),
           cv2.filter2D(img, -1, kern, borderType=cv2.BORDER_REFLECT_101))


@pytest.mark.parametrize("ksize,iterations", [(3, 1), (5, 2)])
def test_dilate(ksize, iterations):
    mask = (np.random.default_rng(7).random((40, 44)) > 0.97).astype(
        np.uint8)
    _agree(tb.dilate(torch.from_numpy(mask), ksize, iterations),
           jb.dilate(mask, ksize, iterations), share=0.0)
    batch = torch.from_numpy(np.stack([mask, mask[::-1].copy()])[..., None])
    out = tb.dilate(batch, ksize, iterations)
    assert torch.equal(out[1, ..., 0], tb.dilate(batch[1, ..., 0], ksize,
                                                 iterations))


@pytest.mark.parametrize("hw,max_mp", [
    ((40, 48), None), ((48, 800), None), ((100, 96), 0.002)],
    ids=["whole", "tiled_above_768", "capped_residual"])
def test_denoise_stage(img, hw, max_mp):
    src = np.ascontiguousarray(np.tile(img, (1, 6, 1))[:hw[0], :hw[1]])
    _agree(te.denoise_stage(torch.from_numpy(src), 0.5, max_mp),
           je.denoise_stage(src, 0.5, max_mp))


@pytest.mark.parametrize("hw", [(64, 72), (48, 800)],
                         ids=["whole", "tiled_above_768"])
def test_masked_sharpen(img, hw):
    src = np.ascontiguousarray(np.tile(img, (1, 6, 1))[:hw[0], :hw[1]])
    mask = (np.random.default_rng(8).random(hw) > 0.9).astype(np.uint8)
    _agree(te.masked_sharpen(torch.from_numpy(src), torch.from_numpy(mask)),
           je.masked_sharpen(src, mask), share=0.0)
