"""The NL-means kernel's module (``kernels/nlmeans.py``) on the CPU.

``nl_means_fields`` takes its plain version for a CPU tensor; the plain
version is held against the JAX package's ``_nl_means_lab_joint`` and
``_nl_means_f32`` (an image narrower than the 13-pixel reach, a batch of
three 23x37 images, sigma > 0); a float32 emulation in torch of the kernel's
walk (``csrc/nlmeans.cu``: its 26 x 32 block tiles, lanes, running column
sums, shuffle row sums and per-offset accumulation, step for step) is
held against the plain version, its area division against the IEEE
division; and the wrapper's refusals are checked on ``meta`` tensors,
which reach every check a CUDA tensor does.

Bars, as in tests/test_torch_nlmeans.py: float32 results max |diff| /
max |ref| <= 1e-5 (float32 sums in another order); uint8 results max
|diff| <= 1 on <= 1e-3 of the values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_enhanced_super_resolution_torch.kernels import (
    KernelInputError, nl_means_fields, nl_means_fields_plain)
from neural_enhanced_super_resolution_torch.kernels.nlmeans import inv_h2
from neural_enhanced_super_resolution_torch.ops.pad import reflect_index
from neural_enhanced_super_resolution_tpu.ops import nlmeans as jn

LAB_FIELDS = (((0,), 5.0), ((1, 2), 7.0))


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: intra-op threads only add contention beside the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _agree_u8(got, ref):
    g = np.clip(np.round(np.asarray(got)), 0, 255).astype(np.int64)
    r = np.clip(np.round(np.asarray(ref)), 0, 255).astype(np.int64)
    diff = np.abs(g - r)
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff > 0) <= 1e-3, np.mean(diff > 0)


def _noisy(rng, shape, integer: bool = True):
    """Flat 8 x 8 patches with edges between them and Gaussian noise of
    std 4, float32: weights between 0 and 1 at many offsets for h 5-9 (on
    uniform noise every weight but the centre's underflows). integer:
    uint8-valued, as the joint pass gets its Lab."""
    *lead, h, w, c = shape
    flat = rng.integers(40, 216, (*lead, h // 8 + 1, w // 8 + 1, c))
    img = np.kron(flat, np.ones((8, 8, 1)))[..., :h, :w, :]
    img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255)
    return (np.round(img) if integer else img).astype(np.float32)


def _jax_joint(img, h, hc):
    return np.asarray(jn._nl_means_lab_joint(
        jnp.asarray(img), jnp.float32(h), jnp.float32(hc), 7, 21))


def _jax_one(img, h, sigma):
    return np.asarray(jn._nl_means_f32(jnp.asarray(img), jnp.float32(h),
                                       jnp.float32(sigma), 7, 21))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_noisy(np.random.default_rng(0), (1, 9, 11, 3)))
    launches, calls = nl_means_fields.launches, nl_means_fields_plain.calls
    got = nl_means_fields(x, LAB_FIELDS, 0.0, 7, 21)
    assert nl_means_fields.launches == launches
    assert nl_means_fields_plain.calls == calls + 1
    assert torch.equal(got, nl_means_fields_plain(x, LAB_FIELDS, 0.0, 7, 21))


@pytest.mark.parametrize("shape", [(1, 9, 11), (3, 23, 37)],
                         ids=["9x11_reflects_twice", "3x23x37"])
def test_plain_lab_joint_matches_jax(shape):
    img = _noisy(np.random.default_rng(1), (*shape, 3))
    got = nl_means_fields_plain(torch.from_numpy(img), LAB_FIELDS, 0.0, 7,
                                21).numpy()
    ref = np.stack([_jax_joint(im, 5.0, 7.0) for im in img])
    assert _rel(got, ref) <= 1e-5
    _agree_u8(got, ref)


@pytest.mark.parametrize("shape,sigma,uint8", [
    ((1, 9, 11, 3), 0.0, True), ((3, 23, 37, 3), 4.0, True),
    ((2, 17, 21, 3), 6.0, False), ((1, 15, 12, 1), 5.0, True)],
    ids=["9x11", "3x23x37_sigma", "float_sigma", "gray_sigma"])
def test_plain_one_field_matches_jax(shape, sigma, uint8):
    rng = np.random.default_rng(2)
    img = _noisy(rng, shape, uint8)
    fields = ((tuple(range(shape[-1])), 9.0),)
    got = nl_means_fields_plain(torch.from_numpy(img), fields, sigma, 7,
                                21).numpy()
    ref = np.stack([_jax_one(im, 9.0, sigma) for im in img])
    assert _rel(got, ref) <= 1e-5
    _agree_u8(got, ref)


# ---- the kernel's walk, emulated -----------------------------------------

TW, TH, RH, REACH = 26, 32, 8, 13


def _shfl_down(v, k):
    """__shfl_down_sync over the last axis (32 lanes): lane l reads l + k,
    or keeps its own value past lane 31."""
    out = v.clone()
    out[..., :32 - k] = v[..., k:]
    return out


def _shfl_up(v, k):
    out = v.clone()
    out[..., k:] = v[..., :32 - k]
    return out


def _div_area(d, a: float):
    """div_area of csrc/nlmeans.cu on float32 ``d``: q = RN(d r), the
    remainder by an FMA (exact in float64, then rounded once), q + e r."""
    r = float(np.float32(1.0 / a))
    q = d * r
    e = (d.double() - q.double() * a).float()
    return (q.double() + e.double() * r).float()


def test_div_area_is_the_ieee_division():
    """The kernel divides by the area with div_area (three instructions,
    no branch) where the plain version takes the IEEE division: the two
    agree for every integer d below 2^24 (the uint8 data's box sums) at
    each area the kernel uses (49 C, 98), the remainder exact in float32
    throughout."""
    for a in (49.0, 98.0, 147.0, 196.0):
        r = np.float64(np.float32(1.0 / a))
        for start in range(0, 1 << 24, 1 << 22):
            d = np.arange(start, start + (1 << 22), dtype=np.float64)
            q = (d * r).astype(np.float32).astype(np.float64)
            e = d - q * a
            assert np.array_equal(e.astype(np.float32), e)
            got = (q + e * r).astype(np.float32)
            assert np.array_equal(got, (d / a).astype(np.float32)), a


def _row_sum7(v):
    a = v + _shfl_down(v, 1)
    b = a + _shfl_up(a, 2)
    return (b + _shfl_up(v, 3)) + _shfl_down(a, 2)


def kernel_walk(x: torch.Tensor, lab: bool, neg_inv0: float,
                neg_inv1: float, two_sigma2: float) -> torch.Tensor:
    """``nlmeans_kernel`` of csrc/nlmeans.cu in float32, every block, warp
    and lane at once: the patch of each block, the lane's 14 difference
    rows, the column sums (7 in full, then running), the row sums by
    shuffles, the weights and the sums, offset by offset."""
    b, h, w, c = x.shape
    nby, nbx = -(-h // TH), -(-w // TW)
    ry = reflect_index(h, REACH, nby * TH - h + REACH)
    rx = reflect_index(w, REACH, nbx * TW - w + REACH)
    # tile[b, by, bx, c, row, col]: (TH + 26) x (TW + 26) patches.
    img = x.permute(0, 3, 1, 2)[:, :, ry][:, :, :, rx]
    rows = torch.arange(nby)[:, None] * TH + torch.arange(TH + 2 * REACH)
    cols = torch.arange(nbx)[:, None] * TW + torch.arange(TW + 2 * REACH)
    tile = img[:, :, rows][:, :, :, :, cols].permute(0, 2, 4, 1, 3, 5)
    warp = torch.arange(4)[:, None] * RH                  # r0 of each warp
    lane = torch.arange(32)

    def pix(row0, col0):
        """(B, nby, nbx, C, warps, 14, lanes): patch rows row0 + r0 + i,
        columns col0 + lane."""
        r = row0 + warp[:, :, None] + torch.arange(RH + 6)[None, :, None]
        cc = (col0 + lane).expand(4, RH + 6, 32)
        return tile[..., r, cc]

    ctr = pix(10, 10)
    nf = 2 if lab else 1
    num = torch.zeros((b, nby, nbx, c, 4, RH, 32))
    den = torch.zeros((b, nby, nbx, nf, 4, RH, 32))
    area = [49.0, 98.0] if lab else [49.0 * c]
    neg = [neg_inv0, neg_inv1]
    field = [0, 1, 1] if lab else [0] * c
    for dy in range(21):
        for dx in range(21):
            s = pix(dy, dx)
            e = (ctr - s) ** 2
            d = ([e[:, :, :, 0], e[:, :, :, 1] + e[:, :, :, 2]] if lab
                 else [e.sum(3)])
            col = [di[..., :7, :].sum(-2) for di in d]
            cols = [col]
            for r in range(1, RH):
                col = [(cf + di[..., r + 6, :]) - di[..., r - 1, :]
                       for cf, di in zip(col, d)]
                cols.append(col)
            wgt = []
            for f in range(nf):
                dist = _div_area(_row_sum7(torch.stack(
                    [cr[f] for cr in cols], -2)), area[f])
                if not lab:
                    dist = torch.clamp(dist - two_sigma2, min=0.0)
                wgt.append(torch.exp(dist * neg[f]))
                den[:, :, :, f] += wgt[f]
            for ch in range(c):
                num[:, :, :, ch] += wgt[field[ch]] * s[:, :, :, ch, :,
                                                       3:3 + RH]
    out = num / den[:, :, :, field]
    # lanes 3..28 of warp w, row r of block (by, bx): pixel (by TH + w RH
    # + r, bx TW + lane - 3).
    out = out[..., 3:29].permute(0, 1, 4, 5, 2, 6, 3).reshape(
        b, nby * TH, nbx * TW, c)
    return out[:, :h, :w]


@pytest.mark.parametrize("shape,lab,sigma", [
    ((1, 9, 11, 3), True, 0.0), ((3, 23, 37, 3), True, 0.0),
    ((1, 40, 60, 3), True, 0.0), ((2, 17, 30, 3), False, 6.0),
    ((1, 13, 9, 1), False, 5.0), ((1, 12, 27, 4), False, 0.0)],
    ids=["9x11", "3x23x37", "40x60_six_blocks", "one_field_sigma",
         "gray", "four_channels"])
def test_kernel_walk_matches_the_plain_version(shape, lab, sigma):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_noisy(rng, shape, lab or shape[-1] != 3))
    fields = LAB_FIELDS if lab else ((tuple(range(shape[-1])), 9.0),)
    got = kernel_walk(x, lab, -inv_h2(fields[0][1]),
                      -inv_h2(fields[-1][1]),
                      float(torch.tensor(2.0) * torch.tensor(sigma) ** 2))
    ref = nl_means_fields_plain(x, fields, sigma, 7, 21)
    assert _rel(got, ref) <= 1e-5
    _agree_u8(got, ref)


# ---- the wrapper's refusals ----------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,match", [
    ("float64", "float32"), ("uint8", "float32"), ("3d", "float32"),
    ("strided", "contiguous"), ("five_channels", "C 1..4"),
    ("empty_batch", "shape"), ("template_5", "7x7 template"),
    ("search_11", "21x21 search"), ("sigma_negative", "sigma"),
    ("lab_with_sigma", "fields"), ("lab_on_four", "fields"),
    ("field_subset", "fields"), ("fields_swapped", "fields"),
    ("valid_meta", "no kernel for device")])
def test_wrapper_refusals(case, match):
    x, fields = _meta(1, 16, 16, 3), LAB_FIELDS
    sigma, template, search = 0.0, 7, 21
    if case == "float64":
        x = _meta(1, 16, 16, 3, dtype=torch.float64)
    elif case == "uint8":
        x = _meta(1, 16, 16, 3, dtype=torch.uint8)
    elif case == "3d":
        x = _meta(16, 16, 3)
    elif case == "strided":
        x = _meta(1, 16, 16, 6)[..., ::2]
    elif case == "five_channels":
        x, fields = _meta(1, 16, 16, 5), ((tuple(range(5)), 5.0),)
    elif case == "empty_batch":
        x = _meta(0, 16, 16, 3)
    elif case == "template_5":
        template = 5
    elif case == "search_11":
        search = 11
    elif case == "sigma_negative":
        sigma = -1.0
    elif case == "lab_with_sigma":
        sigma = 2.0
    elif case == "lab_on_four":
        x = _meta(1, 16, 16, 4)
    elif case == "field_subset":
        fields = (((0, 1), 5.0),)
    elif case == "fields_swapped":
        fields = (((1, 2), 7.0), ((0,), 5.0))
    with pytest.raises(KernelInputError, match=match):
        nl_means_fields(x, fields, sigma, template, search)
