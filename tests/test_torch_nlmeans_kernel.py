"""The NL-means kernel's module (``kernels/nlmeans.py``) on the CPU.

``nl_means_fields`` takes its plain version for a CPU tensor; the plain
version is held against the JAX package's ``_nl_means_lab_joint`` and
``_nl_means_f32`` (an image narrower than the 13-pixel reach, a batch of
three 23x37 images, sigma > 0); a float32 emulation in torch of the kernel's
walk (``csrc/nlmeans.cu``: its 58 x 32 block tiles in the kernel's
storage order, two columns a lane, running column sums, shuffle row
sums, the folded weight and per-offset accumulation, step for step, and
the search rows split between the blocks of a cluster) is held against
the plain version; the folded weight's exponent is bounded against the
plain one for every integer box sum; and the wrapper's refusals are
checked on ``meta`` tensors,
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

# csrc/nlmeans.cu's tile: a lane owns CPL adjacent columns and a warp RH
# rows; the patch is WIN + 20 columns wide, stored with the columns of one
# residue mod CPL side by side (HALF apiece).
CPL, RH, WARPS, REACH = 2, 8, 4, 13
WIN = 32 * CPL
TW, TH = WIN - 6, RH * WARPS
EXT_W, EXT_H = WIN + 20, TH + 2 * REACH
HALF = EXT_W // CPL
LOG2E = 1.4426950408889634


def folded(neg_inv: float, area: float, two_sigma2: float = 0.0):
    """The kernel's weight constants as its C entry computes them in
    double: k = RN(-1/h^2 log2(e) / area), b = RN(-2 sigma^2 area k)."""
    k = np.float32(np.float64(neg_inv) * LOG2E / area)
    b = np.float32(-np.float64(two_sigma2) * area * np.float64(k))
    return float(k), float(b)


def _fma(a, b, c):
    """fmaf on float32 tensors: the product exact in float64, one sum,
    rounded to float32."""
    return (a.double() * b.double() + c.double()).float()


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


def _row_sums(c0, c1):
    """row_sums<2>: s = c0 + c1, t = (s + s(l - 1)) + s(l + 1), the even
    column + c1(l - 2), the odd one + c0(l + 2)."""
    s = c0 + c1
    t = (s + _shfl_up(s, 1)) + _shfl_down(s, 1)
    return t + _shfl_up(c1, 2), t + _shfl_down(c0, 2)


def _col_pos(pc):
    return (pc % CPL) * HALF + pc // CPL


def kernel_walk(x: torch.Tensor, lab: bool, neg_inv0: float,
                neg_inv1: float, two_sigma2: float,
                split: int = 1) -> torch.Tensor:
    """``nlmeans_kernel`` of csrc/nlmeans.cu in float32, every block, warp,
    lane and column at once: the patch of each block in the kernel's
    storage order, read back by its addressing; the lane's 14 difference
    rows at its two columns (FMA where the kernel takes one), the column
    sums (7 in full, then running), the row sums by shuffles, the folded
    weight 2^(d k) and the sums, offset by offset over each block's share
    of the search rows; with ``split`` blocks a tile, the shares' sums
    added in block order."""
    b, h, w, c = x.shape
    nby, nbx = -(-h // TH), -(-w // TW)
    ry = reflect_index(h, REACH, nby * TH - h + REACH)
    rx = reflect_index(w, REACH, nbx * TW - w + REACH)
    img = x.permute(0, 3, 1, 2)[:, :, ry][:, :, :, rx]
    rows = torch.arange(nby)[:, None] * TH + torch.arange(EXT_H)
    cols = torch.arange(nbx)[:, None] * TW + torch.arange(EXT_W)
    # patch[b, by, bx, c, pr, pc], then stored at column _col_pos(pc)
    patch = img[:, :, rows][:, :, :, :, cols].permute(0, 2, 4, 1, 3, 5)
    tile = torch.empty_like(patch)
    tile[..., _col_pos(torch.arange(EXT_W))] = patch
    r0 = torch.arange(WARPS)[:, None] * RH               # (4, 1)
    lane = torch.arange(32)[:, None]                     # (32, 1)
    jj = torch.arange(CPL)[None, :]                      # (1, CPL)

    def pix(row0, dx):
        """(B, nby, nbx, C, warps, 14, lanes, CPL): patch rows row0 + r0 +
        i at the lane's columns shifted by dx, by the kernel's address
        (j + dx) % CPL * HALF + lane + (j + dx) // CPL."""
        r = (row0 + r0 + torch.arange(RH + 6))[:, :, None, None]
        pos = ((jj + dx) % CPL) * HALF + lane + (jj + dx) // CPL
        return tile[..., r, pos[None, None]]

    ctr = pix(10, 10)
    nf = 2 if lab else 1
    area = [49.0, 98.0] if lab else [49.0 * c]
    k0, b0 = folded(neg_inv0, area[0], 0.0 if lab else two_sigma2)
    k = [k0, folded(neg_inv1, area[-1])[0]]
    field = [0, 1, 1] if lab else [0] * c
    parts = []
    for rank in range(split):
        num = torch.zeros((b, nby, nbx, c, WARPS, RH, 32, CPL))
        den = torch.zeros((b, nby, nbx, nf, WARPS, RH, 32, CPL))
        for dy in range(21 * rank // split, 21 * (rank + 1) // split):
            for dx in range(21):
                s = pix(dy, dx)
                e = ctr - s
                if lab:
                    d = [e[:, :, :, 0] * e[:, :, :, 0],
                         _fma(e[:, :, :, 2], e[:, :, :, 2],
                              e[:, :, :, 1] * e[:, :, :, 1])]
                else:
                    acc = e[:, :, :, 0] * e[:, :, :, 0]
                    for ch in range(1, c):
                        acc = _fma(e[:, :, :, ch], e[:, :, :, ch], acc)
                    d = [acc]
                col = [di[..., 0, :, :] for di in d]
                for i in range(1, 7):
                    col = [cf + di[..., i, :, :] for cf, di in zip(col, d)]
                for r in range(RH):
                    if r > 0:
                        col = [(cf + di[..., r + 6, :, :]) - di[..., r - 1, :, :]
                               for cf, di in zip(col, d)]
                    wgt = []
                    for f in range(nf):
                        sums = torch.stack(_row_sums(col[f][..., 0],
                                                     col[f][..., 1]), -1)
                        arg = (sums * k[f] if lab else torch.clamp(
                            _fma(sums, torch.tensor(k0),
                                 torch.tensor(b0)), max=0.0))
                        wgt.append(torch.exp2(arg))
                        den[:, :, :, f, :, r] += wgt[f]
                    for ch in range(c):
                        num[:, :, :, ch, :, r] = _fma(
                            wgt[field[ch]], s[:, :, :, ch, :, r + 3],
                            num[:, :, :, ch, :, r])
        parts.append((num, den))
    num, den = parts[0]
    for pn, pd in parts[1:]:
        num, den = num + pn, den + pd
    out = num / den[:, :, :, field]
    # window column CPL lane + j, whole for 3 .. WIN - 4: image column bx
    # TW + CPL lane + j - 3; warp w, row r: image row by TH + w RH + r.
    out = out.flatten(-2)[..., 3:WIN - 3].permute(0, 1, 4, 5, 2, 6, 3)
    return out.reshape(b, nby * TH, nbx * TW, c)[:, :h, :w]


@pytest.mark.parametrize("shape,lab,sigma,split", [
    ((1, 9, 11, 3), True, 0.0, 1), ((3, 23, 37, 3), True, 0.0, 1),
    ((1, 40, 60, 3), True, 0.0, 1), ((2, 17, 30, 3), False, 6.0, 1),
    ((1, 13, 9, 1), False, 5.0, 1), ((1, 12, 27, 4), False, 0.0, 1),
    ((2, 37, 23, 3), True, 0.0, 8)],
    ids=["9x11", "3x23x37", "40x60_four_blocks", "one_field_sigma",
         "gray", "four_channels", "split_8"])
def test_kernel_walk_matches_the_plain_version(shape, lab, sigma, split):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_noisy(rng, shape, lab or shape[-1] != 3))
    fields = LAB_FIELDS if lab else ((tuple(range(shape[-1])), 9.0),)
    got = kernel_walk(x, lab, -inv_h2(fields[0][1]),
                      -inv_h2(fields[-1][1]),
                      float(np.float32(2.0) * np.float32(sigma) ** 2),
                      split)
    ref = nl_means_fields_plain(x, fields, sigma, 7, 21)
    assert _rel(got, ref) <= 1e-5
    _agree_u8(got, ref)


@pytest.mark.parametrize("area,h,sigma", [
    (49.0, 5.0, 0.0), (98.0, 5.0, 0.0), (147.0, 9.0, 0.0),
    (196.0, 3.0, 0.0), (147.0, 9.0, 6.0), (49.0, 5.0, 4.0)],
    ids=["L", "ab", "three_channels", "four_channels",
         "three_channels_sigma", "gray_sigma"])
def test_folded_weight_is_bounded_by_the_plain_weight(area, h, sigma):
    """The kernel's exponent x = min(RN(d k + b), 0) (base 2; k, b from
    ``folded``) against the plain version's y = RN(max(RN(d / area) - 2
    sigma^2, 0) * (-1/h^2)) (base e), for every integer box sum d below
    2^24 (the uint8 data's). Four float32 roundings (k, d k; d / area, the
    product) bound |x ln 2 - y| by 4 u |y| (u = 2^-24), and the clamp's
    (b, the difference) add u |1/h^2| (d / area + 2 sigma^2): the weights
    differ by that relative amount. ex2.approx's own error on the card
    comes on top; the card's agreement bars hold the whole."""
    u = 2.0 ** -24
    neg = -inv_h2(h)
    s2 = float(np.float32(2.0) * np.float32(sigma) ** 2)
    k, b = folded(neg, area, s2)
    for start in range(0, 1 << 24, 1 << 22):
        d = np.arange(start, start + (1 << 22), dtype=np.float64)
        x = np.minimum((d * k + b).astype(np.float32), 0).astype(np.float64)
        q = (d / area).astype(np.float32)
        t = np.maximum((q - np.float32(s2)).astype(np.float32), 0)
        y = (t * np.float32(neg)).astype(np.float32).astype(np.float64)
        err = np.abs(x * np.log(2.0) - y)
        bar = (4.0 * u + 2.0 ** -40) * np.abs(y) + (
            1.01 * u * abs(neg) * (d / area + s2) if sigma > 0 else 0.0)
        assert (err <= bar).all(), (area, h, sigma, d[err > bar][:4])


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
