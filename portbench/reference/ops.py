"""The request's image operations in plain PyTorch, frozen.

A copy of the port's plain-PyTorch image ops as they stand when this
benchmark was written: reflect padding, OpenCV-semantics blur, pointwise,
colour, resize and CLAHE, the plain NL-means (the formulation the port's
NL-means kernel is held to), the denoise / contrast / sharpen / ensemble
stages, and the overlap-halo tiling's generic path. The benchmark's
reference runs these on the card in float32; a later change to the
program's ops that alters their arithmetic then shows as a difference
against this copy. Nothing here imports the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# ------------------------------------------------------------
# from ops/pad.py
# ------------------------------------------------------------

def reflect_index(n: int, before: int, after: int,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Source indices of an axis of length n reflect-padded by (before,
    after). Computed on ``device`` (reflection is periodic with period
    2 (n - 1)), so no host-to-device copy waits on the host."""
    idx = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = idx.abs() % period
    return torch.where(idx >= n, period - idx, idx)


def reflect_pad(x: torch.Tensor, dim: int, before: int,
                after: int) -> torch.Tensor:
    """Reflect-101 pad ``x`` along ``dim``."""
    if before == 0 and after == 0:
        return x
    idx = reflect_index(x.shape[dim], before, after, x.device)
    return x.index_select(dim, idx)


# ------------------------------------------------------------
# from ops/blur.py
# ------------------------------------------------------------

# OpenCV's fixed small-gaussian tables for ksize<=7 with sigma<=0.
_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125]),
}


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics (incl. fixed small-kernel tables)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].astype(np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _ksize_from_sigma(sigma: float, uint8: bool = True) -> int:
    """OpenCV: ksize = round(sigma * (8U ? 3 : 4) * 2 + 1) | 1."""
    return int(round(sigma * (3 if uint8 else 4) * 2 + 1)) | 1


def saturate_like(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round-and-clip to an integer dtype, plain cast to a float one."""
    if dtype.is_floating_point:
        return y.to(dtype)
    info = torch.iinfo(dtype)
    return torch.clamp(torch.round(y), info.min, info.max).to(dtype)


def _filter_axis(x: torch.Tensor, kern: np.ndarray, dim: int) -> torch.Tensor:
    k = len(kern)
    if k == 1:
        return x * float(kern[0])
    n = x.shape[dim]
    xp = reflect_pad(x, dim, k // 2, k // 2)
    acc = xp.narrow(dim, 0, n) * float(kern[0])
    for i in range(1, k):
        acc = acc + xp.narrow(dim, i, n) * float(kern[i])
    return acc


def _hw_dims(img: torch.Tensor) -> tuple[int, int]:
    return (-2, -1) if img.dim() == 2 else (-3, -2)


def _sep_filter(img: torch.Tensor, kern_h: np.ndarray,
                kern_w: np.ndarray) -> torch.Tensor:
    hdim, wdim = _hw_dims(img)
    x = _filter_axis(img.float(), kern_h, hdim)
    x = _filter_axis(x, kern_w, wdim)
    return saturate_like(x, img.dtype)


def gaussian_blur(img: torch.Tensor, ksize=(0, 0), sigma: float = 0.0,
                  sigma_y: float | None = None) -> torch.Tensor:
    """cv2.GaussianBlur(img, ksize, sigmaX[, sigmaY]), BORDER_REFLECT_101.

    img: (H, W), (H, W, C) or (..., H, W, C); same shape and dtype out.
    """
    kw_, kh_ = (int(ksize[0]), int(ksize[1])) if ksize else (0, 0)
    sy = sigma if sigma_y is None else sigma_y
    uint8 = not img.dtype.is_floating_point
    if kw_ <= 0:
        kw_ = _ksize_from_sigma(sigma, uint8)
    if kh_ <= 0:
        kh_ = _ksize_from_sigma(sy, uint8)
    return _sep_filter(img, gaussian_kernel1d(kh_, sy),
                       gaussian_kernel1d(kw_, sigma))


def _max_axis(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Max over a window of k along dim, -inf beyond the edges."""
    n, pad = x.shape[dim], k // 2
    edge = list(x.shape)
    edge[dim] = pad
    fill = torch.full(edge, -torch.inf, dtype=x.dtype, device=x.device)
    xp = torch.cat([fill, x, fill], dim=dim)
    out = xp.narrow(dim, 0, n)
    for i in range(1, k):
        out = torch.maximum(out, xp.narrow(dim, i, n))
    return out


def dilate(img: torch.Tensor, ksize: int = 3,
           iterations: int = 1) -> torch.Tensor:
    """cv2.dilate with a ksize x ksize all-ones structuring element; the
    border never wins the max (-inf padding)."""
    hdim, wdim = _hw_dims(img)
    x = img.float()
    for _ in range(iterations):
        x = _max_axis(_max_axis(x, ksize, hdim), ksize, wdim)
    return saturate_like(x, img.dtype)


# ------------------------------------------------------------
# from ops/pointwise.py
# ------------------------------------------------------------

def add_weighted(a: torch.Tensor, alpha: float, b: torch.Tensor, beta: float,
                 gamma: float = 0.0) -> torch.Tensor:
    """cv2.addWeighted: saturate(a*alpha + b*beta + gamma)."""
    y = a.float() * alpha + b.float() * beta + gamma
    return saturate_like(y, a.dtype)


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cv2.subtract: saturating subtraction (uint8 clamps at 0)."""
    return saturate_like(a.float() - b.float(), a.dtype)


def convert_scale_abs(x: torch.Tensor, alpha: float = 1.0,
                      beta: float = 0.0) -> torch.Tensor:
    """cv2.convertScaleAbs: saturate_cast<uint8>(|x*alpha + beta|)."""
    return saturate_like(torch.abs(x.float() * alpha + beta), torch.uint8)


def threshold_binary(x: torch.Tensor, thresh: float,
                     maxval: float = 255.0) -> torch.Tensor:
    """cv2.threshold(..., THRESH_BINARY): maxval where x > thresh else 0."""
    y = torch.where(x.float() > thresh, maxval, 0.0)
    return saturate_like(y, x.dtype)


# ------------------------------------------------------------
# from ops/color.py
# ------------------------------------------------------------

# D65 white point, sRGB primaries: the matrices OpenCV uses for Lab.
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.53715, -0.498535),
            (-0.969256, 1.875991, 0.041556),
            (0.055648, -0.204043, 1.057311))
_WHITE = (0.950456, 1.0, 1.088754)


def _f32(v: float) -> float:
    """Round a Python constant to float32, as the JAX tables are."""
    return float(torch.tensor(v, dtype=torch.float32))


def _mat3(x: torch.Tensor, m) -> list[torch.Tensor]:
    ch = [x[..., 0], x[..., 1], x[..., 2]]
    return [ch[0] * _f32(r[0]) + ch[1] * _f32(r[1]) + ch[2] * _f32(r[2])
            for r in m]


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2GRAY: Y = 0.299 R + 0.587 G + 0.114 B."""
    x = img.float()
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    return saturate_like(y, img.dtype)


def _srgb_gamma_inv(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u <= 0.04045, u / 12.92, ((u + 0.055) / 1.055) ** 2.4)


def _srgb_gamma_fwd(u: torch.Tensor) -> torch.Tensor:
    u = torch.clamp(u, min=0.0)
    return torch.where(u <= 0.0031308, u * 12.92,
                       1.055 * u ** (1.0 / 2.4) - 0.055)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    cbrt = torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)
    return torch.where(t > 0.008856, cbrt, 7.787 * t + 16.0 / 116.0)


def _lab_f_inv(ft: torch.Tensor) -> torch.Tensor:
    return torch.where(ft > 0.2068966, ft ** 3, (ft - 16.0 / 116.0) / 7.787)


def rgb_to_lab(img: torch.Tensor, srgb: bool = True) -> torch.Tensor:
    """cv2.COLOR_RGB2LAB for uint8 images (L, a, b each in [0, 255]).

    With srgb=False this is cv2.COLOR_LRGB2Lab (linear RGB, no gamma), the
    variant fastNlMeansDenoisingColored uses internally."""
    is_int = not img.dtype.is_floating_point
    x = img.float() / (255.0 if is_int else 1.0)
    if srgb:
        x = _srgb_gamma_inv(x)
    xyz = _mat3(x, _RGB2XYZ)
    f = [_lab_f(xyz[i] / _f32(_WHITE[i])) for i in range(3)]
    L = 116.0 * f[1] - 16.0
    a = 500.0 * (f[0] - f[1])
    b = 200.0 * (f[1] - f[2])
    if is_int:
        lab = torch.stack([L * 255.0 / 100.0, a + 128.0, b + 128.0], dim=-1)
        return saturate_like(lab, img.dtype)
    return torch.stack([L, a, b], dim=-1).to(img.dtype)


def lab_to_rgb(lab: torch.Tensor, srgb: bool = True) -> torch.Tensor:
    """cv2.COLOR_LAB2RGB for uint8 images (srgb=False: COLOR_Lab2LRGB)."""
    is_int = not lab.dtype.is_floating_point
    x = lab.float()
    if is_int:
        L = x[..., 0] * 100.0 / 255.0
        a = x[..., 1] - 128.0
        b = x[..., 2] - 128.0
    else:
        L, a, b = x[..., 0], x[..., 1], x[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = torch.stack([_lab_f_inv(fx) * _f32(_WHITE[0]),
                       _lab_f_inv(fy) * _f32(_WHITE[1]),
                       _lab_f_inv(fz) * _f32(_WHITE[2])], dim=-1)
    rgb = torch.stack(_mat3(xyz, _XYZ2RGB), dim=-1)
    if srgb:
        rgb = _srgb_gamma_fwd(torch.clamp(rgb, min=0.0))
    rgb = torch.clamp(rgb, 0.0, 1.0)
    if is_int:
        return saturate_like(rgb * 255.0, lab.dtype)
    return rgb.to(lab.dtype)


# ------------------------------------------------------------
# from ops/resize.py
# ------------------------------------------------------------

INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_CUBIC = 2
INTER_AREA = 3
INTER_LANCZOS4 = 4

_MODE_NAMES = {
    "nearest": INTER_NEAREST, "bilinear": INTER_LINEAR,
    "linear": INTER_LINEAR, "bicubic": INTER_CUBIC, "cubic": INTER_CUBIC,
    "area": INTER_AREA, "lanczos": INTER_LANCZOS4, "lanczos4": INTER_LANCZOS4,
}


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0, (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a,
                 0.0))


def _lanczos4_kernel(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return np.where(np.abs(x) < 4.0, np.sinc(x) * np.sinc(x / 4.0), 0.0)


def _axis_weights_interp(src: int, dst: int, mode: int) -> np.ndarray:
    scale = src / dst
    W = np.zeros((dst, src), dtype=np.float64)
    if mode == INTER_NEAREST:
        for d in range(dst):
            W[d, min(int(np.floor(d * scale)), src - 1)] = 1.0
        return W
    if mode == INTER_LINEAR:
        taps, offs = 2, 0
        kernel = lambda t: np.maximum(0.0, 1.0 - np.abs(t))  # noqa: E731
    elif mode == INTER_CUBIC:
        taps, offs, kernel = 4, 1, _cubic_kernel
    elif mode == INTER_LANCZOS4:
        taps, offs, kernel = 8, 3, _lanczos4_kernel
    else:
        raise ValueError(f"unsupported interp mode {mode}")
    for d in range(dst):
        fx = (d + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        w = kernel(fx - sx - (np.arange(taps) - offs))
        if w.sum() != 0:
            w = w / w.sum()
        for k in range(taps):
            W[d, min(max(sx + k - offs, 0), src - 1)] += w[k]
    return W


def _axis_weights_area_up(src: int, dst: int) -> np.ndarray:
    scale, inv_scale = src / dst, dst / src
    W = np.zeros((dst, src), dtype=np.float64)
    for d in range(dst):
        s = int(np.floor(d * scale))
        fx = (d + 1) - (s + 1) * inv_scale
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        W[d, min(s, src - 1)] += 1.0 - fx
        W[d, min(s + 1, src - 1)] += fx
    return W


def _axis_weights_area(src: int, dst: int) -> np.ndarray:
    scale = src / dst
    W = np.zeros((dst, src), dtype=np.float64)
    for d in range(dst):
        lo, hi = d * scale, (d + 1) * scale
        for s in range(int(np.floor(lo)), min(int(np.ceil(hi)), src)):
            overlap = min(hi, s + 1) - max(lo, s)
            if overlap > 0:
                W[d, s] = overlap / scale
    return W


@functools.lru_cache(maxsize=512)
def _weight_matrices(src_h: int, src_w: int, dst_h: int, dst_w: int,
                     mode: int) -> tuple[np.ndarray, np.ndarray]:
    if mode == INTER_AREA:
        if dst_h <= src_h and dst_w <= src_w:
            wh, ww = (_axis_weights_area(src_h, dst_h),
                      _axis_weights_area(src_w, dst_w))
        else:
            wh, ww = (_axis_weights_area_up(src_h, dst_h),
                      _axis_weights_area_up(src_w, dst_w))
    else:
        wh = _axis_weights_interp(src_h, dst_h, mode)
        ww = _axis_weights_interp(src_w, dst_w, mode)
    return wh.astype(np.float32), ww.astype(np.float32)


def resize(img: torch.Tensor, dsize=None, fx: float = 0.0, fy: float = 0.0,
           interpolation="bilinear") -> torch.Tensor:
    """cv2.resize for an (H, W) or (H, W, C) tensor; dsize is (w, h)."""
    mode = (_MODE_NAMES[interpolation.lower()]
            if isinstance(interpolation, str) else int(interpolation))
    src_h, src_w = int(img.shape[0]), int(img.shape[1])
    if dsize is not None:
        dst_w, dst_h = int(dsize[0]), int(dsize[1])
    else:
        dst_w, dst_h = int(round(src_w * fx)), int(round(src_h * fy))
    if dst_h <= 0 or dst_w <= 0:
        raise ValueError(f"invalid destination size ({dst_w}, {dst_h})")
    if (dst_h, dst_w) == (src_h, src_w) and mode != INTER_AREA:
        return img
    wh, ww = (torch.from_numpy(m).to(img.device)
              for m in _weight_matrices(src_h, src_w, dst_h, dst_w, mode))
    x = img.float()
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, :, None]
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    y = torch.einsum("oh,hwc->owc", wh, x)
    y = torch.einsum("pw,owc->opc", ww, y)
    if squeeze:
        y = y[:, :, 0]
    return saturate_like(y, img.dtype)


# ------------------------------------------------------------
# from ops/clahe.py
# ------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _interp_grids(h: int, w: int, tiles_y: int, tiles_x: int,
                  tile_h: int, tile_w: int):
    """Per-pixel tile indices and bilinear weights (OpenCV mapping)."""
    def axis(n, tiles, tile):
        f = np.arange(n, dtype=np.float64) / tile - 0.5
        i1 = np.floor(f).astype(np.int64)
        a = (f - i1).astype(np.float32)
        i2 = np.minimum(i1 + 1, tiles - 1)
        i1 = np.maximum(i1, 0)
        return i1, i2, a

    return axis(h, tiles_y, tile_h) + axis(w, tiles_x, tile_w)


def clahe(src: torch.Tensor, clip_limit: float = 2.0,
          tile_grid_size=(8, 8)) -> torch.Tensor:
    """cv2.createCLAHE(clipLimit, tileGridSize).apply(src), uint8 (H, W)."""
    if src.dtype != torch.uint8:
        raise TypeError("clahe expects a uint8 single-channel image")
    if src.dim() != 2:
        raise ValueError("clahe expects a 2-D (H, W) image")
    tiles_x, tiles_y = int(tile_grid_size[0]), int(tile_grid_size[1])
    dev = src.device
    h, w = src.shape
    he = -(-h // tiles_y) * tiles_y
    we = -(-w // tiles_x) * tiles_x
    ext = reflect_pad(reflect_pad(src, 0, 0, he - h), 1, 0, we - w)
    th, tw = he // tiles_y, we // tiles_x
    tile_area = th * tw
    n_tiles = tiles_y * tiles_x

    vals = ext.reshape(tiles_y, th, tiles_x, tw).permute(0, 2, 1, 3)
    vals = vals.reshape(n_tiles, tile_area).long()
    offs = torch.arange(n_tiles, device=dev)[:, None] * 256
    hist = torch.bincount((vals + offs).reshape(-1),
                          minlength=n_tiles * 256).reshape(n_tiles, 256)

    if clip_limit > 0:
        limit = max(int(clip_limit * tile_area / 256.0), 1)
        clipped = torch.clamp(hist - limit, min=0).sum(dim=1, keepdim=True)
        hist = torch.clamp(hist, max=limit)
        batch = clipped // 256
        residual = clipped - batch * 256
        hist = hist + batch
        step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
        bins = torch.arange(256, device=dev)[None, :]
        gets_one = (((bins % step) == 0) & ((bins // step) < residual)
                    & (residual > 0))
        hist = hist + gets_one.long()

    scale = np.float32(255.0 / float(tile_area))
    lut = torch.clamp(torch.round(torch.cumsum(hist, dim=1).float()
                                  * float(scale)), 0, 255)
    flat_lut = lut.reshape(-1)

    ty1, ty2, ya, tx1, tx2, xa = (torch.from_numpy(a).to(dev) for a in
                                  _interp_grids(h, w, tiles_y, tiles_x,
                                                th, tw))
    ya = ya[:, None]
    xa = xa[None, :]
    v = src.long()

    def sample(tyi, txi):
        return flat_lut[(tyi[:, None] * tiles_x + txi[None, :]) * 256 + v]

    # a*b + c*d with the first product fused (one rounding), as XLA
    # contracts it: values landing on .5 round the same way as the JAX op.
    def lerp(a, wa, c, wc):
        return (a.double() * wa.double() + (c * wc).double()).float()

    top = lerp(sample(ty1, tx1), 1.0 - xa, sample(ty1, tx2), xa)
    bot = lerp(sample(ty2, tx1), 1.0 - xa, sample(ty2, tx2), xa)
    out = lerp(top, 1.0 - ya, bot, ya)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


# ------------------------------------------------------------
# from kernels/nlmeans.py (the plain version)
# ------------------------------------------------------------

def inv_h2(h: float) -> float:
    """1 / h^2 computed in float32, as the JAX package computes it."""
    h32 = np.float32(h)
    return float(np.float32(1.0) / (h32 * h32))


def _two_sigma2(sigma: float) -> float:
    s32 = np.float32(sigma)
    return float(np.float32(2.0) * (s32 * s32))


# The type NL-means computes in: float32 as stated; the check's control
# computes it in bfloat16.
NLM = {"dtype": torch.float32}


def nl_means_fields_plain(x: torch.Tensor, fields, sigma: float,
                          template: int, search: int) -> torch.Tensor:
    """The plain version of ``nl_means_fields``: float32 (B, H, W, C) in,
    (B, H, W, C) out, on x's device."""
    dt = NLM["dtype"]
    x = x.permute(0, 3, 1, 2).to(dt).contiguous()
    b, c, h, w = x.shape
    tr, sr = template // 2, search // 2
    pad = sr + tr
    ext = reflect_pad(reflect_pad(x, 2, pad, pad), 3, pad, pad)
    hh, ww = h + 2 * tr, w + 2 * tr
    center = ext[:, None, :, sr:sr + hh, sr:sr + ww]
    # Per channel: the patch area of its field and -1/h^2; a field's sum
    # is gathered in its first channel and copied to the others.
    area = torch.empty(c, dtype=torch.float32)
    neg_inv = torch.empty(c, dtype=torch.float32)
    for chans, strength in fields:
        area[list(chans)] = float(template * template * len(chans))
        neg_inv[list(chans)] = -inv_h2(strength)
    area = area.view(1, 1, c, 1, 1).to(x.device, dt)
    neg_inv = neg_inv.view(1, 1, c, 1, 1).to(x.device, dt)
    two_sigma2 = _two_sigma2(sigma)

    num = torch.zeros((b, c, h, w), dtype=dt, device=x.device)
    den = torch.zeros_like(num)
    diff = torch.empty((b, search, c, hh, ww), dtype=dt, device=x.device)
    for dy in range(search):
        # The row's 21 column offsets as one view: (B, 21, C, hh, ww).
        shifted = ext[:, :, dy:dy + hh].unfold(3, ww, 1).permute(0, 3, 1, 2,
                                                                  4)
        torch.sub(center, shifted, out=diff)
        diff.square_()
        wgt = F.avg_pool2d(
            F.avg_pool2d(diff.view(b * search, c, hh, ww), (template, 1),
                         stride=1, divisor_override=1),
            (1, template), stride=1, divisor_override=1).view(
                b, search, c, h, w)
        for chans, _ in fields:
            for ch in chans[1:]:
                wgt[:, :, chans[0]].add_(wgt[:, :, ch])
            for ch in chans[1:]:
                wgt[:, :, ch].copy_(wgt[:, :, chans[0]])
        wgt.div_(area)
        if sigma > 0:
            wgt.sub_(two_sigma2).clamp_(min=0.0)
        wgt.mul_(neg_inv).exp_()
        den.add_(wgt.sum(1))
        vals = ext[:, :, dy + tr:dy + tr + h, tr:tr + w + 2 * sr].unfold(
            3, w, 1).permute(0, 3, 1, 2, 4)
        num.add_(wgt.mul_(vals).sum(1))
    return (num / den).float().permute(0, 2, 3, 1)


# ------------------------------------------------------------
# from ops/nlmeans.py
# ------------------------------------------------------------

def _nl_means_lab_joint(lab: torch.Tensor, h: float, h_color: float,
                        template: int = 7, search: int = 21
                        ) -> torch.Tensor:
    """One joint pass over float32 (B, H, W, 3) Lab: L with ``h``, (a, b)
    jointly with ``h_color`` (sigma 0, as cv2's colored variant)."""
    return nl_means_fields_plain(lab.float().contiguous(),
                           (((0,), h), ((1, 2), h_color)), 0.0, template,
                           search)


def _batched(img: torch.Tensor) -> torch.Tensor:
    return img.reshape(-1, *img.shape[-3:])


def _denoised_lab(img: torch.Tensor, h: float, h_color: float,
                  template: int = 7, search: int = 21) -> torch.Tensor:
    """The uint8 linear Lab (B, H, W, 3) that nl_means_colored converts
    back: BGR -> Lab, the joint pass, round and clip."""
    lab = rgb_to_lab(_batched(img).flip(-1), srgb=False).float()
    return saturate_like(_nl_means_lab_joint(lab, h, h_color, template,
                                             search), torch.uint8)


def _lab_to_output(lab: torch.Tensor, shape) -> torch.Tensor:
    """Linear Lab back to RGB in the input's shape. One uint8 Lab level
    spans up to ~5 RGB levels here (linear light is coarse at the bright
    end), so a float32 rounding flip of one Lab level shows as that."""
    return lab_to_rgb(lab, srgb=False).flip(-1).reshape(shape)


def nl_means_colored(img: torch.Tensor, h: float = 3.0, h_color: float = 3.0,
                     template: int = 7, search: int = 21) -> torch.Tensor:
    """cv2.fastNlMeansDenoisingColored for uint8 RGB (..., H, W, 3), on the
    input's device."""
    return _lab_to_output(_denoised_lab(img, h, h_color, template, search),
                          img.shape)


# ------------------------------------------------------------
# from parallel/tiling.py (the generic path)
# ------------------------------------------------------------

def pad_to_grid(image: torch.Tensor, tile: int
                ) -> tuple[torch.Tensor, int, int]:
    """Reflect-pad (H, W, C) on the bottom/right to a multiple of ``tile``."""
    h, w = int(image.shape[0]), int(image.shape[1])
    image = reflect_pad(image, 0, 0, (-h) % tile)
    image = reflect_pad(image, 1, 0, (-w) % tile)
    return image, h, w


def extract_tiles(image: torch.Tensor, tile: int, halo: int) -> torch.Tensor:
    """(H, W, C) -> (ny*nx, tile+2*halo, tile+2*halo, C) with reflect halos.

    H and W must be multiples of ``tile`` (use pad_to_grid first)."""
    h, w, c = image.shape
    ny, nx = h // tile, w // tile
    k = tile + 2 * halo
    dev = image.device
    ridx = reflect_index(h, halo, halo, dev)
    cidx = reflect_index(w, halo, halo, dev)
    win = torch.arange(k, device=dev)
    rows = ridx[(torch.arange(ny, device=dev) * tile)[:, None] + win]  # ny,k
    cols = cidx[(torch.arange(nx, device=dev) * tile)[:, None] + win]  # nx,k
    tiles = image[rows[:, None, :, None], cols[None, :, None, :]]
    return tiles.reshape(ny * nx, k, k, c)


def stitch_tiles(tiles: torch.Tensor, ny: int, nx: int, tile_out: int,
                 halo_out: int) -> torch.Tensor:
    """(ny*nx, tile_out+2*halo_out, ..., C) -> (ny*tile_out, nx*tile_out, C)."""
    c = tiles.shape[-1]
    core = tiles[:, halo_out:halo_out + tile_out,
                 halo_out:halo_out + tile_out, :]
    core = core.reshape(ny, nx, tile_out, tile_out, c).permute(0, 2, 1, 3, 4)
    return core.reshape(ny * tile_out, nx * tile_out, c)


def _chunks(tiles: torch.Tensor, batch_tiles: int | None,
            cancel_check: Callable[[], bool] | None):
    """Yield (start, chunk) over chunks of ``batch_tiles`` tiles; a partial
    last chunk runs at its own size (the kernels take any batch)."""
    n = tiles.shape[0]
    step = batch_tiles or n
    for start in range(0, n, step):
        if cancel_check is not None and cancel_check():
            raise RuntimeError(f"cancelled at tile {start}/{n}")
        yield start, tiles[start:start + step].contiguous()


def _tile_grid(image: torch.Tensor, tile_size: int, halo: int):
    padded, orig_h, orig_w = pad_to_grid(image, tile_size)
    ny = int(padded.shape[0]) // tile_size
    nx = int(padded.shape[1]) // tile_size
    return extract_tiles(padded, tile_size, halo), ny, nx, orig_h, orig_w


def process_tiled(model_fn: Callable[[torch.Tensor], torch.Tensor],
                  image: torch.Tensor, tile_size: int = 512, halo: int = 16,
                  scale: int = 2, batch_tiles: int | None = None,
                  cancel_check: Callable[[], bool] | None = None
                  ) -> torch.Tensor:
    """Batched uniform tiled processing.

    model_fn: (N, T+2h, T+2h, C) -> (N, s(T+2h), s(T+2h), C') on the
    image's device. Returns (H*scale, W*scale, C') on that device.
    """
    tiles, ny, nx, orig_h, orig_w = _tile_grid(image, tile_size, halo)
    outs = [model_fn(chunk)
            for _, chunk in _chunks(tiles, batch_tiles, cancel_check)]
    out_tiles = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    out = stitch_tiles(out_tiles, ny, nx, tile_size * scale, halo * scale)
    return out[:orig_h * scale, :orig_w * scale, :]


# ------------------------------------------------------------
# from ops/enhance.py
# ------------------------------------------------------------

_TILED_THRESHOLD = 768  # route local ops through fixed tiles above this edge
_OP_TILE = 512
_OP_HALO = 16


def _tiled_unit_op(fn, img: torch.Tensor, *planes: torch.Tensor,
                   batch_tiles: int = 32) -> torch.Tensor:
    """Run a local batched op fn(img (B, H, W, C), *planes (B, H, W)) ->
    (B, H, W, C) on an (H, W, C) image and its (H, W) planes, through the
    fixed-tile path when the image is large (the planes are packed as
    channels of the image's dtype, so each tile carries its own crop)."""
    if max(int(img.shape[0]), int(img.shape[1])) <= _TILED_THRESHOLD:
        return fn(img[None], *(p[None] for p in planes))[0]
    c = int(img.shape[-1])
    packed = torch.cat([img] + [p[:, :, None].to(img.dtype) for p in planes],
                       dim=-1)

    def tile_fn(tiles):
        return fn(tiles[..., :c], *(tiles[..., c + i]
                                    for i in range(len(planes))))

    return process_tiled(tile_fn, packed, tile_size=_OP_TILE, halo=_OP_HALO,
                         scale=1, batch_tiles=batch_tiles)


def denoise_stage(img: torch.Tensor, denoise_level: float = 0.5,
                  max_megapixels: float | None = None) -> torch.Tensor:
    """NL-means (h = h_color = 10 * level, 7x7 template, 21x21 search) on
    an (H, W, 3) uint8 image.

    Above ``max_megapixels`` (None = off) NL-means runs on an area-average
    shrink by a power of two (at most 8) and the noise residual is carried
    back: out = img - up_bilinear(small - nl_means(small))."""
    strength = float(denoise_level) * 10.0
    fn = functools.partial(nl_means_colored, h=strength, h_color=strength,
                           template=7, search=21)
    h, w = int(img.shape[0]), int(img.shape[1])
    mp = h * w / 1e6
    if max_megapixels is None or mp <= float(max_megapixels):
        return _tiled_unit_op(fn, img)
    factor = 2
    while mp / (factor * factor) > float(max_megapixels) and factor < 8:
        factor *= 2
    small = resize(img, dsize=(w // factor, h // factor),
                   interpolation="area")
    return _denoise_residual_apply(img, small, _tiled_unit_op(fn, small))


def _denoise_residual_apply(img: torch.Tensor, small: torch.Tensor,
                            den_small: torch.Tensor) -> torch.Tensor:
    resid = small.float() - den_small.float()
    h, w = int(img.shape[0]), int(img.shape[1])
    resid_up = resize(resid, dsize=(w, h), interpolation="bilinear")
    return saturate_like(img.float() - resid_up, img.dtype)


def contrast_stage(img: torch.Tensor) -> torch.Tensor:
    """RGB -> Lab -> CLAHE(2.0, 8x8) on L -> RGB (uint8 (H, W, 3))."""
    lab = rgb_to_lab(img)
    l_eq = clahe(lab[:, :, 0].contiguous(), clip_limit=2.0,
                 tile_grid_size=(8, 8))
    return lab_to_rgb(torch.cat([l_eq[:, :, None], lab[:, :, 1:]], dim=-1))


def unsharp_mask(img: torch.Tensor) -> torch.Tensor:
    """addWeighted(img, 1.5, GaussianBlur(img, 0, 3), -0.5, 0)."""
    return add_weighted(img, 1.5, gaussian_blur(img, (0, 0), 3.0), -0.5, 0.0)


def _masked_sharpen_batch(img: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    mask = dilate(mask[..., None], 3, 1)
    return torch.where(mask == 1, unsharp_mask(img), img)


def masked_sharpen(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Segmentation-guided sharpening of an (H, W, 3) uint8 image: the
    (H, W) uint8 object mask is dilated 3x3 once, and the unsharp-masked
    pixel replaces the input where it is 1 (tiled when large)."""
    return _tiled_unit_op(_masked_sharpen_batch, img, mask)


def adaptive_sharpen_batch(img: torch.Tensor) -> torch.Tensor:
    """Detail-masked unsharp mask on (..., H, W, 3) uint8.

    detail = |gray - blur(gray, sigma=2)| thresholded at 10; the output is
    the unsharp-masked pixel where detail is set, the input elsewhere."""
    gray = rgb_to_gray(img)
    low = gaussian_blur(gray[..., None], (0, 0), 2.0)[..., 0]
    variance = convert_scale_abs(subtract(gray, low))
    alpha = threshold_binary(variance, 10.0, 255.0)
    return torch.where(alpha[..., None] > 0, unsharp_mask(img), img)


def adaptive_sharpen(img: torch.Tensor) -> torch.Tensor:
    """adaptive_sharpen_batch on one (H, W, 3) image (tiled when large)."""
    return _tiled_unit_op(adaptive_sharpen_batch, img)


def ensemble(images: list[torch.Tensor]) -> torch.Tensor:
    """Uniform-weight ensemble: align to the lexicographic max (h, w) with
    Lanczos-4, average in fp32, truncate to uint8."""
    if len(images) == 1:
        return images[0]
    target_h, target_w = max((int(im.shape[0]), int(im.shape[1]))
                             for im in images)
    acc = None
    for im in images:
        if im.shape[0] != target_h or im.shape[1] != target_w:
            im = resize(im, dsize=(target_w, target_h),
                        interpolation="lanczos4")
        term = im.float() * (1.0 / len(images))
        acc = term if acc is None else acc + term
    return acc.to(torch.uint8)

