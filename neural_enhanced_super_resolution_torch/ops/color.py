"""Colour conversions with OpenCV semantics (gray, Lab, linear Lab).

Counterpart of ``neural_enhanced_super_resolution_tpu/ops/color.py``. The
3x3 colour matrices are applied as explicit fp32 multiply-adds, so no TF32
matmul path can touch them on the GPU.
"""

from __future__ import annotations

import torch

from neural_enhanced_super_resolution_torch.ops.blur import saturate_like

__all__ = ["rgb_to_gray", "rgb_to_lab", "lab_to_rgb"]

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
