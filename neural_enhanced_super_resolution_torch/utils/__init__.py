"""Host-side utilities (PIL image IO) and quality metrics."""

from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                             imwrite_rgb)
from neural_enhanced_super_resolution_torch.utils.metrics import psnr, ssim

__all__ = ["imread_rgb", "imwrite_rgb", "psnr", "ssim"]
