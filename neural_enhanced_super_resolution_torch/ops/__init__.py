"""Image ops with OpenCV semantics on torch tensors (any device)."""

from neural_enhanced_super_resolution_torch.ops.blur import (
    gaussian_blur, gaussian_kernel1d)
from neural_enhanced_super_resolution_torch.ops.clahe import clahe
from neural_enhanced_super_resolution_torch.ops.color import (
    lab_to_rgb, rgb_to_gray, rgb_to_lab)
from neural_enhanced_super_resolution_torch.ops.enhance import (
    adaptive_sharpen, adaptive_sharpen_batch, contrast_stage, ensemble,
    unsharp_mask)
from neural_enhanced_super_resolution_torch.ops.pointwise import (
    add_weighted, convert_scale_abs, subtract, threshold_binary)
from neural_enhanced_super_resolution_torch.ops.resize import resize

__all__ = [
    "gaussian_blur", "gaussian_kernel1d", "clahe", "lab_to_rgb",
    "rgb_to_gray", "rgb_to_lab", "adaptive_sharpen", "adaptive_sharpen_batch",
    "contrast_stage", "ensemble", "unsharp_mask", "add_weighted",
    "convert_scale_abs", "subtract", "threshold_binary", "resize",
]
