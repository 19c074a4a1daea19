"""Image ops with OpenCV semantics on torch tensors (any device)."""

from neural_enhanced_super_resolution_torch.ops.blur import (
    box_blur, dilate, filter2d, gaussian_blur, gaussian_kernel1d)
from neural_enhanced_super_resolution_torch.ops.clahe import clahe
from neural_enhanced_super_resolution_torch.ops.color import (
    lab_to_rgb, rgb_to_gray, rgb_to_lab)
from neural_enhanced_super_resolution_torch.ops.enhance import (
    adaptive_sharpen, adaptive_sharpen_batch, contrast_stage, denoise_stage,
    ensemble, masked_sharpen, preprocess, unsharp_mask)
from neural_enhanced_super_resolution_torch.ops.nlmeans import (
    nl_means, nl_means_colored)
from neural_enhanced_super_resolution_torch.ops.pointwise import (
    add_weighted, convert_scale_abs, subtract, threshold_binary)
from neural_enhanced_super_resolution_torch.ops.resize import resize

__all__ = [
    "box_blur", "dilate", "filter2d", "gaussian_blur", "gaussian_kernel1d",
    "clahe", "lab_to_rgb", "rgb_to_gray", "rgb_to_lab", "adaptive_sharpen",
    "adaptive_sharpen_batch", "contrast_stage", "denoise_stage", "ensemble",
    "masked_sharpen", "preprocess", "unsharp_mask", "nl_means",
    "nl_means_colored", "add_weighted", "convert_scale_abs", "subtract",
    "threshold_binary", "resize",
]
