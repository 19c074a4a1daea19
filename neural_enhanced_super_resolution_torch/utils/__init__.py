"""Host-side utilities: degradations and comparison images, image IO,
quality metrics, and the model downloader (``utils.downloader``)."""

from neural_enhanced_super_resolution_torch.utils.image_utils import (
    add_noise, add_text_to_image, apply_jpeg_compression, blur_image,
    create_comparison_image, downsample_image)
from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                             imwrite_rgb)
from neural_enhanced_super_resolution_torch.utils.metrics import psnr, ssim

__all__ = ["add_noise", "blur_image", "downsample_image",
           "apply_jpeg_compression", "create_comparison_image",
           "add_text_to_image", "imread_rgb", "imwrite_rgb", "psnr", "ssim"]
