"""Host-side utilities (PIL image IO)."""

from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                             imwrite_rgb)

__all__ = ["imread_rgb", "imwrite_rgb"]
