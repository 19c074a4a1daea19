"""Runtime layer: device/precision policy, config system, stage timing."""

from neural_enhanced_super_resolution_torch.runtime.config import (
    default_config, merge_config)
from neural_enhanced_super_resolution_torch.runtime.device import (
    default_compute_dtype, determine_device, device_fetch)
from neural_enhanced_super_resolution_torch.runtime.profiler import StageTimer

__all__ = ["default_config", "merge_config", "default_compute_dtype",
           "determine_device", "device_fetch", "StageTimer"]
