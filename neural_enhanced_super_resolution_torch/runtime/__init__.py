"""Runtime layer: device/precision policy, config system, stage timing,
multi-host initialisation."""

from neural_enhanced_super_resolution_torch.runtime.config import (
    default_config, merge_config)
from neural_enhanced_super_resolution_torch.runtime.device import (
    default_compute_dtype, determine_device, device_fetch, visible_devices)
from neural_enhanced_super_resolution_torch.runtime.profiler import StageTimer
from neural_enhanced_super_resolution_torch.runtime.distributed import (
    init_multihost, make_hybrid_mesh)

__all__ = ["default_config", "merge_config", "default_compute_dtype",
           "determine_device", "device_fetch", "visible_devices",
           "StageTimer", "init_multihost", "make_hybrid_mesh"]
