"""The GUI: a toolkit-free controller and a PyQt5 view behind an import
guard (counterpart of the JAX package's ``gui/``)."""

from neural_enhanced_super_resolution_torch.gui.controller import (
    DegradationState, EnhancementSettingsState, EnhancementWorker,
    ModelDownloadWorker, PRESETS, check_model_status)
from neural_enhanced_super_resolution_torch.gui.app import (HAS_QT,
                                                            NESRApplication,
                                                            run_gui)

__all__ = ["DegradationState", "EnhancementSettingsState",
           "EnhancementWorker", "ModelDownloadWorker", "PRESETS",
           "check_model_status", "NESRApplication", "run_gui", "HAS_QT"]
