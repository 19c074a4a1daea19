"""``nesr_torch`` — the reference's module paths on the PyTorch port.

The port's counterpart of the ``nesr`` alias package: code written against
the reference package runs on the port by importing ``nesr_torch`` where
it imported ``nesr``, submodules included (``import
nesr_torch.utils.image_utils``, ``from nesr_torch.utils.downloader import
download_models``, ``from nesr_torch.gui import NESRApplication``, ``from
nesr_torch.nesr import SuperResolutionPipeline``). Everything re-exports
from ``neural_enhanced_super_resolution_torch``; the submodule aliases are
registered in sys.modules so both attribute access and ``import
nesr_torch.x.y`` resolve. It imports no JAX.
"""

import sys as _sys

from neural_enhanced_super_resolution_torch import (SuperResolutionPipeline,
                                                    __version__)
from neural_enhanced_super_resolution_torch import utils  # noqa: F401
from neural_enhanced_super_resolution_torch import pipeline as _pipeline
from neural_enhanced_super_resolution_torch.utils import (downloader as
                                                          _downloader)
from neural_enhanced_super_resolution_torch.utils import (image_utils as
                                                          _image_utils)
from neural_enhanced_super_resolution_torch.utils import metrics as _metrics

# Reference module paths -> the port's modules. ``nesr_torch.nesr`` is the
# reference's pipeline module. Registration must be eager: ``import
# nesr_torch.x.y`` consults sys.modules / the package __path__, never
# module __getattr__. The gui module imports headless (its Qt view is
# import-gated, HAS_QT).
from neural_enhanced_super_resolution_torch import gui as _gui  # noqa: E402

_sys.modules[__name__ + ".utils"] = utils
_sys.modules[__name__ + ".utils.downloader"] = _downloader
_sys.modules[__name__ + ".utils.image_utils"] = _image_utils
_sys.modules[__name__ + ".utils.metrics"] = _metrics
_sys.modules[__name__ + ".nesr"] = _pipeline
_sys.modules[__name__ + ".gui"] = _gui
gui = _gui
nesr = _pipeline

__all__ = ["SuperResolutionPipeline", "__version__", "utils", "nesr", "gui"]
