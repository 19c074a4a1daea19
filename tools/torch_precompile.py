#!/usr/bin/env python3
"""Build the PyTorch port's native code ahead of time.

    python3 tools/torch_precompile.py

The port's counterpart of ``tools/precompile.py``. It builds the kernel
library (``csrc/*.cu``, one nvcc per source) and the host stager
(``csrc/nesr_host.cpp``, g++) from the repository's sources into the build
directory the package loads them from (``build/torch_kernels/``, or
``NESR_TORCH_BUILD_DIR``), so a later process finds both by their sources'
hash and builds nothing. Eager PyTorch keeps no compiled state across
processes, so the build is all there is to do ahead of time. It prints the
build seconds beside the card's name and power limit, and exits 2 without
a CUDA GPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_precompile: no CUDA GPU; the port's kernels run on the "
              "card", file=sys.stderr)
        return 2
    from neural_enhanced_super_resolution_torch.kernels import _build
    from neural_enhanced_super_resolution_torch.runtime import native

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() or torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.load_library()
    kernels_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load_host_library()
    host_s = time.perf_counter() - t0
    print(f"build: kernels {kernels_s:.3f} s ({_build.library_path()}), "
          f"host stager {host_s:.3f} s ({native.host_library_path()}) on "
          f"{card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
