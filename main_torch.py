#!/usr/bin/env python3
"""NESR on PyTorch and CUDA: the main entry point for both CLI and GUI.

The PyTorch port's counterpart of the repo-root ``main.py``: a dependency
check, a log line of the CUDA situation, then CLI or GUI dispatch. The
implementation lives in ``neural_enhanced_super_resolution_torch.cli``.
It imports no JAX.

    python main_torch.py --cli -i photo.jpg -c config.json -n 1 -o out.png
"""

import importlib.util
import logging
import sys

logging.basicConfig(
    level=logging.INFO,
    format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
logger = logging.getLogger("nesr")


def check_dependencies() -> bool:
    """Verify the core dependencies: torch is the compute runtime, numpy
    and Pillow the host-side image stack."""
    missing = [dep for dep in ("torch", "numpy", "PIL")
               if importlib.util.find_spec(dep) is None]
    if missing:
        print("Missing required dependencies:")
        for dep in missing:
            print(f"  - {dep}")
        return False
    return True


def setup_environment() -> None:
    """Log torch, its CUDA build and the GPUs this process sees."""
    try:
        import torch
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        names = sorted({torch.cuda.get_device_name(i) for i in range(count)})
        logger.info("torch %s (CUDA %s): %d GPU(s)%s", torch.__version__,
                    torch.version.cuda, count,
                    ": " + ", ".join(names) if names else "")
    except Exception as exc:  # pragma: no cover
        logger.warning("torch initialisation problem: %s", exc)


def main() -> int:
    if not check_dependencies():
        return 2
    setup_environment()
    from neural_enhanced_super_resolution_torch.cli import main as cli_main
    return cli_main()


if __name__ == "__main__":
    sys.exit(main())
