#!/usr/bin/env python3
"""Fetch the Real-ESRGAN v0.3.0 general (3-channel) models through the
PyTorch port's downloader, and install the x4v3 copy under the standard
RealESRGAN_x2plus.pth name, backing up any existing file.

The counterpart of ``standalone/download_x3_model.py``, with the same
models, paths and flag.
"""

import argparse
import logging
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from neural_enhanced_super_resolution_torch.utils import (  # noqa: E402
    downloader)

logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
logger = logging.getLogger("download_x3")

X3_MODELS = {
    "realesr-general-x4v3": {
        "url": ("https://github.com/xinntao/Real-ESRGAN/releases/download/"
                "v0.3.0/realesr-general-x4v3.pth"),
        "path": "weights/realesr-general-x4v3.pth",
    },
    "realesr-general-wdn-x4v3": {
        "url": ("https://github.com/xinntao/Real-ESRGAN/releases/download/"
                "v0.3.0/realesr-general-wdn-x4v3.pth"),
        "path": "weights/realesr-general-wdn-x4v3.pth",
    },
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Download Real-ESRGAN v0.3.0 3-channel general models")
    parser.add_argument("--install-as-x2plus", action="store_true",
                        help="copy the general model over "
                             "RealESRGAN_x2plus.pth (with backup)")
    args = parser.parse_args(argv)

    models_dir = downloader.get_models_dir()
    ok_all = True
    for key, info in X3_MODELS.items():
        dest = os.path.join(models_dir, info["path"])
        if os.path.exists(dest):
            logger.info("%s already present", key)
            continue
        logger.info("Downloading %s ...", key)
        if not downloader.download_file(info["url"], dest):
            logger.error("Failed to download %s", key)
            ok_all = False

    if args.install_as_x2plus and ok_all:
        src = os.path.join(models_dir,
                           X3_MODELS["realesr-general-x4v3"]["path"])
        dst = os.path.join(models_dir, "weights", "RealESRGAN_x2plus.pth")
        if os.path.exists(dst):
            backup = dst + ".backup"
            shutil.copy2(dst, backup)
            logger.info("Backed up existing model to %s", backup)
        shutil.copy2(src, dst)
        logger.info("Installed 3-channel model as %s", dst)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
