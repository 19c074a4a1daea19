#!/usr/bin/env python3
"""Direct ESRGAN runner on the PyTorch port: component isolation with
timing.

The counterpart of ``standalone/direct_esrgan.py``: runs ONLY the RRDBNet
upscaler (12-channel x4, 64 features, 23 blocks, growth 32, the stock
trunk in bf16, as that script runs it) over one image in tiles, with
wall-clock timing and the same model-path search; no diffusion, no
segmentation, no pipeline. Runs on the card unless ``--device cpu``.
"""

import argparse
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
logger = logging.getLogger("direct_esrgan")


def find_model_path(explicit: str | None = None) -> str | None:
    """The first of the standard weight locations that exists."""
    fname = "RealESRGAN_x2plus.pth"
    candidates = [explicit] if explicit else []
    if "NESR_MODELS_DIR" in os.environ:
        candidates.append(os.path.join(os.environ["NESR_MODELS_DIR"],
                                       "weights", fname))
    home = os.path.expanduser("~")
    candidates += [
        os.path.join(home, ".nesr", "models", "weights", fname),
        os.path.join("models", "weights", fname),
        os.path.join("weights", fname),
    ]
    return next((c for c in candidates if c and os.path.exists(c)), None)


def enhance_image(input_path: str, output_path: str,
                  model_path: str | None = None, tile: int = 512,
                  tile_pad: int = 16, three_channel: bool = False,
                  device: str = "cuda") -> str:
    import torch

    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig, load_state_dict)
    from neural_enhanced_super_resolution_torch.parallel.tiling import (
        process_tiled)
    from neural_enhanced_super_resolution_torch.pipeline import esrgan_step
    from neural_enhanced_super_resolution_torch.runtime.device import (
        determine_device)
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)

    device = determine_device(device)
    path = find_model_path(model_path)
    if path is None:
        raise FileNotFoundError("RealESRGAN_x2plus weights not found")
    logger.info("Model: %s", path)

    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, num_feat=64,
                        num_block=23, num_grow_ch=32)
    model = RRDBNet(cfg, load_state_dict(path), torch.bfloat16, device,
                    "stock")
    image = imread_rgb(input_path)
    logger.info("Input: %s (%dx%d)", input_path, image.shape[1],
                image.shape[0])

    t0 = time.time()
    out = process_tiled(
        lambda tiles: esrgan_step(model, tiles, "repeat12" if three_channel
                                  else "stack12"),
        torch.from_numpy(image.copy()).to(device), tile_size=tile,
        halo=tile_pad, scale=4)
    out = out.cpu().numpy()  # the copy waits for the card
    elapsed = time.time() - t0
    logger.info("Processing took %.2f seconds (%.2f MP/s input)", elapsed,
                image.shape[0] * image.shape[1] / 1e6 / elapsed)

    imwrite_rgb(output_path, out)
    logger.info("Saved: %s", output_path)
    return output_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Direct ESRGAN upscaler")
    parser.add_argument("input")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("-m", "--model", default=None)
    parser.add_argument("--tile", type=int, default=512)
    parser.add_argument("--tile_pad", type=int, default=16)
    parser.add_argument("--three_channel", action="store_true")
    parser.add_argument("-d", "--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    output = args.output or os.path.splitext(args.input)[0] + "_esrgan.png"
    try:
        enhance_image(args.input, output, args.model, args.tile,
                      args.tile_pad, args.three_channel, args.device)
        return 0
    except Exception as exc:
        logger.error("%s", exc)
        return 1


if __name__ == "__main__":
    sys.exit(main())
