#!/usr/bin/env python3
"""Monolithic single-file pipeline variant on the PyTorch port.

The counterpart of ``standalone/superres_project.py``: an eagerly
initialising pipeline in one file with the 3-channel x2plus semantics
(pixel-unshuffle, the network x2 a pass, the stock trunk in bf16 over the
whole image, edge-padded to even sizes) instead of the package's 12-channel
mode, with the same flags. The network's widths come from the checkpoint.
Runs on the card unless ``--device cpu``.
"""

import argparse
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
logger = logging.getLogger("superres")


class SuperResolutionPipeline:
    """Eager-init, x2plus-semantics mini pipeline (standalone variant)."""

    def __init__(self, device: str = "auto", iterations: int = 2,
                 no_diffusion: bool = True, denoise_level: float = 0.5,
                 model_path: str | None = None):
        from neural_enhanced_super_resolution_torch.models import (
            RRDBNet, RRDBNetConfig, load_state_dict)
        from neural_enhanced_super_resolution_torch.runtime.device import (
            determine_device)

        self.device = determine_device(device)
        self.iterations = iterations
        self.denoise_level = denoise_level
        self.use_diffusion = not no_diffusion
        from standalone.torch_direct_esrgan import find_model_path
        path = find_model_path(model_path)
        if path is None:
            raise FileNotFoundError("RealESRGAN_x2plus weights not found")
        sd = load_state_dict(path)
        self.cfg = RRDBNetConfig(
            num_in_ch=3, num_out_ch=3, scale=2,
            num_feat=sd["conv_first.weight"].shape[0],
            num_block=1 + max(int(k.split(".")[1]) for k in sd
                              if k.startswith("body.")),
            num_grow_ch=sd["body.0.rdb1.conv1.weight"].shape[0])
        self.model = RRDBNet(self.cfg, sd, torch.bfloat16, self.device,
                             "stock")
        logger.info("Loaded x2plus weights (3-channel mode) from %s", path)

    def _esrgan_x2(self, image: torch.Tensor) -> torch.Tensor:
        """RGB uint8 (H, W, 3) on the device -> (2H, 2W, 3)."""
        x = image.flip(-1).float()[None] / 255.0
        h, w = x.shape[1], x.shape[2]
        ph, pw = h % 2, w % 2
        if ph or pw:
            x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                                        mode="replicate").permute(0, 2, 3, 1)
        y = self.model(x.contiguous())[0, :2 * h, :2 * w]
        y = torch.clamp(y * 255.0, 0, 255).to(torch.uint8)  # truncates
        return y.flip(-1)

    def enhance(self, image_path: str, output_dir: str = "outputs",
                intermediate_saves: bool = False) -> str:
        from neural_enhanced_super_resolution_torch.ops.enhance import (
            adaptive_sharpen, preprocess)
        from neural_enhanced_super_resolution_torch.utils.io import (
            imread_rgb, imwrite_rgb)
        image = imread_rgb(image_path)
        oh = image.shape[0]
        current = torch.from_numpy(np.array(image)).to(self.device)
        for i in range(self.iterations):
            t0 = time.time()
            current = preprocess(current, self.denoise_level)
            current = self._esrgan_x2(current)
            current = adaptive_sharpen(current)
            if self.device == "cuda":
                torch.cuda.synchronize()
            logger.info("Iteration %d done in %.1fs (%dx%d)", i + 1,
                        time.time() - t0, current.shape[1], current.shape[0])
            if intermediate_saves:
                imwrite_rgb(os.path.join(output_dir,
                                         f"intermediate_iter{i+1}.png"),
                            current.cpu().numpy())
        scale = round(current.shape[0] / oh, 1)
        base, ext = os.path.splitext(os.path.basename(image_path))
        out = os.path.join(output_dir, f"{base}_enhanced_x{scale}{ext}")
        imwrite_rgb(out, current.cpu().numpy())
        logger.info("Saved %s", out)
        return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Monolithic SR pipeline")
    parser.add_argument("--input", "-i", required=True)
    parser.add_argument("--output_dir", "-o", default="outputs")
    parser.add_argument("--iterations", "-n", type=int, default=2)
    parser.add_argument("--device", "-d", default="auto")
    parser.add_argument("--denoise_level", type=float, default=0.5)
    parser.add_argument("--model", default=None)
    parser.add_argument("--no_diffusion", action="store_true")
    parser.add_argument("--intermediate_saves", action="store_true")
    args = parser.parse_args(argv)
    try:
        pipe = SuperResolutionPipeline(args.device, args.iterations,
                                       args.no_diffusion,
                                       args.denoise_level, args.model)
        pipe.enhance(args.input, args.output_dir, args.intermediate_saves)
        return 0
    except Exception as exc:
        logger.error("%s", exc)
        return 1


if __name__ == "__main__":
    sys.exit(main())
