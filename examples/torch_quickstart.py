#!/usr/bin/env python3
"""Quickstart on the PyTorch port: degrade -> enhance -> compare with
quality metrics.

The counterpart of ``examples/quickstart.py``: a x4 bicubic downsample of
the repo's test image goes through the port's ``SuperResolutionPipeline``
with the bundled trained tiny checkpoint (no downloads), and the result is
scored against the original beside bicubic upsampling (PSNR, SSIM). Runs
on the card unless ``--device cpu`` is given.

Usage: python examples/torch_quickstart.py [--device cuda|cpu]
       [--output_dir outputs]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

import torch  # noqa: E402

from neural_enhanced_super_resolution_torch import (  # noqa: E402
    SuperResolutionPipeline)
from neural_enhanced_super_resolution_torch.ops.resize import (  # noqa: E402
    resize)
from neural_enhanced_super_resolution_torch.utils import (  # noqa: E402
    create_comparison_image, imread_rgb, imwrite_rgb, psnr, ssim)

CKPT = os.path.join(HERE, "..", "tests", "fixtures",
                    "tiny_trained_x4.safetensors")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--output_dir", default="outputs")
    args = parser.parse_args(argv)

    hr = imread_rgb(os.path.join(HERE, "..", "tests", "fixtures",
                                 "test.jpeg"))
    # degrade: x4 bicubic downsample (utils.image_utils has noise, blur and
    # JPEG degradations too)
    lr = resize(torch.from_numpy(hr.copy()),
                dsize=(hr.shape[1] // 4, hr.shape[0] // 4),
                interpolation="bicubic").numpy()

    pipe = SuperResolutionPipeline(args.device, config={
        "iterations": 1, "use_diffusion": False,
        "segment_enhancement": False, "denoise_level": 0,
        "adaptive_sharpening": False,
        "esrgan_model_path": CKPT,
        "esrgan_arch": dict(num_in_ch=12, num_out_ch=3, scale=4,
                            num_feat=16, num_block=2, num_grow_ch=8),
        "output_dir": args.output_dir})
    enhanced = pipe.enhance_array(lr)

    bicubic = resize(torch.from_numpy(lr), dsize=(hr.shape[1], hr.shape[0]),
                     interpolation="bicubic").numpy()
    print(f"bicubic : PSNR {float(psnr(hr, bicubic)):5.2f} dB  "
          f"SSIM {float(ssim(hr, bicubic)):.4f}")
    print(f"enhanced: PSNR {float(psnr(hr, enhanced)):5.2f} dB  "
          f"SSIM {float(ssim(hr, enhanced)):.4f}")

    comparison = create_comparison_image(bicubic, enhanced, "horizontal")
    out = imwrite_rgb(os.path.join(args.output_dir,
                                   "quickstart_comparison.png"), comparison)
    print(f"side-by-side saved to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
