"""CLI entry point: the same flags as the JAX package's ``cli.py``.

``python -m neural_enhanced_super_resolution_torch --cli -i img -c cfg.json
-n N -o out.png`` enhances one image; ``-i DIR`` enhances every image of a
directory in one process (``runtime/executor.BatchExecutor``), writing
``{base}_enhanced{ext}`` under ``-o`` (default ``outputs``) and printing
the seconds each image took (``--intermediate_saves`` is dropped there,
as in the JAX package: every image would overwrite the same files).
``--download_models`` fetches the registry's required models
(``utils/downloader``); ``--gui``, or no mode at all, starts the PyQt5 GUI
and, without PyQt5, says so and exits 2.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import time

__all__ = ["main", "parse_arguments", "run_cli_mode", "launch_gui"]


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="NESR on PyTorch/CUDA — Neural Enhanced Super-Resolution",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--gui", action="store_true",
                        help="Launch the graphical user interface")
    parser.add_argument("--cli", action="store_true",
                        help="Run in command line mode")
    parser.add_argument("--input", "-i", help="Input image path (CLI mode)")
    parser.add_argument("--output", "-o", help="Output path (CLI mode)")
    parser.add_argument("--config", "-c",
                        help="Path to configuration JSON file")
    parser.add_argument("--iterations", "-n", type=int, default=3,
                        help="Number of enhancement iterations")
    parser.add_argument("--upscale_factor", "-u", type=float, default=2.0,
                        help="Base upscale factor per iteration")
    parser.add_argument("--device", "-d", default="auto",
                        choices=["auto", "cpu", "cuda"],
                        help="Device to run on (auto and cuda mean the GPU "
                             "and raise without one)")
    parser.add_argument("--prompt", "-p", default=None,
                        help="Text prompt for diffusion guidance")
    parser.add_argument("--download_models", action="store_true",
                        help="Download required models")
    parser.add_argument("--use_swinir", action="store_true",
                        help="Enable the SwinIR branch")
    parser.add_argument("--no_diffusion", action="store_true",
                        help="Disable the diffusion upscaler")
    parser.add_argument("--no_esrgan", action="store_true",
                        help="Disable the ESRGAN upscaler")
    parser.add_argument("--no_segmentation", action="store_true",
                        help="Disable segmentation-guided enhancement")
    parser.add_argument("--intermediate_saves", action="store_true",
                        help="Save the image after each iteration")
    parser.add_argument("--bench", action="store_true",
                        help="Print each stage's and span's host and device "
                             "time, and the counters, at the end")
    return parser.parse_args(argv)


def run_cli_mode(args) -> int:
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline

    print("Starting NESR (PyTorch) in CLI mode")
    if args.download_models:
        from neural_enhanced_super_resolution_torch.utils.downloader import (
            download_models)
        download_models()
        print("Model download complete.")
        return 0
    if not args.input:
        print("Error: Input image path is required in CLI mode.")
        print("Use --input or -i to specify the input image path.")
        return 2
    if os.path.isdir(args.input):
        return _run_batch_mode(args)

    try:
        config = _config(args, (os.path.dirname(args.output) or "outputs")
                         if args.output else "outputs")
    except Exception as exc:  # noqa: BLE001 - clean one-line error
        print(f"Error loading configuration: {exc}")
        return 2
    try:
        pipeline = SuperResolutionPipeline(device=args.device, config=config)
        output_path = pipeline.enhance_image(args.input, prompt=args.prompt)
    except Exception as exc:  # noqa: BLE001 - clean one-line error
        print(f"Error during image enhancement: {exc}")
        return 1
    if args.output and output_path != args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        shutil.copy2(output_path, args.output)
        print(f"Enhanced image saved to: {args.output}")
    else:
        print(f"Enhanced image saved to: {output_path}")
    if args.bench:
        print("\n".join(pipeline.timer.summary_lines()))
    return 0


def _config(args, output_dir: str, batch: bool = False) -> dict:
    """The JSON config of ``-c`` (if given) with the keys the flags set on
    top: CLI args win. Batch mode drops ``--intermediate_saves``. Raises
    when the file does not load."""
    config = {}
    if args.config:
        with open(args.config) as f:
            config = json.load(f)
        print(f"Loaded configuration from {args.config}")
    config.update(iterations=args.iterations,
                  upscale_factor=args.upscale_factor, output_dir=output_dir)
    if args.use_swinir:
        config["use_swinir"] = True
    if args.no_diffusion:
        config["use_diffusion"] = False
    if args.no_esrgan:
        config["use_esrgan"] = False
    if args.no_segmentation:
        config["segment_enhancement"] = False
    if args.intermediate_saves and not batch:
        config["intermediate_saves"] = True
    return config


def _run_batch_mode(args) -> int:
    """Directory input: every image of the directory through one pipeline,
    decoded ahead by the executor's staging thread. Exit 0 when all
    succeed, 1 when any failed (a ``FAILED`` line each), 2 when the
    directory holds no image or the config does not load."""
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.runtime.executor import (
        BatchExecutor)
    from neural_enhanced_super_resolution_torch.utils.io import imwrite_rgb

    exts = {".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".webp"}
    paths = sorted(
        os.path.join(args.input, f) for f in os.listdir(args.input)
        if os.path.splitext(f)[1].lower() in exts)
    if not paths:
        print(f"No images found in {args.input}")
        return 2
    out_dir = args.output or "outputs"
    try:
        config = _config(args, out_dir, batch=True)
    except Exception as exc:  # noqa: BLE001 - clean one-line error
        print(f"Error loading configuration: {exc}")
        return 2
    try:
        pipeline = SuperResolutionPipeline(device=args.device, config=config)
    except Exception as exc:  # noqa: BLE001 - clean one-line error
        print(f"Error during image enhancement: {exc}")
        return 1

    failures = 0
    t0 = time.perf_counter()
    with BatchExecutor(pipeline) as ex:
        for path, result in ex.map_paths(paths, prompt=args.prompt):
            if isinstance(result, Exception):
                print(f"FAILED {path}: {result}")
                failures += 1
            else:
                base, ext = os.path.splitext(os.path.basename(path))
                out_path = os.path.join(out_dir, f"{base}_enhanced{ext}")
                imwrite_rgb(out_path, result)
                print(f"{path} -> {out_path} "
                      f"({time.perf_counter() - t0:.3f} s)")
            t0 = time.perf_counter()
    print(f"Batch complete: {len(paths) - failures}/{len(paths)} succeeded")
    if args.bench:
        print("\n".join(pipeline.timer.summary_lines()))
    return 1 if failures else 0


def launch_gui() -> int:
    """The PyQt5 GUI; without PyQt5 a one-line message and exit 2."""
    try:
        from neural_enhanced_super_resolution_torch.gui import run_gui
        return run_gui()
    except ImportError as exc:
        print(f"GUI unavailable ({exc}). Install PyQt5 or use --cli.")
        return 2


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    args = parse_arguments(argv)
    if args.gui or (not args.cli and not args.input
                    and not args.download_models):
        return launch_gui()
    return run_cli_mode(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
