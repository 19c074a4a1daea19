#!/usr/bin/env python3
"""Train a tiny RRDBNet x4 on patches of the repo test image, on the port.

The PyTorch counterpart of ``tools/train_tiny_esrgan.py``, step for step:
the same tiny config (12 in, 3 out, x4; 16 features, 2 blocks, growth 8),
the same LR image (x4 bicubic, then CLAHE), the same numpy patch sampler
(``default_rng(0)``, the same ``integers`` calls in the same order), the
same 12-channel BGR variant stack, L1 on the RGB output and Adam at the
same rate (``torch.optim.Adam``'s defaults are ``optax.adam``'s), all in
float32 with TF32 off. Every conv runs through
``kernels.conv3x3.Conv3x3Function``: on the card its forward and input
gradient are K1f launches. It writes the basicsr keys the JAX tool writes.

Usage: python tools/torch_train_tiny_esrgan.py [--steps 800] [--cpu]
       [--out outputs/tiny_trained_x4_torch.safetensors]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

logger = logging.getLogger("train_tiny_esrgan")

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "test.jpeg")
TINY = dict(num_in_ch=12, num_out_ch=3, scale=4, num_feat=16, num_block=2,
            num_grow_ch=8)


def training_images(path: str = FIXTURE) -> tuple[np.ndarray, np.ndarray]:
    """(HR float32 (H, W, 3), LR float32 (H/4, W/4, 3)): the image and its
    x4 bicubic downsample preprocessed as the pipeline preprocesses before
    ESRGAN (CLAHE, no denoise), both in [0, 255]."""
    from neural_enhanced_super_resolution_torch.ops.enhance import (
        preprocess)
    from neural_enhanced_super_resolution_torch.ops.resize import resize
    from neural_enhanced_super_resolution_torch.utils.io import imread_rgb

    img = imread_rgb(path)
    h, w = img.shape[:2]
    lr_u8 = resize(torch.from_numpy(np.array(img)),
                   dsize=(w // 4, h // 4), interpolation="bicubic")
    lr = preprocess(lr_u8, 0).numpy().astype(np.float32)
    return img.astype(np.float32), lr


def sample_batch(rng: np.random.Generator, img: np.ndarray, lr_full:
                 np.ndarray, batch: int, patch: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Paired (LR (B, p/4, p/4, 3), HR (B, p, p, 3)) patches in [0, 1]."""
    h, w = img.shape[:2]
    lp = patch // 4
    ys = rng.integers(0, h // 4 - lp, batch)
    xs = rng.integers(0, w // 4 - lp, batch)
    lr = np.stack([lr_full[y:y + lp, x:x + lp] for y, x in zip(ys, xs)])
    hr = np.stack([img[4 * y:4 * y + patch, 4 * x:4 * x + patch]
                   for y, x in zip(ys, xs)])
    return lr / np.float32(255.0), hr / np.float32(255.0)


def stack12(lr: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 3) RGB in [0, 1] -> the inference variant stack in BGR:
    [bgr, clip(1.1 bgr), 0.9 bgr, GaussianBlur3(bgr)], blurred in float."""
    from neural_enhanced_super_resolution_torch.ops.blur import gaussian_blur
    bgr = lr.flip(-1)
    return torch.cat([bgr, torch.clamp(bgr * 1.1, 0, 1), bgr * 0.9,
                      gaussian_blur(bgr, (3, 3), 0.0)], dim=-1)


def l1_loss(model, lr: torch.Tensor, hr: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    """mean |RGB output - HR|; plain=True runs the model's plain convs."""
    return (model(stack12(lr), plain=plain).flip(-1) - hr).abs().mean()


def make_step(model, opt, plain: bool = False):
    """One Adam step on a (LR, HR) batch; returns the step's loss."""
    def step(lr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = l1_loss(model, lr, hr, plain)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def tf32_off(device: str) -> None:
    """The JAX trainer is full float32: TF32 off for cuDNN's weight
    gradient and any product, logged once."""
    if device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        logger.info("training in float32 on cuda: K1f forward and input "
                    "gradients (TF32 off)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--patch", type=int, default=48, help="HR patch size")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--out", default=os.path.join(
        ROOT, "outputs", "tiny_trained_x4_torch.safetensors"))
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from neural_enhanced_super_resolution_torch.models import (
        RRDBNetConfig, TrainableRRDBNet, init_rrdbnet, save_state_dict)
    from neural_enhanced_super_resolution_torch.runtime.device import (
        determine_device)

    device = determine_device("cpu" if args.cpu else "cuda")
    tf32_off(device)
    img, lr_full = training_images()
    cfg = RRDBNetConfig(**TINY)
    model = TrainableRRDBNet(
        cfg, init_rrdbnet(cfg, torch.Generator().manual_seed(0)), device)
    step = make_step(model, torch.optim.Adam(model.parameters(), args.lr))
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    first = last = None
    for i in range(args.steps):
        lr, hr = (torch.from_numpy(a).to(device)
                  for a in sample_batch(rng, img, lr_full, args.batch,
                                        args.patch))
        loss = step(lr, hr)
        if i == 0:
            first = float(loss)
        if i % 100 == 0 or i == args.steps - 1:
            last = float(loss)
            print(f"step {i:5d} loss {last:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"{args.steps} steps in {seconds:.3f} s: "
          f"{seconds / max(1, args.steps):.6f} s/step on {device}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_state_dict(model.state_dict(), args.out)
    print(f"first loss {first:.4f} -> final {last:.4f}; saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
