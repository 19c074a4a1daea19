#!/usr/bin/env python3
"""Reference-parity quality harness for the PyTorch port: the port against
the PyTorch reference stack on identical inputs (BASELINE.md: "PSNR within
0.1 dB").

The counterpart of ``tools/compare_reference.py``, with the same command
line, the same three stacks and the same npz goldens, so a goldens file
recorded once checks against either package:

  --record goldens.npz  (a machine with the reference stack and weights)
      Runs the PyTorch reference stack (basicsr / transformers / diffusers)
      and records inputs and outputs.
  --check goldens.npz   (anywhere the port runs; --device, default cuda)
      Replays the recorded inputs through the port and prints the parity
      table. Exit code 1 on a tolerance failure.

Stacks (--stack):

  esrgan (default): basicsr RRDBNet on the 12-channel stack of degraded
      crops; the port replays them through ``RRDBNet`` and the pipeline's
      tile step (``pipeline.esrgan_step``, "stack12"; bf16 on the card,
      float32 on the CPU); parity metric |dPSNR| against the clean
      original (<= --tolerance dB).
  segformer: transformers SegformerForSemanticSegmentation logits on the
      reference's preprocessing; the port's ``models/segformer.py`` in
      float32; argmax agreement (>= --seg-agreement) and mean |dlogit|.
  diffusion: the x4 upscaler's components with recorded noise tensors and
      the latent after every DDIM step; the port's
      ``UpscalePipeline.trace_latents`` in float32 injects the same noise;
      per-step latent difference (<= --lat-tolerance) and the final
      image's PSNR.

Degradation (esrgan) is the port's ``utils/image_utils``: 0.5x bicubic,
gaussian noise, JPEG 75. Float32 checks on the card run with TF32 off.

Usage:
    python tools/torch_compare_reference.py --record g.npz \\
        --weights RealESRGAN_x2plus.pth --images img1.png img2.png
    python tools/torch_compare_reference.py --check g.npz \\
        --weights RealESRGAN_x2plus.pth [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 ** 2 / mse)


def degrade(img: np.ndarray, seed: int = 0) -> np.ndarray:
    """The reference's test degradation: 0.5x bicubic downscale + gaussian
    noise + JPEG 75, through the port's image_utils."""
    from neural_enhanced_super_resolution_torch.utils.image_utils import (
        add_noise, apply_jpeg_compression, downsample_image)

    out = downsample_image(img, 0.5, interpolation="bicubic")
    out = add_noise(out, "gaussian", amount=0.02, generator=seed)
    return apply_jpeg_compression(out, quality=75)


# Architecture of the published checkpoint; tests override with tiny nets.
ARCH = dict(num_feat=64, num_block=23, num_grow_ch=32)


def _device(args) -> str:
    from neural_enhanced_super_resolution_torch.runtime.device import (
        determine_device)
    import torch
    device = determine_device(args.device)
    if device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def stack12(img_bgr: np.ndarray) -> np.ndarray:
    """The reference's 12-channel input: [original, x1.1, x0.9, blur3]
    stacked on channels, float [0, 1] (record mode)."""
    import cv2

    f = img_bgr.astype(np.float32) / 255.0
    bright = np.clip(f * 1.1, 0, 1)
    dark = np.clip(f * 0.9, 0, 1)
    blur = cv2.GaussianBlur(f, (3, 3), 0)
    return np.concatenate([f, bright, dark, blur], axis=2)


def run_reference(weights: str, inp_rgb: np.ndarray) -> np.ndarray:
    """Reference ESRGAN forward (requires torch + basicsr)."""
    import torch
    from basicsr.archs.rrdbnet_arch import RRDBNet

    model = RRDBNet(num_in_ch=12, num_out_ch=3, scale=4, **ARCH)
    sd = torch.load(weights, map_location="cpu")
    model.load_state_dict(sd.get("params_ema", sd.get("params", sd)),
                          strict=True)
    model.eval()
    bgr = inp_rgb[:, :, ::-1]
    x = torch.from_numpy(stack12(bgr).transpose(2, 0, 1))[None]
    with torch.no_grad():
        y = model(x)[0].numpy().transpose(1, 2, 0)
    y = np.clip(y, 0, 1)[:, :, ::-1]  # BGR -> RGB
    return (y * 255.0).round().astype(np.uint8)


def run_ours(weights: str, inp_rgb: np.ndarray,
             device: str = "cuda") -> np.ndarray:
    """The port's RRDBNet on the pipeline's tile step (the production
    path: bf16 on the card, float32 on the CPU), 12-channel stack."""
    import torch

    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig, load_state_dict)
    from neural_enhanced_super_resolution_torch.pipeline import esrgan_step

    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, **ARCH)
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    model = RRDBNet(cfg, load_state_dict(weights), dtype, device, "fused")
    tiles = torch.from_numpy(np.ascontiguousarray(inp_rgb))[None].to(device)
    return esrgan_step(model, tiles, "stack12")[0].cpu().numpy()


def record(args) -> int:
    from neural_enhanced_super_resolution_torch.utils.io import imread_rgb

    entries = []
    for path in args.images:
        clean = imread_rgb(path)
        h, w = clean.shape[:2]
        crop = clean[:min(h, args.crop), :min(w, args.crop)]
        deg = degrade(crop)
        ref_out = run_reference(args.weights, deg)
        entries.append((os.path.basename(path), crop, deg, ref_out))
        print(f"{path}: ref PSNR vs clean = "
              f"{psnr(_match(ref_out, crop), crop):.3f} dB")
    np.savez_compressed(
        args.record,
        names=np.array([e[0] for e in entries]),
        **{f"clean_{i}": e[1] for i, e in enumerate(entries)},
        **{f"degraded_{i}": e[2] for i, e in enumerate(entries)},
        **{f"ref_{i}": e[3] for i, e in enumerate(entries)})
    print(f"recorded {len(entries)} goldens -> {args.record}")
    return 0


def _match(out: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Resize the x4 output back to the clean original's geometry."""
    import torch

    from neural_enhanced_super_resolution_torch.ops.resize import resize
    th, tw = target.shape[:2]
    if out.shape[:2] == (th, tw):
        return out
    return resize(torch.from_numpy(np.ascontiguousarray(out)),
                  dsize=(tw, th), interpolation="bicubic").numpy()


def check(args) -> int:
    device = _device(args)
    data = np.load(args.check, allow_pickle=False)
    names = [str(n) for n in data["names"]]
    worst = 0.0
    print(f"{'image':24s} {'ref dB':>8s} {'ours dB':>8s} {'dPSNR':>7s} "
          f"{'max|diff|':>9s}")
    for i, name in enumerate(names):
        clean = data[f"clean_{i}"]
        deg = data[f"degraded_{i}"]
        ref_out = data[f"ref_{i}"]
        ours = run_ours(args.weights, deg, device)
        p_ref = psnr(_match(ref_out, clean), clean)
        p_ours = psnr(_match(ours, clean), clean)
        d = abs(p_ours - p_ref)
        worst = max(worst, d)
        mad = int(np.abs(ours.astype(int) - ref_out.astype(int)).max())
        print(f"{name:24s} {p_ref:8.3f} {p_ours:8.3f} {d:7.3f} {mad:9d}")
    ok = worst <= args.tolerance
    print(f"worst |dPSNR| = {worst:.3f} dB "
          f"({'PASS' if ok else 'FAIL'}, tolerance {args.tolerance})")
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# SegFormer stack
# ---------------------------------------------------------------------------

def _segformer_net_input(img_rgb: np.ndarray, input_size: int = 512
                         ) -> np.ndarray:
    """The reference feature-extractor preprocessing through the port's
    ops, as ``models/segformer.SegFormerModel.segment`` runs it: cap 1024,
    square bilinear resize, ImageNet normalise."""
    import torch

    from neural_enhanced_super_resolution_torch.models.segformer import (
        _IMAGENET_MEAN, _IMAGENET_STD)
    from neural_enhanced_super_resolution_torch.ops.resize import resize

    img = torch.from_numpy(np.ascontiguousarray(img_rgb))
    h, w = img.shape[:2]
    if max(h, w) > 1024:
        s = 1024 / max(h, w)
        img = resize(img, dsize=(int(w * s), int(h * s)),
                     interpolation="lanczos4")
    net_in = resize(img, dsize=(input_size, input_size),
                    interpolation="bilinear").numpy()
    return ((net_in.astype(np.float32) / 255.0
             - np.asarray(_IMAGENET_MEAN, np.float32))
            / np.asarray(_IMAGENET_STD, np.float32))


def record_segformer(args) -> int:
    """The HF transformers SegFormer forward, logits recorded.
    --weights = HF snapshot directory."""
    import torch
    from transformers import SegformerForSemanticSegmentation

    from neural_enhanced_super_resolution_torch.utils.io import imread_rgb

    model = SegformerForSemanticSegmentation.from_pretrained(args.weights)
    model.eval()
    entries = []
    for path in args.images:
        img = imread_rgb(path)
        x = _segformer_net_input(img)
        with torch.no_grad():
            logits = model(torch.from_numpy(
                x.transpose(2, 0, 1))[None]).logits
        logits = logits[0].numpy().transpose(1, 2, 0)  # (H/4, W/4, classes)
        entries.append((os.path.basename(path), x, logits))
        print(f"{path}: logits {logits.shape}, "
              f"{len(np.unique(logits.argmax(-1)))} classes present")
    np.savez_compressed(
        args.record, stack="segformer",
        names=np.array([e[0] for e in entries]),
        **{f"netin_{i}": e[1] for i, e in enumerate(entries)},
        **{f"logits_{i}": e[2] for i, e in enumerate(entries)})
    print(f"recorded {len(entries)} segformer goldens -> {args.record}")
    return 0


def check_segformer(args) -> int:
    import torch

    from neural_enhanced_super_resolution_torch.models.segformer import (
        load_segformer)

    device = _device(args)
    model = load_segformer(args.weights, compute_dtype="float32",
                           device=device).model
    data = np.load(args.check, allow_pickle=False)
    names = [str(n) for n in data["names"]]
    worst_agree, worst_dlogit = 1.0, 0.0
    print(f"{'image':24s} {'agree':>8s} {'mean|dl|':>9s} {'max|dl|':>9s}")
    for i, name in enumerate(names):
        x = torch.from_numpy(data[f"netin_{i}"])[None].to(device)
        ref_logits = data[f"logits_{i}"]
        with torch.no_grad():
            ours = model(x)[0].cpu().numpy()
        agree = float(np.mean(ours.argmax(-1) == ref_logits.argmax(-1)))
        dl = np.abs(ours - ref_logits)
        worst_agree = min(worst_agree, agree)
        worst_dlogit = max(worst_dlogit, float(dl.mean()))
        print(f"{name:24s} {agree:8.4f} {dl.mean():9.4f} {dl.max():9.4f}")
    ok = worst_agree >= args.seg_agreement
    print(f"worst agreement = {worst_agree:.4f} "
          f"({'PASS' if ok else 'FAIL'}, threshold {args.seg_agreement})")
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# Diffusion stack
# ---------------------------------------------------------------------------

def record_diffusion(args) -> int:
    """x4-upscaler components from a diffusers snapshot, an explicit DDIM
    loop with recorded noise tensors and per-step latents (so replay is
    trajectory-exact). Call params are the reference's: noise_level=20,
    guidance_scale=7.5."""
    import torch
    from diffusers import (AutoencoderKL, DDIMScheduler as HFDDIM,
                           DDPMScheduler as HFDDPM,
                           UNet2DConditionModel)
    from transformers import CLIPTextModel, CLIPTokenizer

    from neural_enhanced_super_resolution_torch.utils.io import imread_rgb

    root = args.weights
    unet = UNet2DConditionModel.from_pretrained(os.path.join(root, "unet"))
    vae = AutoencoderKL.from_pretrained(os.path.join(root, "vae"))
    text = CLIPTextModel.from_pretrained(os.path.join(root, "text_encoder"))
    tok = CLIPTokenizer.from_pretrained(os.path.join(root, "tokenizer"))
    sched = HFDDIM.from_pretrained(os.path.join(root, "scheduler"))
    low = HFDDPM.from_pretrained(os.path.join(root, "low_res_scheduler"))
    unet.eval(); vae.eval(); text.eval()

    steps, nl, gs = args.steps, 20, 7.5
    prompt = args.prompt
    g = torch.Generator().manual_seed(0)

    path = args.images[0]
    img_u8 = imread_rgb(path)[:args.crop, :args.crop]
    img = torch.from_numpy(
        img_u8.transpose(2, 0, 1)[None].astype(np.float32)) / 127.5 - 1.0

    with torch.no_grad():
        ids = tok([prompt, ""], padding="max_length",
                  max_length=tok.model_max_length, truncation=True,
                  return_tensors="pt").input_ids
        cond, uncond = text(ids[:1])[0], text(ids[1:])[0]
        embeds = torch.cat([uncond, cond])

        image_noise = torch.randn(img.shape, generator=g)
        noisy = low.add_noise(img, image_noise,
                              torch.tensor([nl]))
        init_latents = torch.randn(
            (1, unet.config.out_channels, img.shape[2], img.shape[3]),
            generator=g)

        sched.set_timesteps(steps)
        lat = init_latents
        lats = []
        for t in sched.timesteps:
            lat2 = torch.cat([lat, lat])
            unet_in = torch.cat([lat2, torch.cat([noisy, noisy])], dim=1)
            eps = unet(unet_in, t, encoder_hidden_states=embeds,
                       class_labels=torch.tensor([nl, nl])).sample
            eps_u, eps_c = eps.chunk(2)
            eps = eps_u + gs * (eps_c - eps_u)
            lat = sched.step(eps, t, lat).prev_sample
            lats.append(lat[0].numpy().transpose(1, 2, 0))
        dec = vae.decode(lat / vae.config.scaling_factor).sample
    final = ((dec[0].numpy().transpose(1, 2, 0) + 1) * 127.5)
    final = np.clip(final, 0, 255).round().astype(np.uint8)

    np.savez_compressed(
        args.record, stack="diffusion", prompt=np.array(prompt),
        image=img_u8, steps=steps, noise_level=nl, guidance=gs,
        image_noise=image_noise[0].numpy().transpose(1, 2, 0),
        init_latents=init_latents[0].numpy().transpose(1, 2, 0),
        timesteps=np.asarray(sched.timesteps, np.int64),
        latents=np.stack(lats), final=final)
    print(f"recorded {steps}-step diffusion golden -> {args.record}")
    return 0


def check_diffusion(args) -> int:
    from neural_enhanced_super_resolution_torch.models.diffusion.pipeline \
        import load_upscale_pipeline

    device = _device(args)
    data = np.load(args.check, allow_pickle=False)
    pipe = load_upscale_pipeline(args.weights, device=device,
                                 compute_dtype="float32")
    steps = int(data["steps"])

    ts_ours = np.asarray(pipe.scheduler.timesteps(steps))
    ts_ref = data["timesteps"]
    if not np.array_equal(ts_ours, ts_ref):
        print(f"FAIL: timestep schedules differ: {ts_ours} vs {ts_ref}")
        return 1

    lats, final = pipe.trace_latents(
        str(data["prompt"]), data["image"], data["image_noise"],
        data["init_latents"], noise_level=int(data["noise_level"]),
        num_inference_steps=steps,
        guidance_scale=float(data["guidance"]))
    ref_lats = data["latents"]
    print(f"{'step':>4s} {'t':>5s} {'max|dlat|':>10s} {'rel':>8s}")
    worst_rel = 0.0
    for k in range(steps):
        d = np.abs(lats[k] - ref_lats[k])
        scale = np.abs(ref_lats[k]).mean() + 1e-6
        rel = float(d.max() / scale)
        worst_rel = max(worst_rel, rel)
        print(f"{k:4d} {int(ts_ref[k]):5d} {d.max():10.5f} {rel:8.4f}")
    p = psnr(final, data["final"])
    ok = worst_rel <= args.lat_tolerance
    print(f"final image PSNR vs reference output: {p:.2f} dB; "
          f"worst relative latent diff {worst_rel:.4f} "
          f"({'PASS' if ok else 'FAIL'}, tolerance {args.lat_tolerance})")
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    """The command line of tools/compare_reference.py, plus --device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--record", metavar="NPZ",
                      help="run the PyTorch reference, record goldens")
    mode.add_argument("--check", metavar="NPZ",
                      help="replay goldens through the port")
    ap.add_argument("--stack", choices=("esrgan", "segformer", "diffusion"),
                    default="esrgan")
    ap.add_argument("--weights", required=True,
                    help="checkpoint path (esrgan: .pth; segformer/"
                         "diffusion: HF snapshot directory)")
    ap.add_argument("--images", nargs="*", default=[],
                    help="input images (record mode)")
    ap.add_argument("--crop", type=int, default=512,
                    help="max crop edge for the test region")
    ap.add_argument("--tolerance", type=float, default=0.1,
                    help="esrgan: max |dPSNR| in dB (BASELINE.md contract)")
    ap.add_argument("--seg-agreement", type=float, default=0.999,
                    help="segformer: min argmax class-map agreement")
    ap.add_argument("--lat-tolerance", type=float, default=0.05,
                    help="diffusion: max per-step relative latent diff")
    ap.add_argument("--steps", type=int, default=20,
                    help="diffusion: DDIM steps to record")
    ap.add_argument("--prompt", default="a high resolution, detailed "
                    "photograph")
    ap.add_argument("--device", default="cuda",
                    help="check mode: cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.record and not args.images:
        ap.error("--record requires --images")
    table = {"esrgan": (record, check),
             "segformer": (record_segformer, check_segformer),
             "diffusion": (record_diffusion, check_diffusion)}
    rec, chk = table[args.stack]
    return rec(args) if args.record else chk(args)


if __name__ == "__main__":
    sys.exit(main())
