"""A request of the port's pipeline, computed plainly in float32.

What ``SuperResolutionPipeline.enhance_array`` computes for one iteration
at the cells' settings, written out with the frozen ops (``ops``) and the
plain networks (``nets``): NL-means denoise and CLAHE; SegFormer's class
map, its object mask and the masked sharpening; the ESRGAN branch over
256-px tiles with their halo (the 12-channel stack, RRDBNet, truncation to
uint8), per-tile adaptive sharpening and landing of the cores when ESRGAN
is the only branch (the streamed final), else stitched and joined with the
diffusion branch's decode, ensembled and sharpened. Every function takes
uint8 tensors on the device and the benchmark's weights.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import nets, ops

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_BLOCK_TILES = 4          # tiles a reference forward (memory)


def f32(sd: dict) -> dict:
    return {k: v.float() for k, v in sd.items()}


def pre(img: torch.Tensor, pcfg: dict) -> torch.Tensor:
    if pcfg.get("denoise_level", 0.5) > 0:
        img = ops.denoise_stage(img, pcfg.get("denoise_level", 0.5))
    return ops.contrast_stage(img)


def segment_sharpen(img: torch.Tensor, sd: dict, scfg: dict,
                    input_size: int = 512) -> torch.Tensor:
    """SegFormer's class map at the input capped to 1024 px, the object
    mask (class > 0) resized back nearest then bilinear, masked sharpening."""
    h, w = int(img.shape[0]), int(img.shape[1])
    x = img
    if max(h, w) > 1024:
        s = 1024 / max(h, w)
        x = ops.resize(x, dsize=(int(w * s), int(h * s)),
                       interpolation="lanczos4")
    net_in = ops.resize(x, dsize=(input_size, input_size),
                        interpolation="bilinear")
    mean = torch.tensor(_IMAGENET_MEAN, device=img.device)
    std = torch.tensor(_IMAGENET_STD, device=img.device)
    logits = nets.segformer_logits(sd, scfg,
                                   ((net_in.float() / 255.0 - mean) / std)[None])
    seg = logits[0].argmax(-1).to(torch.uint8)
    seg = ops.resize(seg, dsize=(int(x.shape[1]), int(x.shape[0])),
                     interpolation="nearest")
    if tuple(seg.shape) != (h, w):
        seg = ops.resize(seg, dsize=(w, h), interpolation="nearest")
    mask = ops.resize((seg > 0).to(torch.uint8), dsize=(w, h),
                      interpolation="bilinear")
    return ops.masked_sharpen(img, mask)


def esrgan_tiles(tiles: torch.Tensor, sd: dict, ecfg: dict) -> torch.Tensor:
    """(N, T, T, 3) uint8 RGB tiles -> (N, 4T, 4T, 3) uint8: the 12-channel
    BGR stack [bgr, bgr*1.1, bgr*0.9, blur3(bgr)], RRDBNet, clip(y*255)
    truncated, back to RGB; in blocks of tiles."""
    outs = []
    for s in range(0, tiles.shape[0], _BLOCK_TILES):
        bgr_u8 = tiles[s:s + _BLOCK_TILES].flip(-1)
        bgr = bgr_u8.float() / 255.0
        blurred = ops.gaussian_blur(bgr_u8, (3, 3), 0.0).float() / 255.0
        x = torch.cat([bgr, torch.clamp(bgr * 1.1, 0.0, 1.0),
                       torch.clamp(bgr * 0.9, 0.0, 1.0), blurred], dim=-1)
        y = nets.rrdbnet(sd, x, ecfg["num_block"])
        outs.append(torch.clamp(y * 255.0, 0.0, 255.0).to(torch.uint8)
                    .flip(-1))
        del x, y
    return torch.cat(outs)


def esrgan_streamed(img, sd, ecfg, pcfg, sharpen: bool = True):
    """The streamed final: ESRGAN and adaptive sharpening per tile, the
    cores stitched (the program lands them on the host, chunk by chunk)."""
    def fn(tiles):
        out = esrgan_tiles(tiles, sd, ecfg)
        return ops.adaptive_sharpen_batch(out) if sharpen else out

    return ops.process_tiled(fn, img, tile_size=min(
        int(pcfg["max_tile_size"]), 256), halo=max(4, int(pcfg["tile_halo"])),
        scale=ecfg["scale"], batch_tiles=int(pcfg["tile_batch"]))


def esrgan_whole(img, sd, ecfg, pcfg):
    """The ESRGAN branch of the stage chain at the raw scale, tiled."""
    tile = min(int(pcfg["max_tile_size"]), 256)
    return ops.process_tiled(lambda t: esrgan_tiles(t, sd, ecfg), img,
                             tile_size=tile, halo=int(pcfg["tile_halo"]),
                             scale=ecfg["scale"],
                             batch_tiles=int(pcfg["tile_batch"]))


def vae_to_image(latents: torch.Tensor, sd: dict, vcfg: dict) -> torch.Tensor:
    """Final latents (1, H, W, 4) -> RGB uint8 (4H, 4W, 3)."""
    z = latents.permute(0, 3, 1, 2).float() / vcfg["scaling_factor"]
    dec = nets.vae_decode(sd, vcfg, z)
    out = torch.clamp((dec + 1.0) * 127.5, 0.0, 255.0)
    return torch.round(out).to(torch.uint8)[0].permute(1, 2, 0)


def ensemble(images: list[torch.Tensor]) -> torch.Tensor:
    """Equal sizes here: the mean in float32, truncated to uint8."""
    acc = None
    for im in images:
        term = im.float() * (1.0 / len(images))
        acc = term if acc is None else acc + term
    return acc.to(torch.uint8)


def image_gaps(prog: np.ndarray, ref: np.ndarray,
               block: int = 64) -> dict:
    """Mean |program - reference| (uint8 levels) and mean squared
    difference (levels^2), each over the image and over its worst
    ``block`` x ``block`` block."""
    if prog.shape != ref.shape:
        return {k: float("inf") for k in ("out_mad", "block_mad", "out_mse",
                                          "block_mse")}
    full = np.abs(prog.astype(np.float32) - ref.astype(np.float32))
    d = full.mean(-1)
    h, w = d.shape
    hb, wb = h // block, w // block
    blocks = d[:hb * block, :wb * block].reshape(hb, block, wb, block)
    sq = (full ** 2).mean(-1)
    sqb = sq[:hb * block, :wb * block].reshape(hb, block, wb, block)
    return {"out_mad": float(d.mean()),
            "block_mad": float(blocks.mean(axis=(1, 3)).max()),
            "out_mse": float(sq.mean()),
            "block_mse": float(sqb.mean(axis=(1, 3)).max())}
