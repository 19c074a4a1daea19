"""Model FLOPs of the request's networks, counted by PyTorch's
``FlopCounterMode`` over the benchmark's plain reference run on the meta
device (shapes only, nothing computed): convolutions and matrix products,
two FLOPs a multiply-add, attention's two products included. The weights'
shapes are those the benchmark made for the run."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import nets


def _meta(sd: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in sd.items()}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def rrdbnet_flops(sd: dict, cfg: dict, h: int, w: int) -> int:
    x = torch.empty((1, h, w, cfg["num_in_ch"]), device="meta")
    return _count(lambda: nets.rrdbnet(_meta(sd), x, cfg["num_block"]))


def segformer_flops(sd: dict, cfg: dict, size: int) -> int:
    x = torch.empty((1, size, size, 3), device="meta")
    return _count(lambda: nets.segformer_logits(_meta(sd), cfg, x))


def clip_flops(sd: dict, cfg: dict, batch: int = 2) -> int:
    ids = torch.zeros((batch, cfg["max_position_embeddings"]),
                      dtype=torch.long, device="meta")
    return _count(lambda: nets.clip_text(_meta(sd), cfg, ids))


def unet_pass_flops(sd: dict, cfg: dict, h: int, w: int) -> int:
    x = torch.empty((1, cfg["in_channels"], h, w), device="meta")
    ctx = torch.empty((1, 77, cfg["cross_attention_dim"]), device="meta")
    lab = torch.zeros((1,), dtype=torch.long, device="meta")
    return _count(lambda: nets.unet(_meta(sd), cfg, x, 0, ctx, lab))


def vae_decode_flops(sd: dict, cfg: dict, h: int, w: int) -> int:
    z = torch.empty((1, cfg["latent_channels"], h, w), device="meta")
    return _count(lambda: nets.vae_decode(_meta(sd), cfg, z))
