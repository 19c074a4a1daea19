"""The FLOP and byte counts against the models' conv shapes."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import attention, model_flops
from portbench.counts import rrdbnet as rr
from portbench.models.nesr_pipeline import rrdbnet_weights
from portbench.reference import nets

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FULL = {"num_in_ch": 12, "num_out_ch": 3, "scale": 4, "num_feat": 64,
        "num_block": 23, "num_grow_ch": 32}


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", name)) as f:
        return json.load(f)


def test_rrdbnet_work_per_pixel_at_full_width():
    # an RDB: 9 (64*32 + 96*32 + 128*32 + 160*32 + 192*64) MACs a pixel
    assert rr.rdb_macs_per_pixel(64, 32) == 239616
    macs = rr.macs_per_input_pixel(FULL)
    assert 69 * 239616 == 16533504          # the trunk, 16.5 M
    assert 1.3e6 < macs - 16533504 < 1.5e6  # head and outer convs, ~1.4 M
    assert 35.5e6 < 2 * macs < 36.5e6       # ~36 MFLOP an input pixel


@pytest.mark.parametrize("cfg", [
    dict(FULL, num_feat=16, num_grow_ch=8, num_block=1),
    dict(FULL, num_feat=8, num_grow_ch=4, num_block=2)])
def test_rrdbnet_count_matches_its_conv_shapes(cfg):
    """The count per input pixel equals the conv shapes' work, as PyTorch's
    FLOP counter sees the plain reference run on those weights."""
    sd = {k: v.float() for k, v in rrdbnet_weights(
        cfg, torch.Generator().manual_seed(0), "cpu").items()}
    per_pixel = 0
    for k, w in sd.items():
        if not k.endswith(".weight"):
            continue
        mult = 16 if k.split(".")[0] in ("conv_up2", "conv_hr",
                                         "conv_last") else (
            4 if k.startswith("conv_up1") else 1)
        per_pixel += w.shape[0] * w.shape[1] * 9 * mult
    assert per_pixel == rr.macs_per_input_pixel(cfg)
    x = torch.rand(1, 12, 10, cfg["num_in_ch"])
    with FlopCounterMode(display=False) as fc:
        nets.rrdbnet(sd, x, cfg["num_block"])
    assert fc.get_total_flops() == 2 * per_pixel * 12 * 10
    assert model_flops.rrdbnet_flops(sd, cfg, 12, 10) == 2 * per_pixel * 120


def test_tile_chunks_and_trunk_bound():
    assert rr.tile_chunks(480, 640, 256, 16) == [6]
    assert rr.tile_chunks(600, 800, 256, 16) == [12]
    assert rr.tile_chunks(768, 1024, 256, 16) == [12]
    assert rr.tile_chunks(960, 1280, 256, 16) == [16, 4]
    one = rr.rdb_bf16_bound_s(268 * 268, 64, 32)
    # compute-bound: the RDB's FLOPs at 989 TFLOP/s
    assert one == pytest.approx(2 * 268 * 268 * 26624 * 9 / 989e12)
    assert rr.trunk_bound_s(1, 268, FULL) > 69 * one * 0.999


def test_k3_calls_of_the_published_unet():
    d = _config("sdx4-default.json")["diffusion"]
    calls = attention.unet_calls(d["unet"], 336, 448)
    assert len(calls) == 16              # self-attentions a pass
    assert calls.count((8, 168 * 224, 64)) == 5    # half resolution
    assert calls.count((8, 84 * 112, 64)) == 5
    assert calls.count((8, 42 * 56, 128)) == 6     # quarter, with mid
    assert attention.vae_call(d["vae"], 336, 448) == (1, 336 * 448, 512)
    bound, n = attention.request_bound_s(d["unet"], d["vae"], 336, 448, 40)
    assert n == 641                      # 40 passes x 16 + the VAE's one
    s = 168 * 224
    assert bound > 40 * 5 * 4 * 8 * s * s * 64 / 989e12


def test_meta_counts_equal_counts_on_real_tensors():
    """Counting on the meta device sees the shapes a real run computes."""
    with open(os.path.join(HERE, "data", "tiny_cells.json")) as f:
        d = json.load(f)["sdx4"]["config"]["diffusion"]
    from portbench.models.nesr_pipeline import _shapes, fan_in_weights
    from neural_enhanced_super_resolution_torch.models.diffusion.unet import (
        UNet2DConditionModel, UNetConfig)
    with torch.device("meta"):
        mod = UNet2DConditionModel(UNetConfig(**d["unet"]))
    sd = {k: v.float() for k, v in fan_in_weights(
        _shapes(mod), torch.Generator().manual_seed(0), "cpu").items()}
    x = torch.rand(1, 7, 12, 20)
    ctx = torch.rand(1, 77, d["unet"]["cross_attention_dim"])
    with FlopCounterMode(display=False) as fc:
        nets.unet(sd, d["unet"], x, 500, ctx, torch.zeros(1, dtype=torch.long))
    assert model_flops.unet_pass_flops(sd, d["unet"], 12, 20) == \
        fc.get_total_flops() > 0
