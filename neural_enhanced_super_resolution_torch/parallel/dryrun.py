"""A dry run of every multi-device path on tiny models.

Counterpart of ``dryrun_multichip`` in the repository's
``__graft_entry__.py``: over a given device list (several GPUs, one GPU
listed several times, or ``[cpu] * 8``) it runs, one ``PASS`` line a step:

  1  preprocess -> tile-batch data parallelism -> postprocess
  2  strip sharding with halo exchange
  3  the member-parallel ensemble
  3b SwinIR tile-batch data parallelism
  4  stage overlap: ESRGAN on the split mesh, a diffusion stand-in on the
     remaining slot
  5  a tensor-parallel UNet forward
  5b split-CFG denoise over two slots
  6b ``enhance_image`` with ``data_parallel`` "auto" against "off", bit
     for bit
  6  the hybrid mesh with a tile batch through it

    python3 -m neural_enhanced_super_resolution_torch.parallel.dryrun
    python3 -m neural_enhanced_super_resolution_torch.parallel.dryrun cpu 8

runs it over every visible GPU (``cuda``, the default; it raises when
there is none), or, when ``cpu`` is asked for, over N copies of the CPU
(default 8). Any failure raises.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
from typing import Sequence

import numpy as np
import torch

__all__ = ["dryrun_multichip"]

TINY_UNET = dict(sample_size=16, in_channels=7, out_channels=4,
                 down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                 up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                 block_out_channels=(8, 16), layers_per_block=1,
                 cross_attention_dim=16, attention_head_dim=2,
                 num_class_embeds=50, norm_num_groups=4)


@contextlib.contextmanager
def visible(devices: Sequence[torch.device]):
    """``runtime.device.visible_devices`` returns ``devices`` inside."""
    from neural_enhanced_super_resolution_torch.runtime import device
    saved = device.visible_devices
    device.visible_devices = lambda _device: list(devices)
    try:
        yield
    finally:
        device.visible_devices = saved


def _passed(step: str, what: str) -> None:
    print(f"PASS {step}: {what}", flush=True)


def _close(got: torch.Tensor, ref: torch.Tensor, rel: float) -> float:
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    if not err <= rel * scale:
        raise AssertionError(f"max abs err {err} > {rel} x {scale}")
    return err


def dryrun_multichip(devices: Sequence) -> None:
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig, SwinIRConfig, SwinIRModel, init_rrdbnet,
        init_swinir)
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        DDIMScheduler, DDPMScheduler, UNet2DConditionModel, UNetConfig,
        build_module, unet_forward)
    from neural_enhanced_super_resolution_torch.models.diffusion.cfg_shard \
        import cfg_mesh, denoise_cfg_sharded
    from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
        random_state_dict)
    from neural_enhanced_super_resolution_torch.models.swinir import (
        swinir_params_from_state_dict)
    from neural_enhanced_super_resolution_torch.ops.enhance import (
        adaptive_sharpen, contrast_stage)
    from neural_enhanced_super_resolution_torch.parallel import (
        ensemble_members_sharded, process_strips_sharded, process_tiled,
        process_tiled_sharded, shard_tiles)
    from neural_enhanced_super_resolution_torch.parallel.mesh import module_on
    from neural_enhanced_super_resolution_torch.parallel.overlap import (
        overlap_branches, split_mesh)
    from neural_enhanced_super_resolution_torch.parallel.tensor import (
        TensorParallelUNet)
    from neural_enhanced_super_resolution_torch.pipeline import (
        SuperResolutionPipeline, esrgan_step)
    from neural_enhanced_super_resolution_torch.runtime.distributed import (
        make_hybrid_mesh)
    from neural_enhanced_super_resolution_torch.utils.io import (
        imread_rgb, imwrite_rgb)

    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    home = devices[0]
    gpu = home.type == "cuda"
    dtype = torch.bfloat16 if gpu else torch.float32
    tol = 1e-2 if gpu else 2e-5

    cfg = RRDBNetConfig(num_in_ch=12, num_out_ch=3, scale=4, num_feat=8,
                        num_block=2, num_grow_ch=4)
    model = RRDBNet(cfg, init_rrdbnet(cfg, torch.Generator().manual_seed(0)),
                    dtype=dtype, device=home).eval()
    replicas: dict = {}

    def on(module, dev):
        key = (id(module), dev)
        if key not in replicas:
            replicas[key] = module_on(module, dev)
        return replicas[key]

    def model_fn(tiles):
        return esrgan_step(on(model, tiles.device), tiles, "stack12")

    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.integers(0, 256, (64, 64, 3),
                                          dtype=np.uint8)).to(home)

    # 1) preprocess -> tile DP -> postprocess, against one device
    pre = contrast_stage(image)
    out = process_tiled_sharded(model_fn, pre, devices, tile_size=16, halo=4,
                                scale=4)
    if not torch.equal(out, process_tiled(model_fn, pre, 16, 4, 4)):
        raise AssertionError("tile DP differs from one device")
    out = adaptive_sharpen(out)
    if tuple(out.shape) != (256, 256, 3):
        raise AssertionError(f"tile DP output {tuple(out.shape)}")
    _passed("1", f"preprocess, tile DP over {n} slots, postprocess: "
            f"{tuple(out.shape)}, equal to one device")

    # 2) strip sharding with halo exchange
    strips = process_strips_sharded(model_fn, image, devices, halo=4, scale=4)
    if tuple(strips.shape) != (256, 256, 3):
        raise AssertionError(f"strips output {tuple(strips.shape)}")
    _passed("2", f"strips over {n} slots, halo 4: {tuple(strips.shape)}")

    # 3) member ensemble: the same member on every slot, uniform weights
    ens = ensemble_members_sharded(
        lambda m, img: esrgan_step(m, img[None], "stack12")[0],
        [model] * n, image, devices)
    err = _close(ens, model_fn(image[None])[0], 1.0 / 255 + tol)
    _passed("3", f"member ensemble of {n}: {tuple(ens.shape)}, max abs err "
            f"{err:.3g} against one member")

    # 3b) SwinIR tile DP
    scfg = SwinIRConfig(embed_dim=8, depths=(1,), num_heads=(2,),
                        window_size=4, num_feat=8, upsampler="nearest+conv",
                        scale=4)
    swin = SwinIRModel(scfg, swinir_params_from_state_dict(init_swinir(
        scfg, torch.Generator().manual_seed(2))), dtype, home).eval()

    def swin_fn(tiles):
        return on(swin, tiles.device).upscale_batch(tiles)

    swin_out = process_tiled_sharded(swin_fn, image, devices, tile_size=16,
                                     halo=4, scale=4)
    if not torch.equal(swin_out, process_tiled(swin_fn, image, 16, 4, 4)):
        raise AssertionError("SwinIR tile DP differs from one device")
    _passed("3b", f"SwinIR tile DP over {n} slots: {tuple(swin_out.shape)}, "
            "equal to one device")

    # 4) stage overlap on the split mesh
    esr_slots, diff_slots = split_mesh(devices)
    mesh_a = tuple(devices[i] for i in esr_slots)
    lat = torch.zeros((1, 16, 16, 4), device=devices[diff_slots[-1]])
    esr, diff = overlap_branches(
        lambda: process_tiled_sharded(model_fn, pre, mesh_a, tile_size=16,
                                      halo=4, scale=4),
        lambda: torch.tanh(lat) + 1.0)
    if tuple(esr.shape) != (256, 256, 3) or diff.device != lat.device:
        raise AssertionError(f"overlap: {tuple(esr.shape)}, {diff.device}")
    _passed("4", f"stage overlap: ESRGAN on slots {esr_slots}, diffusion "
            f"stand-in on slot {diff_slots[-1]}")

    # 5) tensor-parallel UNet forward against the replicated one
    ucfg = UNetConfig(**TINY_UNET)
    with torch.device("meta"):
        meta = UNet2DConditionModel(ucfg)
    usd = random_state_dict(meta, torch.Generator().manual_seed(1), "fixed")
    unet = build_module(UNet2DConditionModel, ucfg, usd, dtype, home)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 7)).astype(
        np.float32)).to(home)
    ctx = torch.from_numpy(rng.standard_normal((1, 6, 16)).astype(
        np.float32)).to(home)
    labels = torch.tensor([20], device=home)
    tp = min(2, n)
    tp_unet = TensorParallelUNet(unet, devices[:tp])
    err = _close(tp_unet(x, 3, ctx, labels),
                 unet_forward(unet, x, 3, ctx, labels), tol)
    _passed("5", f"TP UNet forward over {tp} slots: max abs err {err:.3g} "
            "against replicated")

    # 5b) split-CFG over two slots (one device twice on a 1-device list)
    pair = cfg_mesh(devices[:2] if n >= 2 else devices * 2)
    lat = denoise_cfg_sharded(
        [on(unet, d) for d in pair], torch.zeros((2, 6, 16), device=home),
        torch.zeros((1, 8, 8, 3), device=home),
        torch.zeros((1, 8, 8, 3), device=home),
        torch.zeros((1, 8, 8, 4), device=home), None, [801, 401, 1], 20,
        7.5, DDIMScheduler(), DDPMScheduler(), pair)
    if tuple(lat.shape) != (1, 8, 8, 4) or not torch.isfinite(lat).all():
        raise AssertionError(f"split-CFG latents {tuple(lat.shape)}")
    _passed("5b", f"split-CFG over {pair}: latents {tuple(lat.shape)}")

    # 6b) the product entry point: "auto" equals "off" bit for bit
    with tempfile.TemporaryDirectory() as td, visible(devices):
        src = os.path.join(td, "in.png")
        imwrite_rgb(src, image.cpu().numpy())
        outs, meshes = {}, {}
        for mode in ("auto", "off"):
            pipe = SuperResolutionPipeline(
                device="cuda" if gpu else "cpu", config={
                    "iterations": 1, "use_diffusion": False,
                    "segment_enhancement": False, "denoise_level": 0,
                    "adaptive_sharpening": False, "data_parallel": mode,
                    "enable_tiling": True, "max_megapixels": 0.0001,
                    "max_tile_size": 16, "tile_halo": 4,
                    "output_dir": os.path.join(td, "out_" + mode)})
            pipe.models["esrgan"] = {"model": model, "cfg": cfg}
            outs[mode] = imread_rgb(pipe.enhance_image(src))
            meshes[mode] = pipe._parallel_layout()["mesh"]
        if (meshes["auto"] is None) != (n == 1) or meshes["off"] is not None:
            raise AssertionError(f"layouts {meshes}")
        if not np.array_equal(outs["auto"], outs["off"]):
            raise AssertionError("enhance_image: auto differs from off")
    _passed("6b", f"enhance_image data_parallel auto over {n} slots equals "
            "off, bit for bit")

    # 6) the hybrid mesh: a tile batch through its local devices
    hmesh = make_hybrid_mesh({"dp": n}, devices=list(devices))
    batch = torch.arange(n * 4, dtype=torch.float32, device=home).reshape(
        n * 2, 2)
    got = torch.cat([(s * 2.0).to(home) for s in
                     shard_tiles(batch, hmesh.local())])
    if hmesh.devices.shape != (1, n) or not torch.equal(got, batch * 2.0):
        raise AssertionError(f"hybrid mesh {hmesh.devices.shape}")
    _passed("6", f"hybrid mesh {hmesh.axis_names} {hmesh.devices.shape}, a "
            "tile batch through it")


def main(argv: Sequence[str]) -> None:
    from neural_enhanced_super_resolution_torch.runtime.device import (
        determine_device, visible_devices)
    device = determine_device(argv[0] if argv else "cuda")
    if device == "cpu":
        dryrun_multichip([torch.device("cpu")] * int(argv[1] if len(argv) > 1
                                                     else 8))
    else:
        dryrun_multichip(visible_devices(device))


if __name__ == "__main__":
    main(sys.argv[1:])
