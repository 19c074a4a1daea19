"""Where the time of a diffusion request goes on one CUDA GPU.

    python3 tools/torch_sd_profile.py

Run from the root of a checkout on a machine with a CUDA GPU. Writes the
full-width SD x4 upscaler as a seeded synthetic snapshot and prints:

1. the card (``nvidia-smi`` name and power limit);
2. one UNet pass at a 128^2 latent (batch 1) and one VAE decode of a 128^2
   latent: the unprofiled wall clock, a ``torch.profiler`` split of device
   time by kernel family, and the device time of every call of each layer
   function (profiler ranges around every call: GroupNorm, conv, linear,
   LayerNorm, self-attention with K3, cross-attention, SiLU), summed over
   the pass;
3. ``enhance_image`` on a seeded 128x128 PNG at ``-n 1`` (ESRGAN + the
   diffusion branch, 20 steps) in process: model load, the first request's
   wall and stages, three walls after it, the ``StageTimer`` stages, and a
   profiled run's device-busy share and kernel split;
4. the fixed cost of a process (importing the package and starting CUDA),
   a ``cProfile`` of the snapshot load in a fresh process, and the same
   request through the CLI in a subprocess, with its timestamped log.

Needs no JAX; writes only under ``build/probe_out/``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe_out")
LAYER_FUNCS = ("group_norm", "conv2d", "linear", "layer_norm",
               "attention_qmajor", "silu")


@contextlib.contextmanager
def layer_ranges(torch):
    """A ``torch.profiler.record_function`` range around every call of the
    diffusion layer functions, so a profile attributes each kernel to the
    layer that launched it (device time, host gaps excluded)."""
    from neural_enhanced_super_resolution_torch.kernels import attention
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        unet, vae)

    def ranged(label, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"layer/{label}"):
                return fn(*args, **kwargs)
        return call

    saved = [(mod, name, getattr(mod, name)) for mod in (unet, vae)
             for name in LAYER_FUNCS if hasattr(mod, name)]
    saved.append((attention, "attention_auto", attention.attention_auto))
    for mod, name, fn in saved:
        label = "self-attention (K3)" if name == "attention_auto" else name
        setattr(mod, name, ranged(label, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def split_by_layer(torch, fn, acts) -> list[str]:
    """Device time of the kernels each layer function launched, summed over
    one call of ``fn``: a kernel belongs to the layer range that holds its
    start on the device timeline (the ranges do not nest)."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import profile
    with layer_ranges(torch), profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            (spans if e.name.startswith("layer/") else kernels).append(e)
    spans.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]
    rows: dict[str, float] = {}
    for k in kernels:
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        name = ("rest (adds, casts, GEGLU, cat, ...)" if i < 0
                or k.time_range.start >= spans[i].time_range.end
                else spans[i].name[6:])
        rows[name] = rows.get(name, 0.0) + k.time_range.elapsed_us()
    calls = {n: sum(1 for e in spans if e.name[6:] == n) for n in rows}
    total = sum(rows.values())
    return [f"    {name:<36s} {t / 1e3:9.3f} ms {calls[name]:5d} calls "
            f"({100 * t / total:5.1f}% of device time)"
            for name, t in sorted(rows.items(), key=lambda r: -r[1])]


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch_request_profile import breakdown, smi

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 3
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.runtime.profiler import (
        StageTimer)
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNetConfig, init_rrdbnet, save_state_dict)
    from neural_enhanced_super_resolution_torch.models.diffusion import (
        CLIPTextConfig, UNetConfig, VAEConfig, load_upscale_pipeline,
        unet_forward, vae_decode)
    from neural_enhanced_super_resolution_torch.models.diffusion.specs import (
        write_synthetic_snapshot)
    from neural_enhanced_super_resolution_torch.utils.io import imwrite_rgb

    os.makedirs(os.path.join(OUT, "o"), exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print(smi("name,power.limit"), flush=True)

    snap = write_synthetic_snapshot(
        os.path.join(OUT, "sd_x4"), (UNetConfig(), VAEConfig(),
                                     CLIPTextConfig()),
        torch.Generator("cuda").manual_seed(0))
    t0 = time.perf_counter()
    pipe = load_upscale_pipeline(snap, device="cuda")
    print(f"== snapshot load to the card: {time.perf_counter() - t0:.2f} s")
    g = torch.Generator("cuda").manual_seed(1)
    x = torch.randn((1, 128, 128, 7), generator=g, device="cuda")
    lat = torch.randn((1, 128, 128, 4), generator=g, device="cuda") * 12
    ctx = pipe.encode_prompt("a photo")[1:]
    labels = torch.tensor([20], device="cuda")
    runs = {"UNet pass 1x128x128x7": lambda: unet_forward(
                pipe.unet, x, 500, ctx, labels),
            "VAE decode 128^2 -> 512^2": lambda: vae_decode(pipe.vae, lat)}
    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        busy, lines = breakdown(prof)
        best = min(walls)
        print(f"== {label}: walls {', '.join(f'{w:.2f}' for w in walls)} ms"
              f" (unprofiled); device busy {busy:.2f} ms in the profiled run"
              f" ({100 * busy / best:.1f}% of the best wall)")
        print("\n".join(lines))
        print("   device time by layer function (profiler ranges):")
        print("\n".join(split_by_layer(torch, fn, acts)), flush=True)
    del pipe
    torch.cuda.empty_cache()

    arch = RRDBNetConfig(12, 3, 4, 64, 23, 32)
    ckpt = save_state_dict(init_rrdbnet(arch, torch.Generator().manual_seed(
        0)), os.path.join(OUT, "w.pth"))
    small = np.random.default_rng(0).integers(0, 256, (17, 17, 3), np.uint8)
    src = os.path.join(OUT, "req_128.png")
    imwrite_rgb(src, np.kron(small, np.ones((8, 8, 1), np.uint8))[:128, :128])
    sr = SuperResolutionPipeline("cuda", {
        "use_diffusion": True, "diffusion_model_path": snap,
        "segment_enhancement": False, "denoise_level": 0, "iterations": 1,
        "esrgan_model_path": ckpt,
        "output_dir": os.path.join(OUT, "o")})
    t0 = time.perf_counter()
    sr._load_models()
    print(f"== request 128x128 -n 1 (ESRGAN + SD x4, 20 steps): model load "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sr.enhance_image(src)   # the first request of a process
    print(f"   first request {time.perf_counter() - t0:.3f} s; stages:")
    print("\n".join(sr.timer.summary_lines()))
    walls = []
    for _ in range(3):
        sr.timer = StageTimer()
        t0 = time.perf_counter()
        sr.enhance_image(src)
        walls.append(time.perf_counter() - t0)
    print(f"   walls {', '.join(f'{w:.3f}' for w in walls)} s; stages "
          "(last run):")
    print("\n".join(sr.timer.summary_lines()))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sr.enhance_image(src)
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    busy, lines = breakdown(prof)
    print(f"   profiled wall {pwall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / pwall:.1f}% busy)")
    print("\n".join(lines), flush=True)

    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", (
        "import torch, neural_enhanced_super_resolution_torch; "
        "torch.zeros(1, device='cuda'); torch.cuda.synchronize()")],
        cwd=ROOT, check=True, timeout=300)
    print(f"== a process's import + CUDA start: "
          f"{time.perf_counter() - t0:.2f} s")
    code = ("import cProfile, pstats, sys, torch\n"
            "from neural_enhanced_super_resolution_torch.models.diffusion "
            "import load_upscale_pipeline\n"
            "torch.zeros(1, device='cuda')\n"
            "cProfile.run('load_upscale_pipeline(sys.argv[1], "
            "device=\"cuda\")', sys.argv[2])\n"
            "pstats.Stats(sys.argv[2]).sort_stats('cumulative')"
            ".print_stats(14)\n")
    proc = subprocess.run([sys.executable, "-c", code, snap,
                           os.path.join(OUT, "load.prof")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    print("== SD snapshot load in a fresh process (cProfile, cumulative):")
    print(proc.stdout[-3500:], proc.stderr[-1500:], flush=True)
    cfg = os.path.join(OUT, "cli.json")
    with open(cfg, "w") as f:
        json.dump(dict(sr.config, progress_callback=None,
                       output_dir=os.path.join(OUT, "cli")), f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "neural_enhanced_super_resolution_torch",
         "--cli", "-i", src, "-c", cfg, "-n", "1", "-d", "cuda", "--bench",
         "-o", os.path.join(OUT, "cli", "result.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    print(f"== CLI subprocess 128x128 -n 1: rc {proc.returncode}, wall "
          f"{time.perf_counter() - t0:.2f} s (started at "
          f"{time.strftime('%H:%M:%S')} minus the wall); its log:")
    print("\n".join(line for line in proc.stderr.splitlines()
                    if " - nesr" in line))
    print(proc.stdout[-1500:], flush=True)
    print(smi("name,power.limit,clocks.sm,power.draw"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
