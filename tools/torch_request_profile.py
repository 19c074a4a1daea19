"""Where the time of a request goes on one CUDA GPU (the PyTorch port).

    python3 tools/torch_request_profile.py

Run from the root of a checkout on a machine with a CUDA GPU. Uses the
full-width 12-channel RRDBNet x4 (64 features, 23 blocks, growth 32) with
seeded synthetic weights and prints:

1. the card (``nvidia-smi`` name and power limit);
2. for each trunk (K1 fused, K2 dform), one forward on four 268x268 tiles:
   the unprofiled wall clock and a ``torch.profiler`` split of device time
   by kernel group (the fused trunk's RDBs on the K1 step, K1 split into
   the trunk's convs and the head's by instantiation, the elementwise
   group the trunk's residual adds and casts);
3. for each trunk, ``enhance_image`` on a seeded 1024x768 PNG at ``-n 1``:
   three wall clocks after a warm-up, the ``StageTimer`` stages, and one
   profiled run's device-busy share of its wall clock;
4. the host's share of the same request (K1 trunk), three times:
   ``imread_rgb``, ``enhance_array``, the 4096x3072 PNG write and, for
   comparison, a JPEG write of the same array;
5. the card's clocks and power draw at the end.

Needs no JAX; writes only under ``build/probe_out/``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "probe_out")
# The fused trunk's five convs w0..w4 at full width (Cin, Cout); no head
# conv shares K1's instantiation (tile width, k-steps a pass) with them.
TRUNK_CONVS = ((64, 192), (32, 160), (32, 128), (32, 96), (32, 64))


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def breakdown(prof) -> tuple[float, list[str]]:
    """Device time of a profile, grouped by kernel family."""
    from torch.autograd import DeviceType
    from neural_enhanced_super_resolution_torch.kernels.conv3x3 import (
        pass_width, tile_width)
    k1_trunk = {f"{tile_width(cout)[0]},{pass_width(cin) // 16}"
                for cin, cout in TRUNK_CONVS}
    groups: dict[str, tuple[float, int]] = {}
    for e in prof.key_averages():
        # StageTimer's "nesr/<stage>" ranges are annotations, not kernels
        if e.device_type != DeviceType.CUDA or e.key.startswith("nesr/"):
            continue
        k = e.key
        if "rdb_bf16_step_kernel" in k:
            name = "K1 step rdb_bf16_step_kernel"
        elif "conv3x3_kernel" in k:
            inst = k.split("conv3x3_kernel<", 1)[-1].split(">", 1)[0]
            part = "trunk" if inst.replace(" ", "") in k1_trunk else "head"
            name = f"K1 {part} conv3x3_kernel"
        elif "conv2x2_kernel" in k or "conv3x3_head_kernel" in k:
            name = "K1 head, folded head forms"
        elif "rdb_fused_kernel" in k:
            name = "K2 rdb_fused_kernel"
        elif "flash_attn_kernel" in k:
            name = "K3 flash_attn_kernel"
        elif any(s in k.lower() for s in ("conv", "fprop", "dgrad")):
            name = "cuDNN conv"
        elif any(s in k.lower() for s in ("gemm", "nvjet", "cutlass")):
            name = "cuBLAS GEMM"
        elif "Memcpy" in k:
            name = "memcpy " + k.split("(")[-1].rstrip(")")
        elif "elementwise" in k or "reduce" in k:
            name = "torch elementwise/reduce"
        else:
            name = "other: " + k[:40]
        t, n = groups.get(name, (0.0, 0))
        groups[name] = (t + e.self_device_time_total / 1e3, n + e.count)
    busy = sum(t for t, _ in groups.values())
    lines = [f"    {k:<34s} {t:10.3f} ms {n:6d} launches "
             f"({100 * t / max(busy, 1e-9):5.1f}%)"
             for k, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])]
    return busy, lines


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 3
    from neural_enhanced_super_resolution_torch import SuperResolutionPipeline
    from neural_enhanced_super_resolution_torch.runtime.profiler import (
        StageTimer)
    from neural_enhanced_super_resolution_torch.models import (
        RRDBNet, RRDBNetConfig, init_rrdbnet, save_state_dict)
    from neural_enhanced_super_resolution_torch.utils.io import (imread_rgb,
                                                                 imwrite_rgb)

    os.makedirs(os.path.join(OUT, "o"), exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    print(smi("name,power.limit"), flush=True)

    cfg = RRDBNetConfig(12, 3, 4, 64, 23, 32)
    sd = init_rrdbnet(cfg, torch.Generator().manual_seed(0))
    x = torch.rand((4, 268, 268, 12),
                   generator=torch.Generator().manual_seed(1)).cuda()
    for trunk in ("fused", "dform"):
        m = RRDBNet(cfg, sd, torch.bfloat16, "cuda", trunk)
        m(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=acts) as prof:
            m(x)
            torch.cuda.synchronize()
        busy, lines = breakdown(prof)
        print(f"== forward {trunk} trunk, 4 x 268^2 tiles: wall {wall:.2f} ms"
              f" (unprofiled), device busy {busy:.2f} ms (profiled run)")
        print("\n".join(lines), flush=True)
        del m
        torch.cuda.empty_cache()

    ckpt = save_state_dict(sd, os.path.join(OUT, "w.pth"))
    rng = np.random.default_rng(0)
    small = rng.integers(0, 256, (97, 129, 3), dtype=np.uint8)
    img = np.kron(small, np.ones((8, 8, 1), np.uint8))[:768, :1024]
    src = os.path.join(OUT, "req_1024x768.png")
    imwrite_rgb(src, img)
    mp = 4096 * 3072 / 1e6
    pipes = {}
    for trunk in (None, "dform"):
        pipe = pipes[trunk] = SuperResolutionPipeline("cuda", {
            "use_diffusion": False, "segment_enhancement": False,
            "denoise_level": 0, "iterations": 1, "esrgan_model_path": ckpt,
            "esrgan_trunk": trunk, "output_dir": os.path.join(OUT, "o")})
        pipe.enhance_image(src)   # warm-up
        walls = []
        for _ in range(3):
            pipe.timer = StageTimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.enhance_image(src)
            walls.append(time.perf_counter() - t0)
        stages = pipe.timer.summary_lines()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            pipe.enhance_image(src)
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
        busy, lines = breakdown(prof)
        print(f"== request 1024x768 -n 1 ({trunk or 'fused'} trunk): walls "
              f"{', '.join(f'{w:.3f}' for w in walls)} s -> "
              f"{mp / min(walls):.3f} MP_out/s at the best; profiled wall "
              f"{pwall:.1f} ms, device busy {busy:.1f} ms "
              f"({100 * busy / pwall:.1f}% busy)")
        print("   stages (last unprofiled run):")
        print("\n".join(stages))
        print("\n".join(lines), flush=True)

    pipe = pipes[None]
    print("== host share of the request (fused trunk):")
    for _ in range(3):
        t0 = time.perf_counter()
        a = imread_rgb(src)
        t1 = time.perf_counter()
        out = pipe.enhance_array(a)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        imwrite_rgb(os.path.join(OUT, "o", "x.png"), out)
        t3 = time.perf_counter()
        imwrite_rgb(os.path.join(OUT, "o", "x.jpeg"), out)
        t4 = time.perf_counter()
        print(f"   imread {t1 - t0:.4f} s, enhance_array {t2 - t1:.4f} s, "
              f"PNG write {t3 - t2:.4f} s, JPEG write {t4 - t3:.4f} s",
              flush=True)
    print(f"{os.cpu_count()} host cores")
    print(smi("name,power.limit,clocks.sm,power.draw"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
