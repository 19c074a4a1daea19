"""Where the time of a SwinIR forward goes on one CUDA GPU.

    python3 tools/torch_swinir_profile.py [--baseline SWINIR_PY]

Run from the root of a checkout on a machine with a CUDA GPU. Builds the
published SwinIR-M x4 width (embed 180, 6 x 6 STLs, window 8, seeded
weights) in bf16 and prints, for one 268^2 tile (reflect-padded to 272^2):

1. the card (``nvidia-smi`` name and power limit);
2. the wall clock and the device time a forward (``torch.profiler`` kernel
   durations), and the launches a call;
3. the device time of each kind of kernel (by name, the 25 largest) over
   one forward, with its launches;
4. the device time of the kernels each layer part launched: LayerNorm,
   linear (GEMM with bias, cast), K1 convs, and the rest (the attention
   core: scale, scores, bias and mask, softmax, P V; the window gathers,
   residual adds, GELU, the input and output steps).

With ``--baseline``, another version of ``models/swinir.py`` (e.g. from a
``git archive`` of an earlier commit under ``build/``) is built on the same
weights and both forwards are timed in turns (baseline, this, this,
baseline), with the largest difference of their outputs. Needs no JAX;
writes nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def part_ranges(torch):
    """A ``torch.profiler.record_function`` range around every call of the
    SwinIR layer parts, so a profile attributes each kernel to the part
    that launched it (the ranges do not nest)."""
    from neural_enhanced_super_resolution_torch.models import rrdbnet, swinir

    def ranged(label, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"part/{label}"):
                return fn(*args, **kwargs)
        return call

    saved = [(swinir._LayerNorm, "forward", "LayerNorm"),
             (swinir._Linear, "forward", "linear (GEMM with bias, cast)"),
             (rrdbnet.Conv3x3, "forward", "K1 conv")]
    originals = [(cls, name, getattr(cls, name)) for cls, name, _ in saved]
    for cls, name, label in saved:
        setattr(cls, name, ranged(label, getattr(cls, name)))
    try:
        yield
    finally:
        for cls, name, fn in originals:
            setattr(cls, name, fn)


def split(torch, fn) -> tuple[list[str], list[str]]:
    """(top kernels by name, device time by part) over one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with part_ranges(torch), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            (spans if e.name.startswith("part/") else kernels).append(e)
    spans.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]
    parts: dict[str, float] = {}
    names: dict[str, list] = {}
    for k in kernels:
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        part = ("the rest: attention core, gathers, adds, GELU"
                if i < 0 or k.time_range.start >= spans[i].time_range.end
                else spans[i].name[5:])
        us = k.time_range.elapsed_us()
        parts[part] = parts.get(part, 0.0) + us
        row = names.setdefault(k.name[:110], [0.0, 0])
        row[0] += us
        row[1] += 1
    total = sum(parts.values())
    top = [f"    {t / 1e3:9.3f} ms {n:5d}x ({100 * t / total:5.1f}%) {name}"
           for name, (t, n) in sorted(names.items(),
                                      key=lambda r: -r[1][0])[:25]]
    by_part = [f"    {name:<52s} {t / 1e3:9.3f} ms ({100 * t / total:5.1f}%)"
               for name, t in sorted(parts.items(), key=lambda r: -r[1])]
    return top, by_part


def load_baseline(path: str):
    """The module at ``path`` (a copy of models/swinir.py), imported under
    its own name; it imports the rest of this checkout's package."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("swinir_baseline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="another models/swinir.py to time "
                    "in turns with this checkout's")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 3
    import chip_smoke
    from neural_enhanced_super_resolution_torch.models.swinir import (
        SwinIRConfig, SwinIRModel, init_swinir, swinir_params_from_state_dict)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = SwinIRConfig()
    params = swinir_params_from_state_dict(
        init_swinir(cfg, torch.Generator().manual_seed(0)))
    model = SwinIRModel(cfg, params, torch.bfloat16, "cuda")
    x = torch.rand((1, 268, 268, 3),
                   generator=torch.Generator().manual_seed(1)).to("cuda")
    t0 = time.perf_counter()
    model(x)
    torch.cuda.synchronize()
    print(f"== first forward (K1 build and load included): "
          f"{time.perf_counter() - t0:.2f} s")
    wall = chip_smoke.wall_ms(lambda: model(x), reps=5)
    dev = chip_smoke.device_ms(lambda: model(x), reps=5)
    launches = chip_smoke.launches_per_call(lambda: model(x), reps=1)
    print(f"== SwinIR-M x4 forward 1x268x268: wall {wall:.3f} ms, device "
          f"{dev:.3f} ms, {launches:.0f} launches a call")
    top, by_part = split(torch, lambda: model(x))
    print("== device time by kernel (25 largest; one forward, profiled):")
    print("\n".join(top))
    print("== device time by layer part:")
    print("\n".join(by_part))
    if args.baseline:
        base = load_baseline(args.baseline)
        old = base.SwinIRModel(base.SwinIRConfig(),
                               base.swinir_params_from_state_dict(
                                   init_swinir(cfg, torch.Generator()
                                               .manual_seed(0))),
                               torch.bfloat16, "cuda")
        diff = (old(x) - model(x)).abs().max().item()
        rows = []
        for label, m in (("baseline", old), ("this", model),
                         ("this", model), ("baseline", old)):
            rows.append(f"{label} device "
                        f"{chip_smoke.device_ms(lambda: m(x), reps=5):.3f} ms"
                        f" wall {chip_smoke.wall_ms(lambda: m(x), reps=5):.3f}"
                        " ms")
        print(f"== in turns with {args.baseline} (max|out diff| {diff:.6g}): "
              + "; ".join(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
