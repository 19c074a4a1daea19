"""Where NL-means' kernel spends its time on the GPU.

    python3 tools/nlmeans_ablation.py [--reps N]

Builds ``csrc/nlmeans.cu`` and edited copies of it under
``build/nlmeans_ablation/`` (one nvcc each, all started together), and
times each, by CUDA events in turns (the kernel first and last), on the
Lab joint pass at the denoise path's shapes: the 32 x 544^2 tile chunk,
the 4 x 544^2 chunk of a 1024x768 request and a whole 768x576 image. The
copies: the area division by ``__fdiv_rn`` (the IEEE division, as the
plain version divides) instead of ``div_area``; without the exps (w = 1 +
the exponent); without the 7-wide row sums' shuffles; without the
shifted pixels' shared-memory loads (a register stands in); and one
search offset instead of 441 (the patch copy and the stores). Prints
each copy's registers and spills (ptxas), and the SASS instruction mix
of the Lab instantiation (``cuobjdump``). The edited copies compute wrong
outputs: they are timed, not checked. Needs a CUDA GPU (~1 min with the
builds on an H100).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ablation_build import ROOT, prepare, timed  # noqa: E402

OUT = os.path.join(ROOT, "build", "nlmeans_ablation")
SOURCE = "nlmeans.cu"
NOEXP = ("__device__ __forceinline__ float nlm_noexp(float x) "
         "{ return 1.f + x; }\n")
VARIANTS = {
    "kernel": [],
    "IEEE division": [
        ("div_area(row_sum7(col[0]), area0, rcp0)",
         "__fdiv_rn(row_sum7(col[0]), area0)"),
        ("div_area(row_sum7(col[NF - 1]), area1, rcp1)",
         "__fdiv_rn(row_sum7(col[NF - 1]), area1)")],
    "no exps": [(re.compile(r"\bexpf\("), "nlm_noexp("),
                ("namespace {\n", "namespace {\n" + NOEXP)],
    "no row-sum shuffles": [("row_sum7(col[", "(col[")],
    "no shifted loads": [("s[c] = sh[(c * EXT_H + i) * EXT_W];",
                          "s[c] = ctr[i][c] + float(dx);")],
    "one offset": [("for (int dy = 0; dy < SRCH; ++dy)",
                    "for (int dy = 0; dy < 1; ++dy)"),
                   ("for (int dx = 0; dx < SRCH; ++dx)",
                    "for (int dx = 0; dx < 1; ++dx)")],
}
SHAPES = [("32 x 544^2 chunk", (32, 544, 544)),
          ("4 x 544^2 (1024x768 request)", (4, 544, 544)),
          ("768x576 image", (1, 576, 768))]


def lab_input(torch, np, shape, seed: int):
    """Seeded noisy images (flat 16 x 16 patches, noise std 12) as the
    linear Lab the joint pass takes."""
    from neural_enhanced_super_resolution_torch.ops.color import rgb_to_lab
    rng = np.random.default_rng(seed)
    n, h, w = shape
    flat = rng.integers(0, 256, (n, h // 16 + 1, w // 16 + 1, 3))
    img = np.kron(flat, np.ones((1, 16, 16, 1)))[:, :h, :w]
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)
    x = torch.from_numpy(img).to("cuda")
    return rgb_to_lab(x.flip(-1), srgb=False).float().contiguous()


def sass_mix(so: str, cuobjdump: str) -> tuple[int, list]:
    """Instructions of nlmeans_kernel<1, 3> (the Lab pass) by opcode."""
    sass = subprocess.run([cuobjdump, "--dump-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for func in sass.split("Function : ")[1:]:
        if "nlmeans_kernelILi1ELi3E" in func.split(None, 1)[0]:
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                             func)
            mix = collections.Counter(op.split(".")[0] for op in ops)
            return len(ops), mix.most_common(16)
    raise SystemExit("nlmeans_kernel<1, 3> not in the SASS")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from neural_enhanced_super_resolution_torch.kernels import _build
    from neural_enhanced_super_resolution_torch.kernels.nlmeans import (
        _layout)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    os.makedirs(OUT, exist_ok=True)
    jobs = {name: prepare(OUT, name.replace(" ", "_"), SOURCE, edits,
                          ptxas=True)
            for name, edits in VARIANTS.items()}
    libs = {}
    for name, (so, _, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        regs = re.findall(r"nlmeans_kernelILi1ELi3E.*?\n.*?\n.*?(\d+ bytes "
                          r"spill stores).*?\n.*?Used (\d+) registers", log)
        print(f"{name}: Lab instantiation {regs[0][1] if regs else '?'} "
              f"registers, {regs[0][0] if regs else '?'}", flush=True)
        lib = ctypes.CDLL(so)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nesr_nl_means.argtypes = [vp] * 2 + [ci] * 5 + [cf] * 3 + [vp]
        lib.nesr_nl_means.restype = ci
        libs[name] = lib
    total, mix = sass_mix(jobs["kernel"][0], _build.cuda_tool("cuobjdump"))
    print(f"kernel SASS, nlmeans_kernel<1, 3>: {total} instructions; "
          f"{mix}", flush=True)

    fields = (((0,), 5.0), ((1, 2), 5.0))
    for label, shape in SHAPES:
        x = lab_input(torch, np, shape, sum(shape))
        out = torch.empty_like(x)
        mode, neg0, neg1 = _layout(x, fields, 0.0, 7, 21)
        b, h, w, c = x.shape

        def run(lib):
            def fn():
                _build.check("nesr_nl_means", lib.nesr_nl_means(
                    x.data_ptr(), out.data_ptr(), b, h, w, c, mode, neg0,
                    neg1, 0.0, _build.stream_ptr()))
            return fn

        order = list(VARIANTS) + ["kernel"]
        times = collections.defaultdict(list)
        for name in order:
            times[name].append(timed(torch, run(libs[name]), args.reps))
        base = min(times["kernel"])
        print(f"{label} {tuple(x.shape)} on {card}: " + "; ".join(
            f"{name} " + ", ".join(f"{t:.4f}" for t in times[name])
            + ("" if name == "kernel" else
               f" ms ({100 * (min(times[name]) / base - 1):+.1f}%)")
            for name in VARIANTS), flush=True)
        del x, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
